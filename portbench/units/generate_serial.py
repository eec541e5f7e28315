"""A relayer's unit: the configuration's whole range (or pair) and its
storage grid proved on the serial range engine
(``generate_event_proofs_for_range``, the range engine's scan, match and
record, then the storage leg), then the bundle verified with every witness
CID recomputed on the card. It counts the bundle's proofs where every
verdict is true.

The check reads every unit's verdicts against a sound bundle's (each claim
true), and in full (claims, blocks, the reference's walk, verdicts) two
units drawn from the seed before the window and each client's last: keeping
every pass's bundle alive would grow the heap the collector walks as the
window runs. The control is the reference's bundle without the child
headers its claims read, judged by the reference verifier.
"""

from portbench.bench.program import plain_bundle
from portbench.bench.traffic import Unit as BaseUnit
from portbench.reference.check import (
    REJECTED,
    check_bundle,
    child_headers,
    reference_bundle,
    verdict,
    verdict_diff,
)


def _all_true(result) -> bool:
    return result != REJECTED and all(result[0]) and all(result[1])


class Unit(BaseUnit):
    kept: set = frozenset()

    def run(self, client: int, k: int):
        if self.control:
            bundle = reference_bundle(self.world, drop=child_headers(self.world))
            result = verdict(bundle)
            n = len(bundle.events) + len(bundle.storage)
            return (bundle, result), n if _all_true(result) else 0
        from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range

        program = self.program
        bundle = generate_event_proofs_for_range(
            program.store, program.pairs, program.spec, match_backend=program.backend,
            metrics=program.metrics, storage_specs=program.storage_specs,
        )
        result = program.plain_verdicts([program.verify(bundle)])
        return (bundle, result), program.proofs(bundle) if _all_true(result) else 0

    def before(self, seconds: float, warm_s: float) -> None:
        n = max(2, int(seconds / max(warm_s, 1e-3)))
        self.kept = set(self.rng.sample(range(n), 2))

    def slim(self, k: int, output):
        return output if k in self.kept else (None, output[1])  # the verdicts stay

    def check(self, done) -> dict:
        counts = {"claims_wrong": 0, "blocks_wrong": 0, "unproven": 0, "verdicts_wrong": 0}
        sound = ([True] * len(self.world.expected_storage),
                 [True] * len(self.world.expected_events))
        walked: dict = {}  # witness CIDs -> the reference verdict over them
        for r in done:
            bundle, result = r.output
            if bundle is None:
                counts["verdicts_wrong"] += verdict_diff(result, sound)
                continue
            if not self.control:
                bundle = plain_bundle(bundle)
            for key, value in check_bundle(bundle, self.world, walk=False).items():
                counts[key] += value
            key = tuple(c for c, _ in bundle.blocks)
            if key not in walked:
                walked[key] = verdict(bundle)
            want = walked[key]
            if want == REJECTED:
                counts["unproven"] += len(bundle.events) + len(bundle.storage)
            else:
                counts["unproven"] += sum(not v for v in want[0]) + sum(not v for v in want[1])
            counts["verdicts_wrong"] += verdict_diff(result, want)
        return counts
