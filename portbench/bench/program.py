"""The system under test, ``ipc_proofs_tpu_torch``, as the benchmark drives it.

`Program` builds the port's backend on the card, loads a world into a store
(``portbench/stores/<name>.py``: ``load(world) -> (store, pairs)``) and
takes a trust policy (``portbench/policies/<name>.py``: ``make(world)``),
both named by the traffic mix. It offers what every unit shares: one bundle
verified with every witness CID recomputed on the card, and the plain form
of the program's bundles and verdicts, which the reference reads once the
window has closed. The units (``portbench/units/``) call the program's
entries through it.

In a traced run `instrument` wraps three backend entries on the one
backend instance every call reaches: ``blake2b256_batch`` and
``keccak256_batch`` (the lengths of the messages handed in, and a span a
call) and ``verify_block_cids`` (a span a call: the witness-CID
recompute's packing, launches, copy-back and compare).
"""

from __future__ import annotations

import time
from array import array

from portbench.reference.check import REJECTED, Bundle

__all__ = ["Program", "plain_bundle", "plain_result", "launch_count"]


def launch_count() -> int:
    """Kernel launches so far, from the program's three ``LAUNCHES``
    counters."""
    from ipc_proofs_tpu_torch.ops import blake2b, keccak, match

    return sum(sum(c.values()) for c in (blake2b.LAUNCHES, keccak.LAUNCHES, match.LAUNCHES))


def plain_bundle(bundle) -> Bundle:
    return Bundle(
        events=[p.to_json_obj() for p in bundle.event_proofs],
        storage=[p.to_json_obj() for p in bundle.storage_proofs],
        blocks=[(b.cid.to_bytes(), b.data) for b in bundle.blocks],
    )


def plain_result(result):
    """A verify result as ``(storage verdicts, event verdicts)``, or
    ``"rejected"``."""
    if result == REJECTED:
        return REJECTED
    return (list(result.storage_results), list(result.event_results))


class Program:
    """The port over one world: its store, pairs, specs, policy and backend."""

    def __init__(self, world, store, policy, device: str = "cuda"):
        from ipc_proofs_tpu_torch.backend import get_backend
        from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
        from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec
        from ipc_proofs_tpu_torch.utils.metrics import Metrics

        self.backend = get_backend("gpu", device=None if device == "cuda" else device)
        self.backend.warm()  # nvcc builds into the checkout's _build/ on a first run
        self.store, self.pairs = store.load(world)
        self.spec = EventProofSpec(*world.event_spec)
        self.storage_specs = [MappingSlotSpec(*s) for s in world.storage_specs] or None
        self.policy = policy.make(world)
        self.metrics = Metrics()

    def thread_budget(self, threads=None) -> str:
        from ipc_proofs_tpu_torch.utils.threads import resolve_thread_budget

        return repr(resolve_thread_budget(threads=threads))

    def verify(self, bundle):
        """``verify_proof_bundle`` with every witness CID recomputed on the
        card; a bundle whose block does not hash to its CID is rejected."""
        from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle

        try:
            return verify_proof_bundle(
                bundle, self.policy, verify_witness_cids=True, cid_backend=self.backend
            )
        except ValueError as exc:
            if "do not hash" not in str(exc):
                raise
            return REJECTED

    @staticmethod
    def proofs(bundle) -> int:
        return len(bundle.event_proofs) + len(bundle.storage_proofs)

    @staticmethod
    def plain_verdicts(results):
        """Verify results joined into one ``(storage verdicts, event
        verdicts)``, or ``"rejected"``."""
        plain = [plain_result(r) for r in results]
        if any(r == REJECTED for r in plain):
            return REJECTED
        return [v for r in plain for v in r[0]], [v for r in plain for v in r[1]]

    # --- traced runs -------------------------------------------------------

    def instrument(self, spans, hashed: dict) -> None:
        """Wrap the backend's hash and CID-check entries (traced runs only)."""
        backend = self.backend

        def wrap(name, lengths=None):
            inner = getattr(backend, name)

            def call(*args):
                if lengths is not None:
                    lengths.extend(len(m) for m in args[-1])
                t0 = time.perf_counter()
                try:
                    return inner(*args)
                finally:
                    spans.add(name, t0, time.perf_counter())

            setattr(backend, name, call)

        # lengths in flat arrays: a list of int objects would grow the heap
        # the collector walks as the window runs
        wrap("blake2b256_batch", hashed.setdefault("blake2b", array("q")))
        wrap("keccak256_batch", hashed.setdefault("keccak", array("q")))
        wrap("verify_block_cids")

    def uninstrument(self) -> None:
        for name in ("blake2b256_batch", "keccak256_batch", "verify_block_cids"):
            self.backend.__dict__.pop(name, None)
