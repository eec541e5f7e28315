"""Fresh-seed soak driver for the differential/adversarial fuzz program.

The committed test suite pins small seed lists; this driver re-runs the
SAME harness code with fresh seeds at soak scale — the methodology that
found every real divergence to date in the reference. Any assertion
failure is a real bug: the scalar path on the host is the verdict
authority, the reference's serde semantics the acceptance authority.

The counterpart of the reference's ``tools/soak.py``, phase for phase and
seed for seed: the harness is the port's own (`tools._fuzz`), the batched
paths and every range driver run on the card unless ``--device cpu``
(event, shapes and range launch blake2b; storage and range's slot grid
keccak; chaos blake2b through the pool's lane), and in hostkill and
overload a fault of the card raises as a fault, never as a typed refusal.

Usage:
    python -m ipc_proofs_tpu_torch.tools.soak BASE_SEED [phase ...] [--quick]
        [--device cuda|cpu]

Phases (default: all): event storage shapes codec rleplus cert dagcbor
header trees range json chaos crash hostkill overload. Every phase
derives its seeds from BASE_SEED — one `random.Random(f"{base}:{name}")`
per phase — so a (base seed, phase) pair reproduces a run exactly.
"""

from __future__ import annotations

import argparse
import os
import random
import time

from ipc_proofs_tpu_torch.ops.build import DeviceFaultError
from ipc_proofs_tpu_torch.tools import _fuzz, add_device_flag, backend_for, service_device

_T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time()-_T0:7.1f}s] {msg}", flush=True)


def phase_event(rng, quick, backend):
    n = 40 if quick else 2000
    for i in range(n):
        _fuzz.randomized_mutation_differential(rng.randrange(1 << 30), backend)
        if (i + 1) % max(1, n // 4) == 0:
            log(f"event differential: {i+1}/{n} seeds clean")


def phase_storage(rng, quick, backend):
    n = 40 if quick else 2000
    for i in range(n):
        _fuzz.randomized_storage_mutation_differential(rng.randrange(1 << 30), backend)
        if (i + 1) % max(1, n // 4) == 0:
            log(f"storage differential: {i+1}/{n} seeds clean")


def phase_shapes(rng, quick, backend):
    n = 10 if quick else 500
    for i in range(n):
        _fuzz.shape_varied_mutation_differential(rng.randrange(1 << 30), backend)
        _fuzz.shape_varied_storage_mutation_differential(rng.randrange(1 << 30), backend)
        if (i + 1) % max(1, n // 4) == 0:
            log(f"shape-varied differentials: {i+1}/{n} seeds clean")


def phase_codec(rng, quick, backend):
    n = 20 if quick else 300
    for _ in range(n):
        s = rng.randrange(1 << 30)
        _fuzz.cid_string_codec_acceptance_parity(s)
        _fuzz.cid_bytes_codec_acceptance_parity(s)
        _fuzz.exec_order_batch_scalar_parity_under_corruption(rng.randrange(1 << 30), backend)
    log(f"codec/exec-order parity: {n} fresh seeds each clean")


def phase_rleplus(rng, quick, backend):
    from ipc_proofs_tpu_torch.crypto.rleplus import decode_rleplus, encode_rleplus

    r = random.Random(rng.randrange(1 << 30))
    n = 5000 if quick else 60000
    accepted = rejected = 0
    for _ in range(n):
        blob = bytes(r.randrange(256) for _ in range(r.randrange(0, 12)))
        try:
            idxs = decode_rleplus(blob, max_bits=1 << 20)
        except ValueError:
            rejected += 1
            continue
        accepted += 1
        assert encode_rleplus(idxs) == blob, blob.hex()
    assert accepted and rejected
    log(f"rle+ canonicality: {n} blobs, {accepted} accepted all canonical")


def phase_cert(rng, quick, backend):
    from ipc_proofs_tpu_torch.proofs.cert_cbor import certificate_from_cbor, certificate_to_cbor

    base = certificate_to_cbor(_fuzz.sample_certificate())
    r = random.Random(rng.randrange(1 << 30))
    n = 2000 if quick else 20000
    accepted = rejected = 0
    for _ in range(n):
        raw = bytearray(base)
        for _ in range(r.randrange(1, 4)):
            k = r.randrange(3)
            if k == 0 and raw:
                raw[r.randrange(len(raw))] ^= 1 << r.randrange(8)
            elif k == 1 and raw:
                del raw[r.randrange(len(raw))]
            else:
                raw.insert(r.randrange(len(raw) + 1), r.randrange(256))
        raw = bytes(raw)
        try:
            cert = certificate_from_cbor(raw)
        except ValueError:
            rejected += 1
            continue
        accepted += 1
        assert certificate_to_cbor(cert) == raw, raw.hex()
    assert accepted and rejected  # both regimes exercised, no vacuous pass
    log(f"cert cbor mutants: {n}, {accepted} accepted all canonical, {rejected} rejected")


def phase_dagcbor(rng, quick, backend):
    from ipc_proofs_tpu_torch.backend.native import load_dagcbor_ext
    from ipc_proofs_tpu_torch.core.dagcbor import decode_py, encode

    ext = load_dagcbor_ext()
    if ext is None:
        log("dag-cbor: native extension unavailable, skipped")
        return
    r = random.Random(rng.randrange(1 << 30))
    n = 500 if quick else 3000
    for _ in range(n):
        value = _fuzz.random_value(r)
        raw = encode(value)
        assert ext.decode(raw) == decode_py(raw) == value
    log(f"dag-cbor native/python equivalence: {n} fresh values clean")


def phase_header(rng, quick, backend):
    from ipc_proofs_tpu_torch.core.cid import CID
    from ipc_proofs_tpu_torch.state.header import BlockHeader, decode_header_lite

    r = random.Random(rng.randrange(1 << 30))
    h = BlockHeader(
        parents=[CID.hash_of(b"p"), CID.hash_of(b"q")],
        height=77,
        parent_state_root=CID.hash_of(b"s"),
        parent_message_receipts=CID.hash_of(b"r"),
        messages=CID.hash_of(b"m"),
    )
    raw = h.encode()
    n = 10000 if quick else 120000
    agree = 0
    for _ in range(n):
        mutated = bytearray(raw)
        for _ in range(r.randint(1, 4)):
            k = r.randrange(3)
            if k == 0:
                mutated[r.randrange(len(mutated))] = r.randrange(256)
            elif k == 1 and len(mutated) > 1:
                del mutated[r.randrange(len(mutated))]
            else:
                mutated.insert(r.randrange(len(mutated) + 1), r.randrange(256))
        case = bytes(mutated)
        try:
            full = BlockHeader.decode(case)
            full_err = None
        except (ValueError, KeyError) as e:
            full, full_err = None, type(e)
        try:
            lite = BlockHeader.decode_lite(case)
            lite_err = None
        except (ValueError, KeyError) as e:
            lite, lite_err = None, type(e)
        assert (full_err is None) == (lite_err is None), case.hex()
        # the module-level decode_header_lite (C 5-field fast path) has its
        # OWN keep mask and folded validation — same accept/reject set
        # (UnicodeDecodeError narrows to its ValueError parent on skipped
        # text fields, so compare at the ValueError family)
        try:
            lh = decode_header_lite(case)
            lh_err = None
        except (ValueError, KeyError):
            lh, lh_err = None, True
        assert (full_err is None) == (lh_err is None), case.hex()
        if full_err is None:
            assert lite.parents == full.parents and lite.height == full.height
            assert lh.parents == full.parents and lh.height == full.height
            assert lh.messages == full.messages
            agree += 1
    log(f"header lite/full acceptance: {n} mutants, {agree} accepted identically")


def phase_trees(rng, quick, backend):
    from ipc_proofs_tpu_torch.ipld.amt import AMT, amt_build, amt_build_v0
    from ipc_proofs_tpu_torch.ipld.hamt import HAMT, hamt_build, hamt_get_batch
    from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore

    n = 200 if quick else 10000
    batch_checked = False
    for _ in range(n):
        bw = rng.choice([2, 3, 4, 5, 6, 8])
        kv = {
            rng.randbytes(rng.randrange(1, 40)): rng.randbytes(rng.randrange(0, 40))
            for _ in range(rng.randrange(1, 120))
        }
        bs = MemoryBlockstore()
        root = hamt_build(bs, kv, bit_width=bw)
        h = HAMT.load(bs, root, bit_width=bw)
        keys = list(kv) + [rng.randbytes(8) for _ in range(10)]
        rng.shuffle(keys)
        out = hamt_get_batch(bs, [root], [0] * len(keys), keys, bit_width=bw)
        if out is None:  # no native extension: scalar-only round-trips below
            batch_checked = False
        else:
            batch_checked = True
            for k, v in zip(keys, out):
                assert h.get(k) == v, (bw, k.hex())
        assert dict(h.items()) == kv
    log(
        f"HAMT random shapes: {n} trees clean "
        + ("(batch==scalar, items()==built)" if batch_checked
           else "(NATIVE UNAVAILABLE: scalar round-trips only)")
    )
    for _ in range(n):
        v0 = rng.random() < 0.5
        bw = 3 if v0 else rng.choice([1, 2, 3, 4, 5, 8])
        hi = rng.choice([50, 1000, 100000])
        entries = {
            rng.randrange(hi): rng.randbytes(rng.randrange(0, 30))
            for _ in range(rng.randrange(0, 150))
        }
        bs = MemoryBlockstore()
        if v0:
            root = amt_build_v0(bs, entries)
            a = AMT.load(bs, root, expected_version=0)
        else:
            root = amt_build(bs, entries, bit_width=bw)
            a = AMT.load(bs, root, expected_version=3)
        got = {}
        a.for_each(lambda i, v: got.__setitem__(i, v))
        assert got == entries
        for probe in list(entries)[:10] + [rng.randrange(hi) for _ in range(5)]:
            assert a.get(probe) == entries.get(probe)
    log(f"AMT random shapes: {n} trees clean (v0+v3 round-trips)")


def phase_range(rng, quick, backend):
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import (
        generate_and_verify_range_overlapped,
        generate_event_proofs_for_range,
        generate_event_proofs_for_range_pipelined,
    )
    from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec
    from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
    from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle

    SIG, SUBNET, ACTOR = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001
    n = 20 if quick else 500
    for w in range(n):
        bs, pairs, n_match = build_range_world(
            rng.choice([1, 3, 7, 16, 33]),
            rng.choice([1, 4, 16]),
            rng.choice([1, 2, 5]),
            rng.choice([0.0, 0.05, 0.3]),
            signature=SIG,
            topic1=SUBNET,
            actor_id=ACTOR,
        )
        spec = EventProofSpec(event_signature=SIG, topic_1=SUBNET, actor_id_filter=ACTOR)
        # half the worlds also prove a storage slot grid at every pair
        # (mixed range bundles exercise the batched storage generator; its
        # slot digests hash on the backend)
        storage_specs = None
        if rng.random() < 0.5:
            storage_specs = [
                MappingSlotSpec(actor_id=ACTOR, key=SUBNET, slot_index=0),
                MappingSlotSpec(actor_id=ACTOR, key="absent-subnet", slot_index=0),
            ]
        prior = os.environ.get("IPC_SCAN_FUSED_MATCH")
        try:
            os.environ["IPC_SCAN_FUSED_MATCH"] = "1"
            flat = generate_event_proofs_for_range(
                bs, pairs, spec, storage_specs=storage_specs, match_backend=backend
            )
            os.environ["IPC_SCAN_FUSED_MATCH"] = "0"
            unfused = generate_event_proofs_for_range(
                bs, pairs, spec, storage_specs=storage_specs, match_backend=backend
            )
        finally:
            if prior is None:
                del os.environ["IPC_SCAN_FUSED_MATCH"]
            else:
                os.environ["IPC_SCAN_FUSED_MATCH"] = prior
        piped = generate_event_proofs_for_range_pipelined(
            bs, pairs, spec, chunk_size=rng.choice([1, 2, 5, 64]),
            storage_specs=storage_specs, match_backend=backend,
        )
        overlapped, chunk_results = generate_and_verify_range_overlapped(
            bs,
            pairs,
            spec,
            chunk_size=rng.choice([1, 2, 5, 64]),
            verify_chunk=lambda bundle: verify_proof_bundle(
                bundle, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=backend
            ),
            storage_specs=storage_specs,
            match_backend=backend,
        )
        ref = flat.to_json()
        assert unfused.to_json() == ref, f"unfused diverged, world {w}"
        assert piped.to_json() == ref, f"pipelined diverged, world {w}"
        assert overlapped.to_json() == ref, f"overlapped diverged, world {w}"
        assert all(r.all_valid() for r in chunk_results), f"verify failed, world {w}"
        assert len(flat.event_proofs) == n_match, f"count mismatch, world {w}"
        if (w + 1) % max(1, n // 4) == 0:
            log(f"range drivers: {w+1}/{n} random worlds bit-identical + verified")


def phase_json(rng, quick, backend):
    n = 20 if quick else 200
    for _ in range(n):
        _fuzz.bundle_json_garbage_never_leaks(rng.randrange(1 << 30), backend)
        _fuzz.cert_json_garbage_never_leaks(rng.randrange(1 << 30))
    log(f"bundle+cert JSON garbage: {n} fresh seeds each clean")


def phase_chaos(rng, quick, backend):
    # fault-injection differential: under any seeded fault schedule the
    # pipelined driver must emit a bundle byte-identical to the fault-free
    # run or raise a typed error (tools.chaos holds the harness)
    from ipc_proofs_tpu_torch.tools import chaos

    summary = chaos.run_grid(
        rng.randrange(1 << 30),
        runs=5 if quick else 40,
        n_pairs=6 if quick else 16,
        log=log,
        backend=backend,
    )
    assert summary["ok"], summary
    log(
        f"chaos differential: {summary['runs']} runs clean "
        f"({summary['counts']['identical']} identical, "
        f"{summary['counts']['typed_error']} typed errors, "
        f"{summary['total_faults_injected']} faults injected)"
    )


def phase_crash(rng, quick, backend):
    # crash-recovery differential: SIGKILL the journaled range driver at
    # fresh seeded kill points (chunk boundaries + torn mid-record writes),
    # resume, and demand a bundle byte-identical to the uninterrupted run
    # (tools.crashtest holds the harness)
    from ipc_proofs_tpu_torch.tools import crashtest

    summary = crashtest.run_grid(
        rng.randrange(1 << 30),
        points=4 if quick else 16,
        n_pairs=8 if quick else 16,
        log=log,
        device=backend.device.type,
    )
    assert summary["ok"], summary
    log(
        f"crash recovery: {summary['points']} kill points over "
        f"{summary['n_chunks']} chunks, all resumed byte-identical"
    )


def _no_device_fault(status: int, obj) -> None:
    """A daemon's answer for a fault of the card (500, ``error_type:
    device``) is a fault of this run, never a typed refusal."""
    if isinstance(obj, dict) and obj.get("error_type") == "device":
        raise DeviceFaultError(f"the daemon answered {status}: {obj.get('error')}")


def phase_overload(rng, quick, backend):
    # overload-survival differential: a deadline storm (seeded ample /
    # tight / mid-expiry budgets) against the admission-gated HTTP front
    # end — every answer must be byte-identical to the fault-free
    # reference for its pair or a TYPED refusal (deadline / admit /
    # throttle), never an untyped 500 and never a divergent bundle; plus
    # fresh-seed reruns of the SIGTERM grid and the slow-shard
    # quarantine grid (tools.crashtest / tools.chaos harnesses)
    import json as _json
    import threading
    from http.client import HTTPConnection

    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.serve import ProofService, ServiceConfig
    from ipc_proofs_tpu_torch.serve.httpd import ProofHTTPServer
    from ipc_proofs_tpu_torch.tools import chaos, crashtest

    SIG, SUBNET = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1"
    n_pairs = 3 if quick else 6
    store, pairs, _ = build_range_world(
        n_pairs, 4, 2, 0.4, signature=SIG, topic1=SUBNET,
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=SUBNET)
    service = ProofService(
        store=store, spec=spec,
        config=ServiceConfig(
            max_batch=4, max_wait_ms=2.0, workers=2,
            admit_gradient=True, admit_initial=4,
            admit_delay_budget_ms=50.0, device=service_device(backend),
        ),
    )
    httpd = ProofHTTPServer(service, pairs=pairs).start()
    typed_refusals = {"deadline", "cancelled", "admit_rejected",
                      "tenant_throttled", "degraded"}
    try:
        def post(obj):
            conn = HTTPConnection("127.0.0.1", httpd.port, timeout=60)
            try:
                conn.request(
                    "POST", "/v1/generate", _json.dumps(obj),
                    {"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()

        def canonical(data):
            # strip the per-request envelope (trace id, timing) — the
            # differential verdict is about the PROOF payload bytes
            obj = _json.loads(data)
            obj.pop("trace_id", None)
            obj.pop("server_timing", None)
            return _json.dumps(obj, sort_keys=True)

        references = {}
        for i in range(n_pairs):
            st, data = post({"pair_index": i})
            if st != 200:
                _no_device_fault(st, _json.loads(data))
            assert st == 200, data[:200]
            references[i] = canonical(data)

        n = 60 if quick else 400
        outcomes = {"identical": 0, "typed": 0}
        faults: list = []
        lock = threading.Lock()

        def storm(seed):
            r = random.Random(seed)
            for _ in range(n // 4):
                i = r.randrange(n_pairs)
                body = {"pair_index": i}
                draw = r.random()
                if draw < 0.3:
                    body["deadline_ms"] = r.choice([1, 3, 8, 15])  # tight
                elif draw < 0.5:
                    body["deadline_ms"] = r.randrange(2_000, 10_000)  # ample
                st, data = post(body)
                if st == 200:
                    assert canonical(data) == references[i], (
                        f"divergent bundle for pair {i} under deadline storm"
                    )
                    with lock:
                        outcomes["identical"] += 1
                else:
                    obj = _json.loads(data)
                    try:
                        _no_device_fault(st, obj)
                    except DeviceFaultError as exc:
                        faults.append(exc)
                        return
                    assert obj.get("error_type") in typed_refusals, (
                        st, obj,
                    )
                    with lock:
                        outcomes["typed"] += 1

        seeds = [rng.randrange(1 << 30) for _ in range(4)]
        threads = [threading.Thread(target=storm, args=(s,)) for s in seeds]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if faults:
            raise faults[0]
        assert outcomes["identical"] > 0, outcomes  # storms must do real work
        log(
            f"overload deadline storm: {sum(outcomes.values())} requests "
            f"({outcomes['identical']} identical, {outcomes['typed']} typed "
            "refusals), zero divergent/untyped"
        )
    finally:
        httpd.shutdown(timeout=30)
        service.drain()

    summary = crashtest.run_sigterm_grid(rng.randrange(1 << 30), log=log, device=backend.device.type)
    assert summary["ok"], summary
    log("overload SIGTERM grid clean")
    summary = chaos.run_slow_shard_grid(
        rng.randrange(1 << 30), rounds=4 if quick else 10, log=log, backend=backend
    )
    assert summary["ok"], summary
    log(
        f"overload slow-shard grid clean "
        f"({summary['slow_quarantines']} quarantines)"
    )


def phase_hostkill(rng, quick, backend):
    # multi-host recovery differential: kill a live shard mid-load in an
    # R=2 replicated cluster at fresh seeded victims/timings — every
    # answer that completes must be byte-identical to the single-process
    # driver (zero wrong bytes), and the cluster must serve a whole
    # scatter again within a bounded recovery window
    import json as _json
    import tempfile
    import threading

    from ipc_proofs_tpu_torch.cluster import ClusterRouter, LocalShard
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.ops.build import is_device_fault
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_chunked
    from ipc_proofs_tpu_torch.serve.service import ServiceConfig
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    SIG, SUBNET = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1"
    store, pairs, _ = build_range_world(
        6 if quick else 10, 4, 2, 0.3, signature=SIG, topic1=SUBNET,
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=SUBNET)
    reference = _json.dumps(
        generate_event_proofs_for_range_chunked(
            store, list(pairs), spec, chunk_size=3, match_backend=backend
        ).to_json_obj(),
        sort_keys=True,
    )
    idxs = list(range(len(pairs)))
    rounds = 2 if quick else 6
    n_shards = 3
    for rnd in range(rounds):
        with tempfile.TemporaryDirectory(prefix="soak_hostkill_") as workdir:
            shards = [
                LocalShard(
                    f"s{k}", store, pairs, spec,
                    config=ServiceConfig(
                        max_batch=8, max_wait_ms=5.0, workers=1,
                        store_dir=os.path.join(workdir, f"s{k}"),
                        store_owner=f"s{k}",
                        store_segment_max_bytes=1,
                        device=service_device(backend),
                    ),
                    metrics=Metrics(),
                ).start()
                for k in range(n_shards)
            ]
            m = Metrics()
            router = ClusterRouter(
                {s.name: s.url for s in shards}, pairs,
                replication_factor=2, metrics=m, scrape_interval_s=60.0,
            )
            try:
                status, obj = router.generate_range(idxs, chunk_size=3)
                _no_device_fault(status, obj)
                assert status == 200, obj
                summary = router.replicate_now()
                assert not summary["errors"], summary

                wrong: list = []
                stop = threading.Event()

                def load():
                    while not stop.is_set():
                        try:
                            st, o = router.generate_range(idxs, chunk_size=3)
                            _no_device_fault(st, o)
                        except Exception as exc:  # fail-soft: an escape IS the phase finding — recorded in `wrong` and failed below
                            kind = "device fault" if is_device_fault(exc) else "untyped"
                            wrong.append(f"{kind} {type(exc).__name__}: {exc}")
                            return
                        if st != 200:
                            # a typed refusal must still be typed JSON
                            if not isinstance(o, dict) or "error" not in o:
                                wrong.append(f"untyped non-200: {st} {o!r}")
                                return
                            continue
                        got = _json.dumps(o["bundle"], sort_keys=True)
                        if got != reference:
                            wrong.append("DIVERGENT BYTES")
                            return

                t = threading.Thread(target=load)
                t.start()
                time.sleep(0.02 + rng.random() * 0.1)  # kill mid-load
                victim = shards[rng.randrange(n_shards)]
                t_kill = time.monotonic()
                victim.kill()
                # recovery: the next whole byte-identical scatter
                recovered = None
                while time.monotonic() - t_kill < 30.0:
                    st, o = router.generate_range(idxs, chunk_size=3)
                    _no_device_fault(st, o)
                    if st == 200 and _json.dumps(
                        o["bundle"], sort_keys=True
                    ) == reference:
                        recovered = (time.monotonic() - t_kill) * 1000.0
                        break
                stop.set()
                t.join()
                assert not wrong, f"round {rnd}: {wrong}"
                assert recovered is not None, (
                    f"round {rnd}: no whole scatter within 30s of killing "
                    f"{victim.name}"
                )
                log(
                    f"hostkill round {rnd}: killed {victim.name}, whole again "
                    f"in {recovered:,.0f} ms, zero wrong bytes"
                )
            finally:
                router.close()
                for s in shards:
                    try:
                        s.stop(timeout=10)
                    except Exception:  # fail-soft: best-effort teardown; a shard that won't stop must not mask the round verdict
                        pass


PHASES = {
    "event": phase_event,
    "storage": phase_storage,
    "shapes": phase_shapes,
    "codec": phase_codec,
    "rleplus": phase_rleplus,
    "cert": phase_cert,
    "dagcbor": phase_dagcbor,
    "header": phase_header,
    "trees": phase_trees,
    "range": phase_range,
    "json": phase_json,
    "chaos": phase_chaos,
    "crash": phase_crash,
    "hostkill": phase_hostkill,
    "overload": phase_overload,
}


def run_phases(base: int, wanted, quick: bool, backend) -> "dict[str, float]":
    """Each named phase seeded from (base, name); returns its seconds."""
    seconds = {}
    for name in wanted:
        t0 = time.perf_counter()
        # one rng per phase, seeded from (base, name): running a phase
        # alone reproduces exactly what the all-phases run gave it
        PHASES[name](random.Random(f"{base}:{name}"), quick, backend)
        seconds[name] = time.perf_counter() - t0
    return seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seed", type=int, help="base seed; every phase derives its own from it")
    ap.add_argument("phases", nargs="*", help=f"phases to run (default all: {' '.join(PHASES)})")
    ap.add_argument("--quick", action="store_true", help="soak scale cut to a smoke run")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    wanted = args.phases or list(PHASES)
    unknown = [p for p in wanted if p not in PHASES]
    if unknown:
        ap.error(f"unknown phase(s): {unknown}; have {list(PHASES)}")
    backend = backend_for(args.device)
    log(f"base seed {args.seed}, phases {wanted}, quick={args.quick}, device={backend.device}")
    run_phases(args.seed, wanted, args.quick, backend)
    log("SOAK CLEAN")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
