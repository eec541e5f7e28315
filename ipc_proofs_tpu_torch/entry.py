"""Driver entry points: the single-device step and the multi-device dry run.

The counterpart of the JAX package's repo-root ``__graft_entry__.py``:

- ``entry()`` returns the flagship forward step (the batch event-match
  pipeline, `parallel.pipeline.match_pipeline`) with example arguments on
  the card;
- ``dryrun_multichip(n)`` builds an n-device mesh and runs the full batch
  step over it: the sharded event match and per-receipt reduce, the
  witness blake2b recompute split across the mesh (one kernel launch per
  device), and the range drivers with a mesh backend, whose bundles must
  equal the single-device run's byte for byte.

Both default to CUDA cards and raise without them; pass ``device="cpu"``
or ``devices=[torch.device("cpu")] * n`` for the plain versions on the
host (the tests).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["entry", "dryrun_multichip"]

SIGNATURE = "NewTopDownMessage(bytes32,uint256)"
TOPIC1 = "calib-subnet-1"
ACTOR_ID = 1001


def _topics() -> "tuple[bytes, bytes]":
    from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32, hash_event_signature

    return hash_event_signature(SIGNATURE), ascii_to_bytes32(TOPIC1)


def entry(device: "torch.device | str | None" = None):
    """Return ``(fn, example_args)``: `match_pipeline` and its seven
    arguments for a 4 × 4 × 4 synthetic world on ``device`` (the card by
    default; raises without CUDA)."""
    from ipc_proofs_tpu_torch.parallel.pipeline import batch_args, match_pipeline, synthetic_event_batch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry needs a CUDA device (pass device='cpu' for the plain versions)")
    topic0, topic1 = _topics()
    batch = synthetic_event_batch(
        n_tipsets=4,
        receipts_per_tipset=4,
        events_per_receipt=4,
        topic0=topic0,
        topic1=topic1,
        emitter=ACTOR_ID,
        match_rate=0.25,
        seed=0,
    )
    return match_pipeline, batch_args(batch, topic0, topic1, ACTOR_ID, device)


def _sharded_blake2b(mesh, payloads: "list[bytes]") -> "list[bytes]":
    """blake2b-256 of ``payloads`` split into one contiguous block per mesh
    device, each block packed onto its own device (so each launch runs on
    that device's current stream) and hashed there by the multi-block
    kernel; the digests come back in order."""
    from ipc_proofs_tpu_torch.ops.blake2b import blake2b256_blocks
    from ipc_proofs_tpu_torch.ops.pack import digests_to_bytes, pad_blake2b, to_int32

    devices = mesh.devices
    per = -(-len(payloads) // len(devices))
    outs = []
    for b, device in enumerate(devices):
        part = payloads[b * per : (b + 1) * per]
        if not part:
            continue
        blocks, counts, lengths = pad_blake2b(part)
        outs.append(blake2b256_blocks(*(to_int32(a, device) for a in (blocks, counts, lengths))))
    return [d for out in outs for d in digests_to_bytes(out.cpu().numpy())]


def dryrun_multichip(n_devices: int, devices: "Optional[Sequence[torch.device | str]]" = None) -> dict:
    """Run the full batch step over an ``n_devices`` mesh (sp = 2 when
    ``n_devices`` is even) and check it against the single-device run.

    ``devices`` defaults to the CUDA cards (raises when there are fewer
    than ``n_devices``); a list may repeat a device. Raises AssertionError
    on any mismatch; returns what it ran.
    """
    from ipc_proofs_tpu_torch.backend.gpu import GpuBackend
    from ipc_proofs_tpu_torch.core.hashes import blake2b_256
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.parallel.mesh import make_mesh
    from ipc_proofs_tpu_torch.parallel.pipeline import (
        batch_args,
        match_pipeline,
        sharded_match_pipeline,
        synthetic_event_batch,
    )
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import (
        generate_and_verify_range_overlapped,
        generate_event_proofs_for_range,
    )
    from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec
    from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
    from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle

    sp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, sp=sp, devices=devices)
    first = mesh.devices[0]
    dp = n_devices // sp

    # --- leg 1: sharded event match + per-receipt reduce (dp × sp) ----------
    topic0, topic1 = _topics()
    batch = synthetic_event_batch(
        n_tipsets=2 * dp,  # divisible by the dp axis
        receipts_per_tipset=4,
        events_per_receipt=2 * sp,  # divisible by the sp axis
        topic0=topic0,
        topic1=topic1,
        emitter=ACTOR_ID,
        match_rate=0.5,
        seed=7,
    )
    fn, shard_batch = sharded_match_pipeline(mesh)
    hits, mask, count = fn(*shard_batch(batch, topic0, topic1, ACTOR_ID))
    ref_hits, ref_mask, ref_count = match_pipeline(*batch_args(batch, topic0, topic1, ACTOR_ID, first))
    if not (torch.equal(hits, ref_hits) and torch.equal(mask, ref_mask) and int(count) == int(ref_count)):
        raise AssertionError("sharded match diverged from the single-device match")
    if tuple(hits.shape) != batch.shape[:2]:
        raise AssertionError(f"hits {tuple(hits.shape)} for a batch of {batch.shape}")

    # --- leg 2: witness blake2b recompute split across the mesh -------------
    payloads = [f"witness-block-{i}".encode() * 3 for i in range(4 * n_devices)]
    digests = _sharded_blake2b(mesh, payloads)
    if digests != [blake2b_256(p) for p in payloads]:
        raise AssertionError("sharded blake2b diverged from hashlib")

    # --- leg 3: the range driver, match leg sharded over the mesh -----------
    store, pairs, n_matching = build_range_world(
        n_pairs=2 * n_devices, receipts_per_pair=4, events_per_receipt=4, match_rate=0.25,
    )
    spec = EventProofSpec(event_signature=SIGNATURE, topic_1=TOPIC1, actor_id_filter=ACTOR_ID)
    # mixed bundle: storage specs prove at every pair beside the events
    storage_specs = [MappingSlotSpec(actor_id=ACTOR_ID, key=TOPIC1, slot_index=0)]
    meshed, single = GpuBackend(mesh=mesh), GpuBackend(first)
    sharded_bundle = generate_event_proofs_for_range(
        store, pairs, spec, match_backend=meshed, storage_specs=storage_specs
    )
    single_bundle = generate_event_proofs_for_range(
        store, pairs, spec, match_backend=single, storage_specs=storage_specs
    )
    if sharded_bundle.to_json() != single_bundle.to_json():
        raise AssertionError("sharded range pipeline diverged from single-device")
    if len(sharded_bundle.event_proofs) != n_matching or len(sharded_bundle.storage_proofs) != len(pairs):
        raise AssertionError(
            f"{len(sharded_bundle.event_proofs)} event / {len(sharded_bundle.storage_proofs)} storage "
            f"proofs for {n_matching} matching receipts over {len(pairs)} pairs"
        )
    if not verify_proof_bundle(
        sharded_bundle, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=single
    ).all_valid():
        raise AssertionError("the sharded bundle does not verify")

    # --- leg 4: the generate ∥ verify overlapped driver over the mesh -------
    overlapped_bundle, chunk_results = generate_and_verify_range_overlapped(
        store, pairs, spec, chunk_size=max(1, len(pairs) // 2),
        verify_chunk=lambda b: verify_proof_bundle(b, TrustPolicy.accept_all(), cid_backend=single).event_results,
        match_backend=meshed,
        storage_specs=storage_specs,
    )
    if overlapped_bundle.to_json() != single_bundle.to_json():
        raise AssertionError("overlapped driver diverged from single-device over the mesh")
    if not all(r for res in chunk_results for r in res):
        raise AssertionError("a chunk of the overlapped driver does not verify")

    return {
        "mesh": mesh.shape,
        "events": batch.n_events,
        "matches": int(count),
        "cids": len(payloads),
        "event_proofs": len(sharded_bundle.event_proofs),
        "storage_proofs": len(sharded_bundle.storage_proofs),
    }

