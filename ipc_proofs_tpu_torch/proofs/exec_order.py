"""Canonical message execution order for a tipset.

Per block (in tipset order), BLS messages before secp messages, walking
both AMT v0 message lists in index order; cross-block dedup keeps the FIRST
occurrence. Offline reconstruction recomputes each TxMeta CID
(DAG-CBOR + blake2b-256) and fails on mismatch. The counterpart of
``ipc_proofs_tpu.proofs.exec_order``: the scalar walker, and the batched C
walkers of the port's scan extension for the verifier
(`reconstruct_execution_orders_batch`, whose range-wide TxMeta CID
recompute runs on a hash backend, the card by default) and the generator
(`collect_exec_orders_for_pairs`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.native import load_scan_ext
from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import decode as cbor_decode
from ipc_proofs_tpu_torch.core.dagcbor import encode as cbor_encode
from ipc_proofs_tpu_torch.ipld.amt import AMT
from ipc_proofs_tpu_torch.proofs.scan_native import _raw_view, _snap_kw, split_pooled
from ipc_proofs_tpu_torch.state.header import BlockHeader, LiteHeader, decode_header_lite
from ipc_proofs_tpu_torch.store.blockstore import Blockstore

__all__ = [
    "build_execution_order",
    "reconstruct_execution_order",
    "reconstruct_execution_orders_batch",
    "collect_exec_orders_for_pairs",
    "decode_txmeta",
]

# CIDv1 dag-cbor blake2b-256: the prefix of every canonical chain CID
_CHAIN_PREFIX = b"\x01\x71\xa0\xe4\x02\x20"


def decode_txmeta(raw: bytes) -> tuple[CID, CID]:
    """TxMeta is the DAG-CBOR 2-tuple ``(bls_root, secp_root)``."""
    obj = cbor_decode(raw)
    if not (
        isinstance(obj, list)
        and len(obj) == 2
        and isinstance(obj[0], CID)
        and isinstance(obj[1], CID)
    ):
        raise ValueError("malformed TxMeta (expected 2-tuple of CIDs)")
    return obj[0], obj[1]


def _collect_exec_list(
    store: Blockstore, txmeta_cids: list[CID], verify_txmeta: bool = True
) -> list[CID]:
    out: list[CID] = []
    seen: set[CID] = set()

    for tx_cid in txmeta_cids:
        raw = store.get(tx_cid)
        if raw is None:
            raise KeyError(f"missing TxMeta {tx_cid}")
        bls_root, secp_root = decode_txmeta(raw)
        if verify_txmeta:
            recomputed = CID.hash_of(cbor_encode([bls_root, secp_root]))
            if recomputed != tx_cid:
                raise ValueError(f"TxMeta mismatch: header {tx_cid} vs recomputed {recomputed}")

        for root in (bls_root, secp_root):
            amt = AMT.load(store, root, expected_version=0)
            for _, msg_cid in amt.items():
                if not isinstance(msg_cid, CID):
                    raise ValueError("message list AMT must hold CIDs")
                if msg_cid not in seen:
                    seen.add(msg_cid)
                    out.append(msg_cid)
    return out


def build_execution_order(store: Blockstore, parent: "object") -> list[CID]:
    """Online variant: TxMeta CIDs straight from the tipset's headers (the
    generator trusts its own store, so nothing is recomputed)."""
    return _collect_exec_list(
        store, [header.messages for header in parent.blocks], verify_txmeta=False
    )


def reconstruct_execution_order(store: Blockstore, parent_header_cids: list[CID]) -> list[CID]:
    """Offline variant: decode parent headers from the witness, then verify
    each TxMeta CID by recomputation."""
    txmeta_cids = []
    for cid in parent_header_cids:
        raw = store.get(cid)
        if raw is None:
            raise KeyError(f"missing parent header {cid}")
        txmeta_cids.append(BlockHeader.decode(raw).messages)
    return _collect_exec_list(store, txmeta_cids)


def _native_exec_orders(
    store: Blockstore,
    groups: "list[list[CID]]",
    headers: bool,
    want_touched: bool = True,
    validate_blocks: bool = False,
):
    """Raw C-walker call; None in the pure-Python universe (callers then
    take the scalar walker). A group the walk rejects comes back flagged in
    ``out["failed"]``; an error of the walker itself raises.

    ``validate_blocks`` full-validates every fetched block (verify-side
    callers only — the store holds adversarial witness bytes there)."""
    ext = load_scan_ext()
    if ext is None:
        return None
    raw, fallback = _raw_view(store)
    return ext.collect_exec_orders(
        raw,
        [[c.to_bytes() for c in g] for g in groups],
        fallback,
        headers=headers,
        want_touched=want_touched,
        validate_blocks=validate_blocks,
        **_snap_kw(store, raw, len(groups)),
    )


class _GroupView:
    """Per-group slices of the C walker's pooled output."""

    __slots__ = ("msgs", "touched", "txmetas", "canon", "failed")

    def __init__(self, msgs, touched, txmetas, canon, failed):
        # list[bytes] — message CIDs in execution order, first-seen deduped
        # IN the C walker
        self.msgs = msgs
        self.touched = touched  # list[bytes] — fetched block CIDs
        self.txmetas = txmetas  # list[bytes] — TxMeta CIDs
        self.canon = canon  # list[bool] — raw block == canonical encoding
        self.failed = failed


def _unpack_groups(out: dict, n_groups: int, want_touched: bool = True) -> "list[_GroupView]":
    """Decode the C result dict (pools + offset/length/group-offset arrays)
    into per-group byte-slice lists — the single place that knows the
    layout. ``want_touched=False`` skips materializing the touched-block
    lists (the verify-side caller never reads them)."""

    def slices(prefix):
        goff = np.frombuffer(out[f"{prefix}_goff"], "<i4")
        flat = split_pooled(out[f"{prefix}_pool"], out[f"{prefix}_off"], out[f"{prefix}_len"])
        return [flat[goff[g] : goff[g + 1]] for g in range(n_groups)], goff

    msgs, _ = slices("msg")
    # None (not a shared []) so an accidental verify-side read fails loudly
    touched = [None] * n_groups if not want_touched else slices("touch")[0]
    txmetas, tx_goff = slices("tx")
    canon = out["tx_canon"]
    failed = out["failed"]
    return [
        _GroupView(
            msgs[g],
            touched[g],
            txmetas[g],
            [bool(canon[t]) for t in range(tx_goff[g], tx_goff[g + 1])],
            bool(failed[g]),
        )
        for g in range(n_groups)
    ]


def reconstruct_execution_orders_batch(
    store: Blockstore,
    groups: "list[list[CID]]",
    header_cache: "Optional[dict[CID, LiteHeader]]" = None,
    hash_backend=None,
) -> "Optional[list[Optional[list[bytes]]]]":
    """Batched `reconstruct_execution_order` over many parent-header groups:
    ONE C call walks every group's TxMeta/message AMTs. Returns per group the
    execution order as a first-seen-deduped list of message-CID BYTES, or
    None for a group whose reconstruction fails — exactly the scalar path's
    caught-KeyError/ValueError degradation. Returns None overall in the
    pure-Python universe (callers use the scalar path).

    Parity with the scalar path is enforced on top of the C walk:

    - every parent header is re-decoded with `decode_header_lite`
      (acceptance-identical to the full decode: the C walker here only
      extracts the messages field) and its ``messages`` must equal the
      C-reported TxMeta CID;
    - TxMeta CID recomputation: the C walker reports whether each raw block
      IS the canonical encoding; if so the recomputed CID is
      blake2b-256(raw). Those recomputes run range-wide as ONE
      ``blake2b256_batch`` on ``hash_backend`` (default
      ``get_backend("gpu")``, the card; raises without CUDA), whose digest
      per row decides: a group with a mismatching TxMeta fails, as the
      scalar path's recompute would. Non-canonical raws settle their group
      with the scalar reconstruction.
    """
    out = _native_exec_orders(store, groups, headers=True, want_touched=False, validate_blocks=True)
    if out is None:
        return None
    views = _unpack_groups(out, len(groups), want_touched=False)

    def _scalar_redo(g: int) -> "Optional[list[bytes]]":
        """Settle one group with the scalar reconstruction, the verdict
        authority: used when the C walk rejects something (a residual
        acceptance gap between the walkers must not become a verdict
        divergence) and for non-canonical TxMeta raws."""
        try:
            order = reconstruct_execution_order(store, groups[g])
            return [c.to_bytes() for c in order]
        except (KeyError, ValueError):
            return None

    results: "list[Optional[list[bytes]]]" = []
    recompute_group: "list[int]" = []  # deferred TxMeta CID recomputes
    recompute_cids: "list[bytes]" = []
    for g, view in enumerate(views):
        if view.failed:
            results.append(_scalar_redo(g))
            continue
        ok = True
        # strict header validation (scalar parity); header_cache lets the
        # batch verifier share its phase-1 decodes
        expected_txmetas = []
        try:
            for cid in groups[g]:
                header = header_cache.get(cid) if header_cache is not None else None
                if header is None:
                    raw = store.get(cid)
                    if raw is None:
                        ok = False
                        break
                    header = decode_header_lite(raw)
                    if header_cache is not None:
                        header_cache[cid] = header
                expected_txmetas.append(header.messages.to_bytes())
        except ValueError:
            ok = False
        if ok and expected_txmetas != view.txmetas:
            ok = False
        scalar_fallback = False
        if ok:
            mark = len(recompute_cids)
            for cid_b, canon in zip(view.txmetas, view.canon):
                if canon and cid_b[:6] == _CHAIN_PREFIX:
                    recompute_group.append(g)
                    recompute_cids.append(cid_b)
                else:
                    scalar_fallback = True
                    # the scalar redo settles this whole group — drop its
                    # deferred entries so the batch only carries live work
                    del recompute_group[mark:]
                    del recompute_cids[mark:]
                    break
        if scalar_fallback:
            results.append(_scalar_redo(g))
            continue
        results.append(view.msgs if ok else None)

    # TxMeta CID recompute: one batch on the backend for the whole range,
    # each row's digest held against its CID (failure semantics exactly the
    # scalar path's, per group)
    if recompute_cids:
        raw_map = store._raw_readonly() if hasattr(store, "_raw_readonly") else None
        raws = [
            raw_map.get(cid_b) if raw_map is not None else store.get(CID.from_bytes(cid_b))
            for cid_b in recompute_cids
        ]
        present = [i for i, r in enumerate(raws) if r is not None]
        digests = {}
        if present:
            if hash_backend is None:
                hash_backend = get_backend("gpu")
            digests = dict(zip(present, hash_backend.blake2b256_batch([raws[i] for i in present])))
        for i, (g, cid_b) in enumerate(zip(recompute_group, recompute_cids)):
            if digests.get(i) != cid_b[6:]:
                results[g] = None
    return results


def collect_exec_orders_for_pairs(
    store: Blockstore, txmeta_groups: "list[list[CID]]"
) -> "Optional[list[Optional[tuple[list[bytes], list[bytes]]]]]":
    """Generation-side batched walker: per group of TxMeta CIDs, returns
    ``(exec_order, touched_block_cids)`` — the execution order AND the block
    CIDs the walk touched (the recorded base-witness leg of
    `event_generator.collect_base_witness_and_exec_order`), in one C call
    for all matching pairs, both as RAW CID BYTES in order. A failed group
    yields None (callers redo it scalar so errors surface with the scalar
    path's exact exceptions). None overall in the pure-Python universe."""
    out = _native_exec_orders(store, txmeta_groups, headers=False)
    if out is None:
        return None
    return [
        None if view.failed else (view.msgs, view.touched)
        for view in _unpack_groups(out, len(txmeta_groups))
    ]
