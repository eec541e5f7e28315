"""Live-chain byte-compat vector capture.

The reference's only byte-compat grounding is its live calibration-net run
(`src/main.rs:19-101`); this framework's codecs are otherwise pinned to
self-derived goldens. `capture_vectors` fetches a small set of raw chain
blocks — headers, TxMeta, receipts-AMT root — records their CIDs and the
fields our decoders extract, and writes them as a fixtures JSON. The test
suite (tests/test_vectors.py) consumes the file when present and re-checks
every vector byte-for-byte: CID recompute (blake2b-256 over the raw bytes),
strict header decode, TxMeta decode. One captured fixture closes the
residual self-consistency risk.

Usage: ``ipc-proofs vectors --endpoint <lotus> --height <H> -o vectors.json``
"""

from __future__ import annotations

import base64
import json
from typing import Any

from ipc_proofs_tpu_torch.core.cid import CID

__all__ = ["capture_vectors", "check_vectors"]

FORMAT = "ipc-proofs-vectors-v1"


def capture_vectors(client, height: int) -> dict:
    """Capture byte-compat vectors around ``(height, height+1)`` from a
    Lotus-compatible client (anything with `request`/`chain_read_obj` —
    the live `LotusClient` or the hermetic `FakeLotusClient`)."""
    from ipc_proofs_tpu_torch.proofs.chain import Tipset
    from ipc_proofs_tpu_torch.proofs.exec_order import decode_txmeta
    from ipc_proofs_tpu_torch.state.header import BlockHeader

    parent = Tipset.fetch(client, height)
    child = Tipset.fetch(client, height + 1)
    vectors: list[dict[str, Any]] = []

    def fetch_raw(cid: CID) -> bytes:
        raw = client.chain_read_obj(cid)
        if raw is None:
            raise KeyError(f"endpoint has no block {cid}")
        return raw

    def add(kind: str, cid: CID, data: bytes, expect: dict) -> None:
        vectors.append(
            {
                "kind": kind,
                "cid": str(cid),
                "data": base64.b64encode(data).decode("ascii"),
                "expect": expect,
            }
        )

    for cid in parent.cids:
        raw = fetch_raw(cid)
        header = BlockHeader.decode(raw)
        add(
            "header",
            cid,
            raw,
            {
                "height": header.height,
                "parents": [str(c) for c in header.parents],
                "parent_state_root": str(header.parent_state_root),
                "parent_message_receipts": str(header.parent_message_receipts),
                "messages": str(header.messages),
            },
        )
        tx_raw = fetch_raw(header.messages)
        bls_root, secp_root = decode_txmeta(tx_raw)
        add(
            "txmeta",
            header.messages,
            tx_raw,
            {"bls_root": str(bls_root), "secp_root": str(secp_root)},
        )

    child_cid = child.cids[0]
    raw = fetch_raw(child_cid)
    header = BlockHeader.decode(raw)
    add(
        "header",
        child_cid,
        raw,
        {
            "height": header.height,
            "parents": [str(c) for c in header.parents],
            "parent_state_root": str(header.parent_state_root),
            "parent_message_receipts": str(header.parent_message_receipts),
            "messages": str(header.messages),
        },
    )
    receipts_root = header.parent_message_receipts
    add("amt_node", receipts_root, fetch_raw(receipts_root), {})

    return {"format": FORMAT, "height": height, "vectors": vectors}


def check_vectors(doc: dict) -> int:
    """Re-verify every vector in a captured document byte-for-byte; returns
    the number checked, raising on the first mismatch."""
    from ipc_proofs_tpu_torch.core.cid import BLAKE2B_256, DAG_CBOR
    from ipc_proofs_tpu_torch.proofs.exec_order import decode_txmeta
    from ipc_proofs_tpu_torch.state.header import BlockHeader

    if doc.get("format") != FORMAT:
        raise ValueError(f"unknown vectors format {doc.get('format')!r}")
    for vec in doc["vectors"]:
        cid = CID.from_string(vec["cid"])
        data = base64.b64decode(vec["data"])
        if cid.mh_code != BLAKE2B_256 or cid.codec != DAG_CBOR:
            raise ValueError(f"vector {vec['cid']}: not a dag-cbor/blake2b chain CID")
        recomputed = CID.hash_of(data, codec=cid.codec, mh_code=cid.mh_code)
        if recomputed != cid:
            raise ValueError(
                f"vector {vec['cid']}: bytes hash to {recomputed} — CID codec "
                f"or blake2b-256 diverges from the chain"
            )
        expect = vec["expect"]
        if vec["kind"] == "header":
            header = BlockHeader.decode(data)
            actual = {
                "height": header.height,
                "parents": [str(c) for c in header.parents],
                "parent_state_root": str(header.parent_state_root),
                "parent_message_receipts": str(header.parent_message_receipts),
                "messages": str(header.messages),
            }
            if actual != expect:
                raise ValueError(f"vector {vec['cid']}: header fields diverge: {actual} != {expect}")
            lite = BlockHeader.decode_lite(data)
            if [str(c) for c in lite.parents] != expect["parents"] or lite.height != expect["height"]:
                raise ValueError(f"vector {vec['cid']}: decode_lite diverges")
        elif vec["kind"] == "txmeta":
            bls_root, secp_root = decode_txmeta(data)
            if str(bls_root) != expect["bls_root"] or str(secp_root) != expect["secp_root"]:
                raise ValueError(f"vector {vec['cid']}: TxMeta roots diverge")
        elif vec["kind"] == "amt_node":
            pass  # CID recompute above is the check (node formats vary)
        else:
            raise ValueError(f"unknown vector kind {vec['kind']!r}")
    return len(doc["vectors"])


def write_vectors(doc: dict, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2)


def load_vectors(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)
