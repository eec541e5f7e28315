"""Tipset: the chain-view type the generators take as input — the block
CIDs plus fully decoded `BlockHeader`s, built straight from a blockstore,
from a fixture, or from Lotus RPC JSON — and the receipts API's wire
conversion (`receipt_from_api_json`)."""

from __future__ import annotations

import base64
from dataclasses import dataclass

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.state.events import Receipt
from ipc_proofs_tpu_torch.state.header import BlockHeader
from ipc_proofs_tpu_torch.store.blockstore import Blockstore

__all__ = ["Tipset", "receipt_from_api_json"]


def receipt_from_api_json(obj: dict) -> Receipt:
    """`ApiReceipt` JSON → `Receipt`: ``Return`` is base64 (null/empty →
    b""), ``EventsRoot`` a CIDMap or null. The wire conversion of the
    `Filecoin.ChainGetParentReceipts` pathway
    (`event_generator.scan_receipts_from_api`)."""
    ret = obj.get("Return")
    events_root = obj.get("EventsRoot")
    return Receipt(
        exit_code=obj["ExitCode"],
        return_data=base64.b64decode(ret) if ret else b"",
        gas_used=obj.get("GasUsed", 0),
        events_root=CID.from_string(events_root["/"]) if events_root else None,
    )


@dataclass
class Tipset:
    cids: list[CID]
    blocks: list[BlockHeader]
    height: int

    def __post_init__(self):
        if len(self.cids) != len(self.blocks):
            raise ValueError("tipset cids/blocks length mismatch")
        if not self.cids:
            raise ValueError("empty tipset")

    @classmethod
    def from_blockstore(cls, store: Blockstore, cids: list[CID]) -> "Tipset":
        blocks = []
        for cid in cids:
            raw = store.get(cid)
            if raw is None:
                raise KeyError(f"missing header {cid}")
            blocks.append(BlockHeader.decode(raw))
        return cls(cids=cids, blocks=blocks, height=blocks[0].height)

    @classmethod
    def from_api_json(cls, obj: dict) -> "Tipset":
        """Build from a `Filecoin.ChainGetTipSetByHeight` response, trusting
        the JSON fields the generators read (they cross-check against the
        raw header CBOR)."""
        cids = [CID.from_string(c["/"]) for c in obj["Cids"]]
        blocks = [
            BlockHeader(
                parents=[CID.from_string(c["/"]) for c in header["Parents"]],
                height=header["Height"],
                parent_state_root=CID.from_string(header["ParentStateRoot"]["/"]),
                parent_message_receipts=CID.from_string(header["ParentMessageReceipts"]["/"]),
                messages=CID.from_string(header["Messages"]["/"]),
                timestamp=header.get("Timestamp", 0),
            )
            for header in obj["Blocks"]
        ]
        return cls(cids=cids, blocks=blocks, height=obj["Height"])

    @classmethod
    def fetch(cls, client, height: int) -> "Tipset":
        """Fetch by height over RPC (`Filecoin.ChainGetTipSetByHeight`)."""
        return cls.from_api_json(client.request("Filecoin.ChainGetTipSetByHeight", [height, None]))
