"""Hermetic test doubles for the RPC layer.

`FakeLotusClient` serves the client's RPC surface from an in-memory
blockstore and canned JSON responses, so the online generation path runs
offline.
"""

from __future__ import annotations

import base64
from typing import Any, Callable, Optional

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.store.blockstore import Blockstore

__all__ = ["FakeLotusClient"]


class FakeLotusClient:
    """Duck-types `LotusClient.request`/`chain_read_obj` against local data.

    - `Filecoin.ChainReadObj` is served from the backing blockstore.
    - Any other method is looked up in `responses` (method -> value or
      callable(params) -> value).
    """

    def __init__(
        self,
        store: Blockstore,
        responses: Optional[dict[str, Any]] = None,
    ):
        self._store = store
        self.responses: dict[str, Any | Callable[[Any], Any]] = responses or {}
        self.calls: list[tuple[str, Any]] = []

    def request(self, method: str, params: Any) -> Any:
        self.calls.append((method, params))
        if method == "Filecoin.ChainReadObj":
            cid = CID.from_string(params[0]["/"])
            data = self._store.get(cid)
            if data is None:
                raise RuntimeError(f"FakeLotus: block not found: {cid}")
            return base64.b64encode(data).decode("ascii")
        if method in self.responses:
            handler = self.responses[method]
            return handler(params) if callable(handler) else handler
        raise RuntimeError(f"FakeLotus: no canned response for {method}")

    def chain_read_obj(self, cid: CID) -> Optional[bytes]:
        self.calls.append(("Filecoin.ChainReadObj", [{"/": str(cid)}]))
        return self._store.get(cid)

    def chain_get_parent_receipts(self, block_cid: CID) -> Optional[list[dict]]:
        """Serve `Filecoin.ChainGetParentReceipts` by synthesizing the API
        JSON from the block's receipts AMT in the backing store (the dense
        AMT order IS the execution order, which is what the real API
        returns). A canned response, if present, takes precedence."""
        self.calls.append(("Filecoin.ChainGetParentReceipts", [{"/": str(block_cid)}]))
        if "Filecoin.ChainGetParentReceipts" in self.responses:
            handler = self.responses["Filecoin.ChainGetParentReceipts"]
            return handler(block_cid) if callable(handler) else handler

        from ipc_proofs_tpu_torch.ipld.amt import AMT
        from ipc_proofs_tpu_torch.state.events import Receipt
        from ipc_proofs_tpu_torch.state.header import BlockHeader

        raw = self._store.get(block_cid)
        if raw is None:
            return None
        header = BlockHeader.decode(raw)
        amt = AMT.load(self._store, header.parent_message_receipts, expected_version=0)
        out = []
        for _, receipt_cbor in amt.items():
            r = Receipt.from_cbor(receipt_cbor)
            out.append(
                {
                    "ExitCode": r.exit_code,
                    "Return": (
                        base64.b64encode(r.return_data).decode("ascii")
                        if r.return_data
                        else None
                    ),
                    "GasUsed": r.gas_used,
                    "EventsRoot": {"/": str(r.events_root)} if r.events_root else None,
                }
            )
        return out
