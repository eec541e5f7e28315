"""The Lotus RPC errors the range drivers tell apart.

The counterpart of the two error classes of ``ipc_proofs_tpu.store.rpc``:
the pipelined driver retries a chunk's scan after a transient store error
but fails fast on an `RpcError`, a semantic protocol answer that a retry
would only ask again. The RPC client and the RPC-backed blockstore are
still to port (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

__all__ = ["IntegrityError", "RpcError"]


class RpcError(RuntimeError):
    """JSON-RPC level error (the `error` member of the response)."""

    def __init__(self, code: int, message: str):
        super().__init__(f"RPC error {code}: {message}")
        self.code = code
        self.message = message


class IntegrityError(RuntimeError):
    """Fetched block bytes do not hash to the requested CID.

    A *trust* failure, not a transport failure: the endpoint answered
    confidently with wrong bytes, so re-asking the same endpoint is
    pointless (and dangerous).
    """

    def __init__(self, cid, endpoint: str = "?", reason: str = "failed multihash verification"):
        super().__init__(f"block bytes for {cid} {reason} (endpoint {endpoint})")
        self.cid = cid
        self.endpoint = endpoint
