"""ETH address → Filecoin actor ID resolution over RPC.

Reference parity: `resolve_eth_address_to_actor_id`
(`src/proofs/common/address.rs:8-62`): validate 20-byte hex →
`Filecoin.EthAddressToFilecoinAddress` → if delegated (f410) →
`Filecoin.StateLookupID` → numeric id; testnet `t` prefixes normalized.
"""

from __future__ import annotations

from ipc_proofs_tpu_torch.state.address import Address, Protocol

__all__ = ["resolve_eth_address_to_actor_id"]


def _parse_address(text: str) -> Address:
    return Address.from_string(text)


def resolve_eth_address_to_actor_id(client, eth_addr: str) -> int:
    """``client`` is any object with `.request(method, params)` (LotusClient
    or the hermetic fake)."""
    hex_part = eth_addr.removeprefix("0x")
    raw = bytes.fromhex(hex_part)
    if len(raw) != 20:
        raise ValueError(f"Ethereum address must be 20 bytes, got {len(raw)}")

    fil_addr = client.request("Filecoin.EthAddressToFilecoinAddress", [f"0x{hex_part}"])
    address = _parse_address(fil_addr)

    if address.protocol == Protocol.DELEGATED:
        id_addr_str = client.request("Filecoin.StateLookupID", [fil_addr, None])
        return _parse_address(id_addr_str).id()
    return address.id()
