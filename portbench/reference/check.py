"""The plain reference verifier and the comparisons that decide ``correct``.

A `Bundle` is a proof bundle in plain form: event and storage claims as
the wire format's JSON objects, and witness blocks as ``(binary CID,
bytes)``. `verdict` judges one as a verifier must, reading nothing but the
bundle: ``"rejected"`` when a witness block does not hash to its CID,
otherwise one verdict a claim, true where the witness alone proves the
claim. `check_bundle` holds a bundle against the world it was proved over:
its claims against the world's expected claims, its blocks against the
world's blocks, and every claim against the walk.
"""

from __future__ import annotations

from dataclasses import dataclass

from portbench.reference.cbor import Link
from portbench.reference.hashes import cid_digest_ok, cid_from_str
from portbench.reference.ipld import BlockView, amt_get, amt_items, hamt_get
from portbench.reference.chain import World, id_address

__all__ = ["Bundle", "REJECTED", "verdict", "verdict_diff", "check_bundle", "reference_bundle",
           "child_headers"]

REJECTED = "rejected"
_BAD = (KeyError, ValueError, IndexError, TypeError, AttributeError)


@dataclass
class Bundle:
    events: list  # event claims (wire JSON objects), in bundle order
    storage: list  # storage claims
    blocks: list  # (binary CID, bytes), CID-sorted


class _Cids:
    """CID strings parsed once each."""

    def __init__(self):
        self._memo: dict = {}

    def __call__(self, text: str) -> bytes:
        out = self._memo.get(text)
        if out is None:
            out = self._memo[text] = cid_from_str(text)
        return out


def _evm_log(entries: list):
    """(topics, data) of an EVM-shaped actor event's entries."""
    values = {e[1]: e[3] for e in entries}
    if "topics" in values:
        raw = values["topics"]
        return [raw[i : i + 32] for i in range(0, len(raw), 32)], values.get("data", b"")
    topics = []
    for key in ("t1", "t2", "t3", "t4"):
        if key not in values:
            break
        topics.append(values[key])
    return topics, values.get("d", b"")


class _Walker:
    """Proves claims from a block view, with the lookups claims share
    cached."""

    def __init__(self, view: BlockView):
        self.view = view
        self.cid = _Cids()
        self._orders: dict = {}
        self._actors: dict = {}

    def exec_order(self, parents: tuple, epoch: int) -> list:
        key = (parents, epoch)
        if key not in self._orders:
            order, seen = [], set()
            for parent in parents:
                header = self.view.get(parent)
                if header[7] != epoch:
                    raise ValueError("parent epoch")
                txmeta = self.view.get(header[10])
                for root in txmeta[:2]:
                    for _, msg in amt_items(self.view, root, 0):
                        if bytes(msg) not in seen:
                            seen.add(bytes(msg))
                            order.append(bytes(msg))
            self._orders[key] = order
        return self._orders[key]

    def event(self, claim: dict) -> bool:
        child = self.view.get(self.cid(claim["child_block_cid"]))
        parents = tuple(self.cid(c) for c in claim["parent_tipset_cids"])
        if child[7] != claim["child_epoch"] or tuple(bytes(c) for c in child[5]) != parents:
            return False
        order = self.exec_order(parents, claim["parent_epoch"])
        index = claim["exec_index"]
        if not 0 <= index < len(order) or order[index] != self.cid(claim["message_cid"]):
            return False
        receipt = amt_get(self.view, child[9], index, 0)
        if receipt is None or not isinstance(receipt[3], Link):
            return False
        stamped = amt_get(self.view, receipt[3], claim["event_index"], 3)
        if stamped is None:
            return False
        topics, data = _evm_log(stamped[1])
        want = claim["event_data"]
        return (
            stamped[0] == want["emitter"]
            and ["0x" + t.hex() for t in topics] == want["topics"]
            and "0x" + data.hex() == want["data"]
        )

    def actor(self, actors_root: bytes, actor_id: int):
        key = (actors_root, actor_id)
        if key not in self._actors:
            self._actors[key] = hamt_get(self.view, actors_root, id_address(actor_id))
        return self._actors[key]

    def storage(self, claim: dict) -> bool:
        child = self.view.get(self.cid(claim["child_block_cid"]))
        state_root = bytes(child[8])
        if child[7] != claim["child_epoch"] or state_root != self.cid(claim["parent_state_root"]):
            return False
        actor = self.actor(bytes(self.view.get(state_root)[1]), claim["actor_id"])
        if actor is None or bytes(actor[1]) != self.cid(claim["actor_state_cid"]):
            return False
        storage_root = bytes(self.view.get(actor[1])[2])
        if storage_root != self.cid(claim["storage_root"]):
            return False
        raw = hamt_get(self.view, storage_root, bytes.fromhex(claim["slot"][2:])) or b""
        return "0x" + raw.rjust(32, b"\x00")[-32:].hex() == claim["value"]


def _judge(fn, claim) -> bool:
    try:
        return bool(fn(claim))
    except _BAD:
        return False


def verdict(bundle: Bundle, check_cids: bool = True):
    """``"rejected"``, or ``(storage verdicts, event verdicts)``.
    ``check_cids=False`` skips the witness CID recompute (the control)."""
    if check_cids and not all(cid_digest_ok(c, d) for c, d in bundle.blocks):
        return REJECTED
    walker = _Walker(BlockView(dict(bundle.blocks)))
    return ([_judge(walker.storage, c) for c in bundle.storage],
            [_judge(walker.event, c) for c in bundle.events])


def _diff(got: list, want: list) -> int:
    return sum(g != w for g, w in zip(got, want)) + abs(len(got) - len(want))


def verdict_diff(got, want) -> int:
    """Verdicts that differ: ``"rejected"`` against anything else is one;
    otherwise each differing, missing or extra verdict is one."""
    if isinstance(got, str) or isinstance(want, str):
        return 0 if got == want else 1
    return sum(_diff(g, w) for g, w in zip(got, want))


def check_bundle(bundle: Bundle, world: World, expected_events=None, expected_storage=None,
                 walk: bool = True) -> dict:
    """Mismatch counts of a bundle proved over ``world``:
    ``claims_wrong`` (claims missing, extra or differing from the expected),
    ``blocks_wrong`` (blocks that are not the world's block of their CID,
    out of CID order or repeated) and, with ``walk``, ``unproven`` (claims
    the bundle's witness alone does not prove)."""
    want_events = world.expected_events if expected_events is None else expected_events
    want_storage = world.expected_storage if expected_storage is None else expected_storage
    out = {
        "claims_wrong": _diff(bundle.events, want_events) + _diff(bundle.storage, want_storage),
        "blocks_wrong": sum(
            world.blocks.get(c) != d or not cid_digest_ok(c, d) for c, d in bundle.blocks
        ) + sum(a[0] >= b[0] for a, b in zip(bundle.blocks, bundle.blocks[1:])),
    }
    if walk:
        result = verdict(bundle)
        out["unproven"] = (
            len(bundle.events) + len(bundle.storage)
            if result == REJECTED
            else sum(not v for v in result[0]) + sum(not v for v in result[1])
        )
    return out


def reference_bundle(world: World, drop=frozenset()) -> Bundle:
    """The bundle a plain prover gives over ``world``: the expected claims
    and every block the walk reads to prove them, less the blocks ``drop``
    names (the control leaves out the child headers)."""
    reads: set = set()

    class _Recording(dict):
        def __getitem__(self, cid):
            reads.add(cid)
            return world.blocks[cid]

    walker = _Walker(BlockView(_Recording()))
    for claim in world.expected_storage:
        walker.storage(claim)
    for claim in world.expected_events:
        walker.event(claim)
    blocks = sorted((c, world.blocks[c]) for c in reads if c not in drop)
    return Bundle(events=list(world.expected_events), storage=list(world.expected_storage),
                  blocks=blocks)


def child_headers(world: World) -> frozenset:
    return frozenset(child for _, child in world.pairs)
