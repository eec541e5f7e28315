"""RFC 6962-style Merkle tree over registry record payloads.

The provenance log is a parent-hash DAG two ways at once: each record
carries the digest of its predecessor (a linear hash chain, verified on
open), and the record payloads also feed this tree so any client can
demand an O(log n) **inclusion proof** that a record sits at a given
position under a published root, plus a **consistency proof** that one
published root extends another without rewriting history.

Hashing follows the Certificate Transparency discipline exactly — leaf
and interior hashes live in domain-separated namespaces so a leaf can
never masquerade as a node (or vice versa):

    leaf     = SHA-256(0x00 || payload)
    interior = SHA-256(0x01 || left || right)
    MTH(D[n]) splits at k, the largest power of two < n

`MerkleLog` keeps the peak stack of the mountain range (one hash per set
bit of the size), so ``append`` is O(1) amortized and ``root`` is
O(log n) — the serve plane's per-response cost never grows with history.
Proof *generation* walks the retained leaf-hash list (O(n) compute,
O(log n) proof bytes), which is the audit path, not the serve path.

The verifiers (`verify_inclusion`, `verify_consistency`) are pure
functions of public data — a stateless client needs only the proof, the
two roots, and the tree sizes, never the log.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

__all__ = [
    "MerkleLog",
    "consistency_path",
    "inclusion_path",
    "leaf_hash",
    "merkle_root",
    "node_hash",
    "verify_consistency",
    "verify_inclusion",
]


def leaf_hash(payload: bytes) -> bytes:
    """Domain-separated leaf hash: SHA-256(0x00 || payload)."""
    return hashlib.sha256(b"\x00" + payload).digest()


def node_hash(left: bytes, right: bytes) -> bytes:
    """Domain-separated interior hash: SHA-256(0x01 || left || right)."""
    return hashlib.sha256(b"\x01" + left + right).digest()


def _split(n: int) -> int:
    """The largest power of two strictly below ``n`` (n >= 2)."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def merkle_root(leaves: Sequence[bytes]) -> bytes:
    """MTH over already-hashed leaves; the empty tree hashes to
    SHA-256("") per RFC 6962."""
    n = len(leaves)
    if n == 0:
        return hashlib.sha256(b"").digest()
    if n == 1:
        return leaves[0]
    k = _split(n)
    return node_hash(merkle_root(leaves[:k]), merkle_root(leaves[k:]))


def inclusion_path(leaves: Sequence[bytes], index: int) -> List[bytes]:
    """PATH(index, D): the sibling hashes proving ``leaves[index]`` is
    under ``merkle_root(leaves)``. Raises IndexError out of range."""
    n = len(leaves)
    if not 0 <= index < n:
        raise IndexError(f"leaf index {index} out of range [0, {n})")
    if n == 1:
        return []
    k = _split(n)
    if index < k:
        return inclusion_path(leaves[:k], index) + [merkle_root(leaves[k:])]
    return inclusion_path(leaves[k:], index - k) + [merkle_root(leaves[:k])]


def verify_inclusion(
    leaf: bytes, index: int, size: int, path: Sequence[bytes], root: bytes
) -> bool:
    """RFC 9162 §2.1.3.2: recompute the root from ``leaf`` (already
    leaf-hashed) at ``index`` in a ``size``-leaf tree via ``path``."""
    if index < 0 or size <= 0 or index >= size:
        return False
    fn, sn = index, size - 1
    r = leaf
    for p in path:
        if sn == 0:
            return False
        if fn & 1 or fn == sn:
            r = node_hash(p, r)
            if not fn & 1:
                while fn and not fn & 1:
                    fn >>= 1
                    sn >>= 1
        else:
            r = node_hash(r, p)
        fn >>= 1
        sn >>= 1
    return sn == 0 and r == root


def consistency_path(leaves: Sequence[bytes], old_size: int) -> List[bytes]:
    """PROOF(old_size, D): the hashes proving the first ``old_size``
    leaves of this tree are exactly the tree that published the old
    root. Empty when the trees are the same size."""
    n = len(leaves)
    if not 0 < old_size <= n:
        raise IndexError(f"old size {old_size} out of range (0, {n}]")
    if old_size == n:
        return []
    return _subproof(leaves, old_size, True)


def _subproof(leaves: Sequence[bytes], m: int, complete: bool) -> List[bytes]:
    n = len(leaves)
    if m == n:
        return [] if complete else [merkle_root(leaves)]
    k = _split(n)
    if m <= k:
        return _subproof(leaves[:k], m, complete) + [merkle_root(leaves[k:])]
    return _subproof(leaves[k:], m - k, False) + [merkle_root(leaves[:k])]


def verify_consistency(
    old_size: int,
    new_size: int,
    old_root: bytes,
    new_root: bytes,
    path: Sequence[bytes],
) -> bool:
    """RFC 9162 §2.1.4.2: check that the ``new_size`` tree under
    ``new_root`` is an append-only extension of the ``old_size`` tree
    under ``old_root``."""
    if old_size < 0 or old_size > new_size:
        return False
    if old_size == new_size:
        return not path and old_root == new_root
    if old_size == 0:
        # every tree extends the empty tree; nothing to cross-check
        return not path and old_root == hashlib.sha256(b"").digest()
    path = list(path)
    if old_size & (old_size - 1) == 0:
        # old tree is a complete (power-of-two) subtree: its root is a
        # node of the new tree and the proof omits it — restore it
        path = [old_root] + path
    if not path:
        return False
    fn, sn = old_size - 1, new_size - 1
    while fn & 1:
        fn >>= 1
        sn >>= 1
    fr = sr = path[0]
    for p in path[1:]:
        if sn == 0:
            return False
        if fn & 1 or fn == sn:
            fr = node_hash(p, fr)
            sr = node_hash(p, sr)
            if not fn & 1:
                while fn and not fn & 1:
                    fn >>= 1
                    sn >>= 1
        else:
            sr = node_hash(sr, p)
        fn >>= 1
        sn >>= 1
    return sn == 0 and fr == old_root and sr == new_root


class MerkleLog:
    """Append-only tree state: the full leaf-hash list (proof source)
    plus the mountain-range peak stack (O(1) amortized append, O(log n)
    root). NOT thread-safe — the owning registry serializes access."""

    def __init__(self, leaves: Sequence[bytes] = ()):
        self._leaves: List[bytes] = []
        self._peaks: List[tuple] = []  # (height, hash), left-to-right
        for h in leaves:
            self.append(h)

    def append(self, leaf: bytes) -> int:
        """Add one leaf hash; returns its index."""
        index = len(self._leaves)
        self._leaves.append(leaf)
        self._peaks.append((0, leaf))
        # merge equal-height peaks — amortized O(1), exactly the binary
        # carry chain of incrementing the size
        while (
            len(self._peaks) >= 2
            and self._peaks[-1][0] == self._peaks[-2][0]
        ):
            h, right = self._peaks.pop()
            _, left = self._peaks.pop()
            self._peaks.append((h + 1, node_hash(left, right)))
        return index

    @property
    def size(self) -> int:
        return len(self._leaves)

    @property
    def leaves(self) -> List[bytes]:
        return self._leaves

    def root(self) -> bytes:
        """Fold the peaks right-to-left — equals MTH over all leaves."""
        if not self._peaks:
            return hashlib.sha256(b"").digest()
        acc = self._peaks[-1][1]
        for _, peak in reversed(self._peaks[:-1]):
            acc = node_hash(peak, acc)
        return acc

    def inclusion_path(self, index: int) -> List[bytes]:
        return inclusion_path(self._leaves, index)

    def consistency_path(self, old_size: int) -> List[bytes]:
        return consistency_path(self._leaves, old_size)

    def root_at(self, size: int) -> bytes:
        """The root the log had when it held ``size`` leaves."""
        if not 0 <= size <= len(self._leaves):
            raise IndexError(f"size {size} out of range [0, {len(self._leaves)}]")
        return merkle_root(self._leaves[:size])
