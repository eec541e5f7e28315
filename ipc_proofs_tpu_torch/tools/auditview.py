"""Offline auditor for provenance registry logs (``--registry-dir``).

The serve daemon answers `/v1/registry/*` about its own chain; this tool
answers the auditor's side of the contract without a live daemon — from
nothing but the log file and, optionally, a previously pinned checkpoint:

- **verify** — walk one ``reg-<owner>.log`` end to end: every frame's
  CRC, every prev-link of the hash chain, and the Merkle root over all
  records. A torn tail (crash residue) is reported but passes; any other
  defect — one flipped bit anywhere — fails with the typed reason.
- **prove** — check an inclusion proof for a bundle digest: find its
  serve record, rebuild the proof from the log, verify it against the
  recomputed root (or against ``--root`` as served by the daemon).
- **diff** — consistency between two checkpoints of the SAME log: given
  an old size (and optionally the old root you pinned back then), prove
  the current tree is an append-only extension and list the records
  appended since.

Usage::

    python -m ipc_proofs_tpu_torch.tools.auditview verify REG.log
    python -m ipc_proofs_tpu_torch.tools.auditview prove REG.log --digest <bundle-digest> [--root HEX]
    python -m ipc_proofs_tpu_torch.tools.auditview diff REG.log --old-size N [--old-root HEX]
    ... --json        # machine-readable verdicts
    ... --device cpu  # on a host without CUDA

Exit code 0 = everything checked out; 1 = any integrity or proof
failure. Never modifies the log. The counterpart of the reference's
``tools/auditview.py`` over the port's ``registry/log.py`` and
``registry/mmr.py``, verdict for verdict; host code that launches nothing,
but like every tool of the port it asks for the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

from ipc_proofs_tpu_torch.registry.log import (
    RegistryError,
    read_registry_frames,
    record_digest,
)
from ipc_proofs_tpu_torch.registry.mmr import (
    MerkleLog,
    leaf_hash,
    verify_consistency,
    verify_inclusion,
)
from ipc_proofs_tpu_torch.tools import add_device_flag, backend_for

__all__ = ["load_log", "verify_log", "prove_digest", "diff_checkpoints", "main"]


def load_log(path: str) -> "tuple[list, bool]":
    """All complete frames + torn flag; typed RegistryError propagates."""
    entries, _good, torn = read_registry_frames(path)
    return entries, torn


def verify_log(path: str) -> dict:
    """Full-chain verdict: frame CRCs (the reader enforces them),
    prev-links, record count, Merkle root, chain tip."""
    try:
        entries, torn = load_log(path)
    except RegistryError as exc:
        return {"ok": False, "error": str(exc)}
    prev = ""
    for i, (rec, payload, off) in enumerate(entries):
        got = rec.get("prev") if isinstance(rec, dict) else None
        if got != prev:
            return {
                "ok": False,
                "error": f"chain broken at record {i} (offset {off}): "
                f"prev={got!r}, expected {prev!r}",
            }
        prev = record_digest(payload)
    tree = MerkleLog([leaf_hash(payload) for _rec, payload, _off in entries])
    kinds: dict = {}
    for rec, _payload, _off in entries:
        k = rec.get("kind") or "?"
        kinds[k] = kinds.get(k, 0) + 1
    return {
        "ok": True,
        "records": len(entries),
        "kinds": kinds,
        "root": tree.root().hex(),
        "tip": prev,
        "torn_tail": torn,
    }


def prove_digest(path: str, digest: str, root_hex: str = "") -> dict:
    """Inclusion verdict for the (latest) serve record of ``digest``.
    With ``root_hex`` the proof verifies against the daemon's published
    root — binding the log file to the checkpoint clients pinned."""
    try:
        entries, _torn = load_log(path)
    except RegistryError as exc:
        return {"ok": False, "error": str(exc)}
    seq = None
    for i, (rec, _payload, _off) in enumerate(entries):
        if rec.get("kind") == "serve" and rec.get("digest") == digest:
            seq = i
    if seq is None:
        return {"ok": False, "error": f"no serve record for digest {digest}"}
    leaves = [leaf_hash(payload) for _rec, payload, _off in entries]
    tree = MerkleLog(leaves)
    root = bytes.fromhex(root_hex) if root_hex else tree.root()
    path_hashes = tree.inclusion_path(seq)
    ok = verify_inclusion(leaves[seq], seq, len(leaves), path_hashes, root)
    return {
        "ok": ok,
        "seq": seq,
        "size": len(leaves),
        "root": root.hex(),
        "path": [h.hex() for h in path_hashes],
        **({} if ok else {"error": "inclusion proof did not verify"}),
    }


def diff_checkpoints(path: str, old_size: int, old_root_hex: str = "") -> dict:
    """Append-only verdict between checkpoints: old (size[, root]) vs
    the log's current head, plus the records appended between them."""
    try:
        entries, _torn = load_log(path)
    except RegistryError as exc:
        return {"ok": False, "error": str(exc)}
    n = len(entries)
    if not 0 <= old_size <= n:
        return {"ok": False, "error": f"old size {old_size} not in [0, {n}]"}
    tree = MerkleLog([leaf_hash(payload) for _rec, payload, _off in entries])
    old_root = (
        bytes.fromhex(old_root_hex) if old_root_hex else tree.root_at(old_size)
    )
    proof = tree.consistency_path(old_size) if 0 < old_size < n else []
    ok = verify_consistency(old_size, n, old_root, tree.root(), proof)
    out = {
        "ok": ok,
        "old_size": old_size,
        "old_root": old_root.hex(),
        "size": n,
        "root": tree.root().hex(),
        "proof": [h.hex() for h in proof],
        "appended": [
            dict(rec, seq=old_size + i)
            for i, (rec, _payload, _off) in enumerate(entries[old_size:])
        ],
    }
    if not ok:
        out["error"] = (
            "consistency proof did not verify — the log is NOT an "
            "append-only extension of that checkpoint"
        )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cmd", choices=["verify", "prove", "diff"])
    ap.add_argument("log", help="path to a reg-<owner>.log file")
    ap.add_argument("--digest", default="", help="bundle digest (prove)")
    ap.add_argument(
        "--root", default="", help="published head root to prove against (hex)"
    )
    ap.add_argument(
        "--old-size", type=int, default=None, help="old checkpoint size (diff)"
    )
    ap.add_argument(
        "--old-root", default="", help="old checkpoint root to pin (hex, diff)"
    )
    ap.add_argument("--json", action="store_true", dest="as_json")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    backend_for(args.device)

    if args.cmd == "verify":
        out = verify_log(args.log)
    elif args.cmd == "prove":
        if not args.digest:
            ap.error("prove requires --digest")
        out = prove_digest(args.log, args.digest, root_hex=args.root)
    else:
        if args.old_size is None:
            ap.error("diff requires --old-size")
        out = diff_checkpoints(
            args.log, args.old_size, old_root_hex=args.old_root
        )

    if args.as_json:
        print(json.dumps(out, indent=2, sort_keys=True))
    elif out["ok"]:
        if args.cmd == "verify":
            print(
                f"OK: {out['records']} record(s) {out['kinds']}, chain + "
                f"CRC verified, root {out['root'][:16]}…"
                + (" (torn tail truncatable)" if out["torn_tail"] else "")
            )
        elif args.cmd == "prove":
            print(
                f"OK: digest included at seq {out['seq']} of {out['size']} "
                f"under root {out['root'][:16]}…"
            )
        else:
            print(
                f"OK: head ({out['size']}) extends checkpoint "
                f"({out['old_size']}); {len(out['appended'])} record(s) "
                "appended"
            )
    else:
        print(f"FAIL: {out['error']}")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
