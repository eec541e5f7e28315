"""`CID.parse` on the port's pure-Python CID, against the JAX package's.

The port's dataclass `CID` (``PurePythonCID``) parses as the reference's
does: a CID of either implementation passes through unchanged, ``bytes``
decode with `from_bytes`, ``str`` with `from_string`. It matters in the
pure-Python universe (``IPC_PROOFS_NO_NATIVE=1``, driven in a subprocess:
the flag is read once per process), where the dataclass is ``CID`` and
`ProofService.read_block_local` — the route a peer's read-repair uses,
``GET /v1/blocks/<cid>`` — and the backfill stream parse every CID with it.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")

from ipc_proofs_tpu_torch.core import cid as port_cid  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = "bafk2bzaceaze3tycpxkkgcutfrcb6ns2exugwfz556slrzmjjasti4nydnzm6"

_CHILD = r"""
import json, sys, types
sys.path.insert(0, sys.argv[1])
text = sys.argv[2]
out = {}
for name in ("ipc_proofs_tpu", "ipc_proofs_tpu_torch"):
    cid_mod = __import__(name + ".core.cid", fromlist=["CID"])
    service_mod = __import__(name + ".serve.service", fromlist=["ProofService"])
    CID = cid_mod.CID
    parsed = CID.parse(text)
    row = {
        "pure": CID is cid_mod.PurePythonCID,
        "str": str(parsed),
        "bytes": CID.parse(parsed.to_bytes()).to_bytes().hex(),
        "same": CID.parse(parsed) is parsed,
        "pure_same": cid_mod.PurePythonCID.parse(parsed) is parsed,
    }
    for bad in ("", "zabc", b"\x01", 7):
        try:
            CID.parse(bad)
            row[repr(bad)] = "ok"
        except Exception as exc:
            row[repr(bad)] = type(exc).__name__
    kw = {"device": "cpu"} if name.endswith("torch") else {}
    svc = service_mod.ProofService(config=service_mod.ServiceConfig(**kw))
    svc._store = types.SimpleNamespace(get_local=lambda cid: {text: b"hello"}.get(str(cid)))
    row["read_block_local"] = (svc.read_block_local(text) or b"").decode()
    row["read_block_local_bad"] = svc.read_block_local("not-a-cid")
    svc.drain()
    out[name] = row
print(json.dumps(out))
"""


def test_parse_and_read_block_local_match_the_reference_without_native():
    env = dict(os.environ, IPC_PROOFS_NO_NATIVE="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _CHILD, ROOT, TEXT], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    port, ref = out["ipc_proofs_tpu_torch"], out["ipc_proofs_tpu"]
    assert port == ref
    assert port["pure"] and port["same"] and port["pure_same"]
    assert port["str"] == TEXT and port["read_block_local"] == "hello"
    assert port["read_block_local_bad"] is None


def test_parse_passes_either_implementation_through():
    """In the native universe ``CID`` is the extension's type: the pure
    dataclass's parse hands a native CID back unchanged and decodes bytes
    and strings to equal CIDs."""
    native = port_cid.CID.parse(TEXT)
    pure = port_cid.PurePythonCID.parse(TEXT)
    assert port_cid.PurePythonCID.parse(native) is native
    assert port_cid.PurePythonCID.parse(pure) is pure
    assert port_cid.PurePythonCID.parse(native.to_bytes()).to_bytes() == native.to_bytes()
    assert str(pure) == str(native) == TEXT
    with pytest.raises(ValueError):
        port_cid.PurePythonCID.parse("zabc")
