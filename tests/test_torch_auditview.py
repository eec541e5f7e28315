"""`ipc_proofs_tpu_torch.tools.auditview` against the reference's
``tools/auditview.py``: the same log in, the same verdict JSON, text and
exit code out, for ``verify``, ``prove`` and ``diff``.

Logs are written by each package's `ProvenanceRegistry` (the same records
at a fixed clock, so the two files are byte-equal too). Cases: a clean log,
a torn tail, seeded single-bit flips anywhere in the file, a digest the log
does not hold, a pinned root, and a wrong ``--old-root``.
"""

import hashlib
import random
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import tools.auditview as ref_av  # noqa: E402
from ipc_proofs_tpu.registry import ProvenanceRegistry as RefRegistry  # noqa: E402
from ipc_proofs_tpu_torch.registry import ProvenanceRegistry  # noqa: E402
from ipc_proofs_tpu_torch.tools import auditview  # noqa: E402

from tests._torch_http import fixed_clocks  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N_SERVED = 7


def _digest(i: int) -> str:
    return hashlib.sha256(f"bundle-{i}".encode()).hexdigest()


def _write(registry_cls, root: Path) -> "tuple[str, dict]":
    reg = registry_cls(str(root), owner="audit")
    try:
        for i in range(N_SERVED):
            reg.append_served(
                _digest(i), trace=f"t{i}", tenant="acme", key=f"pair:{i}", verdict="valid",
                cids=frozenset(hashlib.sha256(f"c{i}-{j}".encode()).digest() for j in range(2)), t=float(i),
            )
            if i == 3:
                reg.append_base_ack("pool", "k", "s1", _digest(2), 3)
        return reg.path, reg.head()
    finally:
        reg.close()


@pytest.fixture()
def logs(tmp_path, monkeypatch):
    import ipc_proofs_tpu.registry.registry as ref_mod
    import ipc_proofs_tpu_torch.registry.registry as port_mod

    fixed_clocks(monkeypatch, ref_mod, port_mod)
    ref_path, ref_head = _write(RefRegistry, tmp_path / "ref")
    path, head = _write(ProvenanceRegistry, tmp_path / "port")
    assert Path(path).read_bytes() == Path(ref_path).read_bytes()
    assert {k: head[k] for k in ("size", "root", "tip")} == {k: ref_head[k] for k in ("size", "root", "tip")}
    return {"reference": (ref_path, ref_head), "port": (path, head)}


def _both(argv, capsys) -> "tuple[int, str]":
    """Each tool's (exit code, stdout) for ``argv``, with and without
    ``--json``; they must be equal, and are returned for the JSON form."""
    out = None
    for extra in (["--json"], []):
        ref_rc = ref_av.main(argv + extra)
        ref_text = capsys.readouterr().out
        rc = auditview.main(argv + extra + ["--device", "cpu"])
        text = capsys.readouterr().out
        assert (rc, text) == (ref_rc, ref_text), argv + extra
        out = out or (rc, text)
    return out


def _checks(path: str, head: dict) -> "list[list[str]]":
    return [
        ["verify", path],
        ["prove", path, "--digest", _digest(3)],
        ["prove", path, "--digest", _digest(0), "--root", head["root"]],
        ["diff", path, "--old-size", "3"],
        ["diff", path, "--old-size", "0"],
        ["diff", path, "--old-size", str(head["size"])],
    ]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_clean_log(logs, writer, capsys):
    import json

    path, head = logs[writer]
    for argv in _checks(path, head):
        rc, text = _both(argv, capsys)
        assert rc == 0, (argv, text)
    rc, text = _both(["verify", path], capsys)
    out = json.loads(text)
    assert (out["records"], out["root"], out["tip"], out["torn_tail"]) == (N_SERVED + 1, head["root"],
                                                                          head["tip"], False)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_torn_tail_passes_and_is_reported(logs, writer, tmp_path, capsys):
    import json

    path, head = logs[writer]
    torn = tmp_path / "torn.log"
    shutil.copyfile(path, torn)
    with open(torn, "ab") as fh:
        fh.write(b"IPR1\xff")
    for argv in _checks(str(torn), head):
        assert _both(argv, capsys)[0] == 0
    assert json.loads(_both(["verify", str(torn)], capsys)[1])["torn_tail"] is True


@pytest.mark.parametrize("seed", [1, 7, 2026])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_single_bit_flips(logs, writer, seed, tmp_path, capsys):
    path, head = logs[writer]
    raw = Path(path).read_bytes()
    rng = random.Random(seed)
    failed = 0
    for k in range(8):
        off, bit = rng.randrange(len(raw)), rng.randrange(8)
        flipped = tmp_path / f"flip{k}.log"
        flipped.write_bytes(raw[:off] + bytes([raw[off] ^ (1 << bit)]) + raw[off + 1:])
        rc, _ = _both(["verify", str(flipped)], capsys)
        failed += rc == 1
        for argv in _checks(str(flipped), head)[1:]:
            _both(argv, capsys)
    assert failed  # a flip is caught somewhere in the sweep


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_absent_digest_and_wrong_old_root_fail(logs, writer, capsys):
    path, head = logs[writer]
    assert _both(["prove", path, "--digest", _digest(99)], capsys)[0] == 1
    forged = hashlib.sha256(b"forged").hexdigest()
    assert _both(["prove", path, "--digest", _digest(1), "--root", forged], capsys)[0] == 1
    assert _both(["diff", path, "--old-size", "3", "--old-root", forged], capsys)[0] == 1
    assert _both(["diff", path, "--old-size", str(head["size"] + 1)], capsys)[0] == 1


def test_module_exits_nonzero_without_cuda(logs):
    path, _ = logs["port"]
    run = [sys.executable, "-m", "ipc_proofs_tpu_torch.tools.auditview", "verify", path]
    refused = subprocess.run(run, cwd=ROOT, capture_output=True, text=True, timeout=60,
                             env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert refused.returncode != 0 and not refused.stdout
    assert "--device cuda" in refused.stderr
    ran = subprocess.run(run + ["--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert ran.returncode == 0 and ran.stdout.startswith("OK:"), ran.stderr
