"""The port's multi-process helpers on ``torch.distributed`` against the
JAX package's ``parallel.multihost``.

- `initialize_distributed` returns False with no coordinator (neither
  argument nor torchrun's ``MASTER_ADDR``), and its NCCL default needs
  CUDA;
- `global_mesh` shapes and errors, and `host_local_pairs` splits equal to
  the reference's;
- a real two-process gloo run on localhost: each process holds 2 virtual
  CPU devices, so the global mesh is (dp=2 across the processes, sp=2
  within each); each process shards its contiguous half of the tipsets,
  runs the sharded match, all-reduces the count and all-gathers the hits.
  Both processes' results must equal the JAX package's single-process
  `match_pipeline` (``tests/test_multihost.py``'s world). The workers are
  a script written into the test's temporary directory, run with a
  timeout well under a minute so a hung rendezvous fails the test.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ipc_proofs_tpu.parallel import multihost as ref_multihost  # noqa: E402
from ipc_proofs_tpu.parallel.pipeline import (  # noqa: E402
    make_specs_u32,
    match_pipeline as ref_match_pipeline,
    synthetic_event_batch as ref_synthetic_event_batch,
)
from ipc_proofs_tpu_torch.parallel.multihost import (  # noqa: E402
    global_mesh,
    host_local_pairs,
    initialize_distributed,
)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


class TestSingleProcess:
    def test_initialize_noop_without_coordinator(self, monkeypatch):
        for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(name, raising=False)
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        assert initialize_distributed() is False
        assert initialize_distributed(device="cpu") is False
        assert ref_multihost.initialize_distributed() is False

    def test_nccl_default_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            initialize_distributed("127.0.0.1:1", 1, 0)

    def test_global_mesh_shapes(self):
        mesh = global_mesh(sp=2, devices=[CPU] * 8)
        ref = ref_multihost.global_mesh(sp=2)
        assert mesh.axis_names == tuple(ref.axis_names) == ("dp", "sp")
        assert mesh.shape == dict(ref.shape) == {"dp": 4, "sp": 2}
        assert mesh.process_count == 1 and not mesh.distributed
        for sp in (3, 16):
            with pytest.raises(ValueError, match="sp="):
                global_mesh(sp=sp, devices=[CPU] * 8)
            with pytest.raises(ValueError):
                ref_multihost.global_mesh(sp=sp)

    def test_global_mesh_needs_cuda_by_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            global_mesh()

    @pytest.mark.parametrize("n_pairs", [0, 1, 4, 10, 17])
    @pytest.mark.parametrize("n_procs", [1, 2, 3, 5])
    def test_host_local_pairs_equals_the_reference(self, n_pairs, n_procs):
        pairs = list(range(n_pairs))
        shards = [host_local_pairs(pairs, process_id=i, num_processes=n_procs) for i in range(n_procs)]
        assert shards == [
            ref_multihost.host_local_pairs(pairs, process_id=i, num_processes=n_procs) for i in range(n_procs)
        ]
        assert [p for shard in shards for p in shard] == pairs

    def test_host_local_pairs_defaults_to_this_process(self):
        assert host_local_pairs(list(range(4))) == list(range(4))


_WORKER = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    from ipc_proofs_tpu_torch.parallel.multihost import global_mesh, host_local_pairs, initialize_distributed
    from ipc_proofs_tpu_torch.parallel.pipeline import EventBatch, sharded_match_pipeline, synthetic_event_batch

    rank, world, port, out_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu") is True
    try:
        mesh = global_mesh(sp=2, devices=[torch.device("cpu")] * 2)
        assert mesh.shape == {"dp": world, "sp": 2} and mesh.distributed
        T, R, E = 8, 4, 4
        topic0, topic1 = b"\\x11" * 32, b"\\x22" * 32
        batch = synthetic_event_batch(T, R, E, topic0, topic1, match_rate=0.3, seed=7)
        mine = host_local_pairs(list(range(T)))
        rows = slice(mine[0], mine[-1] + 1)
        local = EventBatch(batch.topics[rows], batch.n_topics[rows], batch.emitters[rows], batch.valid[rows])
        fn, shard_batch = sharded_match_pipeline(mesh)
        hits, mask, count = fn(*shard_batch(local, topic0, topic1, None))
        result = {
            "process_id": rank,
            "count": int(count),
            "hits": hits.to(torch.int64).ravel().tolist(),
            "mask": mask.to(torch.int64).ravel().tolist(),
            "my_pairs": mine,
            "mesh": mesh.shape,
            "backend": dist.get_backend(),
        }
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as fh:
        json.dump(result, fh)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_match_equals_single_process(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(ROOT)
    outs = [tmp_path / f"p{i}.json" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port), str(outs[i])],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    try:
        for p in procs:
            _, err = p.communicate(timeout=45)
            assert p.returncode == 0, err.decode(errors="replace")[-2000:]
    finally:
        for p in procs:
            p.kill()
            p.wait()

    results = [json.loads(o.read_text()) for o in outs]
    assert [r["backend"] for r in results] == ["gloo", "gloo"]
    assert results[0]["mesh"] == results[1]["mesh"] == {"dp": 2, "sp": 2}
    assert results[0]["my_pairs"] == [0, 1, 2, 3]
    assert results[1]["my_pairs"] == [4, 5, 6, 7]

    batch = ref_synthetic_event_batch(8, 4, 4, b"\x11" * 32, b"\x22" * 32, match_rate=0.3, seed=7)
    spec0, spec1 = make_specs_u32(b"\x11" * 32, b"\x22" * 32)
    ref_hits, ref_mask, ref_count = ref_match_pipeline(
        batch.topics, batch.n_topics, batch.emitters, batch.valid, spec0, spec1, np.int32(-1),
    )
    ref_hits = np.asarray(ref_hits).astype(int).ravel().tolist()
    ref_mask = np.asarray(ref_mask).astype(int)
    assert int(ref_count) > 0
    for r in results:
        # the count and the hits are the whole mesh's in every process ...
        assert r["count"] == int(ref_count)
        assert r["hits"] == ref_hits
    # ... and each mask holds its own process's rows
    assert results[0]["mask"] + results[1]["mask"] == ref_mask.ravel().tolist()
