"""Multi-process scale-out for the batch proof pipeline, on
``torch.distributed``.

The counterpart of ``ipc_proofs_tpu.parallel.multihost``. The workload is
embarrassingly parallel across tipset ranges: shard the epoch range across
processes (``dp`` across processes), keep the event axis (``sp``) inside
each process's devices, and reduce only tiny aggregates (the proof count,
the per-receipt hits). There is no parameter state to synchronize.

Usage, one process per host (or per card):

    initialize_distributed()          # torchrun's env, or explicit args
    mesh = global_mesh(sp=2)          # dp spans processes, sp stays local
    fn, shard = sharded_match_pipeline(mesh)

Without a coordinator nothing is initialized and the mesh is this
process's alone, so the same driver script runs everywhere. The process
group uses NCCL for CUDA devices and gloo for the CPU (the tests).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from ipc_proofs_tpu_torch.parallel.mesh import Mesh, _grid, cuda_devices

__all__ = ["initialize_distributed", "global_mesh", "host_local_pairs", "reduce_across_processes"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: "torch.device | str | None" = None,
) -> bool:
    """Join the default process group from args or torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

    ``coordinator_address`` is ``host:port`` of rank 0's TCP store.
    ``device`` picks the collectives' backend: CUDA (the default) takes
    NCCL, ``"cpu"`` takes gloo. Returns True once a process group is up,
    False when running single-process (no coordinator configured).
    """
    import torch.distributed as dist

    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        return False
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    process_id = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed: NCCL needs CUDA (pass device='cpu' for gloo)")
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    return True


def _process() -> "tuple[int, int, bool]":
    """(process index, process count, whether a process group is up)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), True
    return 0, 1, False


def global_mesh(sp: int = 1, devices: "Optional[Sequence[torch.device | str]]" = None) -> Mesh:
    """A ``(dp, sp)`` mesh over every process's devices, laid out so ``sp``
    (the axis with the per-receipt reduce) stays within a process and only
    ``dp`` crosses processes. ``devices`` is this process's device list
    (default: its CUDA cards; raises without CUDA); every process must
    hold as many."""
    devices = cuda_devices() if devices is None else [torch.device(d) for d in devices]
    local = len(devices)
    if sp < 1 or sp > local or local % sp != 0:
        raise ValueError(f"sp={sp} must divide local device count {local}")
    _, count, distributed = _process()
    return Mesh(_grid(devices, sp), process_count=count, distributed=distributed)


def host_local_pairs(pairs, process_id: Optional[int] = None, num_processes: Optional[int] = None):
    """Partition an epoch range across processes (contiguous slices — keeps
    adjacent pairs, and so their shared witness blocks, in one process)."""
    index, count, _ = _process()
    process_id = index if process_id is None else process_id
    num_processes = count if num_processes is None else num_processes
    chunk = (len(pairs) + num_processes - 1) // num_processes
    return pairs[process_id * chunk : (process_id + 1) * chunk]


def reduce_across_processes(hits: torch.Tensor, count: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Sum ``count`` over every process and gather each process's ``hits``
    rows in rank order (every process holds as many). The collectives run
    on the tensors' device under NCCL and on the CPU under gloo; the
    results come back on the inputs' device."""
    import torch.distributed as dist

    device = hits.device
    comm = device if dist.get_backend() == "nccl" else torch.device("cpu")
    total = count.to(comm, torch.int32).reshape(1)
    dist.all_reduce(total)
    local = hits.to(comm, torch.uint8).contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return torch.cat(parts).to(device, torch.bool), total.reshape(()).to(device)
