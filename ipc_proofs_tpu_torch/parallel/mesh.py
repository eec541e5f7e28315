"""The device mesh: a ``(dp, sp)`` grid of torch devices.

The counterpart of ``ipc_proofs_tpu.parallel.mesh``. A JAX mesh is a grid of
devices that XLA shards over; here it is the same grid, and the sharded
functions (`parallel.pipeline.sharded_match_pipeline`,
`ops.match.sharded_fp_mask_fn`) place one block on each device themselves.

An explicit device list may repeat a device: ``[torch.device("cpu")] * 8``
is the counterpart of XLA's virtual host devices (the tests), and
``[torch.device("cuda", 0)] * 4`` runs every shard, gather and reduce of a
4-device mesh on one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

__all__ = ["Mesh", "make_mesh", "cuda_devices"]


@dataclass(frozen=True)
class Mesh:
    """A ``(dp, sp)`` grid of devices; hashable, so sharded functions cache
    per mesh.

    ``grid`` holds this process's devices: ``local_dp`` rows of ``sp``.
    Under a process group (`parallel.multihost.global_mesh`) ``dp`` spans
    ``process_count`` processes, each holding ``local_dp`` rows, and the
    sharded functions all-reduce and all-gather across them; ``distributed``
    is True even for a group of one.
    """

    grid: "tuple[tuple[torch.device, ...], ...]"
    process_count: int = 1
    distributed: bool = False

    axis_names = ("dp", "sp")

    @property
    def local_dp(self) -> int:
        return len(self.grid)

    @property
    def shape(self) -> "dict[str, int]":
        return {"dp": self.local_dp * self.process_count, "sp": len(self.grid[0])}

    @property
    def size(self) -> int:
        """Devices in the whole mesh (every process's)."""
        return self.shape["dp"] * self.shape["sp"]

    @property
    def devices(self) -> "list[torch.device]":
        """This process's devices, row-major (dp outer, sp inner): the order
        in which row-sharded functions lay their blocks."""
        return [device for row in self.grid for device in row]


def cuda_devices() -> "list[torch.device]":
    """Every CUDA card of this process; raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a device mesh needs CUDA cards (pass devices=[torch.device('cpu')] * n for the plain versions)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid(devices: "Sequence[torch.device]", sp: int) -> "tuple[tuple[torch.device, ...], ...]":
    return tuple(tuple(devices[r * sp : (r + 1) * sp]) for r in range(len(devices) // sp))


def make_mesh(
    n_devices: Optional[int] = None,
    sp: int = 1,
    devices: "Optional[Sequence[torch.device | str]]" = None,
) -> Mesh:
    """Build a 2D ``(dp, sp)`` mesh over the first ``n_devices`` devices.

    ``sp`` devices shard the event axis (the per-receipt reduce crosses
    them); the rest shard the tipset axis. ``devices=None`` means every
    CUDA card (raises without CUDA); ``n_devices=None`` uses all of
    ``devices``.
    """
    devices = cuda_devices() if devices is None else [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    if sp < 1 or n_devices % sp != 0:
        raise ValueError(f"n_devices {n_devices} not divisible by sp {sp}")
    if n_devices == 0:
        raise ValueError("a mesh needs at least one device")
    return Mesh(_grid(devices[:n_devices], sp))
