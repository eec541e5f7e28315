"""The BatchHashBackend seam: the batch inner loops the proof engines call.

The counterpart of ``ipc_proofs_tpu.backend``: the same protocol, and a
registry with the ``gpu`` backend (`GpuBackend`, CUDA kernels on the card).
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence

import torch

from ipc_proofs_tpu_torch.state.events import StampedEvent

__all__ = ["BatchHashBackend", "available_backends", "get_backend"]


class BatchHashBackend(Protocol):
    """Batch primitives the proof engines can offload."""

    name: str

    def keccak256_batch(self, messages: Sequence[bytes]) -> list[bytes]:
        """keccak256 of each message."""
        ...

    def blake2b256_batch(self, messages: Sequence[bytes]) -> list[bytes]:
        """blake2b-256 of each message (CID digests)."""
        ...

    def verify_block_cids(self, cids_digests: Sequence[bytes], blocks: Sequence[bytes]) -> bool:
        """True iff every block hashes (blake2b-256) to its claimed digest."""
        ...

    def event_match_mask(
        self,
        events: Sequence[StampedEvent],
        topic0: bytes,
        topic1: bytes,
        actor_id_filter: Optional[int],
    ) -> list[bool]:
        """Per-event predicate: EVM-log shaped, topics[0:2] equal, emitter ok."""
        ...

    def any_event_matches(
        self,
        events: Sequence[StampedEvent],
        topic0: bytes,
        topic1: bytes,
        actor_id_filter: Optional[int],
    ) -> bool:
        """Existence form of `event_match_mask`."""
        ...


_BACKENDS: "dict[str, BatchHashBackend]" = {}


def get_backend(name: str = "gpu", device=None, mesh_devices: Optional[int] = None) -> BatchHashBackend:
    """Backend registry; one cached instance per (name, device, mesh)
    variant.

    ``device`` defaults to the card (``cuda``); ``device="cpu"`` runs the
    kernels' plain versions, as the tests do. ``mesh_devices`` lays the
    fingerprint mask across that many devices (`parallel.mesh.make_mesh`):
    CUDA cards (0 = all of them; raises without CUDA), or with
    ``device="cpu"`` that many virtual CPU devices. ``None`` keeps the
    single-device path. Mesh variants cache under their own key.
    """
    if name != "gpu":
        raise ValueError(f"unknown backend {name!r} (expected gpu)")
    from ipc_proofs_tpu_torch.backend.gpu import GpuBackend

    if mesh_devices is None:
        backend = GpuBackend(device)
        key = f"{name}:{backend.device}"
        return _BACKENDS.setdefault(key, backend)
    from ipc_proofs_tpu_torch.parallel.mesh import make_mesh

    key = f"{name}:{torch.device('cuda' if device is None else device)}:mesh{mesh_devices}"
    if key not in _BACKENDS:
        if device is not None and torch.device(device).type == "cpu":
            if mesh_devices < 1:
                raise ValueError(f"mesh_devices={mesh_devices}: a CPU mesh needs at least one device")
            mesh = make_mesh(mesh_devices, devices=[torch.device("cpu")] * mesh_devices)
        else:
            mesh = make_mesh(mesh_devices or None)  # 0 = every card
        _BACKENDS.setdefault(key, GpuBackend(device, mesh=mesh))
    return _BACKENDS[key]


def available_backends() -> list[str]:
    """The backend names `get_backend` can build here: ``gpu`` where CUDA
    is present, none otherwise (the plain versions on the host are
    ``get_backend("gpu", device="cpu")``, not a backend of their own)."""
    return ["gpu"] if torch.cuda.is_available() else []
