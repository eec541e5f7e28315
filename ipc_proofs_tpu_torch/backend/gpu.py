"""GPU batch backend: the blake2b-256, keccak-256 and match-mask CUDA
kernels.

`blake2b256_batch` splits a batch into three size classes and gives each
its own kernel — ≤128 B to the single-block kernel, 129–256 B to the
two-block kernel, >256 B to the multi-block kernel — and scatters the
digests back in input order. (The TPU backend instead picks one kernel by
the batch's longest message, so any witness with a block over 256 B ran
wholly on its multi-block scan.) There is no host crossover: on CUDA every
non-empty class launches its kernel.

`keccak256_batch` splits the same way (`keccak_class`): messages under
136 B, one rate block, to the single-block kernel; 136 B and above to the
multi-block kernel. (The TPU backend kept batches under 8 MiB on its host
C++ hasher, which would put all of BASELINE config 3's 4 MB of slot
preimages on the host; here every non-empty class launches.)

`event_match_mask_fp` is the counterpart of the TPU backend's fingerprint
mask: its presence (with ``mesh`` None) is what makes the range driver take
the fused C scan+match, as the reference does; the unfused branch
(``IPC_SCAN_FUSED_MATCH=0``) runs this mask on the card. A backend built
with a device mesh (`parallel.mesh.Mesh`) runs that mask sharded over every
mesh device (rows padded to a mesh-divisible bucket), and its full-word
masks too (rows split, exact length): those are what the range scan runs
over a store without a raw map, such as the CLI's RPC store. Both masks
are kernels of ``csrc/match.cu`` (one launch a device block). Its hash
kernels stay on ``device``, as in the reference.

A backend holds nothing but its device, so one instance serves several
host threads at once (the pipelined driver's workers): every call packs
into its own arrays and tensors, launches on its thread's current stream
(`ops.build.launch`) and copies its digests back before it returns. `warm`
builds the kernels before such threads start.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ipc_proofs_tpu_torch.ops import blake2b, keccak, match
from ipc_proofs_tpu_torch.ops.build import KERNEL_LIBRARIES, load_libraries
from ipc_proofs_tpu_torch.ops.pack import (
    RATE_BYTES,
    digests_to_bytes,
    pack_single_block_blake2b,
    pack_single_block_keccak,
    pack_two_block_blake2b,
    pad_blake2b,
    pad_keccak,
    to_int32,
)
from ipc_proofs_tpu_torch.proofs.scan_native import topic_fingerprint
from ipc_proofs_tpu_torch.state.events import StampedEvent

__all__ = ["GpuBackend", "SIZE_CLASSES", "size_class", "KECCAK_CLASSES", "keccak_class"]

# the blake2b kernel (an `ops.blake2b` function name) of each size class
SIZE_CLASSES = ("blake2b256_single_block", "blake2b256_two_block", "blake2b256_blocks")
# the keccak kernel (an `ops.keccak` function name) of each size class
KECCAK_CLASSES = ("keccak256_single_block", "keccak256_blocks")


def size_class(n_bytes: int) -> str:
    """The kernel `GpuBackend.blake2b256_batch` gives an n-byte message."""
    if n_bytes <= 128:
        return "blake2b256_single_block"
    return "blake2b256_two_block" if n_bytes <= 256 else "blake2b256_blocks"


def keccak_class(n_bytes: int) -> str:
    """The kernel `GpuBackend.keccak256_batch` gives an n-byte message."""
    return "keccak256_single_block" if n_bytes < RATE_BYTES else "keccak256_blocks"


def _split(messages: Sequence[bytes], classes: "tuple[str, ...]", route, hashers) -> list[bytes]:
    """Hash each message with its class's hasher, one call per non-empty
    class, digests back in input order."""
    rows: "dict[str, list[int]]" = {name: [] for name in classes}
    for i, message in enumerate(messages):
        rows[route(len(message))].append(i)
    out: "list[bytes | None]" = [None] * len(messages)
    for name, positions in rows.items():
        if positions:
            digests = hashers[name]([messages[i] for i in positions])
            for i, digest in zip(positions, digests):
                out[i] = digest
    return out


class GpuBackend:
    name = "gpu"

    def __init__(self, device: "torch.device | str | None" = None, mesh=None):
        """``device`` defaults to the card (or to the first device of
        ``mesh``); without a CUDA device that raises rather than running on
        the CPU. ``device="cpu"`` runs the kernels' plain versions (the
        tests). ``mesh``: a `parallel.mesh.Mesh` over which the event
        masks run sharded (None: single device)."""
        if device is None and mesh is not None:
            device = mesh.devices[0]
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "GpuBackend needs a CUDA device (pass device='cpu' for the plain versions)"
            )
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self.mesh = mesh

    def warm(self) -> None:
        """Build (nvcc) and load the blake2b, keccak and match kernels now,
        every source at once, so no later caller compiles; nothing to do for
        the plain versions on the CPU."""
        if self.device.type == "cuda":
            load_libraries(KERNEL_LIBRARIES)

    def keccak256_batch(self, messages: Sequence[bytes]) -> list[bytes]:
        hashers = {
            "keccak256_single_block": self._keccak_single_block,
            "keccak256_blocks": self._keccak_multi_block,
        }
        return _split(messages, KECCAK_CLASSES, keccak_class, hashers)

    def _keccak_single_block(self, messages: "list[bytes]") -> list[bytes]:
        lo, hi, n = pack_single_block_keccak(messages)
        words = keccak.keccak256_single_block(to_int32(lo, self.device), to_int32(hi, self.device))
        return digests_to_bytes(words[:n].cpu().numpy())

    def _keccak_multi_block(self, messages: "list[bytes]") -> list[bytes]:
        blocks, n_blocks = pad_keccak(messages)
        words = keccak.keccak256_blocks(to_int32(blocks, self.device), to_int32(n_blocks, self.device))
        return digests_to_bytes(words.cpu().numpy())

    def blake2b256_batch(self, messages: Sequence[bytes]) -> list[bytes]:
        hashers = {
            "blake2b256_single_block": self._single_block,
            "blake2b256_two_block": self._two_block,
            "blake2b256_blocks": self._multi_block,
        }
        return _split(messages, SIZE_CLASSES, size_class, hashers)

    def _single_block(self, messages: "list[bytes]") -> list[bytes]:
        m_lo, m_hi, lengths, n = pack_single_block_blake2b(messages)
        words = blake2b.blake2b256_single_block(
            to_int32(m_lo, self.device), to_int32(m_hi, self.device), to_int32(lengths, self.device)
        )
        return digests_to_bytes(words[:n].cpu().numpy())

    def _two_block(self, messages: "list[bytes]") -> list[bytes]:
        m_lo, m_hi, lengths, n = pack_two_block_blake2b(messages)
        words = blake2b.blake2b256_two_block(
            to_int32(m_lo, self.device), to_int32(m_hi, self.device), to_int32(lengths, self.device)
        )
        return digests_to_bytes(words[:n].cpu().numpy())

    def _multi_block(self, messages: "list[bytes]") -> list[bytes]:
        blocks, n_blocks, lengths = pad_blake2b(messages)
        words = blake2b.blake2b256_blocks(
            to_int32(blocks, self.device), to_int32(n_blocks, self.device), to_int32(lengths, self.device)
        )
        return digests_to_bytes(words.cpu().numpy())

    def verify_block_cids(
        self, cids_digests: Sequence[bytes], blocks: Sequence[bytes]
    ) -> bool:
        digests = self.blake2b256_batch(blocks)
        return len(digests) == len(cids_digests) and all(
            d == e for d, e in zip(digests, cids_digests)
        )

    def event_match_mask(
        self,
        events: Sequence[StampedEvent],
        topic0: bytes,
        topic1: bytes,
        actor_id_filter: Optional[int],
    ) -> list[bool]:
        return match.event_match_mask(
            events, topic0, topic1, actor_id_filter, self.device, mesh=self.mesh
        )

    def event_match_mask_flat(
        self,
        topics: np.ndarray,
        n_topics: np.ndarray,
        emitters: np.ndarray,
        valid: np.ndarray,
        topic0: bytes,
        topic1: bytes,
        actor_id_filter: Optional[int],
    ) -> np.ndarray:
        """Mask over pre-flattened arrays (exact length, no padding)."""
        return match.event_match_mask_flat(
            topics, n_topics, emitters, valid, topic0, topic1, actor_id_filter,
            self.device, mesh=self.mesh,
        )

    def event_match_mask_fp(
        self,
        fp: np.ndarray,
        n_topics: np.ndarray,
        emitters: np.ndarray,
        valid: np.ndarray,
        topic0: bytes,
        topic1: bytes,
        actor_id_filter: Optional[int],
    ) -> np.ndarray:
        """Fingerprint mask over the scanner's flat arrays: one u64 per
        event crosses to the device instead of 64 topic bytes. Same
        predicate as `event_match_mask_flat` up to a 2^-64 fingerprint
        collision, which pass 2 (the exact matcher) filters out."""
        return match.event_match_mask_fp(
            fp, n_topics, emitters, valid, topic_fingerprint(topic0, topic1),
            actor_id_filter, self.device, mesh=self.mesh,
        )

    def any_event_matches(
        self,
        events: Sequence[StampedEvent],
        topic0: bytes,
        topic1: bytes,
        actor_id_filter: Optional[int],
    ) -> bool:
        return any(self.event_match_mask(events, topic0, topic1, actor_id_filter))
