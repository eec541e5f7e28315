"""Kernel selection and the timeable pass for the witness-CID recompute
measurement (BASELINE config 4: blake2b-256 over ~200-byte IPLD nodes).

The counterpart of ``ipc_proofs_tpu.ops.cid_bench``: messages of at most
256 bytes go to the two-block CUDA kernel (``csrc/blake2b.cu``), longer ones
to the multi-block kernel. The reference falls back to its XLA kernel when
Mosaic rejects the two-block Pallas kernel; there is no such fallback here:
a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ipc_proofs_tpu_torch.ops import blake2b
from ipc_proofs_tpu_torch.ops.pack import pack_two_block_blake2b, pad_blake2b, to_int32

__all__ = ["blake2b_cid_bench_setup"]


def blake2b_cid_bench_setup(messages: "list[bytes]", device: "torch.device | str | None" = None):
    """Build the timing closure for a blake2b CID-recompute measurement.

    Returns ``(one_pass, args, first_digests, kernel_name)``: ``one_pass(i,
    *args)`` hashes every message once with ``i`` XORed into the first
    plane (so passes differ; for `utils.timing.measure_pass_seconds`) and
    returns a scalar that depends on every digest; ``first_digests`` is
    the uint32 ``[N, 8]`` digest words of the unperturbed input (the
    correctness check); ``kernel_name`` names the `ops.blake2b` kernel that
    runs. ``device`` defaults to the card (raises without CUDA);
    ``"cpu"`` runs the kernels' plain versions.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("blake2b_cid_bench_setup needs a CUDA device (pass device='cpu' for the plain versions)")
    n = len(messages)
    if max(len(m) for m in messages) <= 256:
        m_lo, m_hi, lengths, _ = pack_two_block_blake2b(messages)
        args = (to_int32(m_lo, device), to_int32(m_hi, device), to_int32(lengths, device))
        kernel = blake2b.blake2b256_two_block
    else:
        blocks, counts, lengths = pad_blake2b(messages)
        args = (to_int32(blocks, device), to_int32(counts, device), to_int32(lengths, device))
        kernel = blake2b.blake2b256_blocks
    first = kernel(*args)[:n].cpu().numpy().view(np.uint32)

    def one_pass(i, a, b, c):
        return kernel(a ^ i, b, c).sum(dtype=torch.int32)

    return one_pass, args, first, kernel.__name__
