"""Optional `torch.profiler` tracing of a block (``range --profile DIR``)."""

from __future__ import annotations

import os
from contextlib import contextmanager

__all__ = ["maybe_profile"]


@contextmanager
def maybe_profile(trace_dir: "str | None"):
    """Trace the enclosed block with `torch.profiler` (host ops, and the
    card's kernels when CUDA is present) and write a Chrome trace,
    ``trace_dir/trace.json`` (open at ui.perfetto.dev), when a directory
    is given; no-op otherwise."""
    if not trace_dir:
        yield
        return
    import torch

    from ipc_proofs_tpu_torch.utils.log import get_logger

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    get_logger(__name__).info("profiler trace written to %s", path)
