"""Device throughput by the slope of k passes.

The counterpart of ``ipc_proofs_tpu.utils.timing``. A single call's wall
time holds the launch overhead, the host's enqueue and the final copy back
as well as the device's work. So ``measure_pass_seconds`` runs k passes
back to back (each pass's index ``i`` a device tensor mixed into an input,
so no two passes compute the same thing), accumulates each pass's scalar on
the device, synchronises once at the end by reading the sum back, and times
two different k. The slope ``(t_large - t_small) / (k_large - k_small)`` is
the per-pass time with every constant cost cancelled.

The reference runs the k passes in one ``lax.fori_loop`` under ``jit``, so
its slope is the device's. Eager PyTorch would enqueue each pass's ops one
by one, and for a cheap pass (a few µs of device work a launch) the slope
would be the host's enqueue rate instead. So on a card one pass — the
body, the accumulate and ``i += 1`` — is captured once in a CUDA graph
(`torch.cuda.CUDAGraph`) and replayed k times: a replay costs the host a
few µs whatever the body launches, and the slope is the device's time a
pass once that exceeds it. No JIT, no ``torch.compile``. On the CPU, and
for a body whose tensors span several cards, the passes run eagerly
(`PassTime.graph` is False): on the CPU that is the compute itself.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Sequence

import torch

__all__ = ["PassTime", "measure_pass_seconds"]


class PassTime(NamedTuple):
    seconds: float  # per-pass device seconds (slope)
    k_small: int
    k_large: int
    t_small: float  # best-of wall time for the k_small loop
    t_large: float  # best-of wall time for the k_large loop
    graph: bool = False  # True: the slope of CUDA graph replays (device time)

    @property
    def per_pass_ms(self) -> float:
        return self.seconds * 1e3


def _devices_of(args) -> "list[torch.device]":
    """The devices of the tensors in ``args`` (nested tuples and lists
    too), each once, in the order they come."""
    found: "dict[torch.device, None]" = {}
    for arg in args:
        if isinstance(arg, torch.Tensor):
            found[arg.device] = None
        elif isinstance(arg, (tuple, list)):
            found.update(dict.fromkeys(_devices_of(arg)))
    return list(found)


def _eager_runner(body: Callable, args: Sequence, device: torch.device, max_k: int) -> Callable[[int], int]:
    index = torch.arange(max_k, dtype=torch.int32, device=device)

    def run(k: int) -> int:
        acc = torch.zeros((), dtype=torch.int32, device=device)
        for i in range(k):
            # int32 sum; wraparound is harmless — only timing matters
            acc = acc + body(index[i], *args).to(torch.int32)
        return int(acc)  # the one synchronisation

    return run


def _graph_runner(body: Callable, args: Sequence, device: torch.device) -> Callable[[int], int]:
    i = torch.zeros((), dtype=torch.int32, device=device)
    acc = torch.zeros((), dtype=torch.int32, device=device)

    def one_pass() -> None:
        acc.add_(body(i, *args).to(torch.int32))  # int32 sum; wraparound is harmless
        i.add_(1)

    with torch.cuda.device(device):
        # a first pass on a side stream before the capture, as
        # torch.cuda.graphs asks: it builds and loads the kernels
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            one_pass()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            one_pass()

    def run(k: int) -> int:
        for _ in range(k):
            graph.replay()
        return int(acc)  # the one synchronisation

    return run


def measure_pass_seconds(
    body: Callable,
    args: Sequence,
    *,
    k_small: int = 5,
    k_large: int = 105,
    repeats: int = 3,
    max_k: int = 8005,
    min_delta_s: float = 0.010,
) -> PassTime:
    """Measure per-pass device seconds of ``body`` via the slope method.

    Args:
      body: ``body(i, *args) -> scalar tensor`` — one pass. ``i`` is an
        int32 scalar tensor on the arguments' device; the body must mix it
        into an input (e.g. XOR it into one), and the returned scalar must
        depend on the pass's real output.
      args: tensors (or tuples of them) passed through unchanged each pass.
      k_small/k_large: initial loop lengths. If the timing difference is
        below ``min_delta_s`` (a pass too cheap to resolve), ``k_large``
        escalates geometrically up to ``max_k``.
      repeats: best-of-N wall timings per loop length (a first run of each
        loop warms it and is discarded).

    On one card the pass is captured once in a CUDA graph and replayed k
    times, so the body must be capturable: no host synchronisation
    (``.item()``, ``.cpu()``) inside it. On the CPU, or across several
    cards, it runs eagerly.

    Returns:
      PassTime with the per-pass seconds (clamped to >= 1 ns).
    """
    if not (k_large > k_small >= 1):
        raise ValueError(
            f"need k_large > k_small >= 1, got k_small={k_small} k_large={k_large}"
        )
    devices = _devices_of(args) or [torch.device("cpu")]
    device = devices[0]
    graph = len(devices) == 1 and device.type == "cuda"
    if graph:
        run = _graph_runner(body, args, device)
    else:
        run = _eager_runner(body, args, device, max(k_large, max_k))

    def best_of(k: int) -> float:
        run(k)  # warm: builds and loads kernels, fills the allocator's cache
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            run(k)
            best = min(best, time.perf_counter() - t0)
        return best

    t_small = best_of(k_small)
    while True:
        t_large = best_of(k_large)
        delta = t_large - t_small
        if delta >= max(min_delta_s, 0.05 * t_small) or k_large >= max_k:
            break
        k_large = min(max_k, (k_large - k_small) * 4 + k_small)
    per_pass = max((t_large - t_small) / (k_large - k_small), 1e-9)
    return PassTime(per_pass, k_small, k_large, t_small, t_large, graph)
