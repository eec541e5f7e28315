"""Operator and adversarial tools of the port, run as modules:
``python -m ipc_proofs_tpu_torch.tools.<name>``.

The counterparts of the reference's repo-root ``tools/``: ``traceview``
and ``auditview`` (offline readers of traces and registry logs), and
``chaos``, ``crashtest`` and ``soak`` (fault injection, kill-and-resume and
fresh-seed differential fuzz, with ``_fuzz`` as the soak's harness). Each
takes the reference's arguments plus ``--device`` (default ``cuda``): on
the card unless the caller passes ``--device cpu``; without CUDA and
without that flag it exits non-zero before any work.
"""

from __future__ import annotations

import argparse

__all__ = ["add_device_flag", "backend_for", "service_device"]


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where kernels run: the card (default) or their plain versions on the host",
    )


def backend_for(device: str):
    """The `GpuBackend` on ``device``; without CUDA a ``cuda`` request
    exits non-zero with the backend's error, as the CLI's ``--backend gpu``
    does."""
    from ipc_proofs_tpu_torch.backend import get_backend

    try:
        return get_backend("gpu", device=device)
    except (RuntimeError, ValueError) as exc:
        raise SystemExit(f"--device {device}: {exc}") from exc


def service_device(backend) -> "str | None":
    """The `ServiceConfig.device` of services beside ``backend``: None (the
    card) unless the backend runs the plain versions on the host."""
    return "cpu" if backend.device.type == "cpu" else None
