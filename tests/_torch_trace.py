"""Span-tree comparisons between the port and the JAX package.

The port opens spans the reference never does: its GPU backend's
``gpu.*`` spans (``backend/gpu.py``) and, while the span collector is
installed, a ``host.gc`` span for each full collection inside a span
(``obs.trace.SpanCollector.on_gc``, which also adds a young collection's
pause to the interrupted span's ``gc_us`` attribute). A test that holds the
port's spans against the reference's leaves the first out
(`PORT_ONLY_SPANS`) and runs with no collection in between
(`no_collections`).
"""

import contextlib
import gc

# span names only the port makes (prefixes)
PORT_ONLY_SPANS = ("gpu.", "host.gc")


@contextlib.contextmanager
def no_collections():
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()
