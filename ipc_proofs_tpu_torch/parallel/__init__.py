"""Host parallelism for the range drivers: the bounded-queue stage
pipeline and the fingerprint-mask coalescer (`parallel.pipeline`). The
device mesh of the JAX package's ``parallel/`` waits for the multi-device
slice (ROADMAP Queue 1 item 4)."""
