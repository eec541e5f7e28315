"""setup_s (end to end): process start to the window's opening, on the
host's clock: imports, the world built from the seed, the program loaded
(kernels built on a checkout's first run), the warm unit."""

UNIT = "s"


def read(record):
    return record["setup_s"]
