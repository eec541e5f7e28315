"""kernel_us_per_kproof (end to end): the card's kernel time a thousand
proofs cost.

The summed device time of every kernel that ran in the window (the card's
timeline, `portbench.bench.trace.DeviceTimeline`; copies and memsets left
out: a pageable copy's device time follows the host's staging, not the
card), in microseconds, over the thousands of proofs completed there. It
counts every kernel the window's proofs needed, whatever implements them;
the host's speed, which paces the window, does not move it. None where no
kernel ran or no proof completed.
"""

UNIT = "us/kproof"
COPIES = ("Memcpy", "Memset")


def read(record):
    seconds = sum(end - start for name, start, end in record["device_ops"]
                  if not name.startswith(COPIES))
    if seconds <= 0 or not record["proofs"]:
        return None
    return seconds / record["proofs"] * 1e9
