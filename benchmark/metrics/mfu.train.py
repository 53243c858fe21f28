"""The whole train step's share of the chip's peak: the least time of the
window's model products (each part at the peak of its stated precision,
``harness/gps_work.py``) over the untraced window's time."""

from benchmark.harness import readers


def read(ctx):
    return readers.mfu(ctx)
