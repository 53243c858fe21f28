"""Share of their roofline that the frozen PointNet++ kernels (SA1 and SA2
``fps`` and ``sv_sa_fwd``) reach in the traced train steps, from the
batches' in-ball pairs (``harness/gps_work.py``)."""

from benchmark.harness import readers


def read(ctx):
    return readers.sa_fwd_roofline(ctx)
