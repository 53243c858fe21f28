"""Share of their roofline that the fused attention kernels (``mha_fwd``,
``mha_bwd``) reach in the traced train steps, from the batches' needed
queries and real keys (``harness/gps_work.py``)."""

from benchmark.harness import readers


def read(ctx):
    return readers.mha_roofline(ctx)
