"""Device milliseconds a train step spends in cuBLAS / CUTLASS matrix
products, from the traced window."""

from benchmark.harness import readers


def read(ctx):
    return readers.gemm_ms(ctx)
