"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit), and the least time of a piece of work.

``f32`` is the CUDA-core rate. ``3xtf32`` is float32-exact products on the
tensor cores as three TF32 products at 495 TFLOP/s: the chip's fastest
path that keeps float32 accuracy, which the configurations' float32 parts
are counted against."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bf16": 989e12, "tf32": 495e12, "3xtf32": 495e12 / 3, "f32": 67e12}


def least_s(nbytes: float, flops: dict) -> float:
    """The least seconds of work that reads and writes ``nbytes`` once and
    does ``flops`` {precision: operations}: the larger of the two."""
    t_ops = sum(n / FLOPS[p] for p, n in flops.items())
    return max(nbytes / HBM_BYTES_PER_S, t_ops)
