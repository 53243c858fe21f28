"""What the per-layer readers (``metrics/<name>.py``) take from a traced
run's context: the untraced window's steps, time, host timings of the
dispatch call and work, and the traced window's trace and work. A reader
that finds nothing to read returns None."""

from __future__ import annotations

from benchmark.harness import peaks

GEMM = ("gemm", "sgemm", "cutlass", "xmma", "nvjet")
PORT = ("sv_", "fa_")  # the program's own kernels


def is_gemm(name):
    """cuBLAS / CUTLASS matrix products by kernel name (``profile_torch.py``'s
    grouping)."""
    low = name.lower()
    return (not any(p in name for p in PORT)
            and any(t in low for t in GEMM))


def dispatch_host_ms(ctx):
    """Host milliseconds a step spends in the dispatch call."""
    if ctx["trace"] is None or not ctx["window_steps"]:
        return None
    return 1e3 * sum(ctx["dispatch_s"]) / ctx["window_steps"]


def gemm_ms(ctx):
    """Traced device milliseconds a step of the matrix-product kernels."""
    tr = ctx["trace"]
    if tr is None or not ctx["traced_steps"]:
        return None
    return 1e3 * sum(d for _, _, d in tr.kernels(is_gemm)) / ctx["traced_steps"]


def idle_share(ctx):
    """Share of the traced window in which no kernel runs (copies and fills
    count as idle)."""
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.union_s(tr.kernels()) / tr.window_s)


def mfu(ctx):
    """The least time of the untraced window's model products, each part at
    the peak of its stated precision, over the window's time."""
    if ctx["trace"] is None or ctx["window_s"] <= 0:
        return None
    least = sum(n * peaks.least_s(0, w["flops"]) for w, n in ctx["window_work"])
    return 100.0 * least / ctx["window_s"]


def roofline(ctx, key, match):
    """The least time of the traced steps' calls of a kernel family (the
    work's ``key``) over the traced time of the kernels ``match`` names."""
    tr = ctx["trace"]
    if tr is None:
        return None
    t = sum(d for _, _, d in tr.kernels(match))
    if t <= 0:
        return None
    return 100.0 * sum(w[key] for w in ctx["traced_work"]) / t


def mha_roofline(ctx):
    return roofline(ctx, "mha_s", lambda n: "sv_mha_" in n)


SA_KERNELS = ("sv_fps_kernel", "sv_sa_fwd_kernel")


def sa_fwd_roofline(ctx):
    return roofline(ctx, "sa_fwd_s",
                    lambda n: any(k in n for k in SA_KERNELS))
