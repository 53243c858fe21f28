"""How far ``sa_pool_bwd``'s gradients sit from their plain twin at the
pooled-center counts of SA3, beside the twin's own spread.

    python3 sa_train_spread.py        # needs one CUDA card

At ObjCls's SA3 (259 -> 256, 512, 512) and GPS's (259 -> 256, 512, 768),
2560 objects x 16 rows, for four input seeds (the inputs of
``chip_smoke.phase_sa_train``): the largest relative error of each
gradient (dW, da, db of the three layers) of the kernel against the twin,
and of the twin against itself with its input channels permuted (the same
function, its bf16 products summed in another order). A ReLU decision
within rounding of 0 lands either way in both, and over 2560 pooled
centers one such row's term is about 2% of the largest gradient: the
reason ``chip_smoke.pool_bwd_grads_tol`` scales the tolerance with the
pooled count. Imports nothing of JAX.
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NAMES = ["dW1", "da1", "db1", "dW2", "da2", "db2", "dW3", "da3", "db3"]


def rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def main():
    import chip_smoke

    chip_smoke.phase_env()
    chip_smoke.phase_build()
    import torch

    from sceneverse_tpu_torch.ops import sa_train as st

    dev = torch.device("cuda")
    G, ns = 2560, 16
    for dims in ([259, 256, 512, 512], [259, 256, 512, 768]):
        for seed in (3, 4, 5, 6):
            g = torch.Generator(device="cpu").manual_seed(seed)
            x = torch.randn((G * ns, dims[0]), generator=g).to(dev)
            params = tuple(
                ((torch.randn((k, h), generator=g) / math.sqrt(k)).to(dev),
                 (torch.rand(h, generator=g) + 0.5).to(dev),
                 (torch.randn(h, generator=g) * 0.1).to(dev))
                for k, h in zip(dims[:-1], dims[1:]))
            pooled, arg = st.sa_pool(x, params, ns)
            dpooled = torch.randn(pooled.shape, generator=g).to(dev)
            _, grads = st.sa_pool_bwd(x, params, ns, dpooled, arg, True)
            _, want = st.mlp_pool_bwd_plain(x, params, ns, dpooled, arg)
            perm = torch.randperm(dims[0], generator=g).to(dev)
            _, twin = st.mlp_pool_bwd_plain(
                x[:, perm].contiguous(),
                ((params[0][0][perm],) + params[0][1:],) + params[1:], ns,
                dpooled, arg)
            kg = [t for gr in grads for t in gr]
            wg = [t for gr in want for t in gr]
            tg = [t for gr in twin for t in gr]
            tg[0] = tg[0][torch.argsort(perm)]  # dW1's rows back in order
            for label, got in (("kernel vs twin", kg),
                               ("twin permuted vs twin", tg)):
                errs = {n: rel(a, b) for n, a, b in zip(NAMES, got, wg)}
                print(f"dims {dims} seed {seed}: {label} max "
                      f"{max(errs.values()):.3e} "
                      f"{ {k: f'{v:.1e}' for k, v in errs.items()} }",
                      flush=True)


if __name__ == "__main__":
    main()
