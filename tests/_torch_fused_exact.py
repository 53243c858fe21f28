"""The fused trainable-SA route's first-step losses against the route in
float64 (ROADMAP C): the slice of ``test_torch_fused_unfreeze_slice.py``
(hidden 64, 2 layers, 4 objects x 256 points, batch 2, both fused-SA
gates on), the JAX model's weights carried into the port, one forward
each. Prints, per loss, the value with the route exact (``exact_route``:
every sum, the fold and the affine in float64, the bf16 roundings at the
route's points; the port's towers around it), the port's f32 route and
JAX's interpret-mode kernels, each with its distance from the exact value
relative to max(1, |exact|), for the thread count the process runs at;
JAX's twice: its forward compiled alone and inside the ``value_and_grad``
program whose losses the slice test compares:

    OMP_NUM_THREADS=1 JAX_PLATFORMS=cpu \
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tests/_torch_fused_exact.py

No test collects it: the distances it prints move with the thread count
and from run to run (the route's bf16 roundings follow f32 summation
orders), which is what it measures.
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def exact_route(x, convs, bns, ns):
    """``sa_train.fused_trainable_sa_fn`` in float64 with its bf16 roundings
    at the same points: bf16 operands of every product, the moments of the
    rows for layer 1 and of bf16(h) after, h = relu(u * a + b), the pool of
    the unrounded h3."""
    from sceneverse_tpu_torch.ops import sa_train

    def bf(t):
        return t.to(torch.bfloat16).double()

    h, stats = x.double(), []
    for j in range(3):
        scale, bias, eps = bns[j]
        m = h if j == 0 else bf(h)
        a, b, mh, vh = sa_train.fold_moments(
            convs[j].double(), m.sum(0) / len(m), m.t() @ m / len(m),
            scale.double(), bias.double(), eps)
        h = torch.relu(bf(h) @ bf(convs[j].double()) * a + b)
        stats.append((mh.float(), vh.float()))
    return h.reshape(-1, ns, h.shape[-1]).amax(1).float(), tuple(stats)


def main():
    from flax import nnx
    from torch import nn

    import jax.numpy as jnp
    from sceneverse_tpu.config import load_config
    from sceneverse_tpu.data.build import get_dataset, numpy_collate
    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu.optim import build_optim
    from sceneverse_tpu_torch.ckpt.convert import load_jax_params
    from sceneverse_tpu_torch.model import build_model as tbuild
    from sceneverse_tpu_torch.ops import sa_train
    from sceneverse_tpu_torch.optim.loss.loss import Loss
    from test_torch_fused_unfreeze_slice import FUSED
    from test_torch_slice import CFG, _flat

    os.environ.update({"SCENEVERSE_PALLAS_INTERPRET": "1",
                       "SCENEVERSE_BN_FOLD": "on",
                       "SCENEVERSE_SA_TRAIN_FUSED": "on",
                       "SCENEVERSE_FUSED_MHA": "off"})
    cfg = load_config(CFG, FUSED)
    ds = get_dataset(cfg, "train")
    items = [ds[i] for i in range(len(ds))
             if (ds[i]["masked_lm_labels"] != -1).any()][:2]
    batch = {k: v for k, v in numpy_collate(items).items()
             if isinstance(v, np.ndarray)}
    jm = nnx.jit(lambda: jbuild(cfg, rngs=nnx.Rngs(0)))()
    jm.eval()
    for _, m in nnx.iter_modules(jm):
        if isinstance(m, nnx.BatchNorm):
            m.use_running_average = False
    loss_mod = build_optim(cfg, jm, total_steps=10)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # JAX's forward compiled alone, and inside the value_and_grad program
    # the slice test's step compiles (another XLA fusion of the same math)
    jloss = nnx.jit(lambda m: loss_mod(m(jb))[1])(jm)
    jgrad = nnx.jit(nnx.value_and_grad(lambda m: loss_mod(m(jb)),
                                       has_aux=True))(jm)[0][1]
    tm = tbuild(cfg)
    load_jax_params(tm, _flat(nnx.state(jm, nnx.Not(nnx.RngState))))
    tm.eval()
    for m in tm.modules():
        if isinstance(m, nn.BatchNorm1d):
            m.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        port = Loss(cfg)(tm(tb))[1]
        tm.load_state_dict(state)
        real = sa_train.fused_trainable_sa_fn
        sa_train.fused_trainable_sa_fn = exact_route
        try:
            exact = Loss(cfg)(tm(tb))[1]
        finally:
            sa_train.fused_trainable_sa_fn = real
    print(f"threads {torch.get_num_threads()}")
    for k, r in exact.items():
        r, t = float(r), float(port[k])
        j, g = float(jloss[k]), float(jgrad[k])
        d = max(1.0, abs(r))
        print(f"{k}: exact {r!r}; port {t!r} ({abs(t - r) / d:.3e}); jax "
              f"forward {j!r} ({abs(j - r) / d:.3e}); jax value_and_grad "
              f"{g!r} ({abs(g - r) / d:.3e}); port - jax value_and_grad "
              f"{abs(t - g) / max(1.0, abs(g)):.3e}")


if __name__ == "__main__":
    main()
