"""JAX parameters -> this package's state dict: the inverse of
sceneverse_tpu/ckpt/convert.py's torch -> NNX rules (:8-20, :33-60 there).

The port's modules carry the original SceneVerse torch names, so the rules
read backwards:
  * ``kernel`` (in, out) -> ``weight`` (out, in), transposed;
    packed ``in_proj.kernel`` (D, 3D) -> ``in_proj_weight`` (3D, D);
  * ``embedding`` -> ``weight``; LayerNorm / BatchNorm ``scale`` ->
    ``weight``; BatchNorm ``mean`` / ``var`` -> ``running_mean`` /
    ``running_var``;
  * HF BERT: ``layer.N`` -> ``encoder.layer.N``, ``intermediate_dense`` ->
    ``intermediate.dense``, ``output_dense`` / ``output_LayerNorm`` ->
    ``output.dense`` / ``output.LayerNorm``;
  * loc layer ``linear`` / ``norm`` -> Sequential ``0`` / ``1``;
    ``sem_cls_embed_layer_{linear,norm}`` -> ``sem_cls_embed_layer.{0,1}``;
  * PointNet++ ``mlp.layers.K`` -> ``mlps.0.layerK``, the multi-scale
    modules' ``mlps.S.layers.K`` -> ``mlps.S.layerK`` for every scale S and
    ``post_mlp.layers.K`` -> ``post_mlp.layerK``, BN ``bn`` -> ``bn.bn``;
  * separate attention projections ``q_proj`` / ``k_proj`` / ``v_proj``
    and CLIP's HF tree keep their names (``kernel`` -> ``weight``);
  * MLP heads ``*_head.{fc1,norm,fc2}`` and CLIP's ``projection.*`` ->
    Sequential ``{0,2,4}``;
    QA head ``.mlp.fc.`` -> ``.mlp.fc.linear.``, ``answer_fc1`` /
    ``answer_fc2`` -> ``answer_cls.0`` / ``answer_cls.3``.
Non-``Param`` variables (``text_features``) pass through and load as
buffers. The input is plain numpy keyed by dotted nnx path: this module
never sees a JAX object.

``load_torch_pretrain`` loads torch checkpoints (released
``pytorch_model*.bin`` shards or this package's ``best.pth``) by name,
skipping a tensor whose shape differs from the model's, as the JAX
package's loader does.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

_SEGMENTS = [
    (".intermediate_dense.", ".intermediate.dense."),
    (".output_dense.", ".output.dense."),
    (".output_LayerNorm.", ".output.LayerNorm."),
    ("loc_layers.0.linear.", "loc_layers.0.0."),
    ("loc_layers.0.norm.", "loc_layers.0.1."),
    ("sem_cls_embed_layer_linear.", "sem_cls_embed_layer.0."),
    ("sem_cls_embed_layer_norm.", "sem_cls_embed_layer.1."),
    # MLP heads (get_mlp_head); "_head." also covers vis_cls_head, cls_head
    ("_head.fc1.", "_head.0."),
    ("_head.norm.", "_head.2."),
    ("_head.fc2.", "_head.4."),
    # CLIPLanguageEncoder's MLP head (get_mlp_head)
    (".projection.fc1.", ".projection.0."),
    (".projection.norm.", ".projection.2."),
    (".projection.fc2.", ".projection.4."),
    # QA head
    (".mlp.fc.", ".mlp.fc.linear."),
    (".answer_fc1.", ".answer_cls.0."),
    (".answer_fc2.", ".answer_cls.3."),
]


def _rename(path: str) -> str:
    n = "." + path
    n = re.sub(r"\.model\.layer\.(\d+)\.", r".model.encoder.layer.\1.", n)
    for old, new in _SEGMENTS:
        n = n.replace(old, new)
    n = re.sub(r"\.mlp\.layers\.(\d+)\.", r".mlps.0.layer\1.", n)
    n = re.sub(r"\.(mlps\.\d+|post_mlp)\.layers\.(\d+)\.", r".\1.layer\2.",
               n)
    n = re.sub(r"(\.(?:mlps\.\d+|post_mlp)\.layer\d+)\.bn\.", r"\1.bn.bn.",
               n)
    return n[1:]


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{nnx dotted path: array} -> torch state dict of this package."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        arr = np.asarray(arr)
        name = _rename(path)
        stem, _, leaf = name.rpartition(".")
        if name.endswith("in_proj.kernel"):
            key, arr = name.replace("in_proj.kernel", "in_proj_weight"), arr.T
        elif name.endswith("in_proj.bias"):
            key = name.replace("in_proj.bias", "in_proj_bias")
        elif leaf == "kernel":
            key, arr = f"{stem}.weight", arr.T
        elif leaf in ("embedding", "scale"):
            key = f"{stem}.weight"
        elif leaf == "mean":
            key = f"{stem}.running_mean"
        elif leaf == "var":
            key = f"{stem}.running_var"
        else:
            key = name
        out[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return out


def apply_state_dict(model: torch.nn.Module,
                     weights: Dict[str, torch.Tensor]
                     ) -> Tuple[int, List[str], List[str]]:
    """Non-strict load by name, as JAX ``apply_to_model`` (``ckpt/convert.py
    :139-177`` there): a tensor the model lacks, or whose shape differs from
    the model's, is skipped and listed as unexpected (a mismatch with both
    shapes); every other tensor is copied. Returns (tensors loaded, the
    model's tensors left as they were, unexpected): a skipped mismatch is in
    both lists, as there."""
    own = model.state_dict()
    unexpected, hit = [], set()
    with torch.no_grad():
        for k, t in weights.items():
            if k not in own:
                unexpected.append(k)
            elif tuple(t.shape) != tuple(own[k].shape):
                unexpected.append(f"{k} (shape {tuple(t.shape)} vs "
                                  f"{tuple(own[k].shape)})")
            else:
                own[k].copy_(t)
                hit.add(k)
    return len(hit), [k for k in own if k not in hit], unexpected


def load_torch_pretrain(model: torch.nn.Module, ckpt_path) -> int:
    """Warm start (JAX ``ckpt/convert.py:189-210``; reference
    trainer/build.py:174-184): a directory of ``pytorch_model*.bin`` shards,
    or one file holding a flat state dict or this package's own checkpoint
    (``BaseTrainer.save``: the state dict under ``"model"``). Non-strict, by
    ``apply_state_dict``: reports missing and unexpected keys, skips a
    tensor whose shape differs from the model's and loads the rest; returns
    the number of tensors loaded."""
    path = Path(ckpt_path)
    if path.is_dir():
        paths = sorted(path.glob("pytorch_model*.bin"))
        if not paths:
            raise FileNotFoundError(f"no pytorch_model*.bin in {path}")
    else:
        paths = [path]
    weights: Dict[str, torch.Tensor] = {}
    for p in paths:
        sd = torch.load(p, map_location="cpu", weights_only=True)
        if isinstance(sd.get("model"), dict):
            sd = sd["model"]
        weights.update(sd)
    loaded, missing, unexpected = apply_state_dict(model, weights)
    if unexpected:
        print(f"[convert] {len(unexpected)} unexpected/unmatched tensors, "
              f"e.g. {unexpected[:5]}")
    if missing:
        print(f"[convert] {len(missing)} tensors not in the checkpoint, e.g. "
              f"{missing[:5]}")
    return loaded


def load_jax_params(model: torch.nn.Module, flat: Dict[str, np.ndarray]):
    """Load converted JAX parameters; returns (missing, unexpected) keys,
    ignoring BatchNorm's ``num_batches_tracked`` counters."""
    sd = from_jax_params(flat)
    res = model.load_state_dict(sd, strict=False)
    missing = [k for k in res.missing_keys
               if not k.endswith("num_batches_tracked")]
    return missing, list(res.unexpected_keys)
