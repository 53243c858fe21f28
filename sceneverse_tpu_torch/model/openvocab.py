"""GPS task model ``OpenVocab`` (port of sceneverse_tpu/model/openvocab.py;
reference model/openvocab.py:11-126): BERT text tower (utterance, and the
scene caption as a second call when ``split_scene_cap_tower``, [CLS]-only
in its final layer under ``SCENEVERSE_CAP_CLS_ONLY``),
the PointNet++ + spatial vision tower, the unified encoder and the
configured heads; og3d logits are fused objects . fused [CLS] text.

``model.remat`` / ``model.remat_policy`` (JAX :57-81) recompute the named
towers' activations in the backward (``modules/utils.py::remat``): ``true``
is {language, grounding}, a bare string one tower, a list as given; the
policy is "full" or "dots"."""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from sceneverse_tpu_torch.registry import Registry
from sceneverse_tpu_torch.modules.build import build_module
from sceneverse_tpu_torch.modules.utils import init_bert_weights, remat

MODEL_REGISTRY = Registry("model")


def cap_cls_only_enabled() -> bool:
    """``SCENEVERSE_CAP_CLS_ONLY`` (default on, read at call time, as the
    JAX package's ``_lang_cls``): the split caption tower computes only the
    [CLS] query row in its final layer; off runs the full tower and takes
    its ``[:, 0]`` (the parity recipe, ``PARITY_KIT.md:19-28``)."""
    return os.environ.get("SCENEVERSE_CAP_CLS_ONLY", "on").lower() in (
        "1", "on", "true")


def _get_lr(module_cfg, default_lr):
    lr = module_cfg.get("lr") if hasattr(module_cfg, "get") else None
    return default_lr if lr is None else lr


@MODEL_REGISTRY.register()
class OpenVocab(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        import sceneverse_tpu_torch.modules  # noqa: F401  (registries)

        self.cfg = cfg
        self.lang_encoder = build_module("language", cfg.model.language)
        self.point_encoder = build_module("vision", cfg.model.vision)
        self.unified_encoder = build_module("grounding", cfg.model.grounding)
        self.head_list = list(cfg.model.heads.head_list)
        for head in self.head_list:
            if head != "pretrain_head":
                raise NotImplementedError(f"head {head!r} is not ported yet")
            setattr(self, head, build_module("heads", cfg.model.heads[head]))
        self.inter = cfg.model.get("inter", "")
        self.use_scene_cap = cfg.data.args.get("use_scene_cap", False)
        self.split_scene_cap_tower = bool(
            cfg.model.get("split_scene_cap_tower", False))
        self.lm_max_predictions = int(cfg.model.get("lm_max_predictions", 0))
        remat_cfg = cfg.model.get("remat", None)
        if remat_cfg is True:
            self.remat = {"language", "grounding"}
        elif isinstance(remat_cfg, str):  # a bare override, model.remat=vision
            self.remat = {remat_cfg}
        else:
            self.remat = set(remat_cfg or [])
        unknown = self.remat - {"language", "vision", "grounding"}
        if unknown:
            raise ValueError(f"model.remat: unknown towers {sorted(unknown)}; "
                             "valid: language, vision, grounding")
        self.remat_policy = str(cfg.model.get("remat_policy", "full"))
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"model.remat_policy: {self.remat_policy!r}; "
                             "valid: full, dots")
        if generator is None:
            generator = torch.Generator().manual_seed(
                int(cfg.get("rng_seed", 42)))
        init_bert_weights(self.lang_encoder, generator)
        init_bert_weights(self.point_encoder.spatial_encoder, generator)
        init_bert_weights(self.point_encoder.loc_layers, generator)
        init_bert_weights(self.point_encoder.sem_cls_embed_layer, generator)
        init_bert_weights(self.point_encoder.sem_mask_embeddings, generator)
        init_bert_weights(self.unified_encoder, generator)
        for head in self.head_list:
            init_bert_weights(getattr(self, head), generator)
        with torch.no_grad():
            pnet = self.point_encoder.point_feature_extractor
            for m in pnet.modules():
                if isinstance(m, nn.Linear):  # kaiming-normal, zero bias
                    std = (2.0 / m.weight.shape[1]) ** 0.5
                    m.weight.normal_(0.0, std, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()

    # ------------------------------------------------------------ optim hooks
    def get_opt_params(self):
        lr = self.cfg.solver.lr
        m = self.cfg.model
        groups = [
            {"prefix": ("lang_encoder",), "lr": _get_lr(m.language, lr)},
            {"prefix": ("point_encoder",), "lr": _get_lr(m.vision, lr)},
            {"prefix": ("unified_encoder",), "lr": _get_lr(m.grounding, lr)},
        ]
        for head in self.head_list:
            groups.append({"prefix": (head,), "lr": _get_lr(m.heads[head], lr)})
        return groups

    def frozen_prefixes(self):
        if self.cfg.model.vision.args.get("freeze", False):
            return [("point_encoder", "point_feature_extractor")]
        return []

    # ---------------------------------------------------------------- forward
    def _tower(self, name, module, *args, call=None):
        """``(call or module)(*args)``, rematerialised when ``name`` is in
        ``model.remat`` and gradients are recorded (JAX :94-98)."""
        call = call or module
        if name in self.remat and torch.is_grad_enabled():
            return remat(module, call, *args, policy=self.remat_policy)
        return call(*args)

    def _lang_cls(self, ids, masks):
        """The caption tower, read only at [CLS]; ``cls_only`` stays a
        closed-over Python bool through remat (JAX :120-126)."""
        if not cap_cls_only_enabled():
            return self._tower("language", self.lang_encoder, ids, masks)[:, 0]
        enc = self.lang_encoder
        return self._tower("language", enc, ids, masks,
                           call=lambda a, b: enc(a, b, cls_only=True))[:, 0]

    def _lm_head_inputs(self, language_fuse, data_dict, out):
        """Stable gather of the K masked text positions before the LM head
        (:155-172 there); overrides out['masked_lm_labels'] to match."""
        K = self.lm_max_predictions
        labels = data_dict.get("masked_lm_labels")
        if not K or labels is None or K >= language_fuse.shape[1]:
            return language_fuse
        unmasked = (labels == -1).to(torch.int8)
        idx = torch.argsort(unmasked, dim=1, stable=True)[:, :K]
        out["masked_lm_labels"] = torch.gather(labels, 1, idx)
        return torch.gather(language_fuse, 1, idx[..., None].expand(
            *idx.shape, language_fuse.shape[-1]))

    def forward(self, data_dict: dict) -> dict:
        out = dict(data_dict)
        txt_ids, txt_masks = data_dict["txt_ids"], data_dict["txt_masks"]
        if self.use_scene_cap and "scene_txt_ids" in data_dict:
            sc_ids, sc_masks = (data_dict["scene_txt_ids"],
                                data_dict["scene_txt_masks"])
            if self.split_scene_cap_tower:
                lang_feats = self._tower("language", self.lang_encoder,
                                         txt_ids, txt_masks)
                out["scene_text_embed"] = self._lang_cls(sc_ids, sc_masks)
            else:
                B, L = txt_ids.shape
                M = max(L, sc_ids.shape[1])
                pad = lambda x: F.pad(x, (0, M - x.shape[1]))
                feats = self._tower(
                    "language", self.lang_encoder,
                    torch.cat([pad(txt_ids), pad(sc_ids)], 0),
                    torch.cat([pad(txt_masks), pad(sc_masks)], 0))
                lang_feats = feats[:B, :L]
                out["scene_text_embed"] = feats[B:, 0]
        else:
            lang_feats = self._tower("language", self.lang_encoder, txt_ids,
                                     txt_masks)

        point_feats, point_pre, obj_cls_raw_logits = self._tower(
            "vision", self.point_encoder, data_dict["obj_fts"].float(),
            data_dict["obj_locs"], data_dict["obj_masks"],
            data_dict["obj_sem_masks"], data_dict.get("obj_labels"))
        if self.use_scene_cap:
            out["scene_embed"] = point_feats.mean(dim=1)
        if self.inter == "before":
            out["inter_text_embed"] = lang_feats[:, 0]
            out["inter_obj_embeds"] = point_feats
        language_fuse, point_fuse = self._tower(
            "grounding", self.unified_encoder, lang_feats, txt_masks,
            point_feats, data_dict["obj_locs"], data_dict["obj_masks"])
        if self.inter != "before":
            out["inter_text_embed"] = language_fuse[:, 0]
            out["inter_obj_embeds"] = point_fuse
        language_cls = language_fuse[:, 0]
        out["intra_text_embed"] = language_cls
        out["intra_obj_embeds"] = point_fuse
        out["obj_cls_raw_logits"] = obj_cls_raw_logits
        out["og3d_logits"] = torch.einsum("bod,bd->bo", point_fuse,
                                          language_cls)
        if getattr(self, "pretrain_head", None) is not None:
            lm_in = self._lm_head_inputs(language_fuse, data_dict, out)
            out["txt_lm_cls_logits"], out["obj_cls_post_logits"] = \
                self.pretrain_head(lm_in, point_fuse)
        return out


def build_model(cfg, generator: torch.Generator | None = None) -> nn.Module:
    return MODEL_REGISTRY.get(cfg.model.name)(cfg, generator=generator)
