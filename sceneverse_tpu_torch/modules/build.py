"""Module registries + factory (port of sceneverse_tpu/modules/build.py)."""

from __future__ import annotations

from sceneverse_tpu_torch.registry import Registry

VISION_REGISTRY = Registry("vision")
LANGUAGE_REGISTRY = Registry("language")
GROUNDING_REGISTRY = Registry("grounding")
HEADS_REGISTRY = Registry("heads")

_REGISTRIES = {
    "vision": VISION_REGISTRY,
    "language": LANGUAGE_REGISTRY,
    "grounding": GROUNDING_REGISTRY,
    "heads": HEADS_REGISTRY,
}


def build_module(module_type: str, cfg):
    """Instantiate ``cfg.name`` with ``**cfg.args`` from the typed registry."""
    args = dict(cfg.get("args") or {})
    return _REGISTRIES[module_type].get(cfg["name"])(cfg, **args)
