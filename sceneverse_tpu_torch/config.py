"""Config system: YAML experiment files + dotted CLI overrides.

The port's own copy of ``sceneverse_tpu/config.py`` (the port imports
nothing of the JAX package); both resolve every config to the same dict,
which ``tests/test_torch_standalone.py`` checks over ``configs/final``.

``Config`` is a dict subclass with attribute access, ``.get``, deep merge,
dotted set/select, and YAML round-tripping.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Iterable

import yaml


class Config(dict):
    """Nested dict with attribute access (OmegaConf-like)."""

    def __init__(self, data: dict | None = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = _wrap(v)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = _wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    # -- helpers -------------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return super().get(key, default)

    def select(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def merge(self, other: dict) -> "Config":
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, dict):
                self[k].merge(v)
            else:
                self[k] = _wrap(v)
        return self

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, Config) else copy.deepcopy(v))
            for k, v in self.items()
        }

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, dict):
        return Config(v)
    if isinstance(v, (list, tuple)):
        return [(_wrap(x)) for x in v]
    return v


def _parse_value(raw: str) -> Any:
    """CLI override value parsing: literal if possible, else string."""
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        pass
    if raw.startswith(("[", "{")):  # hydra-style list/dict of bare words
        try:
            return yaml.safe_load(raw)
        except yaml.YAMLError:
            pass
    return raw


def load_config(path: str, overrides: Iterable[str] = ()) -> Config:
    """Load a YAML experiment file and apply ``key.sub=value`` overrides.

    Supports ``_base_: <path or [paths]>`` (relative to the file) for config
    inheritance: bases are loaded first and deep-merged in order, then the
    file's own keys override.
    """
    import os

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    bases = raw.pop("_base_", None)
    if bases:
        if isinstance(bases, str):
            bases = [bases]
        cfg = Config()
        for base in bases:
            base_path = os.path.join(os.path.dirname(path), base)
            cfg.merge(load_config(base_path))
        cfg.merge(raw)
    else:
        cfg = Config(raw)
    return apply_overrides(cfg, overrides)


def apply_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key=value")
        key, _, raw = item.partition("=")
        cfg.set_dotted(key.strip(), _parse_value(raw.strip()))
    return cfg


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        f.write(cfg.to_yaml())
