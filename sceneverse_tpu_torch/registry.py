"""Lightweight name -> class registry (the port's own copy of
``sceneverse_tpu/registry.py``): the model, trainer, dataset, module, loss
and evaluator registries of the port."""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """Name -> class/callable mapping with decorator-based registration."""

    def __init__(self, name: str):
        self._name = name
        self._map: Dict[str, Any] = {}

    def register(self, obj: Any = None, *, name: str | None = None) -> Callable:
        if obj is None:
            return lambda o: self.register(o, name=name)
        key = name or obj.__name__
        if key in self._map:
            raise KeyError(f"'{key}' already registered in registry '{self._name}'")
        self._map[key] = obj
        return obj

    def get(self, key: str) -> Any:
        if key not in self._map:
            raise KeyError(
                f"'{key}' not found in registry '{self._name}'. "
                f"Available: {sorted(self._map)}"
            )
        return self._map[key]
