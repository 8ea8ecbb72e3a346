"""Registry keeping the reference's ``dict(type='Name', ...)`` API (the
port's copy of ``sst_tpu/utils/registry.py``)."""

from __future__ import annotations

from typing import Any


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._modules: dict[str, Any] = {}

    def register(self, cls):
        key = cls.__name__
        if key in self._modules and self._modules[key] is not cls:
            raise KeyError(f"{key} already registered in {self.name}")
        self._modules[key] = cls
        return cls

    def get(self, key: str):
        if key not in self._modules:
            raise KeyError(f"{key!r} not found in registry {self.name}; "
                           f"have {sorted(self._modules)}")
        return self._modules[key]

    def build(self, cfg: dict, **default_kwargs):
        cfg = dict(cfg)
        cls = self.get(cfg.pop("type"))
        return cls(**{**default_kwargs, **cfg})


MODELS = Registry("models")
PIPELINES = Registry("pipelines")
DATASETS = Registry("datasets")
