"""Python-file config loader with ``_base_`` inheritance and deep merge,
mmcv.Config.fromfile semantics (the port's copy of ``sst_tpu/utils/config.py``:
importing ``sst_tpu`` loads JAX, which the port never does)."""

from __future__ import annotations

import copy
import importlib.util
import os

DELETE_KEY = "_delete_"


def _load_py_dict(path: str) -> dict:
    spec = importlib.util.spec_from_file_location(
        "_cfg_" + os.path.basename(path), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and not callable(v)
            and not isinstance(v, type(os))}


def deep_merge(base: dict, override: dict) -> dict:
    """mmcv-style merge: dicts merge recursively unless the override
    carries ``_delete_: True``."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if (isinstance(v, dict) and k in out and isinstance(out[k], dict)
                and not v.get(DELETE_KEY, False)):
            out[k] = deep_merge(out[k], v)
        else:
            v = copy.deepcopy(v)
            if isinstance(v, dict):
                v.pop(DELETE_KEY, None)
            out[k] = v
    return out


def load_config(path: str) -> dict:
    """The config at ``path`` merged over its ``_base_`` files (paths
    relative to its own directory)."""
    path = os.path.abspath(path)
    cfg = _load_py_dict(path)
    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for b in bases:
        merged = deep_merge(merged, load_config(
            os.path.join(os.path.dirname(path), b)))
    return deep_merge(merged, cfg)

