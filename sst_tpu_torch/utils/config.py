"""Python-file config loader with ``_base_`` inheritance and deep merge,
mmcv.Config.fromfile semantics (the port's copy of ``sst_tpu/utils/config.py``:
importing ``sst_tpu`` loads JAX, which the port never does).

A config file may itself load another through the JAX package's loader
(it imports ``load_config`` from ``sst_tpu.utils.config``, as the FSD++
configs do). While the port runs a config file, that import resolves to this module,
by an ``__import__`` given to that file's code alone: nothing of ``sst_tpu``
is imported or entered into ``sys.modules``, and any other import of the JAX
package from a config raises ``ImportError``."""

from __future__ import annotations

import builtins
import copy
import importlib.util
import os
import sys

DELETE_KEY = "_delete_"
_JAX_PACKAGE = "sst_tpu"
# the JAX package's modules a config may import, and the port's counterparts
_CONFIG_MODULES = {"sst_tpu.utils.config": __name__}


def _config_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` for a config file's code: the JAX package's config
    loader resolves to the port's, any other module of the JAX package
    raises ``ImportError``, and every other module imports as usual."""
    top = name.split(".")[0]
    if level == 0 and top == _JAX_PACKAGE:
        if name not in _CONFIG_MODULES or not fromlist:
            raise ImportError(f"a config imports {name!r} of the JAX "
                              f"package; the port resolves only "
                              f"'from {sorted(_CONFIG_MODULES)} import ...'")
        return sys.modules[_CONFIG_MODULES[name]]
    return builtins.__import__(name, globals, locals, fromlist, level)


def _load_py_dict(path: str) -> dict:
    spec = importlib.util.spec_from_file_location(
        "_cfg_" + os.path.basename(path), path)
    mod = importlib.util.module_from_spec(spec)
    mod.__builtins__ = {**vars(builtins), "__import__": _config_import}
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



def set_by_dotted(cfg: dict, dotted: str, value) -> None:
    """``cfg[a][b][c] = value`` for ``dotted = "a.b.c"``, making the
    dicts on the way (the CLIs' ``--cfg-options a.b.c=value``)."""
    keys = dotted.split(".")
    cur = cfg
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    cur[keys[-1]] = value
