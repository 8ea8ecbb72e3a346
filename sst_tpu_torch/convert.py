"""Load a flax variable tree into the port's torch modules.

The torch modules keep flax's module names (``segmentor_mod``,
``enc_0_0``, ``Dense_1``, ``task_2`` …), so a flax leaf at path
``a/b/c/leaf`` lands on torch module ``a.b.c``. Layout rules by leaf:

  params   kernel (2-D)   Dense [in, out]  → Linear ``weight`` [out, in]
  params   kernel (4-D)   Conv HWIO        → Conv2d ``weight`` OIHW
  params   kernel (4-D)   ConvTranspose HWIO → ConvTranspose2d weight
                          [in, out, kh, kw], flipped in kh and kw (flax's
                          ``transpose_kernel=False`` kernel is torch's
                          ``conv_transpose2d`` kernel turned by 180°)
  params   kernel (3-D)   sparse conv [K, Cin, Cout] → ``weight`` as it is
  params   bias                            → ``bias``
  params   scale          BN / LayerNorm   → ``weight``
  params   z_embed                         → ``z_embed`` as it is
  params   tau       cosine attention      → ``tau`` as it is
  params   weight_bank  PAConv [Cin * mul, M * Cout] → ``weight_bank`` as
                          it is
  batch_stats mean / var                   → ``running_mean`` / ``running_var``

The conversion is strict: it raises if a flax leaf has no torch target, if a
shape differs, or if any torch parameter or buffer is left unset.
:func:`check_flax_shapes` runs the same checks on a tree of shapes alone
(``jax.eval_shape`` of a full-width init), with nothing allocated.

FSD maps by the same names: ``rpn`` / ``roi`` (two stage), ``segmentor_mod``,
``backbone_mod`` / ``block_i`` / ``rel_mlp`` and ``vfe_i`` (SIR, MLPs with
LayerNorm), ``head_mod``, ``bbox_head_mod`` / ``conv_cls`` / ``conv_reg``.
The cluster head's velocity and IoU branches are its tasks' ``vel`` and
``iou`` MLPs, and under group sampling the segmentor head's background
column is the last row of ``conv_seg`` (``num_classes + 1`` outputs): both
map by name and shape like every other leaf. CenterHead maps by the same
rules: ``shared_conv``, ``task_{t}/{name}_conv{i}`` (ConvNormAct) and
``task_{t}/{name}_out`` (a conv with bias). PointPillars maps
``vfe_mod/pfn_{i}`` / ``pfn_bn_{i}``, SECOND's ``backbone_mod/down_{i}`` /
``conv_{i}_{j}`` and ``neck_mod/deblock_conv_{i}`` (a transposed conv at
stride above 1); SECOND's ``SparseEncoder`` its ``[K, Cin, Cout]`` kernels
(K = 27, and 3 for ``conv_out``) as every sparse conv. The PointNet++
modules (``models/pointnet_modules.py``) map their shared MLPs'
``layer{i}`` / ``bn{i}``, the SA module's ``mlp{i}``, the FP module's and
ScoreNet's ``_SharedMLP_0``, and PAConv's ``scorenet``, ``weight_bank`` and
``bn``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "z_embed": "z_embed", "tau": "tau",
                "weight_bank": "weight_bank"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(leaf: str, value: np.ndarray,
                     transposed: bool = False) -> np.ndarray:
    """``transposed``: the target is a ``ConvTranspose2d``."""
    if leaf == "kernel" and value.ndim == 2:
        return value.T
    if leaf == "kernel" and value.ndim == 4 and transposed:
        return value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    if leaf == "kernel" and value.ndim == 3:
        return value
    if leaf == "kernel":
        raise ValueError(f"kernel of rank {value.ndim} has no torch layout")
    return value


def _matched(module: nn.Module, variables: Mapping):
    """Yield (torch key, target tensor, flax leaf name, flax value, whether
    the target is a transposed conv) for every flax leaf, its shape in the
    torch layout checked against the target's; raise on a leaf without a
    target and on a target left unset. ``value`` needs only ``.shape`` and
    ``.ndim``."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    state = module.state_dict(keep_vars=True)
    done = set()
    for collection, names in (("params", _PARAM_NAMES),
                              ("batch_stats", _STAT_NAMES)):
        for path, value in _leaves(variables.get(collection, {})):
            leaf = path[-1]
            if leaf not in names:
                raise KeyError(f"no torch counterpart for flax leaf "
                               f"{collection}/{'/'.join(path)}")
            key = ".".join(path[:-1] + (names[leaf],))
            if key not in state:
                raise KeyError(f"flax leaf {collection}/{'/'.join(path)} has "
                               f"no torch target {key!r}")
            transposed = isinstance(module.get_submodule(
                ".".join(path[:-1])), nn.ConvTranspose2d)
            shape = _to_torch_layout(
                leaf, np.broadcast_to(np.float32(0), value.shape),
                transposed).shape
            target = state[key]
            if tuple(shape) != tuple(target.shape):
                raise ValueError(f"{key}: flax shape {tuple(shape)} (torch "
                                 f"layout) != torch shape "
                                 f"{tuple(target.shape)}")
            done.add(key)
            yield key, target, leaf, value, transposed
    missing = sorted(set(state) - done)
    if missing:
        raise KeyError(f"torch parameters/buffers not set by the flax "
                       f"variables: {missing}")


@torch.no_grad()
def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Fill ``module`` from ``{"params": ..., "batch_stats": ...}`` (nested
    dicts of numpy arrays) and return it."""
    for _, target, leaf, value, transposed in list(_matched(module,
                                                             variables)):
        arr = _to_torch_layout(leaf, np.asarray(value), transposed)
        target.copy_(torch.from_numpy(np.array(arr)))
    return module


def check_flax_shapes(module: nn.Module, shapes: Mapping) -> int:
    """The checks of :func:`load_flax_variables` on a tree of shapes only
    (``jax.eval_shape`` of a flax init: objects with ``.shape`` and
    ``.ndim``), copying nothing; returns the number of leaves matched."""
    return len(list(_matched(module, shapes)))
