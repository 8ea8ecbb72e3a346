"""Loss functions (counterpart of ``sst_tpu/core/losses.py``): mmdet's
focal, L1, smooth-L1, cross-entropy and binary cross-entropy losses with
explicit element weights and an ``avg_factor``, the reference's reduction
convention."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _reduce(loss, weight, avg_factor):
    """The weighted sum over ``avg_factor``, in JAX's result dtype: a float
    tensor ``avg_factor`` promotes a bfloat16 sum to its dtype, as a float32
    array does in JAX whatever its rank (torch would keep bfloat16 against a
    0-dim float32 tensor); a Python number does not."""
    if weight is not None:
        loss = loss * weight
    total = loss.sum()
    if torch.is_tensor(avg_factor) and avg_factor.is_floating_point():
        total = total.to(torch.promote_types(total.dtype, avg_factor.dtype))
    return total / torch.clamp(torch.as_tensor(avg_factor, dtype=total.dtype,
                                               device=total.device), min=1e-6)


def _sigmoid_bce(logits, targets):
    """optax ``sigmoid_binary_cross_entropy``."""
    return -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(
        -logits)


def sigmoid_focal_loss(logits, targets, weight=None, gamma: float = 2.0,
                       alpha: float = 0.25, avg_factor=1.0):
    """mmdet sigmoid focal loss. ``targets``: integer class ids in [0, C],
    where C (== logits.shape[-1]) is background, or a float one-hot of the
    shape of ``logits``."""
    c = logits.shape[-1]
    if targets.dtype in (torch.int32, torch.int64):
        onehot = F.one_hot(targets.long(), c + 1)[..., :c].to(logits.dtype)
    else:
        onehot = targets
    p = torch.sigmoid(logits)
    ce = _sigmoid_bce(logits, onehot)
    pt = p * onehot + (1 - p) * (1 - onehot)
    focal_weight = (alpha * onehot + (1 - alpha) * (1 - onehot)) \
        * (1 - pt) ** gamma
    return _reduce((ce * focal_weight).sum(-1), weight, avg_factor)


def l1_loss(pred, target, weight=None, avg_factor=1.0):
    return _reduce(torch.abs(pred - target).sum(-1), weight, avg_factor)


def smooth_l1_loss(pred, target, weight=None, beta: float = 1.0,
                   avg_factor=1.0):
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)
    return _reduce(loss.sum(-1), weight, avg_factor)


def cross_entropy_loss(logits, targets, weight=None, avg_factor=1.0):
    """Softmax cross-entropy with integer labels; a negative label reads
    class 0 (``jnp.maximum(targets, 0)``)."""
    labels = torch.clamp(targets.long(), min=0)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1),
                           reduction="none").reshape(labels.shape)
    return _reduce(loss, weight, avg_factor)


def binary_cross_entropy_loss(logits, targets, weight=None, avg_factor=1.0):
    loss = _sigmoid_bce(logits, targets)
    if loss.dim() > 1:
        loss = loss.sum(-1)
    return _reduce(loss, weight, avg_factor)
