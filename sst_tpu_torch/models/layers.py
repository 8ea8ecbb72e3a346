"""Shared NN building blocks (counterpart of ``sst_tpu/models/layers.py``).

Submodules keep flax's automatic names (``Dense_0``, ``LayerNorm_0``,
``MaskedBatchNorm_0``, ``Conv_0``, ``BatchNorm_0``) so that
``sst_tpu_torch/convert.py`` maps a flax variable tree onto these modules
name for name. Every module takes ``train=True``: the batch norms then
normalise with the batch's statistics and move their running statistics
by flax's rule.

Every module takes a compute ``dtype``, as its flax counterpart does, and
keeps its parameters and running statistics in float32 (flax's
``param_dtype``). :class:`Dense` and :class:`Conv` cast their input, kernel
and bias to ``dtype`` before the product; the norms compute in float32 and
cast their result to ``dtype``. The same code computes every dtype: at
float32 the casts do nothing and the bias is added after the product, as
flax adds it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sst_tpu_torch.utils import remat

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``gelu`` (the tanh form) in ``x``'s dtype. Below float32 it is
    evaluated op by op as ``jax.nn.gelu`` writes it, each op rounded to the
    dtype (``x * x * x`` as JAX's integer power, two products); a fused
    ``F.gelu`` computes in float32 and rounds once, which differs from
    JAX's bfloat16 result on ~40% of inputs."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c = torch.tensor(_SQRT_2_OVER_PI, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * (x * x))))))


ACTIVATIONS = {
    "relu": F.relu,
    "gelu": gelu,  # flax gelu default
    "silu": F.silu,
    "swish": F.silu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "none": lambda x: x,
}


class Dense(nn.Linear):
    """flax ``nn.Dense`` at a compute ``dtype``: input, kernel and bias are
    cast to ``dtype``, and the bias is added to the rounded product as a
    separate add, so a bfloat16 result rounds twice, as flax's does (a
    fused ``F.linear`` with a bias rounds once and misses flax's bits on
    about a quarter of the outputs)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` (NCHW here) at a compute ``dtype``: input, kernel and
    bias cast to ``dtype``, the bias added to the rounded product."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x):
        y = self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype),
                               None)
        if self.bias is None:
            return y
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` at a compute ``dtype``: statistics and the
    normalised result in float32, cast to ``dtype``."""

    def __init__(self, normalized_shape, eps: float = 1e-6,
                 dtype=torch.float32):
        super().__init__(normalized_shape, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class BatchNorm(nn.Module):
    """Batch norm over dim 1 (flax ``nn.BatchNorm(momentum=0.99,
    epsilon=1e-3)`` as ``ConvNormAct`` and ``SECONDFPN`` use it).

    At inference the running statistics normalise. In train mode the
    statistics of each channel are taken over every other dim (N, H, W of
    an NCHW map), as flax does: the mean, and the biased variance
    ``E[x^2] - E[x]^2`` clamped at 0; the running statistics move by
    ``r = 0.99 r + 0.01 batch`` (``F.batch_norm`` would update them with the
    unbiased variance and torch's momentum). The update is skipped while a
    rematerialised call is recomputed in the backward (``utils/remat.py``),
    where JAX discards it. The statistics and the normalised result are
    float32 whatever the input's dtype; the result is cast to ``dtype``
    (at inference ``F.batch_norm`` takes a bfloat16 input with the float32
    statistics and computes in float32)."""

    momentum = 0.99

    def __init__(self, num_features: int, eps: float = 1e-3,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(self.dtype)
        x = x.float()
        dims = [d for d in range(x.dim()) if d != 1]
        mean = x.mean(dims)
        var = torch.clamp(torch.square(x).mean(dims) - torch.square(mean),
                          min=0.0)
        self._update_running(mean, var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape)).to(self.dtype)

    def _update_running(self, mean, var) -> None:
        if remat.recomputing():
            return
        with torch.no_grad():
            self.running_mean.copy_(self.momentum * self.running_mean
                                    + (1 - self.momentum) * mean)
            self.running_var.copy_(self.momentum * self.running_var
                                   + (1 - self.momentum) * var)


class MaskedBatchNorm(BatchNorm):
    """BatchNorm over rows of [N, C] with a validity mask (``sst_tpu``'s
    ``MaskedBatchNorm``). At inference the running statistics normalise
    every row, so the mask is not read. In train mode the statistics are
    taken over the valid rows only (``mask`` None: every row), with the
    biased variance, all in float32, and the running statistics move as
    :class:`BatchNorm`'s do."""

    def forward(self, x, mask=None, train: bool = False):
        if not train:
            return super().forward(x)
        x = x.float()
        if mask is None:
            m = x.new_ones((x.shape[0], 1))
        else:
            m = mask.float()[:, None]
        n = torch.clamp(m.sum(), min=1.0)
        mean = (x * m).sum(0) / n
        var = torch.clamp((torch.square(x) * m).sum(0) / n
                          - torch.square(mean), min=0.0)
        self._update_running(mean, var)
        return ((x - mean) * torch.rsqrt(var + self.eps) * self.weight
                + self.bias).to(self.dtype)


class MLP(nn.Module):
    """Linear + norm + activation stack (reference build_mlp)."""

    def __init__(self, in_channels: int, hidden: Sequence[int],
                 act: str = "relu", norm: str = "bn", is_head: bool = False,
                 bias: bool = False, dtype=torch.float32):
        super().__init__()
        if norm not in ("bn", "ln", "none"):
            raise NotImplementedError(f"norm={norm!r}")
        self.act = ACTIVATIONS[act]
        self.norm = norm
        self.is_head = is_head
        self.depth = len(hidden)
        c_in = in_channels
        for i, c in enumerate(hidden):
            last = i == len(hidden) - 1
            use_bias = True if (last and is_head) else bias
            self.add_module(f"Dense_{i}", Dense(c_in, c, bias=use_bias,
                                                dtype=dtype))
            if not (last and is_head):
                if norm == "bn":
                    self.add_module(f"MaskedBatchNorm_{i}",
                                    MaskedBatchNorm(c, dtype=dtype))
                elif norm == "ln":
                    self.add_module(f"LayerNorm_{i}",
                                    LayerNorm(c, eps=1e-6, dtype=dtype))
            c_in = c
        self.out_channels = c_in

    def forward(self, x, mask=None, train: bool = False):
        for i in range(self.depth):
            x = getattr(self, f"Dense_{i}")(x)
            if i == self.depth - 1 and self.is_head:
                break
            if self.norm == "bn":
                x = getattr(self, f"MaskedBatchNorm_{i}")(x, mask, train)
            elif self.norm == "ln":
                x = getattr(self, f"LayerNorm_{i}")(x)
            x = self.act(x)
        return x


class ConvNormAct(nn.Module):
    """Conv2d + BN + activation over NCHW maps, with flax's symmetric
    padding ``dilation * (kernel_size - 1) // 2``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, act: str = "relu",
                 use_norm: bool = True, dtype=torch.float32):
        super().__init__()
        pad = dilation * (kernel_size - 1) // 2
        self.Conv_0 = Conv(in_channels, features, kernel_size, stride=stride,
                           padding=pad, dilation=dilation, bias=not use_norm,
                           dtype=dtype)
        self.BatchNorm_0 = (BatchNorm(features, dtype=dtype) if use_norm
                            else None)
        self.act = ACTIVATIONS[act]

    def forward(self, x, train: bool = False):
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, train)
        return self.act(x)
