"""Shared NN building blocks (counterpart of ``sst_tpu/models/layers.py``).

Submodules keep flax's automatic names (``Dense_0``, ``LayerNorm_0``,
``MaskedBatchNorm_0``, ``Conv_0``, ``BatchNorm_0``) so that
``sst_tpu_torch/convert.py`` maps a flax variable tree onto these modules
name for name. Only the inference (running-statistics) path of batch norm is
ported; ``train=True`` raises.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax gelu default
    "silu": F.silu,
    "swish": F.silu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "none": lambda x: x,
}


def require_inference(train: bool) -> None:
    if train:
        raise NotImplementedError(
            "sst_tpu_torch ports the inference path only (train=False)")


class BatchNorm(nn.Module):
    """Batch norm over dim 1 with running statistics (flax ``BatchNorm`` in
    eval mode; eps 1e-3 as in ``ConvNormAct``)."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, train: bool = False):
        require_inference(train)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class MaskedBatchNorm(BatchNorm):
    """BatchNorm over rows of [N, C]. At inference the running statistics
    normalise every row, so the validity mask is not read."""

    def forward(self, x, mask=None, train: bool = False):
        return super().forward(x, train)


class MLP(nn.Module):
    """Linear + norm + activation stack (reference build_mlp)."""

    def __init__(self, in_channels: int, hidden: Sequence[int],
                 act: str = "relu", norm: str = "bn", is_head: bool = False,
                 bias: bool = False):
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
            self.add_module(f"Dense_{i}", nn.Linear(c_in, c, bias=use_bias))
            if not (last and is_head):
                if norm == "bn":
                    self.add_module(f"MaskedBatchNorm_{i}", MaskedBatchNorm(c))
                elif norm == "ln":
                    self.add_module(f"LayerNorm_{i}", nn.LayerNorm(c, eps=1e-6))
            c_in = c
        self.out_channels = c_in

    def forward(self, x, mask=None, train: bool = False):
        require_inference(train)
        for i in range(self.depth):
            x = getattr(self, f"Dense_{i}")(x)
            if i == self.depth - 1 and self.is_head:
                break
            if self.norm == "bn":
                x = getattr(self, f"MaskedBatchNorm_{i}")(x, mask)
            elif self.norm == "ln":
                x = getattr(self, f"LayerNorm_{i}")(x)
            x = self.act(x)
        return x


class ConvNormAct(nn.Module):
    """Conv2d + BN + activation over NCHW maps, with flax's symmetric
    padding ``dilation * (kernel_size - 1) // 2``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, act: str = "relu",
                 use_norm: bool = True):
        super().__init__()
        pad = dilation * (kernel_size - 1) // 2
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel_size,
                                stride=stride, padding=pad, dilation=dilation,
                                bias=not use_norm)
        self.BatchNorm_0 = BatchNorm(features) if use_norm else None
        self.act = ACTIVATIONS[act]

    def forward(self, x, train: bool = False):
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, train)
        else:
            require_inference(train)
        return self.act(x)
