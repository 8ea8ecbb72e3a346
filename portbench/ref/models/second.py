"""SECOND backbone and FPN neck over BEV maps (counterpart of
``sst_tpu/models/second.py``), in inference and train mode.

Maps are NCHW. ``SECOND``: per stage a strided 3x3 ``ConvNormAct`` and
``layer_nums`` more at stride 1, every stage's output kept. ``SECONDFPN``:
per level an upsample (a 1x1 conv at stride 1, a transposed conv with
kernel = stride above it), BN and ReLU; the levels are concatenated. flax's
``ConvTranspose`` kernel maps onto ``models/layers.py ConvTranspose``
transposed and flipped in both spatial axes (``convert.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from portbench.ref.models.layers import BatchNorm, Conv, ConvNormAct, \
    ConvTranspose


class SECOND(nn.Module):
    """``in_channels``: the width of the input map (the JAX module reads it
    from the input). Returns the list of the stages' outputs."""

    def __init__(self, in_channels: int,
                 out_channels: Sequence[int] = (128, 128, 256),
                 layer_nums: Sequence[int] = (3, 5, 5),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 dtype=torch.float32):
        super().__init__()
        stages = list(zip(out_channels, layer_nums, layer_strides))
        self.layer_nums = tuple(n for _, n, _ in stages)
        self.out_channels = tuple(out for out, _, _ in stages)
        c = in_channels
        for i, (out, n, s) in enumerate(stages):
            self.add_module(f"down_{i}", ConvNormAct(c, out, 3, stride=s,
                                                     dtype=dtype))
            for j in range(n):
                self.add_module(f"conv_{i}_{j}",
                                ConvNormAct(out, out, 3, dtype=dtype))
            c = out

    def forward(self, x, train: bool = False):
        outs = []
        for i, n in enumerate(self.layer_nums):
            x = getattr(self, f"down_{i}")(x, train)
            for j in range(n):
                x = getattr(self, f"conv_{i}_{j}")(x, train)
            outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    """Per level: an upsample without bias (a 1x1 conv at stride 1, a
    transposed conv with kernel = stride above it), BN (eps 1e-3), ReLU;
    the levels are concatenated along channels.

    ``in_channels``: the width of each input level (an int for one);
    ``dtype``: the compute dtype of the convs and norms."""

    def __init__(self, in_channels: int | Sequence[int],
                 out_channels: Sequence[int] = (384,),
                 upsample_strides: Sequence[int] = (1,),
                 dtype=torch.float32):
        super().__init__()
        if isinstance(in_channels, int):
            in_channels = (in_channels,)
        self.levels = min(len(in_channels), len(out_channels),
                          len(upsample_strides))
        for i in range(self.levels):
            s = upsample_strides[i]
            self.add_module(f"deblock_conv_{i}", ConvTranspose(
                in_channels[i], out_channels[i], s, dtype=dtype) if s > 1
                else Conv(in_channels[i], out_channels[i], 1, bias=False,
                          dtype=dtype))
            self.add_module(f"deblock_bn_{i}", BatchNorm(
                out_channels[i], eps=1e-3, dtype=dtype))
        self.out_channels = sum(out_channels[:self.levels])

    def forward(self, feats, train: bool = False):
        if not isinstance(feats, (list, tuple)):
            feats = [feats]
        ups = [torch.relu(getattr(self, f"deblock_bn_{i}")(
            getattr(self, f"deblock_conv_{i}")(x), train))
            for i, x in zip(range(self.levels), feats)]
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
