"""SECOND FPN neck over BEV maps (counterpart of ``sst_tpu/models/second.py``,
``SECONDFPN`` at upsample stride 1, in inference and train mode).

Maps are NCHW. A stride above 1 needs ``ConvTranspose``, whose flax kernel
layout ``convert.py`` does not map yet: it raises. The ``SECOND`` backbone is
not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sst_tpu_torch.models.layers import BatchNorm, Conv


class SECONDFPN(nn.Module):
    """Per level: a 1x1 conv without bias, BN (eps 1e-3), ReLU; the levels
    are concatenated along channels.

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
            if upsample_strides[i] > 1:
                raise NotImplementedError(
                    f"upsample stride {upsample_strides[i]} "
                    f"(ConvTranspose) is not ported")
            self.add_module(f"deblock_conv_{i}", Conv(
                in_channels[i], out_channels[i], 1, bias=False, dtype=dtype))
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
