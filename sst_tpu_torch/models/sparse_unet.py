"""SimpleSparseUNet (FSD's fully-sparse segmentation backbone) and FSDv2's
VirtualVoxelMixer (counterpart of ``sst_tpu/models/sparse_unet.py``).

Submanifold ``conv_input`` → encoder stages (a stride-2 sparse conv, then
submanifold convs) → symmetric decoder (lateral SparseBasicBlock, merge conv,
channel-reduce residual, SparseInverseConv upsample). The rulebooks of every
level are built once per forward by :func:`build_unet_plan` and shared by all
convs at that level. Modules keep flax's names so that
``sst_tpu_torch/convert.py`` maps a flax variable tree onto them.

``train=True`` takes batch statistics in every ``MaskedBatchNorm`` and runs
each conv through the sparse conv's autograd function
(``ops/sparse_conv.py``). With ``remat=True`` (flax's ``nn.remat``) every
conv layer and basic block that ``SimpleSparseUNet`` calls is rematerialised
in the backward (``utils/remat.py``); the mixer's ``conv_out`` is not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from sst_tpu_torch.models.layers import ACTIVATIONS, MaskedBatchNorm
from sst_tpu_torch.ops.sparse_conv import (
    ConvPlan,
    SparseGrid,
    build_conv_plans,
    downsample_grid,
    windowed_sparse_conv,
)
from sst_tpu_torch.utils import remat


@dataclass
class UNetPlan:
    levels: tuple  # SparseGrid per level, level 0 = input resolution
    subm: tuple  # ConvPlan per level
    down: tuple  # ConvPlan level l-1 → l, for l >= 1
    inv: tuple  # ConvPlan level l → l-1, for l >= 1


def build_unet_plan(sg0: SparseGrid, level_caps: Sequence[int],
                    strides: Sequence[tuple],
                    paddings: Sequence[tuple]) -> UNetPlan:
    """level_caps[0] must equal sg0.cap; one stride and padding for each
    downsample (len == num_levels - 1)."""
    if level_caps[0] != sg0.cap:
        raise ValueError(f"level_caps[0] = {level_caps[0]} but the input "
                         f"grid has {sg0.cap} slots")
    levels = [sg0]
    subm = [build_conv_plans(sg0, sg0, "subm")]
    down, inv = [], []
    for i, (s, p) in enumerate(zip(strides, paddings)):
        prev = levels[-1]
        nxt = downsample_grid(prev, level_caps[i + 1], s, p)
        levels.append(nxt)
        subm.append(build_conv_plans(nxt, nxt, "subm"))
        down.append(build_conv_plans(nxt, prev, "strided", s, p))
        inv.append(build_conv_plans(prev, nxt, "inverse", s, p))
    return UNetPlan(levels=tuple(levels), subm=tuple(subm), down=tuple(down),
                    inv=tuple(inv))


class SparseConvLayer(nn.Module):
    """Sparse conv (+ norm + act) over a precomputed rulebook; the weight is
    ``[taps, Cin, Cout]`` as in the JAX package, which takes the tap count
    from the table: 27 for a 3x3x3 conv, 3 for ``SparseEncoder``'s z-only
    ``conv_out``."""

    def __init__(self, in_channels: int, out_channels: int,
                 act: str = "relu", use_norm: bool = True, taps: int = 27):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(taps, in_channels,
                                               out_channels))
        nn.init.normal_(self.weight, 0.0, (taps * in_channels) ** -0.5)
        self.MaskedBatchNorm_0 = (MaskedBatchNorm(out_channels) if use_norm
                                  else None)
        self.act = ACTIVATIONS[act]

    def forward(self, feats, cp: ConvPlan, out_valid, train: bool = False):
        x = windowed_sparse_conv(feats, self.weight, cp)
        # masked before the norm and again after it: at inference the BN
        # bias makes padding rows non-zero in between
        x = torch.where(out_valid[:, None], x, 0.0)
        if self.MaskedBatchNorm_0 is not None:
            x = self.MaskedBatchNorm_0(x, out_valid, train)
        return torch.where(out_valid[:, None], self.act(x), 0.0)


class SparseBasicBlock(nn.Module):
    """ResNet basic block with submanifold convs."""

    def __init__(self, in_channels: int, channels: int, act: str = "relu"):
        super().__init__()
        self.conv1 = SparseConvLayer(in_channels, channels, act=act)
        self.conv2 = SparseConvLayer(channels, channels, act="none")
        self.downsample = (nn.Linear(in_channels, channels, bias=False)
                           if in_channels != channels else None)
        self.act = ACTIVATIONS[act]

    def forward(self, feats, cp: ConvPlan, valid, train: bool = False):
        x = self.conv1(feats, cp, valid, train)
        x = self.conv2(x, cp, valid, train)
        identity = feats if self.downsample is None else self.downsample(feats)
        return torch.where(valid[:, None], self.act(x + identity), 0.0)


class SimpleSparseUNet(nn.Module):
    """``in_channels`` is the width of the input features (the JAX module
    reads it from the input). ``output_channels`` is unused (no densify).
    ``remat`` rematerialises each conv layer and basic block in train mode;
    it changes nothing at inference."""

    def __init__(self, in_channels: int = 64, base_channels: int = 64,
                 output_channels: int = 128,
                 encoder_channels: tuple = ((64,), (64, 64, 64), (64, 64, 64),
                                            (128, 128, 128), (256, 256, 256)),
                 decoder_channels: tuple = ((256, 256, 128), (128, 128, 64),
                                            (64, 64, 64), (64, 64, 64),
                                            (64, 64, 64)),
                 act: str = "relu", return_multiscale: bool = False,
                 remat: bool = False):
        super().__init__()
        self.encoder_channels = tuple(tuple(c) for c in encoder_channels)
        self.decoder_channels = tuple(tuple(c) for c in decoder_channels)
        self.return_multiscale = return_multiscale
        self.remat = remat
        # width of each decoder output, deepest first
        self.decoder_widths = tuple(c[2] for c in self.decoder_channels)
        self.out_channels = self.decoder_widths[-1]
        self.conv_input = SparseConvLayer(in_channels, base_channels, act=act)
        c = base_channels
        enc_widths = []
        for i, blocks in enumerate(self.encoder_channels):
            for j, out in enumerate(blocks):
                name = (f"encoder_{i}_{j}_down" if i != 0 and j == 0
                        else f"encoder_{i}_{j}")
                self.add_module(name, SparseConvLayer(c, out, act=act))
                c = out
            enc_widths.append(c)
        num_stages = len(self.encoder_channels)
        for d, chans in enumerate(self.decoder_channels):
            s = num_stages - d
            lat_in = enc_widths[s - 1]
            self.add_module(f"lateral_{s}",
                            SparseBasicBlock(lat_in, chans[0], act=act))
            self.add_module(f"merge_{s}",
                            SparseConvLayer(c + chans[0], chans[1], act=act))
            self.add_module(f"upsample_{s}",
                            SparseConvLayer(chans[1], chans[2], act=act))
            c = chans[2]

    def _call(self, name: str, x, cp: ConvPlan, valid, train: bool):
        mod = getattr(self, name)
        if self.remat and train and torch.is_grad_enabled():
            return remat.checkpoint(mod, x, cp, valid, train)
        return mod(x, cp, valid, train)

    def forward(self, feats, plan: UNetPlan, train: bool = False):
        num_stages = len(self.encoder_channels)
        x = self._call("conv_input", feats, plan.subm[0],
                       plan.levels[0].valid, train)
        encode = []
        for i, blocks in enumerate(self.encoder_channels):
            for j in range(len(blocks)):
                if i != 0 and j == 0:  # strided conv: level i-1 → i
                    x = self._call(f"encoder_{i}_{j}_down", x,
                                   plan.down[i - 1], plan.levels[i].valid,
                                   train)
                else:
                    x = self._call(f"encoder_{i}_{j}", x, plan.subm[i],
                                   plan.levels[i].valid, train)
            encode.append(x)

        decode = []
        x = encode[-1]
        for d, chans in enumerate(self.decoder_channels):
            s = num_stages - d
            lvl = s - 1
            lateral = self._call(f"lateral_{s}", encode[lvl],
                                 plan.subm[lvl], plan.levels[lvl].valid,
                                 train)
            cat = torch.cat([x, lateral], dim=-1)
            merge = self._call(f"merge_{s}", cat, plan.subm[lvl],
                               plan.levels[lvl].valid, train)
            # channel-reduce residual: sums groups of consecutive channels
            n, cin = cat.shape
            x = merge + cat.reshape(n, chans[1], cin // chans[1]).sum(-1)
            if s != 1:
                x = self._call(f"upsample_{s}", x, plan.inv[lvl - 1],
                               plan.levels[lvl - 1].valid, train)
            else:
                x = self._call(f"upsample_{s}", x, plan.subm[0],
                               plan.levels[0].valid, train)
            decode.append(x)

        out = {
            "voxel_feats": decode[-1],
            "voxel_coords": plan.levels[0].coords,
            "voxel_valid": plan.levels[0].valid,
        }
        if self.return_multiscale:
            out["decoder_features"] = decode
        return out


class VirtualVoxelMixer(nn.Module):
    """FSDv2's small sparse UNet over the virtual-voxel grid + submanifold
    ``conv_out``. ``in_channels`` is the width of the union features."""

    def __init__(self, in_channels: int, base_channels: int = 64,
                 output_channels: int = 128,
                 encoder_channels: tuple = ((64,), (64, 64), (64, 64)),
                 decoder_channels: tuple = ((64, 64, 64), (64, 64, 64),
                                            (64, 64, 64)),
                 act: str = "relu", remat: bool = False):
        super().__init__()
        self.unet = SimpleSparseUNet(
            in_channels, base_channels=base_channels,
            encoder_channels=encoder_channels,
            decoder_channels=decoder_channels, act=act, remat=remat)
        self.conv_out = SparseConvLayer(self.unet.out_channels,
                                        output_channels, act=act)
        self.out_channels = output_channels

    def forward(self, feats, plan: UNetPlan, train: bool = False):
        out = self.unet(feats, plan, train)
        return self.conv_out(out["voxel_feats"], plan.subm[0],
                             plan.levels[0].valid, train)
