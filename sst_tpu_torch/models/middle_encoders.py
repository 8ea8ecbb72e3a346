"""Densifying middle encoders (counterpart of
``sst_tpu/models/middle_encoders.py``): ``PointPillarsScatter`` (pillar
features onto a BEV pseudo-image) and SECOND's ``SparseEncoder`` (a
submanifold ``conv_input``, four encoder stages with stride-2 downsamples,
the z-only (3, 1, 1) stride-(2, 1, 1) ``conv_out``, then the densify).

Both return NCHW BEV maps for ``models/second.py``; the channels of
``SparseEncoder``'s map are ordered ``z * C + c``, JAX's NHWC order. The
encoder's tables are the rulebook's (``ops/sparse_conv.py``, from the
sorted keys); the z-only ``conv_out``, the one non-cubic kernel of the
stack, has its own table builder here. Every conv runs through
``ops/sparse_conv.py windowed_sparse_conv``: on CUDA tensors the
hand-written conv kernel, and in training its input-gradient and
weight-gradient kernels, at 27 taps and at the ``conv_out``'s 3 (mode
``"zdown"``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sst_tpu_torch.models.sparse_unet import SparseConvLayer
from sst_tpu_torch.ops.sparse_conv import (
    ConvPlan,
    SparseGrid,
    downsample_grid,
    nbr_from_targets,
    strided_neighbor_table,
    subm_neighbor_table,
)


def _scatter_rows(rows: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                  size: int) -> torch.Tensor:
    """[size, C] zeros with row ``idx[i]`` set to ``rows[i]`` where
    ``valid[i]`` (the others go to one extra row that is sliced off);
    differentiable in ``rows``."""
    idx = torch.where(valid, idx.long(), size)
    out = rows.new_zeros((size + 1, rows.shape[-1]))
    out = out.index_put((idx,), torch.where(valid[:, None], rows, 0.0))
    return out[:size]


class PointPillarsScatter(nn.Module):
    """Pillar features [P, C] at coords [P, 4] (b, _, y, x) with a validity
    mask → [B, C, ny, nx] (no parameters)."""

    def __init__(self, in_channels: int, output_shape: tuple,
                 batch_size: int = 1):
        super().__init__()
        self.in_channels = in_channels
        self.output_shape = tuple(output_shape)
        self.batch_size = batch_size

    def forward(self, pillar_features, coors, valid):
        ny, nx = self.output_shape
        b = self.batch_size
        idx = (coors[:, 0].long() * ny + coors[:, 2]) * nx + coors[:, 3]
        canvas = _scatter_rows(pillar_features, idx, valid, b * ny * nx)
        return canvas.reshape(b, ny, nx, -1).permute(0, 3, 1, 2).contiguous()


def zdown_grid_and_table(in_sg: SparseGrid, cap_out: int, kz: int = 3,
                         sz: int = 2):
    """Output grid and ``[kz, Vout]`` table of the z-only strided conv
    (kernel (kz, 1, 1), stride (sz, 1, 1), no padding): output (b, o, y, x)
    exists where an input site lies at z in [o*sz, o*sz + kz), and its tap
    k reads the input site at (b, o*sz + k, y, x) (``in_sg.cap`` where
    there is none). The grid is ``downsample_grid``'s, so outputs past
    ``cap_out`` are dropped, and the table is found in the sorted input
    keys. Returns (out_sg with grid (oz, ny, nx), nbr)."""
    nz, ny, nx = in_sg.grid
    out_sg = downsample_grid(in_sg, cap_out, (sz, 1, 1), (0, 0, 0),
                             (kz, 1, 1))
    b, o, y, x = out_sg.coords.long().unbind(-1)
    z = o * sz + torch.arange(kz, device=o.device)[:, None]
    key = ((b * nz + z) * ny + y) * nx + x
    tfull = torch.where(out_sg.valid, key, -1).to(torch.int32)
    return out_sg, nbr_from_targets(tfull, in_sg.keys, in_sg.cap)


class SparseEncoder(nn.Module):
    """SECOND's densifying sparse encoder: voxel features [V, Cin] on a
    SparseGrid at the sparse shape → NCHW BEV map [B, oz * C_out, ny/8,
    nx/8] (channel ``z * C_out + c``). Each downsample's level holds
    ``max(128, int(cap0 * level_cap_ratios[i]))`` sites. A forward runs
    ``conv_input``, the encoder convs (one strided per stage after the
    first) and ``conv_out``; every subm conv of a level shares its plan.
    float32 only: the conv kernels have no bf16 route."""

    def __init__(self, in_channels: int, base_channels: int = 16,
                 output_channels: int = 128,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16,), (32, 32, 32), (64, 64, 64), (64, 64, 64)),
                 encoder_paddings: Sequence[Sequence] = (
                     (1,), (1, 1, 1), (1, 1, 1), ((0, 1, 1), 1, 1)),
                 level_cap_ratios: Sequence[float] = (1.0, 0.75, 0.5, 0.35),
                 dtype=torch.float32):
        super().__init__()
        if dtype != torch.float32:
            raise NotImplementedError(
                "SparseEncoder at a compute dtype other than float32 "
                "(ROADMAP queue 1 item 11b)")
        self.encoder_channels = tuple(tuple(c) for c in encoder_channels)
        self.encoder_paddings = tuple(tuple(p) for p in encoder_paddings)
        self.level_cap_ratios = tuple(level_cap_ratios)
        self.conv_input = SparseConvLayer(in_channels, base_channels)
        c = base_channels
        for i, blocks in enumerate(self.encoder_channels):
            for j, out in enumerate(blocks):
                name = (f"encoder_{i}_{j}_down" if i != 0 and j == 0
                        else f"encoder_{i}_{j}")
                self.add_module(name, SparseConvLayer(c, out))
                c = out
        self.conv_out = SparseConvLayer(c, output_channels, taps=3)
        self.output_channels = output_channels

    def forward(self, voxel_features, sg: SparseGrid, train: bool = False):
        cap0 = sg.cap
        cur = ConvPlan(nbr=subm_neighbor_table(sg), mode="subm")
        x = self.conv_input(voxel_features, cur, sg.valid, train)
        cur_sg = sg
        for i, blocks in enumerate(self.encoder_channels):
            for j in range(len(blocks)):
                if i != 0 and j == 0:
                    pad = self.encoder_paddings[i][0]
                    pad = (pad,) * 3 if isinstance(pad, int) else tuple(pad)
                    cap = max(128, int(cap0 * self.level_cap_ratios[i]))
                    nxt = downsample_grid(cur_sg, cap, (2, 2, 2), pad)
                    down = ConvPlan(nbr=strided_neighbor_table(
                        nxt, cur_sg, (2, 2, 2), pad), mode="strided")
                    x = getattr(self, f"encoder_{i}_{j}_down")(
                        x, down, nxt.valid, train)
                    cur_sg = nxt
                    cur = ConvPlan(nbr=subm_neighbor_table(cur_sg),
                                   mode="subm")
                else:
                    x = getattr(self, f"encoder_{i}_{j}")(x, cur, cur_sg.valid,
                                                          train)
        out_sg, znbr = zdown_grid_and_table(cur_sg, cur_sg.cap)
        x = self.conv_out(x, ConvPlan(nbr=znbr, mode="zdown"), out_sg.valid,
                          train)
        oz, ny, nx = out_sg.grid
        b = out_sg.batch_size
        c = out_sg.coords.long()
        idx = ((c[:, 0] * oz + c[:, 1]) * ny + c[:, 2]) * nx + c[:, 3]
        dense = _scatter_rows(x, idx, out_sg.valid, b * oz * ny * nx)
        return dense.reshape(b, oz, ny, nx, -1).permute(0, 1, 4, 2, 3) \
            .reshape(b, oz * x.shape[-1], ny, nx)
