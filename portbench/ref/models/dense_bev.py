"""Dense-BEV backbone (counterpart of ``sst_tpu/models/dense_bev.py``).

z is packed into the feature dimension (learned z-embedding + max scatter
onto a BEV canvas), a dense 2D UNet runs over the canvas, and z is
re-injected when features are read back per voxel. Public tensors keep the
JAX package's layout: BEV maps are NHWC. The convolutions take NCHW-shaped
views of them (channels-last strides), so no copy is made at the module
boundary.

Each module takes the compute ``dtype`` of its flax counterpart: canvases,
maps and the one-hot band selections are in that dtype, the float32 z
embeddings are cast to it, and its MLPs and convs compute in it.

Two max conventions meet here. The canvas scatters below max onto zeros and
include that zero (JAX ``.at[].max`` onto a zero array), so they use
``include_self=True``; ``ops/segment.py segment_reduce`` does not. In the
backward both frameworks split the gradient of a tied maximum equally
among the rows that hold it, the zero init counted as one of them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.ref.models.layers import MLP, ConvNormAct
from portbench.ref.ops.segment import (
    INT_SENTINEL,
    gather_rows,
    unique_segments_canvas,
)


def _widen(x: torch.Tensor, slot: torch.Tensor, n_slots: int) -> torch.Tensor:
    """[n, c] rows → [n, n_slots * c] with row i in slot ``slot[i]`` and
    zeros elsewhere (the JAX package's one-hot product, without the
    multiply)."""
    n, c = x.shape
    out = x.new_zeros((n, n_slots, c))
    out[torch.arange(n, device=x.device), slot.long()] = x
    return out.reshape(n, n_slots * c)


def _pick(rows: torch.Tensor, slot: torch.Tensor, n_slots: int) -> torch.Tensor:
    """[n, n_slots * c] rows → [n, c], the slice ``slot[i]`` of row i."""
    n = rows.shape[0]
    return rows.reshape(n, n_slots, -1)[torch.arange(n, device=rows.device),
                                        slot.long()]


def _canvas(x: torch.Tensor, cell: torch.Tensor, valid: torch.Tensor,
            size: int) -> torch.Tensor:
    """Max-merge rows that share a cell into a compact site table (zero
    init included), then build the [size, C] canvas by an inverse-index row
    gather (``ops/segment.py gather_rows``); cells with no site read
    zero."""
    n = x.shape[0]
    cell_key = torch.where(valid, cell, size)
    uniq = unique_segments_canvas(cell_key, valid, num_segments=n,
                                  key_space=size)
    seg = uniq.seg_ids.long()
    # row n takes the invalid rows and is dropped
    sites = x.new_zeros((n + 1, x.shape[1])).scatter_reduce(
        0, seg[:, None].expand_as(x), x, "amax", include_self=True)[:n]
    site_valid = uniq.unique_keys != INT_SENTINEL
    inv = torch.full((size + 1,), n, dtype=torch.long, device=x.device)
    inv[torch.where(site_valid, uniq.unique_keys, size).long()] = torch.arange(
        n, device=x.device)
    return gather_rows(sites, inv[:size])


def _cells(coords, h: int, w: int):
    return (coords[:, 0] * h + coords[:, 2]) * w + coords[:, 3]


class BEVScatter(nn.Module):
    """Scatter per-voxel features onto a dense NHWC BEV canvas.

    z_groups=1: z is folded in through a learned embedding before a max over
    each xy column. z_groups=G>1: the z axis is split into G bands, each with
    its own channel slice (max only within a band); features are first
    projected to ``pre_channels``. An occupancy channel rides along, so the
    canvas has G * (c + 1) channels."""

    def __init__(self, in_channels: int, nz: int, z_groups: int = 1,
                 pre_channels: int = 0, dtype=torch.float32):
        super().__init__()
        self.nz = nz
        self.z_groups = z_groups
        c = in_channels
        self.pre = None
        if pre_channels:
            self.pre = MLP(in_channels, (pre_channels,), norm="ln",
                           dtype=dtype)
            c = pre_channels
        self.z_embed = nn.Parameter(torch.zeros(nz, c))
        self.out_channels = z_groups * (c + 1)

    def forward(self, feats, coords, valid, batch_size: int, grid_hw,
                train: bool = False):
        h, w = grid_hw
        g_n = self.z_groups
        x = feats
        if self.pre is not None:
            # >= 0: empty cells read zero
            x = torch.relu(self.pre(x, valid, train))
        z = torch.clamp(coords[:, 1], 0, self.nz - 1).long()
        x = x + self.z_embed[z].to(x.dtype)
        x = torch.cat([x, x.new_ones((x.shape[0], 1))], dim=-1)
        x = torch.where(valid[:, None], x, 0.0)
        if g_n > 1:
            x = _widen(x, (z * g_n) // self.nz, g_n)
        size = batch_size * h * w
        canvas = _canvas(x, _cells(coords, h, w), valid, size)
        return canvas.reshape(batch_size, h, w, -1)


class DenseBEVUNet(nn.Module):
    """2D BEV encoder-decoder with stride-2 downsamples and lateral adds.

    Takes and returns NHWC maps: the full-resolution output and every
    decoder map, deepest first."""

    def __init__(self, in_channels: int,
                 encoder_channels: tuple = ((64, 64), (128, 128), (256, 256),
                                            (256, 256)),
                 decoder_channels: tuple = (256, 128, 128),
                 out_channels: int = 128, dtype=torch.float32):
        super().__init__()
        self.encoder_channels = tuple(tuple(e) for e in encoder_channels)
        self.decoder_channels = tuple(decoder_channels)
        c = in_channels
        enc_widths = []
        for i, widths in enumerate(self.encoder_channels):
            for j, cch in enumerate(widths):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"enc_{i}_{j}",
                                ConvNormAct(c, cch, 3, stride=stride,
                                            dtype=dtype))
                c = cch
            enc_widths.append(c)
        n_enc = len(self.encoder_channels)
        for d, cch in enumerate(self.decoder_channels):
            skip = enc_widths[n_enc - 2 - d]
            self.add_module(f"up_{d}", ConvNormAct(c, cch, 3, dtype=dtype))
            self.add_module(f"lat_{d}", ConvNormAct(skip, cch, 1,
                                                    dtype=dtype))
            self.add_module(f"merge_{d}", ConvNormAct(cch, cch, 3,
                                                      dtype=dtype))
            c = cch
        self.out_conv = ConvNormAct(c, out_channels, 3, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        enc = []
        for i, widths in enumerate(self.encoder_channels):
            for j in range(len(widths)):
                x = getattr(self, f"enc_{i}_{j}")(x, train)
            enc.append(x)
        dec_maps = []
        x = enc[-1]
        n_enc = len(self.encoder_channels)
        for d in range(len(self.decoder_channels)):
            skip = enc[n_enc - 2 - d]
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"up_{d}")(x, train)
            lat = getattr(self, f"lat_{d}")(skip, train)
            x = getattr(self, f"merge_{d}")(x + lat, train)
            dec_maps.append(x)
        out = self.out_conv(x, train)
        return (out.permute(0, 2, 3, 1),
                [m.permute(0, 2, 3, 1) for m in dec_maps])


class DenseVoxelDecode(nn.Module):
    """Per-3D-voxel features from an NHWC BEV map: gather the voxel's xy
    cell (its own z band's slice when z_groups > 1), append a z embedding and
    fuse with an MLP."""

    def __init__(self, in_channels: int, nz: int, out_channels: int = 128,
                 z_groups: int = 1, group_channels: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.nz = nz
        self.z_groups = z_groups
        g_in = group_channels if z_groups > 1 else in_channels
        self.z_embed = nn.Parameter(torch.zeros(nz, 32))
        self.fuse = MLP(g_in + 32, (out_channels,), norm="ln", dtype=dtype)
        self.out_channels = out_channels

    def forward(self, bev, coords, valid, train: bool = False):
        b, h, w, c = bev.shape
        z = torch.clamp(coords[:, 1], 0, self.nz - 1).long()
        cell = torch.clamp(_cells(coords, h, w), 0, b * h * w - 1).long()
        # index_select: its backward adds repeated cells by index_add_
        # (the invalid voxels all read cell 0)
        rows = torch.index_select(bev.reshape(b * h * w, c), 0, cell)
        if self.z_groups > 1:
            rows = _pick(rows, (z * self.z_groups) // self.nz, self.z_groups)
        x = torch.cat([rows, self.z_embed[z].to(rows.dtype)], dim=-1)
        x = self.fuse(x, valid, train)
        return torch.where(valid[:, None], x, 0.0)


class DenseBEVMixer(nn.Module):
    """z-sliced scatter of virtual voxels onto the BEV grid (z kept as
    channel groups), a small 2D UNet, then a per-voxel z-slice gather and a
    projection back to per-voxel features."""

    def __init__(self, in_channels: int, nz: int, z_channels: int = 32,
                 output_channels: int = 128,
                 encoder_channels: tuple = ((128, 128), (128, 128)),
                 decoder_channels: tuple = (128,), dtype=torch.float32):
        super().__init__()
        self.nz = nz
        self.z_channels = z_channels
        self.pre = MLP(in_channels, (z_channels,), norm="ln", dtype=dtype)
        self.unet = DenseBEVUNet(nz * z_channels, encoder_channels,
                                 decoder_channels,
                                 out_channels=nz * z_channels, dtype=dtype)
        self.post = MLP(2 * z_channels, (output_channels,), norm="ln",
                        dtype=dtype)
        self.out_channels = output_channels

    def forward(self, feats, coords, valid, batch_size: int, grid_hw,
                train: bool = False):
        h, w = grid_hw
        # >= 0: empty cells read zero
        x = torch.relu(self.pre(feats, valid, train))
        z = torch.clamp(coords[:, 1], 0, self.nz - 1).long()
        cell = _cells(coords, h, w)
        size = batch_size * h * w
        xw = _widen(torch.where(valid[:, None], x, 0.0), z, self.nz)
        canvas = _canvas(xw, cell, valid, size).reshape(batch_size, h, w, -1)
        out2d, _ = self.unet(canvas, train)
        rows = torch.index_select(out2d.reshape(size, -1), 0,
                                  torch.clamp(cell, 0, size - 1).long())
        back = _pick(rows, z, self.nz)
        y = self.post(torch.cat([back, x], dim=-1), valid, train)
        return torch.where(valid[:, None], y, 0.0)
