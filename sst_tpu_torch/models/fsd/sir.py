"""SIR — Sparse Instance Recognition backbone, cluster-wise PointNets
(counterpart of ``sst_tpu/models/fsd/sir.py``).

Each block decorates its points (xyz over ``xyz_normalizer``, the rest as
it is), gates them by an MLP of the offset to the cluster centre, then runs
its VFE layers: a Linear + LayerNorm + GELU per layer, a segment max per
cluster, the pooled feature broadcast back and concatenated between layers.
The backbone concatenates every block's pooled features. All segment ops
share one precomputed cluster assignment (seg_ids [N] -> cluster slots).

The flax modules infer their input widths; here ``in_channels`` is the
width of the block's input rows (xyz first), and :class:`SIR` derives each
block's from the point width and the previous block's output.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sst_tpu_torch.models.layers import MLP
from sst_tpu_torch.ops.segment import gather_segments, segment_reduce


class SIRLayer(nn.Module):
    """One SIR block: decorate → rel-MLP gate → VFE layers with pool and
    broadcast between them, and the shortcut where the widths agree.
    Returns (point_feats, cluster_feats). The JAX module's switches
    (``with_rel_mlp``, ``with_cluster_center``, ``with_shortcut``,
    ``rel_dist_scaler``) keep their defaults here: no config sets them."""

    def __init__(self, in_channels: int,
                 feat_channels: Sequence[int] = (128, 128),
                 rel_mlp_hidden: Sequence[int] = (16, 32), mode: str = "max",
                 xyz_normalizer: tuple = (20.0, 20.0, 4.0), norm: str = "ln",
                 act: str = "gelu", dtype=torch.float32):
        super().__init__()
        self.feat_channels = tuple(feat_channels)
        self.mode = mode
        # a buffer moves with the module: no copy to the card per call
        self.register_buffer("normalizer", torch.tensor(
            xyz_normalizer, dtype=torch.float32), persistent=False)
        self.rel_mlp = MLP(3, tuple(rel_mlp_hidden) + (in_channels,),
                           act=act, norm=norm, dtype=dtype)
        c = in_channels
        for i, out in enumerate(self.feat_channels):
            self.add_module(f"vfe_{i}", MLP(c, (out,), act=act, norm=norm,
                                            dtype=dtype))
            c = 2 * out
        self.out_channels = self.feat_channels[-1]
        self.cluster_channels = sum(self.feat_channels)

    def forward(self, feats, f_cluster, seg_ids, num_clusters: int, valid,
                train: bool = False):
        """feats: [N, 3+C] (xyz first); f_cluster: [N, 3] offsets to the
        cluster centre; seg_ids: [N] cluster slot per point."""
        base = torch.cat([feats[:, :3] / self.normalizer, feats[:, 3:]],
                         dim=-1)
        shortcut = feats[:, 3:]
        # the gate reads the offset to the cluster centre over 10 m
        x = base * self.rel_mlp(f_cluster / 10.0, valid, train)
        x = torch.where(valid[:, None], x, 0.0)

        pooled_list = []
        for i in range(len(self.feat_channels)):
            x = getattr(self, f"vfe_{i}")(x, valid, train)
            x = torch.where(valid[:, None], x, 0.0)
            pooled = segment_reduce(x, seg_ids, num_clusters, self.mode)
            pooled_list.append(pooled)
            if i != len(self.feat_channels) - 1:
                x = torch.cat([x, gather_segments(pooled, seg_ids)], dim=-1)
                x = torch.where(valid[:, None], x, 0.0)
        # each VFE layer's pooled feature is kept
        cluster_feats = torch.cat(pooled_list, dim=-1)
        if x.shape == shortcut.shape:
            x = x + shortcut
        return x, cluster_feats


class SIR(nn.Module):
    """Stack of SIRLayers; concatenates every block's cluster features.

    ``point_channels`` is the width of the raw point rows (xyz + extras)
    and ``feat_channels_in`` that of the features fed to block 0. The JAX
    module's ``in_channels`` is read by no layer (flax infers the widths);
    it is accepted and ignored, as there."""

    def __init__(self, point_channels: int, feat_channels_in: int,
                 num_blocks: int = 3, in_channels: Sequence[int] = (),
                 feat_channels: Sequence[Sequence[int]] = ((128, 128),) * 3,
                 rel_mlp_hidden: Sequence[Sequence[int]] = ((16, 32),) * 3,
                 mode: str = "max",
                 xyz_normalizer: tuple = (20.0, 20.0, 4.0),
                 norm: str = "ln", act: str = "gelu", dtype=torch.float32):
        super().__init__()
        del in_channels
        self.num_blocks = num_blocks
        c = feat_channels_in
        self.cluster_channels = 0
        for i in range(num_blocks):
            block = SIRLayer(point_channels + c,
                             feat_channels=tuple(feat_channels[i]),
                             rel_mlp_hidden=tuple(rel_mlp_hidden[i]),
                             mode=mode, xyz_normalizer=xyz_normalizer,
                             norm=norm, act=act, dtype=dtype)
            self.add_module(f"block_{i}", block)
            c = block.out_channels
            # the shortcut keeps the width, so the next block sees c
            self.cluster_channels += block.cluster_channels
        self.out_channels = c

    def forward(self, points, feats, f_cluster, seg_ids, num_clusters: int,
                valid, train: bool = False):
        """points: [N, 3+] raw point columns (xyz + intensity, elongation)."""
        out_feats = feats
        cluster_list = []
        for i in range(self.num_blocks):
            x = torch.cat([points, out_feats], dim=-1)
            out_feats, cfeat = getattr(self, f"block_{i}")(
                x, f_cluster, seg_ids, num_clusters, valid, train)
            cluster_list.append(cfeat)
        return out_feats, torch.cat(cluster_list, dim=-1)
