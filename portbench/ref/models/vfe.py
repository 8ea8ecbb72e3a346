"""Voxel feature encoders (counterpart of ``sst_tpu/models/vfe.py``): the
dynamic ``DynamicVFE`` and ``DynamicPillarFeatureNet``, and over hard
voxels ([V, T, C] from ``ops/voxelize.py hard_voxelize``) ``HardSimpleVFE``
and PointPillars' ``PillarFeatureNet``.

``DynamicVFE``: per-point decoration (cluster-centre and voxel-centre
offsets), then per layer: Linear + BN + ReLU, a per-voxel max (or mean)
and a broadcast concat. With ``use_sorted_reduce=True`` and a sort-based
voxel mapping (``vm.unique.order`` present), rows are gathered into voxel
order once, the segments' row offsets are computed once, and every
per-voxel reduction goes through the sorted segment reduce kernel over them
(``ops/sorted_reduce.py``); otherwise the reductions are scatters
(``ops/segment.py``). The decoration runs in float32 (the cluster-centre
sum among it); its result is cast to the compute ``dtype``, so the layers'
maxima reduce rows of that dtype. Gradients follow JAX on each path: a
scatter max splits a tie evenly among the rows that hold the maximum, the
sorted reduce's max hands it to the first of them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from portbench.ref.models.layers import Dense, MaskedBatchNorm
from portbench.ref.ops.segment import gather_segments, segment_reduce
from portbench.ref.ops.sorted_reduce import (
    segment_offsets,
    sorted_segment_reduce,
)
from portbench.ref.ops.voxelize import VoxelMapping


def _decorate(points, valid, seg_ids, counts, coords, reduce_fn,
              point_cloud_range, voxel_size, with_cluster_center,
              with_voxel_center, with_distance, extra_sum=None):
    """Append cluster-centre and voxel-centre offsets to raw point features.
    Works in any consistent row order.

    ``extra_sum`` [N, E]: extra per-point channels whose per-voxel sum the
    caller needs; they ride the cluster-centre sum pass. Returns
    (decorated_points, aux) with aux['cluster_mean'] [V, 3] and
    aux['extra_sum'] [V, E] when requested."""
    feats = [points]
    xyz = points[:, :3]
    aux = {}
    if with_cluster_center or extra_sum is not None:
        cols = xyz if extra_sum is None else torch.cat(
            [xyz, torch.where(valid[:, None], extra_sum, 0.0)], dim=-1)
        vox_sum = reduce_fn(cols.contiguous(), "sum")
        vox_mean = vox_sum[:, :3] / torch.clamp(counts, min=1).to(
            vox_sum.dtype)[:, None]
        aux["cluster_mean"] = vox_mean
        if extra_sum is not None:
            aux["extra_sum"] = vox_sum[:, 3:]
        if with_cluster_center:
            feats.append(xyz - gather_segments(vox_mean, seg_ids))
    if with_voxel_center:
        vs = torch.tensor(voxel_size, dtype=torch.float32, device=xyz.device)
        pcr = torch.tensor(point_cloud_range[:3], dtype=torch.float32,
                           device=xyz.device)
        centers = (coords[:, [3, 2, 1]].float() + 0.5) * vs + pcr
        feats.append(xyz - centers)
    if with_distance:
        feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
    out = torch.cat(feats, dim=-1)
    return torch.where(valid[:, None], out, 0.0), aux


class DynamicVFELayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_channels, out_channels, bias=False,
                             dtype=dtype)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels, dtype=dtype)

    def forward(self, x, mask, train: bool = False):
        return torch.relu(self.MaskedBatchNorm_0(self.Dense_0(x), mask, train))


class DynamicVFE(nn.Module):
    """Point→voxel encoder. Returns voxel features [V, C_out]; with
    ``extra_sum`` returns (voxel_feats, aux), see :func:`_decorate`. With
    ``return_point_feats`` it returns the last layer's point features
    [N, C_out] in their place (on the scatter route).

    ``in_channels`` is the width of the raw point rows (xyz first).
    ``sorted_calls`` counts the forwards that took the sorted path."""

    def __init__(self, in_channels: int,
                 feat_channels: Sequence[int] = (64, 128),
                 with_cluster_center: bool = True,
                 with_voxel_center: bool = True, with_distance: bool = False,
                 voxel_size: tuple = (0.32, 0.32, 6.0),
                 point_cloud_range: tuple = (-74.88, -74.88, -2, 74.88, 74.88,
                                             4),
                 mode: str = "max", return_point_feats: bool = False,
                 use_sorted_reduce: bool = False, dtype=torch.float32):
        super().__init__()
        if mode not in ("max", "mean", "sum"):
            raise NotImplementedError(f"mode={mode!r}")
        self.feat_channels = tuple(feat_channels)
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        self.with_distance = with_distance
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.mode = mode
        self.use_sorted_reduce = use_sorted_reduce
        self.return_point_feats = return_point_feats
        self.dtype = dtype
        self.sorted_calls = 0
        c = (in_channels + 3 * with_cluster_center + 3 * with_voxel_center
             + int(with_distance))
        for i, out in enumerate(self.feat_channels):
            self.add_module(f"DynamicVFELayer_{i}",
                            DynamicVFELayer(c, out, dtype))
            c = 2 * out
        self.out_channels = self.feat_channels[-1]

    def sorted_path(self, vm: VoxelMapping) -> bool:
        """The sorted reduce's route; never with ``return_point_feats``,
        whose point rows stay in their own order (JAX's ``_sorted_path``)."""
        return (self.use_sorted_reduce and not self.return_point_feats
                and vm.unique.order is not None)

    def forward(self, points, vm: VoxelMapping, train: bool = False,
                extra_sum=None):
        num_vox = vm.num_voxel_slots
        counts = vm.unique.counts
        if self.sorted_path(vm):
            self.sorted_calls += 1
            order = vm.unique.order
            points = points[order]
            valid = vm.valid[order]
            seg = vm.point_seg_ids[order]
            coords = vm.coords[order]
            if extra_sum is not None:
                extra_sum = extra_sum[order]
            # read only by the kernel: a CPU tensor's twin finds its rows
            offsets = segment_offsets(seg, num_vox) if seg.is_cuda else None

            def reduce_fn(x, mode):
                if mode == "mean":
                    s = sorted_segment_reduce(x, seg, num_vox, "sum", offsets)
                    return s / torch.clamp(counts, min=1).to(s.dtype)[:, None]
                return sorted_segment_reduce(x, seg, num_vox, mode, offsets)
        else:
            valid, seg, coords = vm.valid, vm.point_seg_ids, vm.coords

            def reduce_fn(x, mode):
                return segment_reduce(x, seg, num_vox, mode)

        x, aux = _decorate(points, valid, seg, counts, coords, reduce_fn,
                           self.point_cloud_range, self.voxel_size,
                           self.with_cluster_center, self.with_voxel_center,
                           self.with_distance, extra_sum=extra_sum)
        point_feats = x.to(self.dtype)
        n_layers = len(self.feat_channels)
        for i in range(n_layers):
            layer = getattr(self, f"DynamicVFELayer_{i}")
            point_feats = layer(point_feats, valid, train)
            if i == n_layers - 1 and self.return_point_feats:
                # the last layer's per-point features, before the pooling
                return (point_feats, aux) if extra_sum is not None \
                    else point_feats
            voxel_feats = reduce_fn(point_feats, self.mode)
            if i != n_layers - 1:
                back = gather_segments(voxel_feats, seg)
                point_feats = torch.cat([point_feats, back], dim=-1)
                point_feats = torch.where(valid[:, None], point_feats, 0.0)
        out = torch.where(vm.voxel_valid[:, None], voxel_feats, 0.0)
        if extra_sum is not None:
            return out, aux
        return out


class DynamicPillarFeatureNet(DynamicVFE):
    """The dynamic PillarFeatureNet: :class:`DynamicVFE` over full-height
    pillars (a ``voxel_size`` whose z extent covers the range), with its
    sorted-reduce route where ``use_sorted_reduce`` is set."""


class HardSimpleVFE(nn.Module):
    """The mean of each hard voxel's points (no parameters): voxels [V, T,
    C] and num_points [V] → [V, C]."""

    def forward(self, voxels, num_points):
        t = voxels.shape[1]
        mask = (torch.arange(t, device=voxels.device)[None]
                < num_points[:, None])
        s = (voxels * mask[..., None]).sum(1)
        return s / torch.clamp(num_points, min=1)[:, None]


class PillarFeatureNet(nn.Module):
    """PointPillars' PFN over hard voxels: per point the raw channels, the
    offset from the pillar's mean and from its centre (and the range with
    ``with_distance``); per layer a bias-free Dense, a MaskedBatchNorm over
    the V*T rows with the point mask, ReLU times the mask, the max over the
    pillar (a tie's gradient split evenly, as JAX's), and (but for the last
    layer) the broadcast concat of the max. ``in_channels`` is the width of
    the raw point rows. Returns [V, C]."""

    def __init__(self, in_channels: int, feat_channels: Sequence[int] = (64,),
                 with_distance: bool = False,
                 voxel_size: tuple = (0.32, 0.32, 6.0),
                 point_cloud_range: tuple = (-74.88, -74.88, -2, 74.88, 74.88,
                                             4),
                 dtype=torch.float32):
        super().__init__()
        self.feat_channels = tuple(feat_channels)
        self.with_distance = with_distance
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.dtype = dtype
        c = in_channels + 6 + int(with_distance)
        for i, out in enumerate(self.feat_channels):
            self.add_module(f"pfn_{i}", Dense(c, out, bias=False,
                                              dtype=dtype))
            self.add_module(f"pfn_bn_{i}", MaskedBatchNorm(out, dtype=dtype))
            c = 2 * out
        self.out_channels = self.feat_channels[-1]

    def forward(self, voxels, num_points, coords, train: bool = False):
        v, t, _ = voxels.shape
        dev = voxels.device
        mask = (torch.arange(t, device=dev)[None]
                < num_points[:, None])[..., None]
        xyz = voxels[..., :3]
        mean = (xyz * mask).sum(1) / torch.clamp(num_points, min=1)[:, None]
        cluster = (xyz - mean[:, None]) * mask
        vs = torch.tensor(self.voxel_size, dtype=torch.float32, device=dev)
        pcr = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32,
                           device=dev)
        centers = (coords[:, [3, 2, 1]].float() + 0.5) * vs + pcr
        feats = [voxels, cluster, (xyz - centers[:, None]) * mask]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
                         * mask)
        x = torch.cat(feats, dim=-1).to(self.dtype)
        flat_mask = mask.reshape(v * t)
        for i, ch in enumerate(self.feat_channels):
            x = getattr(self, f"pfn_{i}")(x)
            x = getattr(self, f"pfn_bn_{i}")(
                x.reshape(v * t, ch), flat_mask, train).reshape(v, t, ch)
            x = torch.relu(x) * mask
            pooled = x.amax(dim=1)
            if i != len(self.feat_channels) - 1:
                x = torch.cat([x, pooled[:, None].expand_as(x)], dim=-1) * mask
        return pooled
