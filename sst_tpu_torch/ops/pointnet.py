"""PointNet++ neighbourhood ops, batched at static shapes (counterpart of
``sst_tpu/ops/pointnet.py``; the reference's ``ball_query``, ``knn``,
``three_nn``, ``three_interpolate``, ``gather_points`` and
``group_points`` CUDA ops).

Each query is one dense [npoint, N] squared-distance matrix, taken as the
expansion ``|a|^2 + |b|^2 - 2 a.b`` clamped at 0 as the JAX package takes
it (a ball's edge depends on that rounding, so the expansion stays and the
product runs at full float32: TF32 off), then a cumulative count, a top-k
or an argmin. Padding rows are masked by ``valid`` flags pushing their
distances to 1e10. Index outputs carry no gradient; the gathers
differentiate as gathers.
"""

from __future__ import annotations

import torch

from sst_tpu_torch.ops.ccl import stable_topk

_INF = 1e10


def square_distance(a: torch.Tensor, b: torch.Tensor,
                    b_valid: torch.Tensor | None = None) -> torch.Tensor:
    """[..., N, M] squared distances of a [..., N, 3] to b [..., M, 3];
    invalid b rows read 1e10."""
    d = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
         - 2.0 * torch.einsum("...nc,...mc->...nm", a, b))
    d = torch.clamp(d, min=0.0)
    if b_valid is not None:
        d = torch.where(b_valid[..., None, :], d, _INF)
    return d


def ball_query(min_radius: float, max_radius: float, sample_num: int,
               xyz: torch.Tensor, center_xyz: torch.Tensor,
               xyz_valid: torch.Tensor | None = None) -> torch.Tensor:
    """[B, npoint, sample_num] int32: per centre the first ``sample_num``
    points (in index order) with ``min_radius^2 <= d^2 < max_radius^2``;
    the slots past them repeat the first, 0 where the ball is empty.
    xyz [B, N, 3], center_xyz [B, npoint, 3], xyz_valid [B, N]."""
    if not min_radius < max_radius:
        raise ValueError(f"min_radius {min_radius} >= max_radius "
                         f"{max_radius}")
    d2 = square_distance(center_xyz, xyz, xyz_valid)
    inball = (d2 < max_radius * max_radius) & (d2 >= min_radius * min_radius)
    n = xyz.shape[-2]
    # each in-ball point's rank among its centre's, in index order; the
    # ranks are distinct, so each slot below sample_num takes one point
    rank = torch.cumsum(inball, dim=-1, dtype=torch.int32) - 1
    slot = torch.where(inball & (rank < sample_num), rank, sample_num).long()
    src = torch.arange(n, dtype=torch.int32, device=xyz.device).expand(
        d2.shape)
    idx = torch.zeros(d2.shape[:-1] + (sample_num + 1,), dtype=torch.int32,
                      device=xyz.device)
    idx.scatter_(-1, slot, src)
    idx = idx[..., :sample_num]
    filled = torch.arange(sample_num, device=xyz.device) < torch.clamp(
        inball.sum(-1, keepdim=True), max=sample_num)
    return torch.where(filled, idx, idx[..., :1])


def knn(k: int, xyz: torch.Tensor, center_xyz: torch.Tensor | None = None,
        xyz_valid: torch.Tensor | None = None) -> torch.Tensor:
    """[B, k, npoint] int32 (the reference's transposed layout): each
    centre's k nearest points, ascending, the lower index first on a tie;
    with ``xyz_valid``, slots that reach padding repeat the nearest."""
    if center_xyz is None:
        center_xyz = xyz
    d2 = square_distance(center_xyz, xyz, xyz_valid)
    neg, idx = stable_topk(-d2, k)
    idx = idx.to(torch.int32)
    if xyz_valid is not None:
        idx = torch.where(-neg < _INF, idx, idx[..., :1])
    return idx.transpose(-1, -2)


def three_nn(target: torch.Tensor, source: torch.Tensor,
             source_valid: torch.Tensor | None = None):
    """The 3 nearest source points of every target point: (dist [B, N, 3],
    idx [B, N, 3] int32), nearest first."""
    d2 = square_distance(target, source, source_valid)
    neg, idx = stable_topk(-d2, 3)
    return torch.sqrt(torch.clamp(-neg, min=0.0)), idx.to(torch.int32)


def _gather_columns(features: torch.Tensor,
                    indices: torch.Tensor) -> torch.Tensor:
    """features [B, C, N], indices [B, ...] → [B, C, ...]."""
    b, c, _ = features.shape
    flat = indices.reshape(b, 1, -1).long().expand(b, c, -1)
    return torch.gather(features, 2, flat).reshape(
        (b, c) + tuple(indices.shape[1:]))


def three_interpolate(features: torch.Tensor, indices: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """[B, C, n]: the weighted sum of 3 neighbours' features. features
    [B, C, M], indices and weight [B, n, 3]."""
    g = _gather_columns(features, indices)  # [B, C, n, 3]
    return torch.einsum("bcnk,bnk->bcn", g, weight)


def gather_points(features: torch.Tensor,
                  indices: torch.Tensor) -> torch.Tensor:
    """[B, C, npoint]: columns ``indices`` [B, npoint] of features
    [B, C, N]."""
    return _gather_columns(features, indices)


def grouping_operation(features: torch.Tensor,
                       indices: torch.Tensor) -> torch.Tensor:
    """[B, C, npoint, nsample]: columns ``indices`` [B, npoint, nsample] of
    features [B, C, N]."""
    return _gather_columns(features, indices)


def query_and_group(points_xyz: torch.Tensor, center_xyz: torch.Tensor,
                    idx: torch.Tensor, features: torch.Tensor | None = None,
                    relative_xyz: bool = True, normalize_xyz: bool = False,
                    radius: float | None = None) -> torch.Tensor:
    """[B, 3 (+C), npoint, nsample]: the grouped xyz (relative to their
    centre, divided by ``radius`` with ``normalize_xyz``), then the grouped
    features. points_xyz [B, N, 3], center_xyz [B, npoint, 3], idx
    [B, npoint, nsample], features [B, C, N] or None."""
    grouped = grouping_operation(points_xyz.transpose(-1, -2), idx)
    if relative_xyz:
        grouped = grouped - center_xyz.transpose(-1, -2)[..., None]
    if normalize_xyz:
        if radius is None:
            raise ValueError("normalize_xyz needs a radius")
        grouped = grouped / radius
    if features is None:
        return grouped
    return torch.cat([grouped, grouping_operation(features, idx)], dim=1)
