"""Dynamic (uncapped) voxelization (counterpart of ``sst_tpu/ops/voxelize.py``).

A point cloud arrives as a padded [N, C] tensor (xyz first) with a batch
index per point and a validity mask. Points outside ``point_cloud_range``
become invalid. Voxel identity is the linearized (b, z, y, x) int32 key fed
to the unique pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from sst_tpu_torch.ops.segment import (
    INT_SENTINEL,
    UniqueResult,
    unique_segments,
    unique_segments_canvas,
)

# Key spaces above this many cells take the sort-based unique (which also
# yields the sort permutation the sorted segment reduce consumes); smaller
# ones take the occupancy-canvas unique.
CANVAS_MAX_KEY_SPACE = 1 << 21


def grid_shape_zyx(point_cloud_range: Sequence[float],
                   voxel_size: Sequence[float]):
    """(nz, ny, nx) grid shape with the reference's round() semantics."""
    pcr = point_cloud_range
    nx = int(round((pcr[3] - pcr[0]) / voxel_size[0]))
    ny = int(round((pcr[4] - pcr[1]) / voxel_size[1]))
    nz = int(round((pcr[5] - pcr[2]) / voxel_size[2]))
    return (nz, ny, nx)


@dataclass
class VoxelMapping:
    """Point→voxel assignment with statically capped voxel slots.

    Attributes:
      coords: [P, 4] int32 (b, z, y, x) per point; -1 rows for invalid points.
      keys: [P] int32 linearized voxel key per point (-1 when invalid).
      valid: [P] bool, in range and a real point.
      unique: UniqueResult over keys (seg_ids map points to voxel slots).
      voxel_coords: [V, 4] int32 (b, z, y, x) per voxel slot; -1 unused.
      voxel_valid: [V] bool.
      grid: (nz, ny, nx).
      batch_size: int.
    """

    coords: torch.Tensor
    keys: torch.Tensor
    valid: torch.Tensor
    unique: UniqueResult
    voxel_coords: torch.Tensor
    voxel_valid: torch.Tensor
    grid: tuple
    batch_size: int

    @property
    def num_voxel_slots(self) -> int:
        return self.voxel_coords.shape[0]

    @property
    def point_seg_ids(self) -> torch.Tensor:
        return self.unique.seg_ids


def f32_reciprocal(x: float) -> float:
    """The float32 ``1 / x`` as a Python float. Jitted XLA divides by a
    constant as the product with the constant's float32 reciprocal, so a
    coordinate exactly on a cell boundary (``(x - lo) / size`` a hair
    under an integer, its product with the reciprocal the integer) falls
    in the upper cell in the JAX package: the port's cell floors multiply
    by this reciprocal to land in the same cell."""
    return float(np.float32(1.0) / np.float32(x))


def compute_voxel_coords(xyz, batch_idx, valid, point_cloud_range,
                         voxel_size):
    """Per-point (b, z, y, x) int32 voxel coords + in-range mask; the cell
    is ``floor((xyz - lo) * (1 / size))`` in float32 (see
    :func:`f32_reciprocal`)."""
    pcr = torch.tensor(point_cloud_range, dtype=torch.float32,
                       device=xyz.device)
    inv = torch.tensor([f32_reciprocal(v) for v in voxel_size],
                       dtype=torch.float32, device=xyz.device)
    nz, ny, nx = grid_shape_zyx(point_cloud_range, voxel_size)
    c = torch.floor((xyz[:, :3].float() - pcr[:3]) * inv).to(torch.int32)
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    in_range = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) & (cz >= 0)
                & (cz < nz) & valid)
    coords = torch.stack([batch_idx.to(torch.int32), cz, cy, cx], dim=-1)
    coords = torch.where(in_range[:, None], coords, -1)
    return coords, in_range


def linearize_coords(coords, grid: tuple, valid):
    """(b, z, y, x) → int32 key; the caller keeps batch*nz*ny*nx < 2**31."""
    nz, ny, nx = grid
    b, z, y, x = coords.unbind(-1)
    key = ((b * nz + z) * ny + y) * nx + x
    return torch.where(valid, key, -1).to(torch.int32)


def delinearize_key(keys, grid: tuple, valid):
    nz, ny, nx = grid
    x = keys % nx
    r = keys // nx
    y = r % ny
    r = r // ny
    z = r % nz
    b = r // nz
    coords = torch.stack([b, z, y, x], dim=-1).to(torch.int32)
    return torch.where(valid[:, None], coords, -1)


def dynamic_voxelize(points, batch_idx, points_valid, point_cloud_range,
                     voxel_size, max_voxels: int, batch_size: int,
                     need_ranks: bool = False) -> VoxelMapping:
    """Assign every point to a voxel; no per-voxel point cap.

    Args:
      points: [P, C] padded points, xyz first.
      batch_idx: [P] int32 sample index within the batch.
      points_valid: [P] bool.
      max_voxels: cap on distinct voxels in the whole batch.
      need_ranks: force the sort-based unique (per-voxel ranks and the sort
        permutation) even for small key spaces.
    """
    grid = grid_shape_zyx(point_cloud_range, voxel_size)
    nz, ny, nx = grid
    key_space = batch_size * nz * ny * nx
    assert key_space < 2**31, "int32 voxel key overflow; shrink grid"
    coords, valid = compute_voxel_coords(points[:, :3], batch_idx,
                                         points_valid, point_cloud_range,
                                         voxel_size)
    keys = linearize_coords(coords, grid, valid)
    if need_ranks or key_space > CANVAS_MAX_KEY_SPACE:
        uniq = unique_segments(keys, valid, max_voxels)
    else:
        uniq = unique_segments_canvas(keys, valid, max_voxels, key_space)
    voxel_valid = uniq.unique_keys != INT_SENTINEL
    voxel_coords = delinearize_key(uniq.unique_keys, grid, voxel_valid)
    return VoxelMapping(coords=coords, keys=keys, valid=valid, unique=uniq,
                        voxel_coords=voxel_coords, voxel_valid=voxel_valid,
                        grid=grid, batch_size=batch_size)
