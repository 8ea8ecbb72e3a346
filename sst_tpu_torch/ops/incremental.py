"""Incremental (multi-frame residual) point ops for FSD++ (counterpart of
``sst_tpu/ops/incremental.py``).

- :func:`delta_points_mask`: the current frame's points whose voxel no
  previous frame occupies, by one boolean occupancy canvas over the range
  (one scatter, one gather; 401 x 401 x 16 cells at FSD++'s 0.4 m voxel over
  +-80 m and 6 m).
- :func:`points_frame_transform`, :func:`box_frame_transform`: rigid pose
  transforms of points and 7-dof (or 9-dof, with velocity) boxes between
  ego frames.

Masks stand for ragged sets: a removed point keeps its row, invalid.
"""

from __future__ import annotations

import torch

from sst_tpu_torch.ops.voxelize import f32_reciprocal


def points_frame_transform(points_xyz: torch.Tensor, pre_pose: torch.Tensor,
                           cur_pose_inv: torch.Tensor) -> torch.Tensor:
    """[N, 3] points from a previous ego frame into the current one (4x4
    poses)."""
    mm = cur_pose_inv @ pre_pose
    return points_xyz @ mm[:3, :3].T + mm[:3, 3]


def box_frame_transform(boxes: torch.Tensor, pre_pose: torch.Tensor,
                        cur_pose_inv: torch.Tensor) -> torch.Tensor:
    """[N, 7] (or [N, 9] with velocity) LiDAR boxes between ego frames: the
    centre (and velocity) rotated and moved, the yaw through the heading
    unit vector (sin(yaw), cos(yaw), 0)."""
    mm = cur_pose_inv @ pre_pose
    rot = mm[:3, :3]
    centers = boxes[:, :3] @ rot.T + mm[:3, 3]
    yaw = boxes[:, 6]
    heading = torch.stack([torch.sin(yaw), torch.cos(yaw),
                           torch.zeros_like(yaw)], dim=-1) @ rot.T
    new_yaw = torch.atan2(heading[:, 0], heading[:, 1])
    out = torch.cat([centers, boxes[:, 3:6], new_yaw[:, None]], dim=-1)
    if boxes.shape[1] >= 9:
        vel = torch.cat([boxes[:, 7:9], torch.zeros_like(boxes[:, :1])],
                        dim=-1) @ rot.T
        out = torch.cat([out, vel[:, :2]], dim=-1)
    return out


def _grid_size(point_cloud_range, voxel_size) -> tuple[int, int, int]:
    """(nx, ny, nz): the cells per axis, one more than the range holds
    whole, as JAX counts them (Python floats)."""
    return tuple(int((point_cloud_range[i + 3] - point_cloud_range[i])
                     / voxel_size[i]) + 1 for i in range(3))


def _voxel_keys(points_xyz: torch.Tensor, valid: torch.Tensor,
                point_cloud_range, voxel_size):
    """(int32 cell key per point, ``size`` for invalid or out-of-range
    points; in-range mask; the canvas size). Cells are ``floor((xyz - lo) *
    (1 / voxel))`` in float32 (``ops/voxelize.py f32_reciprocal``), column
    by column with Python scalars (no small tensor copied to the card)."""
    nx, ny, nz = _grid_size(point_cloud_range, voxel_size)
    c = torch.stack([torch.floor((points_xyz[:, i] - point_cloud_range[i])
                                 * f32_reciprocal(voxel_size[i]))
                     for i in range(3)], dim=-1).to(torch.int32)
    ok = valid & (c >= 0).all(-1) & (c[:, 0] < nx) & (c[:, 1] < ny) \
        & (c[:, 2] < nz)
    key = (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0]
    size = nx * ny * nz
    return torch.where(ok, key, size), ok, size


def delta_points_mask(cur_xyz: torch.Tensor, cur_valid: torch.Tensor,
                      prev_xyz: torch.Tensor, prev_valid: torch.Tensor,
                      point_cloud_range, voxel_size) -> torch.Tensor:
    """[P_cur] bool: the valid current points whose voxel holds no valid
    previous point (one sample). Current points outside the range are
    kept."""
    pkey, _, size = _voxel_keys(prev_xyz, prev_valid, point_cloud_range,
                                voxel_size)
    occ = torch.zeros(size + 1, dtype=torch.bool, device=cur_xyz.device)
    occ[pkey.long()] = True
    ckey, cok, _ = _voxel_keys(cur_xyz, cur_valid, point_cloud_range,
                               voxel_size)
    seen = occ[ckey.long()]
    return cur_valid & (~cok | ~seen)
