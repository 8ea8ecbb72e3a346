"""LiDAR 3D box ops in the mmdet3d-v0.15 convention (counterpart of
``sst_tpu/core/boxes.py``; the parts the rotated IoU, the decoder, the FSD
targets, the RoI head's corner loss and test-time augmentation use).

A box is a row [x, y, z, w, l, h, yaw, ...] with (x, y, z) the bottom
centre; yaw rotates around +z with x' = x cos θ + y sin θ,
y' = -x sin θ + y cos θ.
"""

from __future__ import annotations

import math

import torch


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def rotate_2d(xy, yaw):
    """Rotate [..., 2] points by per-row yaw (mmdet3d axis=2 sign)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = xy[..., 0] * c + xy[..., 1] * s
    y = -xy[..., 0] * s + xy[..., 1] * c
    return torch.stack([x, y], dim=-1)


def bev(boxes):
    """[N, 5] (x, y, w, l, yaw) rotated BEV boxes."""
    return boxes[:, [0, 1, 3, 4, 6]]


def nearest_bev(boxes):
    """[N, 4] axis-aligned (x1, y1, x2, y2), w/l swapped when the box is
    closer to 90 degrees."""
    b = bev(boxes)
    rot = limit_period(b[:, 4], 0.5, math.pi)
    cond = (torch.abs(rot) > math.pi / 4)[:, None]
    dims = torch.where(cond, b[:, [3, 2]], b[:, [2, 3]])
    centers = b[:, :2]
    return torch.cat([centers - dims / 2, centers + dims / 2], dim=-1)


_CORNERS_NORM_2D = ((-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5), (0.5, -0.5))


def bev_corners(boxes_bev):
    """[N, 4, 2] corners of (x, y, w, l, yaw) BEV boxes, in a consistent
    winding for polygon ops."""
    norm = torch.tensor(_CORNERS_NORM_2D, dtype=boxes_bev.dtype,
                        device=boxes_bev.device)
    dims = boxes_bev[:, None, 2:4] * norm[None]
    rot = rotate_2d(dims, boxes_bev[:, None, 4])
    return rot + boxes_bev[:, None, :2]


def corners(boxes):
    """[N, 8, 3] 3D corners, the bottom four then the top four (the BEV
    corners' order)."""
    cb = bev_corners(bev(boxes))
    z0 = boxes[:, None, 2].expand(cb.shape[:2])
    z1 = z0 + boxes[:, None, 5]
    return torch.cat([torch.cat([cb, z0[..., None]], -1),
                      torch.cat([cb, z1[..., None]], -1)], dim=1)


def gravity_center(boxes):
    """[N, 3] centre with z at mid-height."""
    return torch.cat([boxes[:, :2], (boxes[:, 2] + boxes[:, 5] * 0.5)[:, None]],
                     dim=-1)


def points_in_boxes(points_xyz, boxes, margin: float = 0.0):
    """[P, N] bool: point p inside (rotated) box n, faces included."""
    rel = points_xyz[:, None, :2] - boxes[None, :, :2]
    local = rotate_2d(rel, -boxes[None, :, 6])  # into the box frame
    in_x = torch.abs(local[..., 0]) <= boxes[None, :, 3] / 2 + margin
    in_y = torch.abs(local[..., 1]) <= boxes[None, :, 4] / 2 + margin
    z = points_xyz[:, None, 2]
    in_z = (z >= boxes[None, :, 2] - margin) & (
        z <= boxes[None, :, 2] + boxes[None, :, 5] + margin)
    return in_x & in_y & in_z


def rotate_boxes(boxes, angle: float):
    """Boxes (and their velocities, columns 7-8, where present) turned
    around z by the scalar ``angle``."""
    yaw = torch.full((boxes.shape[0],), angle, dtype=boxes.dtype,
                     device=boxes.device)
    out = boxes.clone()
    out[:, :2] = rotate_2d(boxes[:, :2], yaw)
    out[:, 6] = boxes[:, 6] + angle
    if boxes.shape[1] > 7:
        out[:, 7:9] = rotate_2d(boxes[:, 7:9], yaw)
    return out


def flip_boxes(boxes, axis: str = "x"):
    """BEV flip as ``LiDARInstance3DBoxes.flip``: ``"x"`` negates y (yaw'
    = pi - yaw, the y velocity negated), ``"y"`` negates x (yaw' = -yaw,
    the x velocity negated)."""
    out = boxes.clone()
    if axis == "x":
        out[:, 1] = -boxes[:, 1]
        out[:, 6] = -boxes[:, 6] + math.pi
        if boxes.shape[1] > 7:
            out[:, 8] = -boxes[:, 8]
    else:
        out[:, 0] = -boxes[:, 0]
        out[:, 6] = -boxes[:, 6]
        if boxes.shape[1] > 7:
            out[:, 7] = -boxes[:, 7]
    return out
