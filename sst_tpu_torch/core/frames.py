"""Coordinate-frame structures: camera / depth / lidar box and point
conversions plus camera-frame box geometry.

The port's copy of ``sst_tpu/core/frames.py`` (numpy code; the
port cannot import the JAX package, whose ``__init__`` loads JAX).

Counterpart of the reference's coordinate-frame class family
(mmdet3d/core/bbox/structures/cam_box3d.py:9 CameraInstance3DBoxes,
depth_box3d.py:15, box_3d_mode.py:62 Box3DMode.convert,
coord_3d_mode.py:181 Coord3DMode.convert_point,
core/points/{cam,depth,lidar}_points.py). The rebuild keeps the repo's
functional-numpy style: a box is a row [x, y, z, dx, dy, dz, yaw, ...] whose
meaning depends on an explicit frame tag, and every structure method is a
pure function here.

Frame conventions (identical to mmdet3d v0.15):

  LIDAR:  x forward, y left,  z up;    yaw about z; bottom-center origin
          (0.5, 0.5, 0) ; dims (dx=w, dy=l, dz=h).
  CAM:    x right,  y DOWN,  z forward; yaw about y (decreasing x→z);
          origin (0.5, 1.0, 0.5) i.e. y is the box BOTTOM; dims stored as
          (x_size, y_size, z_size) of the camera frame.
  DEPTH:  x right,  y forward, z up;   yaw about z; origin (0.5, 0.5, 0).

`convert_boxes` / `convert_points` reproduce Box3DMode.convert /
Coord3DMode.convert_point exactly: xyz goes through the (optionally
homogeneous) rt matrix, dims are axis-permuted, yaw and extra columns pass
through unchanged (the reference does not touch yaw in mode conversion —
KITTI's ry↔lidar-yaw sign flip lives in the KITTI anno codec, see
data/datasets.py camera_to_lidar_boxes).
"""

from __future__ import annotations

import numpy as np

LIDAR = "lidar"
CAM = "cam"
DEPTH = "depth"

# default rotation matrices between frames when no sensor calibration is
# given (box_3d_mode.py:104-127); row layout is the rt_mat of the reference
# (applied as xyz @ rt_mat.T).
_DEFAULT_RT = {
    (LIDAR, CAM): np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32),
    (CAM, LIDAR): np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32),
    (DEPTH, CAM): np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32),
    (CAM, DEPTH): np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32),
    (LIDAR, DEPTH): np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32),
    (DEPTH, LIDAR): np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float32),
}

# dim-column permutation applied to (dx, dy, dz) for each conversion
# (box_3d_mode.py:107-127: x/y/z_size reorderings).
_DIM_PERM = {
    (LIDAR, CAM): (1, 2, 0),
    (CAM, LIDAR): (2, 0, 1),
    (DEPTH, CAM): (0, 2, 1),
    (CAM, DEPTH): (0, 2, 1),
    (LIDAR, DEPTH): (1, 0, 2),
    (DEPTH, LIDAR): (1, 0, 2),
}


def _apply_rt(xyz, rt):
    rt = np.asarray(rt, np.float32)
    if rt.shape[-1] == 4:  # homogeneous sensor calibration
        hom = np.concatenate(
            [xyz, np.ones((len(xyz), 1), xyz.dtype)], axis=1)
        return (hom @ rt.T)[:, :3]
    return xyz @ rt.T


def convert_points(points, src: str, dst: str, rt_mat=None):
    """Coord3DMode.convert_point equivalent: transforms cols 0:3, passes any
    extra feature columns through."""
    points = np.asarray(points, np.float32)
    if src == dst and rt_mat is None:
        return points.copy()
    if rt_mat is None:
        rt_mat = _DEFAULT_RT[(src, dst)]
    out = points.copy()
    out[:, :3] = _apply_rt(points[:, :3], rt_mat)
    return out


def convert_boxes(boxes, src: str, dst: str, rt_mat=None):
    """Box3DMode.convert equivalent on [N, 7+] rows.

    xyz through rt_mat, dims permuted per frame pair, yaw + extras
    unchanged. Note the converted position refers to the SOURCE frame's
    origin corner (the reference behaves identically and fixes the origin
    at container construction); use :func:`shift_origin` when the target
    container convention differs.
    """
    boxes = np.asarray(boxes, np.float32)
    if src == dst and rt_mat is None:
        return boxes.copy()
    if rt_mat is None:
        rt_mat = _DEFAULT_RT[(src, dst)]
    perm = _DIM_PERM[(src, dst)]
    out = boxes.copy()
    out[:, :3] = _apply_rt(boxes[:, :3], rt_mat)
    out[:, 3:6] = boxes[:, 3:6][:, list(perm)]
    return out


def shift_origin(boxes, src_origin, dst_origin):
    """Move the reference point of each box (cam_box3d.py:71-74): the stored
    center shifts by dims * (dst - src) in the box's axis-aligned frame."""
    boxes = np.asarray(boxes, np.float32).copy()
    delta = np.asarray(dst_origin, np.float32) - np.asarray(
        src_origin, np.float32)
    boxes[:, :3] += boxes[:, 3:6] * delta
    return boxes


# ---------------------------------------------------------------- camera ops


def cam_gravity_center(boxes):
    """[N, 3] 3D centers of camera-frame boxes whose stored y is the BOTTOM
    (origin (0.5, 1.0, 0.5); y points down — cam_box3d.py:93-99)."""
    boxes = np.asarray(boxes, np.float32)
    c = boxes[:, :3].copy()
    c[:, 1] = c[:, 1] - boxes[:, 4] * 0.5
    return c


def cam_corners(boxes):
    """[N, 8, 3] corners of camera-frame boxes (cam_box3d.py:102-142):
    yaw rotates about the y axis, positive from +x toward -z (the camera
    yaw decreases from x to z)."""
    boxes = np.asarray(boxes, np.float32)
    n = len(boxes)
    if n == 0:
        return np.zeros((0, 8, 3), np.float32)
    # unit corners in the reference's clockwise order, origin (0.5, 1, 0.5)
    corners_norm = np.stack(
        np.unravel_index(np.arange(8), (2, 2, 2)), axis=1).astype(np.float32)
    corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.array([0.5, 1.0, 0.5], np.float32)
    corners = boxes[:, None, 3:6] * corners_norm[None]
    yaw = boxes[:, 6]
    c, s = np.cos(yaw), np.sin(yaw)
    # rotation_3d_in_axis(axis=1): x' = x c + z s ; z' = -x s + z c
    x = corners[..., 0] * c[:, None] + corners[..., 2] * s[:, None]
    z = -corners[..., 0] * s[:, None] + corners[..., 2] * c[:, None]
    out = np.stack([x, corners[..., 1], z], axis=-1)
    return out + boxes[:, None, :3]


def cam_bev(boxes):
    """[N, 5] BEV boxes (x, z, x_size, z_size, yaw) of camera-frame boxes
    (cam_box3d.py:145-148)."""
    boxes = np.asarray(boxes, np.float32)
    return boxes[:, [0, 2, 3, 5, 6]]


def cam_rotate(boxes, angle, points=None):
    """Rotate camera-frame boxes (+ optional points) about y
    (cam_box3d.py:171-217). Returns (boxes, points)."""
    boxes = np.asarray(boxes, np.float32).copy()
    c, s = np.cos(angle), np.sin(angle)
    rot_t = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
    boxes[:, :3] = boxes[:, :3] @ rot_t
    boxes[:, 6] += angle
    if points is not None:
        points = np.asarray(points, np.float32).copy()
        points[:, :3] = points[:, :3] @ rot_t
    return boxes, points


def cam_flip(boxes, bev_direction: str = "horizontal", points=None):
    """BEV flip in camera frame (cam_box3d.py:219-251): horizontal negates
    x (yaw → -yaw + pi), vertical negates z (yaw → -yaw)."""
    boxes = np.asarray(boxes, np.float32).copy()
    if bev_direction == "horizontal":
        boxes[:, 0] = -boxes[:, 0]
        boxes[:, 6] = -boxes[:, 6] + np.pi
    elif bev_direction == "vertical":
        boxes[:, 2] = -boxes[:, 2]
        boxes[:, 6] = -boxes[:, 6]
    else:
        raise ValueError(bev_direction)
    if points is not None:
        points = np.asarray(points, np.float32).copy()
        points[:, 0 if bev_direction == "horizontal" else 2] *= -1
    return boxes, points


def cam_height_overlaps(boxes_a, boxes_b):
    """[N, M] vertical overlap of camera-frame boxes — y grows DOWNWARD so
    top = bottom - height (cam_box3d.py:276-304)."""
    a, b = np.asarray(boxes_a, np.float32), np.asarray(boxes_b, np.float32)
    bot_a, bot_b = a[:, 1:2], b[None, :, 1].reshape(1, -1)
    top_a, top_b = bot_a - a[:, 4:5], bot_b - b[None, :, 4].reshape(1, -1)
    return np.clip(np.minimum(bot_a, bot_b) - np.maximum(top_a, top_b),
                   0.0, None)


def cam_points_in_boxes(points_xyz, boxes):
    """[P, N] bool containment for camera-frame boxes, via the lidar-frame
    kernel (core/boxes.py points_in_boxes) after a default-frame conversion.

    Unlike :func:`convert_boxes` (which mirrors the reference codec and
    passes yaw through untouched), geometry here needs the exact heading:
    with the (z_size, x_size, y_size) dims permutation, the cam box's
    z_size axis at yaw θ maps to lidar (cos θ, -sin θ, 0) under the default
    rotation — i.e. lidar local-x at yaw -θ."""
    import torch

    from sst_tpu_torch.core.boxes import points_in_boxes

    pts_l = convert_points(np.asarray(points_xyz, np.float32), CAM, LIDAR)
    boxes_l = convert_boxes(boxes, CAM, LIDAR)
    if len(boxes_l):
        boxes_l[:, 6] = -np.asarray(boxes, np.float32)[:, 6]
    # the camera y-bottom becomes the lidar z-bottom under the default
    # CAM→LIDAR rotation, matching the lidar kernel's bottom-center z rows.
    return points_in_boxes(torch.from_numpy(np.ascontiguousarray(
        pts_l[:, :3], np.float32)), torch.from_numpy(np.asarray(
            boxes_l, np.float32))).numpy()


# ----------------------------------------------------------- image projection


def project_to_image(pts_3d, proj_mat):
    """[..., 3] camera-frame points → [..., 2] image pixels through a 3x4 or
    4x4 projection matrix (KITTI P2); reference
    core/bbox/structures/utils.py points_cam2img."""
    pts = np.asarray(pts_3d, np.float32)
    p = np.asarray(proj_mat, np.float32)
    if p.shape == (3, 3):
        full = np.eye(4, dtype=np.float32)
        full[:3, :3] = p
        p = full[:3]
    hom = np.concatenate(
        [pts, np.ones(pts.shape[:-1] + (1,), np.float32)], axis=-1)
    uvw = hom @ p.T
    return uvw[..., :2] / np.clip(uvw[..., 2:3], 1e-5, None)


def cam_boxes_to_image_bbox(boxes_cam, P, image_shape=None):
    """[N, 4] (x1, y1, x2, y2) image bboxes of camera-frame boxes: project
    the 8 corners through P and take the extent, clipped to the image
    (kitti eval anno path; reference box_np_ops.py center_to_corner_box3d →
    project_to_image → minmax)."""
    boxes_cam = np.asarray(boxes_cam, np.float32)
    if len(boxes_cam) == 0:
        return np.zeros((0, 4), np.float32)
    corners = cam_corners(boxes_cam)
    uv = project_to_image(corners, P)
    bbox = np.concatenate([uv.min(axis=1), uv.max(axis=1)], axis=1)
    if image_shape is not None:
        h, w = image_shape[:2]
        bbox[:, 0::2] = np.clip(bbox[:, 0::2], 0, w - 1)
        bbox[:, 1::2] = np.clip(bbox[:, 1::2], 0, h - 1)
    return bbox.astype(np.float32)


def kitti_alpha(loc_cam, ry):
    """Observation angle alpha = ry - arctan2(x, z) (KITTI devkit
    convention; reference kitti converter anno path)."""
    loc_cam = np.asarray(loc_cam, np.float32)
    return np.asarray(ry, np.float32) - np.arctan2(
        loc_cam[:, 0], loc_cam[:, 2])
