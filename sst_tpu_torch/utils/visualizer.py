"""Visualization (counterpart of the JAX package's
``utils/visualizer.py``, after the reference's mmdet3d/core/visualizer):
matplotlib BEV PNGs, headless under the ``Agg`` backend (matplotlib is
imported only by :func:`show_bev`), and meshlab-ready OBJ dumps
(show_result.py:74 show_result / :10 _write_obj / :32 _write_oriented_bbox;
the box meshes are hand-rolled 8-vertex / 12-triangle OBJs, no trimesh or
open3d). Points, boxes and scores may be numpy arrays or tensors on any
device; the files are the JAX module's byte for byte (the PNG's pixels)."""

from __future__ import annotations

import os

import numpy as np


def _np(x):
    """``x`` as a numpy array (a tensor is detached and brought to the
    host); None stays None."""
    if x is None or isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _bev_corners_np(boxes):
    w = boxes[:, 3][:, None]
    l = boxes[:, 4][:, None]
    yaw = boxes[:, 6]
    base = np.stack([
        np.stack([w / 2, l / 2], -1), np.stack([w / 2, -l / 2], -1),
        np.stack([-w / 2, -l / 2], -1), np.stack([-w / 2, l / 2], -1),
    ], 1)[:, :, 0, :]
    c, s = np.cos(yaw), np.sin(yaw)
    x = base[..., 0] * c[:, None] + base[..., 1] * s[:, None]
    y = -base[..., 0] * s[:, None] + base[..., 1] * c[:, None]
    return np.stack([x + boxes[:, 0][:, None], y + boxes[:, 1][:, None]], -1)


def show_bev(points=None, gt_boxes=None, pred_boxes=None, pred_scores=None,
             out_file: str = "bev.png", pc_range: float = 80.0,
             max_points: int = 120000):
    """Scatter the cloud + draw gt (green) and predicted (red) boxes."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points, gt_boxes, pred_boxes, pred_scores = (
        _np(points), _np(gt_boxes), _np(pred_boxes), _np(pred_scores))
    fig, ax = plt.subplots(figsize=(12, 12))
    if points is not None:
        pts = np.asarray(points)
        if len(pts) > max_points:
            pts = pts[np.random.RandomState(0).choice(len(pts), max_points,
                                                      False)]
        ax.scatter(pts[:, 0], pts[:, 1], s=0.05, c="gray", alpha=0.5)
    for boxes, color in ((gt_boxes, "lime"), (pred_boxes, "red")):
        if boxes is None or not len(boxes):
            continue
        corners = _bev_corners_np(np.asarray(boxes))
        for i, quad in enumerate(corners):
            ax.plot(*np.vstack([quad, quad[:1]]).T, color=color, linewidth=0.8)
            if color == "red" and pred_scores is not None:
                ax.text(quad[0, 0], quad[0, 1], f"{float(pred_scores[i]):.2f}",
                        color=color, fontsize=5)
    ax.set_xlim(-pc_range, pc_range)
    ax.set_ylim(-pc_range, pc_range)
    ax.set_aspect("equal")
    fig.savefig(out_file, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_file


def write_points_obj(points, out_filename: str):
    """Dump a point cloud as OBJ vertices (show_result.py:10 _write_obj);
    columns 3:6, if present, are written as int vertex colors."""
    pts = np.asarray(_np(points))
    with open(out_filename, "w") as f:
        if pts.shape[1] >= 6:
            for p in pts:
                c = p[3:6].astype(int)
                f.write(f"v {p[0]:f} {p[1]:f} {p[2]:f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in pts:
                f.write(f"v {p[0]:f} {p[1]:f} {p[2]:f}\n")
    return out_filename


_BOX_FACES = np.array([  # 12 triangles over the 8 canonical corners
    (0, 1, 2), (0, 2, 3), (4, 6, 5), (4, 7, 6),  # bottom, top
    (0, 4, 5), (0, 5, 1), (1, 5, 6), (1, 6, 2),  # sides
    (2, 6, 7), (2, 7, 3), (3, 7, 4), (3, 4, 0),
])


def write_boxes_obj(boxes, out_filename: str):
    """Export gravity-centered (x, y, z, dx, dy, dz, yaw) boxes as a triangle
    mesh OBJ (show_result.py:32 _write_oriented_bbox, without trimesh)."""
    boxes = _np(boxes)
    boxes = np.asarray(boxes, np.float64).reshape(-1, boxes.shape[-1] if len(boxes) else 7)
    with open(out_filename, "w") as f:
        for n, b in enumerate(boxes):
            dx, dy, dz = b[3:6] / 2.0
            corners = np.array([
                [-dx, -dy, -dz], [dx, -dy, -dz], [dx, dy, -dz], [-dx, dy, -dz],
                [-dx, -dy, dz], [dx, -dy, dz], [dx, dy, dz], [-dx, dy, dz],
            ])
            c, s = np.cos(b[6]), np.sin(b[6])
            rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            verts = corners @ rot.T + b[:3]
            for v in verts:
                f.write(f"v {v[0]:f} {v[1]:f} {v[2]:f}\n")
            for a, bb, cc in _BOX_FACES + 8 * n + 1:
                f.write(f"f {a} {bb} {cc}\n")
    return out_filename


def show_result(points, gt_bboxes, pred_bboxes, out_dir: str, filename: str,
                show: bool = False, snapshot: bool = False):
    """Meshlab-format result dump (show_result.py:74): writes
    <out_dir>/<filename>/<filename>_{points,gt,pred}.obj (+ a BEV PNG in
    place of the open3d interactive window when show=True).

    Boxes arrive bottom-centered (x, y, z_bottom, dx, dy, dz, yaw) and are
    shifted to gravity center with meshlab's clockwise yaw, matching the
    reference's in-place adjustment."""
    result_path = os.path.join(out_dir, filename)
    os.makedirs(result_path, exist_ok=True)
    points, gt_bboxes, pred_bboxes = (_np(points), _np(gt_bboxes),
                                      _np(pred_bboxes))

    def _adjust(b):
        b = np.asarray(b, np.float64).copy().reshape(-1, 7)
        b[:, 2] += b[:, 5] / 2
        b[:, 6] *= -1
        return b

    if show:
        show_bev(points, gt_bboxes, pred_bboxes,
                 out_file=os.path.join(result_path, f"{filename}_online.png"))
    if points is not None:
        write_points_obj(points,
                         os.path.join(result_path, f"{filename}_points.obj"))
    if gt_bboxes is not None and len(gt_bboxes):
        write_boxes_obj(_adjust(gt_bboxes),
                        os.path.join(result_path, f"{filename}_gt.obj"))
    if pred_bboxes is not None and len(pred_bboxes):
        write_boxes_obj(_adjust(pred_bboxes),
                        os.path.join(result_path, f"{filename}_pred.obj"))
    return result_path
