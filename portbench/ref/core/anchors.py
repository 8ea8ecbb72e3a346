"""Aligned 3D anchor generation, numpy on the host (counterpart of
``sst_tpu/core/anchors.py``).

AlignedAnchor3DRangeGenerator semantics: linspace over the range with
feature_size + 1 knots, centres shifted half a cell (align_corner=False),
per-class sizes and rotations.
"""

from __future__ import annotations

import numpy as np


def aligned_anchors_single_range(feature_size, anchor_range, size,
                                 rotations=(0.0, 1.5707963),
                                 align_corner: bool = False) -> np.ndarray:
    """[D, H, W, num_rot, 7] float32 anchors; ``feature_size`` is (H, W) or
    (D, H, W), ``anchor_range`` (x0, y0, z0, x1, y1, z1), ``size``
    (w, l, h)."""
    if len(feature_size) == 2:
        feature_size = (1, feature_size[0], feature_size[1])
    d, h, w = feature_size
    zc = np.linspace(anchor_range[2], anchor_range[5], d + 1,
                     dtype=np.float64)
    yc = np.linspace(anchor_range[1], anchor_range[4], h + 1,
                     dtype=np.float64)
    xc = np.linspace(anchor_range[0], anchor_range[3], w + 1,
                     dtype=np.float64)
    if not align_corner:
        zc = zc + (zc[1] - zc[0]) / 2
        yc = yc + (yc[1] - yc[0]) / 2
        xc = xc + (xc[1] - xc[0]) / 2
    zc, yc, xc = zc[:d], yc[:h], xc[:w]
    rot = np.asarray(rotations, np.float64)
    zz, yy, xx, rr = np.meshgrid(zc, yc, xc, rot, indexing="ij")
    sz = np.broadcast_to(np.asarray(size, np.float64), (*zz.shape, 3))
    anchors = np.concatenate(
        [xx[..., None], yy[..., None], zz[..., None], sz, rr[..., None]],
        axis=-1)
    return anchors.astype(np.float32)


def multiclass_aligned_anchors(feature_size, ranges, sizes,
                               rotations=(0.0, 1.5707963)) -> np.ndarray:
    """Per-class anchors stacked: [num_cls, H * W * num_rot, 7] (D = 1)."""
    return np.stack([
        aligned_anchors_single_range(feature_size, r, s, rotations)
        .reshape(-1, 7) for r, s in zip(ranges, sizes)])
