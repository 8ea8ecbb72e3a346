"""Rotated BEV and 3D IoU, nearest BEV IoU (counterpart of
``sst_tpu/core/iou.py``).

Green's theorem, sort-free: the boundary of A∩B is the part of A's edges
inside B plus the part of B's edges inside A. Each sub-segment's line
integral ½(x·dy − y·dx) is independent of the others, so the area is a plain
sum over the 8 edges, and clipping one edge against a convex quad is an
interval intersection on the edge parameter t.

Shared boundaries are counted once by an eps asymmetry: A's edges are
clipped to "inside B, boundary included", B's to "strictly inside A".
"""

from __future__ import annotations

import torch

from portbench.ref.core.boxes import bev, bev_corners, nearest_bev


def _cross(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _clipped_edge_integrals(cp, cq, boundary_eps: float):
    """Σ over edges of quad P of the ½-shoelace terms of the edge portion
    inside quad Q. cp/cq: [..., 4, 2]. boundary_eps > 0 includes Q's
    boundary, < 0 excludes it."""
    a1 = cp
    d = torch.roll(cp, -1, dims=-2) - a1  # [..., 4, 2] edge directions
    b1 = cq
    e = torch.roll(cq, -1, dims=-2) - b1
    rel = a1[..., :, None, :] - b1[..., None, :, :]  # [..., 4(P), 4(Q), 2]
    eh = e[..., None, :, :]
    s0 = _cross(eh, rel) - boundary_eps
    sd = _cross(eh, d[..., :, None, :].expand(rel.shape))
    flat = torch.abs(sd) < 1e-9
    tcross = -s0 / torch.where(flat, 1.0, sd)
    lo = torch.where(~flat & (sd < 0), tcross, 0.0).amax(dim=-1)
    hi = torch.where(~flat & (sd > 0), tcross, 1.0)
    # sd ≈ 0: the whole edge is inside iff s0 <= 0, else fully clipped
    hi = torch.where(flat & (s0 > 0), -1.0, hi).amin(dim=-1)
    tlo = torch.clamp(lo, 0.0, 1.0)[..., None]
    thi = torch.clamp(hi, 0.0, 1.0)[..., None]
    pa = a1 + tlo * d
    pb = a1 + thi * d
    contrib = pa[..., 0] * pb[..., 1] - pb[..., 0] * pa[..., 1]
    return torch.where(hi > lo, contrib, 0.0).sum(dim=-1)


def rect_intersection_area(ca, cb):
    """Overlap area of quads ca/cb [..., 4, 2] (broadcast over leading dims)."""
    tot = (_clipped_edge_integrals(ca, cb, 1e-7)
           + _clipped_edge_integrals(cb, ca, -1e-7))
    return torch.abs(0.5 * tot)


def bev_overlap(boxes_a, boxes_b):
    """[N, M] rotated BEV intersection areas of 7-dof boxes."""
    ca = bev_corners(bev(boxes_a)).float()
    cb = bev_corners(bev(boxes_b)).float()
    ca, cb = torch.broadcast_tensors(ca[:, None], cb[None, :])
    return rect_intersection_area(ca, cb)


def boxes_iou_bev(boxes_a, boxes_b, eps: float = 1e-6):
    """[N, M] rotated BEV IoU."""
    inter = bev_overlap(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=eps)


def boxes_iou_3d(boxes_a, boxes_b, eps: float = 1e-6,
                 aligned: bool = False):
    """[N, M] rotated 3D IoU: the BEV overlap times the overlap of the z
    extents, ``boxes[:, 2]`` the bottom and ``boxes[:, 5]`` the height.
    ``aligned``: the [N] IoUs of row i of ``boxes_a`` with row i of
    ``boxes_b`` alone, the JAX package's ``vmap`` of the [1, 1] IoU over
    the pairs, op by op, with no [N, N] formed."""
    if aligned:
        inter_bev = rect_intersection_area(bev_corners(bev(boxes_a)).float(),
                                           bev_corners(bev(boxes_b)).float())
        a, b = boxes_a, boxes_b
    else:
        inter_bev = bev_overlap(boxes_a, boxes_b)
        a, b = boxes_a[:, None], boxes_b[None, :]
    inter_h = torch.clamp(torch.minimum(a[..., 2] + a[..., 5],
                                        b[..., 2] + b[..., 5])
                          - torch.maximum(a[..., 2], b[..., 2]), min=0.0)
    inter = inter_bev * inter_h
    vol_a = a[..., 3] * a[..., 4] * a[..., 5]
    vol_b = b[..., 3] * b[..., 4] * b[..., 5]
    return inter / torch.clamp(vol_a + vol_b - inter, min=eps)


def _aligned_overlap_2d(xyxy_a, xyxy_b):
    lt = torch.maximum(xyxy_a[:, None, :2], xyxy_b[None, :, :2])
    rb = torch.minimum(xyxy_a[:, None, 2:], xyxy_b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def nearest_iou(boxes_a, boxes_b, eps: float = 1e-6):
    """[N, M] axis-aligned nearest-BEV IoU."""
    a = nearest_bev(boxes_a)
    b = nearest_bev(boxes_b)
    inter = _aligned_overlap_2d(a, b)
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=eps)


def boxes_overlap_1to1(boxes_a, boxes_b, mode: str = "iou",
                       eps: float = 1e-6):
    """[N] rotated BEV overlap of row i of ``boxes_a`` with row i of
    ``boxes_b`` (TorchEx ``boxes_overlap_1to1``, FSD++'s seed matching):
    ``"iou"``, or ``"iof"`` (the intersection over the area of a)."""
    inter = rect_intersection_area(bev_corners(bev(boxes_a)).float(),
                                   bev_corners(bev(boxes_b)).float())
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    if mode == "iof":
        return inter / torch.clamp(area_a, min=eps)
    return inter / torch.clamp(area_a + area_b - inter, min=eps)
