"""Target assignment (counterpart of ``sst_tpu/core/target_assign.py``: the
anchor head's max-IoU assigner, the per-point gt labels FSD's
``add_gt_fg_points`` reads, and the RoI head's IoU-piecewise sampler)."""

from __future__ import annotations

import torch

from portbench.ref.core.boxes import points_in_boxes

NEG = -1
IGNORE = -2


def max_iou_assign(anchors, gts, gt_valid, pos_thr: float, neg_thr: float,
                   min_pos_iou: float, iou_fn):
    """Each anchor to a gt box (mmdet ``MaxIoUAssigner``).

    Args:
      anchors: [A, 7]; gts: [G, 7+] padded gt boxes; gt_valid: [G] bool;
      iou_fn: pairwise (a_boxes, b_boxes) -> [n, m] IoU.

    Returns (assigned [A] int32: gt index, NEG or IGNORE; max_iou [A]): an
    anchor whose best IoU reaches ``pos_thr`` takes its first best gt, one
    below ``neg_thr`` is negative, the rest are ignored; then every anchor
    that achieves some valid gt's best IoU (at least ``min_pos_iou``) takes
    the first such gt. The JAX package streams the anchors in chunks to
    bound its memory; the full [A, G] matrix gives the same result."""
    iou = iou_fn(anchors, gts[:, :7])
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    max_iou = iou.amax(dim=1)
    argmax_gt = torch.argmax(iou, dim=1).to(torch.int32)
    # JAX's running maximum starts from -1 (an invalid gt's IoU)
    gt_best = torch.clamp(iou.amax(dim=0), min=-1.0)
    assigned = torch.full_like(argmax_gt, IGNORE)
    assigned = torch.where(max_iou < neg_thr, NEG, assigned)
    assigned = torch.where(max_iou >= pos_thr, argmax_gt, assigned)
    hit = ((iou == gt_best[None, :]) & (gt_best[None, :] >= min_pos_iou)
           & gt_valid[None, :])
    which = torch.argmax(hit.to(torch.uint8), dim=1).to(torch.int32)
    return torch.where(hit.any(dim=1), which, assigned), max_iou


def gt_fg_points_mask(points_xyz, batch_idx, valid, gt_boxes, gt_labels,
                      gt_valid, cls: int | None = None):
    """[P] bool: the point lies inside a valid gt box of its sample (of
    class ``cls``; any class where None), and is valid: the reference's
    ``add_gt_fg_points`` mask, and FSDv2's ``centroid_alpha`` weights."""
    b, g = gt_boxes.shape[:2]
    gt_flat = gt_boxes.reshape(b * g, -1)[:, :7]
    gmask = gt_valid.reshape(-1)
    if cls is not None:
        gmask = gmask & (gt_labels.reshape(-1) == cls)
    gt_b = torch.arange(b, dtype=batch_idx.dtype,
                        device=batch_idx.device).repeat_interleave(g)
    ok = (points_in_boxes(points_xyz[:, :3], gt_flat) & gmask[None, :]
          & (batch_idx[:, None] == gt_b[None, :]))
    return ok.any(dim=1) & valid


def gt_point_class_labels(points_xyz, batch_idx, valid, gt_boxes, gt_labels,
                          gt_valid):
    """[P] int32: the class of the first valid gt box of its sample that
    holds the point, -1 when none does (and for invalid points)."""
    b, g = gt_boxes.shape[:2]
    gt_flat = gt_boxes.reshape(b * g, -1)[:, :7]
    gt_b = torch.arange(b, dtype=batch_idx.dtype,
                        device=batch_idx.device).repeat_interleave(g)
    ok = (points_in_boxes(points_xyz[:, :3], gt_flat)
          & gt_valid.reshape(1, -1)
          & (batch_idx[:, None] == gt_b[None, :]))
    first = torch.argmax(ok.to(torch.uint8), dim=1)
    lbl = torch.where(ok.any(dim=1), gt_labels.reshape(-1)[first], -1)
    return torch.where(valid, lbl, -1).to(torch.int32)


def iou_neg_piecewise_sample(max_iou, is_pos, valid, num: int,
                             pos_fraction: float, neg_piece_fractions,
                             neg_iou_piece_thrs, generator=None, draws=None):
    """[P] bool keep mask of the IoU-piecewise sampler: up to
    ``int(num * pos_fraction)`` positives at random, then the rest of
    ``num`` from the negatives piece by piece by IoU band (``[thrs[i+1],
    thrs[i])`` for piece i, ``[0, thrs[-1])`` for the last), each piece
    ``floor(budget * fraction)`` plus what the piece before it could not
    fill, the last piece what is left.

    The randomness is one uniform draw per slot: ``draws`` when given (the
    JAX package's ``jax.random.uniform(rng, (P,))``, which torch cannot
    reproduce), else ``torch.rand`` from ``generator`` (on its device) or
    from the default generator on ``max_iou``'s device. Positives are the
    highest draws; within a piece, negatives are ranked in the order of
    ascending draws. Everything stays on the device: no host read."""
    from portbench.ref.ops.ccl import topk_compact
    from portbench.ref.ops.segment import INT_SENTINEL, unique_segments

    p = max_iou.shape[0]
    dev = max_iou.device
    npieces = len(neg_piece_fractions)
    if draws is None:
        draws = torch.rand(p, generator=generator,
                           device=dev if generator is None
                           else generator.device).to(dev)

    kidx, kok = topk_compact(draws, is_pos & valid, int(num * pos_fraction))
    keep = torch.zeros(p + 1, dtype=torch.bool, device=dev)
    keep[torch.where(kok, kidx, p)] = True
    keep = keep[:p]
    neg_exp = torch.clamp(num - keep.sum(dtype=torch.int32), min=0)

    neg = valid & ~is_pos
    thrs = list(neg_iou_piece_thrs) + [0.0]
    piece = torch.full((p,), npieces, dtype=torch.int32, device=dev)
    for i in range(npieces):
        lo = thrs[i + 1] if i < npieces - 1 else 0.0
        band = neg & (max_iou >= lo) & (max_iou < thrs[i])
        piece = torch.where(band, i, piece)

    # the rank of each negative within its piece over a random order
    order = torch.argsort(draws, stable=True)
    pperm = piece[order]
    inside = pperm < npieces
    uu = unique_segments(torch.where(inside, pperm, INT_SENTINEL), inside,
                         npieces)
    ranks = torch.zeros(p, dtype=torch.int32, device=dev)
    ranks[order] = uu.ranks
    counts = torch.zeros(npieces + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, piece.long(), torch.ones_like(piece))

    taken = torch.zeros((), dtype=torch.int32, device=dev)
    extend = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(npieces):
        if i == npieces - 1:
            budget = neg_exp - taken
        else:
            budget = torch.floor(neg_exp * neg_piece_fractions[i]).to(
                torch.int32) + extend
        actual = torch.minimum(counts[i], budget)
        extend = budget - actual
        taken = taken + actual
        keep = keep | ((piece == i) & (ranks < budget))
    return keep
