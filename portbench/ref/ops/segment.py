"""Sort/segment sparse primitives (counterpart of ``sst_tpu/ops/segment.py``).

Everything here keeps the reference's static-shape contract: callers pass a
padded array of N slots with a validity mask plus a fixed segment capacity.
Invalid slots get segment id ``num_segments``. JAX drops such ids in its
scatters; torch raises on an out-of-bounds index, so every reduction here
scatters into one extra row that is sliced off afterwards.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT_SENTINEL = 2**31 - 1


class UniqueResult(NamedTuple):
    """Static-shape ``torch.unique(keys, return_inverse, return_counts)``.

    Attributes:
      seg_ids: [N] int32 dense segment id in [0, num_segments) for valid
        slots; ``num_segments`` for invalid slots and capacity overflow.
      ranks: [N] int32 rank of the element within its segment in sorted-key
        order (zeros from :func:`unique_segments_canvas`).
      unique_keys: [num_segments] int32 distinct keys, INT_SENTINEL unused.
      counts: [num_segments] int32 valid elements per segment.
      num_unique: [] int32 distinct valid keys (may exceed num_segments).
      valid: [N] bool input validity.
      order: [N] int64 sort permutation (rows taken in this order are grouped
        by segment with nondecreasing ids), or None when nothing was sorted.
    """

    seg_ids: torch.Tensor
    ranks: torch.Tensor
    unique_keys: torch.Tensor
    counts: torch.Tensor
    num_unique: torch.Tensor
    valid: torch.Tensor
    order: torch.Tensor | None = None


def _drop_row_ids(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 ids with everything outside [0, num_segments) sent to the extra
    row ``num_segments``."""
    seg = seg_ids.long()
    return torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)


def _count(seg_ids: torch.Tensor, weights: torch.Tensor,
           num_segments: int) -> torch.Tensor:
    idx = _drop_row_ids(seg_ids, num_segments)
    out = torch.zeros(num_segments + 1, dtype=torch.int32, device=idx.device)
    out.index_add_(0, idx, weights.to(torch.int32))
    return out[:num_segments]


def unique_segments(keys: torch.Tensor, valid: torch.Tensor,
                    num_segments: int) -> UniqueResult:
    """Dense segment ids for integer keys via one stable sort.

    Args:
      keys: [N] int32 group keys.
      valid: [N] bool mask of real slots.
      num_segments: capacity for the number of distinct keys.
    """
    n = keys.shape[0]
    dev = keys.device
    k = torch.where(valid, keys, INT_SENTINEL).to(torch.int32)
    ks, order = torch.sort(k, stable=True)
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = ks[1:] != ks[:-1]
    seg_sorted = torch.cumsum(head, 0, dtype=torch.int32) - 1
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    start = torch.cummax(torch.where(head, idx, 0), 0).values
    rank_sorted = idx - start
    valid_sorted = ks != INT_SENTINEL
    num_unique = (head & valid_sorted).sum(dtype=torch.int32)
    seg_sorted = torch.where(valid_sorted, seg_sorted, num_segments)
    seg_sorted = torch.clamp(seg_sorted, max=num_segments)

    inv_order = torch.empty_like(idx)
    inv_order[order] = idx
    inv = inv_order.long()
    seg_ids = seg_sorted[inv]
    ranks = rank_sorted[inv]

    unique_keys = torch.full((num_segments + 1,), INT_SENTINEL,
                             dtype=torch.int32, device=dev)
    unique_keys[seg_sorted.long()] = ks
    counts = _count(seg_sorted, valid_sorted, num_segments)
    return UniqueResult(seg_ids, ranks, unique_keys[:num_segments], counts,
                        num_unique, valid, order)


def unique_segments_canvas(keys: torch.Tensor, valid: torch.Tensor,
                           num_segments: int, key_space: int) -> UniqueResult:
    """Sort-free unique for bounded key spaces: occupancy canvas + cumsum.

    Same dense ids (ascending key order) and overflow semantics as
    :func:`unique_segments`; ``ranks`` are zeros and ``order`` is None.
    Memory is O(key_space).
    """
    n = keys.shape[0]
    dev = keys.device
    k = torch.where(valid, keys, key_space).long()
    occ = torch.zeros(key_space + 1, dtype=torch.bool, device=dev)
    occ[k] = True
    occ = occ[:key_space]
    rank = torch.cumsum(occ, 0, dtype=torch.int32) - 1
    cell_seg = torch.where(occ, torch.clamp(rank, max=num_segments),
                           num_segments)
    seg_ids = torch.where(valid, cell_seg[torch.clamp(k, max=key_space - 1)],
                          num_segments).to(torch.int32)
    num_unique = occ.sum(dtype=torch.int32)
    unique_keys = torch.full((num_segments + 1,), INT_SENTINEL,
                             dtype=torch.int32, device=dev)
    unique_keys[seg_ids.long()] = k.to(torch.int32)
    counts = _count(seg_ids, valid, num_segments)
    ranks = torch.zeros(n, dtype=torch.int32, device=dev)
    return UniqueResult(seg_ids, ranks, unique_keys[:num_segments], counts,
                        num_unique, valid)


def segment_reduce(data: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, mode: str = "mean") -> torch.Tensor:
    """Segment reduction with out-of-range-drop semantics.

    Args:
      data: [N, C] (or [N]); rows whose id lies outside [0, num_segments)
        are dropped.
      seg_ids: [N] int32.
      mode: 'sum' | 'mean' | 'max' | 'min'.

    Returns [num_segments, C] in ``data``'s dtype. Empty segments are 0 in
    every mode; max and min ignore the zero init (``include_self=False``),
    so a segment of negative values keeps its negative maximum. A max or
    min that is not finite (a segment holding a NaN, or an infinite
    extreme) is written as 0, as the JAX package does.

    Sums and means of bfloat16 rows are taken in float32 (the counts too)
    and rounded once. JAX's ``segment_sum`` in bfloat16 rounds after each
    add, and ``index_add_`` in bfloat16 would too, in no fixed order on the
    card; a float32 sum rounded once is nearer the exact one. A max or min
    is exact in any dtype.
    """
    squeeze = data.dim() == 1
    if squeeze:
        data = data[:, None]
    idx = _drop_row_ids(seg_ids, num_segments)
    if mode in ("sum", "mean"):
        acc = data.float()
        out = acc.new_zeros((num_segments + 1, data.shape[1]))
        out.index_add_(0, idx, acc)
        if mode == "mean":
            cnt = acc.new_zeros(num_segments + 1)
            cnt.index_add_(0, idx, acc.new_ones(data.shape[0]))
            out = out / torch.clamp(cnt, min=1.0)[:, None]
        out = out.to(data.dtype)
    elif mode in ("max", "min"):
        out = data.new_zeros((num_segments + 1, data.shape[1]))
        out.scatter_reduce_(0, idx[:, None].expand_as(data), data,
                            "amax" if mode == "max" else "amin",
                            include_self=False)
        out = torch.where(torch.isfinite(out), out, 0.0)
    else:
        raise NotImplementedError(mode)
    out = out[:num_segments]
    return out[:, 0] if squeeze else out


def segment_max_with_argmax(data: torch.Tensor, seg_ids: torch.Tensor,
                            num_segments: int):
    """Per-segment max (as :func:`segment_reduce` ``"max"``) and the row
    that holds it: the lowest row index whose value equals the max, per
    channel. Returns (max [num_segments, ...], argmax int32 of the same
    shape): an empty segment's argmax is ``2**31 - 1``, a non-empty one's
    with no row equal to its written max (a non-finite max, written as 0)
    is N, as JAX's ``segment_min`` of the row indices gives them."""
    out = segment_reduce(data, seg_ids, num_segments, "max")
    own = torch.clamp(seg_ids.long(), max=num_segments - 1)
    is_max = data == out[own]
    n = data.shape[0]
    row = torch.arange(n, dtype=torch.int32, device=data.device)
    row = row.view((-1,) + (1,) * (data.dim() - 1)).expand(data.shape)
    row = torch.where(is_max, row, n)
    idx = _drop_row_ids(seg_ids, num_segments)
    idx = idx.view((-1,) + (1,) * (data.dim() - 1)).expand(data.shape)
    argmax = torch.full((num_segments + 1,) + tuple(data.shape[1:]),
                        INT_SENTINEL, dtype=torch.int32, device=data.device)
    argmax.scatter_reduce_(0, idx, row, "amin")
    return out, argmax[:num_segments]


def scatter_v2(feat: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
               num_segments: int, mode: str = "mean",
               unique: UniqueResult | None = None):
    """Unique + segment reduce, the reference's most-used primitive.
    Returns (voxel_feats [num_segments, C], UniqueResult); a ``unique``
    passed in is reused, its sort not repeated."""
    if unique is None:
        unique = unique_segments(keys, valid, num_segments)
    return segment_reduce(feat, unique.seg_ids, num_segments, mode), unique


def gather_rows(src: torch.Tensor, index: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """[len(index), ...]: row j is ``src[index[j]]``, or ``fill`` where
    ``index[j]`` lies outside [0, N) (the padding slots of an inverse
    table). ``src`` is [N, ...] of any rank.

    An ``index_select``, whose backward adds each row's gradient into its
    source. The rows outside read source ``j mod N`` and are masked: sent
    all to one source, their zero gradients would be added to that row one
    after another on the card."""
    n = src.shape[0]
    inside = (index >= 0) & (index < n)
    spread = torch.arange(index.shape[0], device=index.device) % n
    rows = torch.index_select(src, 0, torch.where(inside, index.long(),
                                                  spread))
    return torch.where(inside.view((-1,) + (1,) * (src.dim() - 1)), rows,
                       fill)


def gather_segments(voxel_data: torch.Tensor, seg_ids: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """Broadcast per-segment rows [S, ...] back to elements; ids outside
    [0, S) (the invalid elements' id S) get ``fill``. A ``gather_rows``, so
    the invalid elements do not all add their zero gradients into one
    segment's row in the backward."""
    return gather_rows(voxel_data, seg_ids, fill)
