"""Segment reduce over rows sorted by segment id, in plain PyTorch (the
scatter twin of the port's kernel, frozen here).

A bfloat16 row is reduced in float32 and the result rounded to bfloat16. A
sum hands each row its segment's gradient; a max hands it to the first row
of the segment that holds the maximum, and 0 to every other row. Ids
outside [0, num_segments) get 0. ``offsets`` is accepted and not read.
"""

from __future__ import annotations

import torch

MODES = {"sum": 0, "max": 1}
DTYPES = {torch.float32: ("float32", 0), torch.bfloat16: ("bfloat16", 1)}


def _check_seg(seg: torch.Tensor, num_segments: int) -> None:
    if seg.dim() != 1:
        raise ValueError(f"expected seg [N], got {tuple(seg.shape)}")
    if seg.dtype != torch.int32:
        raise TypeError(f"seg must be int32, got {seg.dtype}")
    if not seg.is_contiguous():
        raise ValueError("seg must be contiguous")
    if not 0 <= num_segments < 2**31 - 1:
        raise ValueError(f"num_segments out of int32 range: {num_segments}")


def segment_offsets_ref(seg: torch.Tensor, num_segments: int
                        ) -> torch.Tensor:
    """Plain PyTorch twin of the offsets kernel: ``offsets[s]`` is the first
    row of the nondecreasing ``seg`` whose id is >= s, for s in [0, S]."""
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=seg.device)
    return torch.searchsorted(seg, bounds, out_int32=True)


def segment_offsets(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[num_segments + 1] int32 row offsets of the segments of ``seg``."""
    _check_seg(seg, num_segments)
    return segment_offsets_ref(seg, num_segments)


def _check(data: torch.Tensor, seg: torch.Tensor, num_segments: int,
           mode: str, offsets: torch.Tensor | None) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    _check_seg(seg, num_segments)
    if data.dim() != 2 or seg.shape[0] != data.shape[0]:
        raise ValueError(f"expected data [N, C] and seg [N], got "
                         f"{tuple(data.shape)} and {tuple(seg.shape)}")
    if data.dtype not in DTYPES:
        raise TypeError(f"data must be float32 or bfloat16, got {data.dtype}")
    if data.device != seg.device:
        raise ValueError(f"data on {data.device} but seg on {seg.device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if offsets is not None and (
            offsets.shape != (num_segments + 1,)
            or offsets.dtype != torch.int32 or not offsets.is_contiguous()
            or offsets.device != seg.device):
        raise ValueError(f"offsets must be [{num_segments + 1}] int32 "
                         f"contiguous on {seg.device}, got "
                         f"{tuple(offsets.shape)} {offsets.dtype} on "
                         f"{offsets.device}")


def sorted_segment_reduce_ref(data: torch.Tensor, seg: torch.Tensor,
                              num_segments: int, mode: str = "sum"
                              ) -> torch.Tensor:
    """Plain PyTorch twin: ``ops/segment.py segment_reduce`` semantics.

    Ids outside [0, num_segments) go to an extra row that is sliced off;
    max ignores the zero init (``include_self=False``), so empty segments
    read 0 and negative maxima stay negative, and a max that is not finite
    reads 0. Rows need not be sorted. bfloat16 rows are reduced in float32
    and the result rounded to bfloat16."""
    if data.dtype != torch.float32:
        return sorted_segment_reduce_ref(data.float(), seg, num_segments,
                                         mode).to(data.dtype)
    idx = seg.long()
    idx = torch.where((idx >= 0) & (idx < num_segments), idx, num_segments)
    out = data.new_zeros((num_segments + 1, data.shape[1]))
    if mode == "sum":
        out.index_add_(0, idx, data)
    else:
        out.scatter_reduce_(0, idx[:, None].expand_as(data), data, "amax",
                            include_self=False)
        out = torch.where(torch.isfinite(out), out, 0.0)
    return out[:num_segments]


def _reduce(data: torch.Tensor, seg: torch.Tensor, num_segments: int,
            mode: str, offsets: torch.Tensor | None) -> torch.Tensor:
    return sorted_segment_reduce_ref(data, seg, num_segments, mode)


def _backward(data, seg, out, g, num_segments: int, mode: str):
    """JAX's ``_bwd``: the gradient of ``data`` from the gradient ``g`` of
    the [num_segments, C] result."""
    idx = seg.long()
    keep = ((idx >= 0) & (idx < num_segments))[:, None]
    safe = torch.clamp(idx, 0, max(num_segments - 1, 0))
    g_rows = g[safe]
    if mode == "sum":
        return torch.where(keep, g_rows, 0.0)
    n = data.shape[0]
    is_max = (data == out[safe]) & keep
    rows = torch.arange(n, device=data.device)[:, None].expand_as(data)
    rows = torch.where(is_max, rows, n)
    first = torch.full((num_segments, data.shape[1]), n, dtype=rows.dtype,
                       device=data.device)
    first.scatter_reduce_(0, safe[:, None].expand_as(data), rows, "amin")
    return torch.where(rows == first[safe], g_rows, 0.0)


class _SortedSegmentReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg, num_segments, mode, offsets):
        out = _reduce(data, seg, num_segments, mode, offsets)
        ctx.save_for_backward(data, seg, out)
        ctx.num_segments, ctx.mode = num_segments, mode
        return out

    @staticmethod
    def backward(ctx, g):
        data, seg, out = ctx.saved_tensors
        return (_backward(data, seg, out, g, ctx.num_segments, ctx.mode),
                None, None, None, None)


def sorted_segment_reduce(data: torch.Tensor, seg: torch.Tensor,
                          num_segments: int, mode: str = "sum",
                          offsets: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Per-segment sum or max over rows sorted by segment id.

    Args:
      data: [N, C] float32 or bfloat16 rows grouped by segment (the voxel
        sort's order).
      seg: [N] int32 nondecreasing ids; ids outside [0, num_segments) are
        dropped.
      num_segments: output rows.
      mode: 'sum' | 'max'.
      offsets: :func:`segment_offsets` of ``(seg, num_segments)``, computed
        here when None; read only by the kernel (the twin needs none).
    Returns [num_segments, C] in ``data``'s dtype (a bfloat16 result is the
    float32 reduction rounded to nearest even); empty segments are 0, and a
    max that is not finite (a segment holding a NaN, or a maximum of +-inf)
    is 0, in the kernel and in the twin alike: the JAX package's
    ``segment_reduce`` function. A sum holding a NaN or an inf stays non-finite. Where autograd
    needs the gradient of ``data``, it is JAX's (see the module note).
    """
    _check(data, seg, num_segments, mode, offsets)
    if torch.is_grad_enabled() and data.requires_grad:
        return _SortedSegmentReduce.apply(data, seg, num_segments, mode,
                                          offsets)
    return _reduce(data, seg, num_segments, mode, offsets)
