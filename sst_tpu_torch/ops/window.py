"""Regional window grouping and drop-level region batching, static-shape
(counterpart of ``sst_tpu/ops/window.py``).

Voxels are grouped into windows (``get_window_coors``); each shift's drop
pass sorts the window ids once (``drop_pass``) and the plan
(``finalize_flat2win``) numbers every bucket's windows by ascending window
key, seats each surviving voxel at ``window * max_tokens + rank`` and keeps,
per bucket, the slot -> row table ``inv_inds`` and the key padding mask
``pads``. ``flat2window`` is then one row gather per bucket and
``window2flat`` one gather back.

JAX drops out-of-range ids in its ``mode="drop"`` scatters; torch raises on
them, so each such scatter writes into one extra row that is sliced off.
The JAX package's legacy scatter plan (``build_flat2win``,
``drop_and_bucket``) is not on the port's path and has no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch

from sst_tpu_torch.ops.segment import (
    UniqueResult,
    gather_rows,
    unique_segments,
)

OOB = 2**31 - 1


@dataclass(frozen=True)
class BucketSpec:
    """One region-batching level: windows holding a token count in
    [drop_lower, drop_upper) are seated in ``max_windows`` windows of
    ``max_tokens`` slots."""

    max_tokens: int
    drop_lower: int
    drop_upper: int
    max_windows: int


@dataclass
class FlatToWindow:
    """Gather plan between flat voxels [N, C] and one shift's bucketed
    window tensors ([max_windows_b, max_tokens_b, C] per bucket).

    drop_lvl: [N] int32 bucket index, -1 where the voxel is not seated.
    flat_inds: [N] int32 ``window_in_bucket * max_tokens + rank``, OOB
      where the voxel is not seated.
    valid: [N] bool, the voxel is seated in this shift.
    coors_in_win: [N, 3] int32 (z, y, x) within the window.
    buckets: the BucketSpecs.
    pads: per bucket [max_windows, max_tokens] bool, True for an empty slot.
    inv_inds: per bucket [max_windows * max_tokens] int32 slot -> row (N for
      an empty slot)."""

    drop_lvl: torch.Tensor
    flat_inds: torch.Tensor
    valid: torch.Tensor
    coors_in_win: torch.Tensor
    buckets: tuple
    pads: tuple = field(default=())
    inv_inds: tuple = field(default=())


def _floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def get_window_coors(coords: torch.Tensor, sparse_shape: Sequence[int],
                     window_shape: Sequence[int], do_shift: bool,
                     valid: torch.Tensor):
    """Voxel coords (b, z, y, x) -> batch-unique window index (-1 where not
    valid) and (z, y, x) within the window. ``sparse_shape`` is (x, y, z);
    ``window_shape`` is (wx, wy) for pillar windows or (wx, wy, wz).
    Division and remainder floor, as Python's and JAX's do."""
    if len(window_shape) == 2:
        wx, wy = window_shape
        wz = sparse_shape[2]
    else:
        wx, wy, wz = window_shape
    sx, sy, sz = sparse_shape

    mx = -(-sx // wx) + 1  # ceil + 1, room for the shifted pass
    my = -(-sy // wy) + 1
    mz = -(-sz // wz) + 1
    n_win_per_sample = mx * my * mz

    if do_shift:
        shift_x, shift_y, shift_z = wx // 2, wy // 2, wz // 2
    else:
        shift_x, shift_y, shift_z = wx, wy, wz
    if sz == wz:  # 2D windows: never shift along z
        shift_z = 0

    x = coords[:, 3] + shift_x
    y = coords[:, 2] + shift_y
    z = coords[:, 1] + shift_z
    win_x, win_y, win_z = _floor_div(x, wx), _floor_div(y, wy), \
        _floor_div(z, wz)
    batch_win_inds = (coords[:, 0] * n_win_per_sample
                      + (win_x * my + win_y) * mz + win_z)
    batch_win_inds = torch.where(valid, batch_win_inds, -1).to(torch.int32)
    coors_in_win = torch.stack(
        [torch.remainder(z, wz), torch.remainder(y, wy),
         torch.remainder(x, wx)], dim=-1).to(torch.int32)
    return batch_win_inds, coors_in_win


def assign_drop_levels(counts_per_voxel: torch.Tensor,
                       buckets: Sequence[BucketSpec]):
    """Token count -> bucket index (-1 outside every bucket's drop range) and
    that bucket's seat count (0 there)."""
    lvl = torch.full_like(counts_per_voxel, -1)
    target = torch.zeros_like(counts_per_voxel)
    for i, b in enumerate(buckets):
        m = (counts_per_voxel >= b.drop_lower) & (counts_per_voxel
                                                  < b.drop_upper)
        lvl = torch.where(m, i, lvl)
        target = torch.where(m, b.max_tokens, target)
    return lvl, target


def drop_pass(win_inds: torch.Tensor, valid: torch.Tensor,
              buckets: Sequence[BucketSpec], max_total_windows: int):
    """One shift's drop pass: one sort of the window ids, the per-window
    token counts, each voxel's drop level, and the keep mask (rank below
    the bucket's seat count, window inside the table). Returns
    (UniqueResult, keep, drop_lvl); the sort is reused by
    :func:`finalize_flat2win`."""
    uniq = unique_segments(win_inds, valid, max_total_windows)
    seg = torch.clamp(uniq.seg_ids, max=max_total_windows - 1).long()
    counts_per_voxel = torch.where(valid, uniq.counts[seg], 0)
    lvl, target = assign_drop_levels(counts_per_voxel, buckets)
    keep = (valid & (lvl >= 0) & (uniq.ranks < target)
            & (uniq.seg_ids < max_total_windows))
    return uniq, keep, lvl


def finalize_flat2win(uniq: UniqueResult, coors_in_win: torch.Tensor,
                      drop_lvl: torch.Tensor, valid: torch.Tensor,
                      buckets: Sequence[BucketSpec],
                      max_total_windows: int) -> FlatToWindow:
    """The shift's plan from its drop-pass sort, with no further sorting.

    Windows are numbered within their bucket by ascending window key; only
    windows holding a voxel of ``valid`` (which may be a subset of the drop
    pass's mask: the other shift's drops) take a slot, and windows past a
    bucket's ``max_windows`` are dropped."""
    n = uniq.seg_ids.shape[0]
    dev = uniq.seg_ids.device
    wused = uniq.counts > 0
    wlvl, _ = assign_drop_levels(uniq.counts, buckets)
    wlvl = torch.where(wused, wlvl, -1)
    seg = torch.clamp(uniq.seg_ids, max=max_total_windows - 1).long()
    surv_idx = torch.where(valid, uniq.seg_ids, max_total_windows).long()
    wsurv = torch.zeros(max_total_windows + 1, dtype=torch.bool, device=dev)
    wsurv[surv_idx] = True
    wsurv = wsurv[:max_total_windows]
    flat_inds = torch.full((n,), OOB, dtype=torch.int32, device=dev)
    out_valid = torch.zeros(n, dtype=torch.bool, device=dev)
    for i, b in enumerate(buckets):
        wmask = (wlvl == i) & wsurv
        cw = torch.cumsum(wmask.to(torch.int32), 0, dtype=torch.int32) - 1
        wok = wmask & (cw < b.max_windows)
        ok = (valid & (drop_lvl == i) & (uniq.seg_ids < max_total_windows)
              & wok[seg] & (uniq.ranks < b.max_tokens))
        flat_inds = torch.where(ok, cw[seg] * b.max_tokens + uniq.ranks,
                                flat_inds)
        out_valid = out_valid | ok
    f2w = FlatToWindow(drop_lvl=torch.where(out_valid, drop_lvl, -1),
                       flat_inds=flat_inds, valid=out_valid,
                       coors_in_win=coors_in_win, buckets=tuple(buckets))
    inv = invert_flat_inds(f2w)
    f2w.inv_inds = tuple(inv)
    f2w.pads = tuple((iv == n).reshape(b.max_windows, b.max_tokens)
                     for iv, b in zip(inv, f2w.buckets))
    return f2w


def invert_flat_inds(f2w: FlatToWindow):
    """Per-bucket slot -> row tables (one int32 scatter each, once per
    plan); an empty slot holds N."""
    n = f2w.flat_inds.shape[0]
    dev = f2w.flat_inds.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    out = []
    for i, b in enumerate(f2w.buckets):
        size = b.max_windows * b.max_tokens
        idx = torch.where(f2w.valid & (f2w.drop_lvl == i), f2w.flat_inds,
                          size).long()
        inv = torch.full((size + 1,), n, dtype=torch.int32, device=dev)
        inv[idx] = rows
        out.append(inv[:size])
    return out


def flat2window(feat: torch.Tensor, f2w: FlatToWindow,
                padding: float = 0.0):
    """[N, C] voxel features -> list of [max_windows_b, max_tokens_b, C]
    window tensors, one row gather per bucket (``ops/segment.py
    gather_rows``); empty slots read ``padding``."""
    c = feat.shape[-1]
    return [gather_rows(feat, inv, padding).reshape(b.max_windows,
                                                    b.max_tokens, c)
            for b, inv in zip(f2w.buckets, f2w.inv_inds)]


def window2flat(feat_3d_list, f2w: FlatToWindow) -> torch.Tensor:
    """Per-bucket window tensors back to flat [N, C], one row gather per
    bucket (``gather_rows``); voxels not seated in this shift read 0."""
    out = None
    for i, feat in enumerate(feat_3d_list):
        flat = feat.reshape(-1, feat.shape[-1])
        in_b = f2w.valid & (f2w.drop_lvl == i)
        rows = gather_rows(flat, torch.where(in_b, f2w.flat_inds, -1))
        out = rows if out is None else torch.where(in_b[:, None], rows, out)
    return out


def window_key_padding(f2w: FlatToWindow):
    """Per bucket [max_windows_b, max_tokens_b] bool, True = empty slot
    (computed once at plan build)."""
    return list(f2w.pads)
