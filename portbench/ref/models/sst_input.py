"""SST input layer: window partition for both shifts, drop-level region
batching, the window plans and the sinusoidal in-window position embedding
(counterpart of ``sst_tpu/models/sst_input.py``).

Parameter-free: :func:`sst_input_layer` returns an :class:`SSTPlan`. In
training the voxel rows are shuffled first (a permutation the caller draws),
so that the rank-based drops fall on random voxels; the plan is built on
the shuffled rows and mapped back to the given order, as JAX does.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from portbench.ref.ops.window import (
    FlatToWindow,
    assign_drop_levels,
    drop_pass,
    finalize_flat2win,
    get_window_coors,
)


@dataclass
class SSTPlan:
    """Per-shift plans and position embeddings, and the voxels that survive
    both drop passes.

    f2w: (FlatToWindow, FlatToWindow).
    pos: per shift [N, d_model] float32 position embeddings.
    valid: [N] bool, seated in both shifts.
    num_seat_trimmed: [] int32 voxels dropped by SST's own drop rule (rank
      past the bucket's seat count, or a token count outside every bucket's
      range); the rest of ``voxel_valid & ~valid`` is window-cap overflow.
    """

    f2w: tuple
    pos: tuple
    valid: torch.Tensor
    num_seat_trimmed: torch.Tensor


def sinusoidal_window_pos(coors_in_win: torch.Tensor, window_shape,
                          d_model: int, pos_temperature: float = 10000.0,
                          normalize: bool = False) -> torch.Tensor:
    """In-window sine/cosine embedding: per axis (x, y, then z for 3D
    windows) ``d_model // ndim`` channels whose even channels hold the sine
    of the even frequencies and whose odd channels the cosine of the odd
    ones, zero-padded to ``d_model``."""
    if len(window_shape) == 2 or window_shape[-1] == 1:
        ndim = 2
        win_x, win_y = window_shape[0], window_shape[1]
        win_z = 0
    else:
        win_x, win_y, win_z = window_shape
        ndim = 3
    z = coors_in_win[:, 0].float() - win_z / 2
    y = coors_in_win[:, 1].float() - win_y / 2
    x = coors_in_win[:, 2].float() - win_x / 2
    if normalize:
        x = x / win_x * 2 * math.pi
        y = y / win_y * 2 * math.pi
        if ndim == 3:
            z = z / win_z * 2 * math.pi

    pos_length = d_model // ndim
    inv_freq = torch.arange(pos_length, dtype=torch.float32,
                            device=coors_in_win.device)
    inv_freq = pos_temperature ** (
        2 * torch.div(inv_freq, 2, rounding_mode="floor") / pos_length)

    def embed(v):
        # float32 arguments; sine and cosine taken in float64 and rounded,
        # so that the embedding does not depend on the accuracy of the
        # vector math library (torch's CPU sine has given one thread's share
        # of its first call at MKL's ~11-bit "enhanced performance" accuracy)
        e = (v[:, None] / inv_freq[None, :]).double()
        # sin of the even columns and cos of the odd ones, interleaved
        return torch.stack([torch.sin(e[:, ::2]), torch.cos(e[:, 1::2])],
                           dim=-1).reshape(v.shape[0], -1).float()

    parts = [embed(x), embed(y)] + ([embed(z)] if ndim == 3 else [])
    pe = torch.cat(parts, dim=-1)
    gap = d_model - pe.shape[1]
    if gap > 0:
        pe = torch.cat([pe, pe.new_zeros((pe.shape[0], gap))], dim=1)
    return pe


def sst_input_layer(voxel_coords: torch.Tensor, voxel_valid: torch.Tensor,
                    sparse_shape, window_shape, buckets, d_model: int,
                    max_total_windows: int, pos_temperature: float = 10000.0,
                    normalize_pos: bool = False,
                    perm: torch.Tensor | None = None) -> SSTPlan:
    """The two-shift window plan for a batch of voxels.

    sparse_shape is (x, y, z); window_shape is (wx, wy) or (wx, wy, wz).
    ``perm``, a permutation of the N voxel rows (the training-time voxel
    shuffle, JAX's ``jax.random.permutation(shuffle_rng, N)``): the ranks
    that decide the drops are taken in the order ``voxel_coords[perm]``,
    and the plan is mapped back to the rows' given order. None: the rows'
    own order (inference)."""
    n = voxel_coords.shape[0]
    if perm is not None:
        perm = perm.to(device=voxel_coords.device, dtype=torch.long)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n, device=perm.device)
        voxel_coords, voxel_valid = voxel_coords[perm], voxel_valid[perm]
    win0, ciw0 = get_window_coors(voxel_coords, sparse_shape, window_shape,
                                  False, voxel_valid)
    win1, ciw1 = get_window_coors(voxel_coords, sparse_shape, window_shape,
                                  True, voxel_valid)

    # one sort per shift: the drop pass's sort is reused for the plan
    uniq0, keep0, lvl0 = drop_pass(win0, voxel_valid, buckets,
                                   max_total_windows)
    uniq1, keep1, lvl1 = drop_pass(win1, keep0, buckets, max_total_windows)
    final = keep0 & keep1

    def design_dropped(uniq, valid, lvl):
        seg = torch.clamp(uniq.seg_ids, max=max_total_windows - 1).long()
        _, target = assign_drop_levels(
            torch.where(valid, uniq.counts[seg], 0), buckets)
        in_table = uniq.seg_ids < max_total_windows
        return valid & in_table & ((lvl < 0) | (uniq.ranks >= target))

    # shift-1 design drops are taken on shift-0 survivors, so the two sets
    # are disjoint and their sizes add
    num_seat_trimmed = (design_dropped(uniq0, voxel_valid, lvl0).sum()
                        + design_dropped(uniq1, keep0, lvl1).sum()
                        ).to(torch.int32)

    f2w0 = finalize_flat2win(uniq0, ciw0, lvl0, final, buckets,
                             max_total_windows)
    f2w1 = finalize_flat2win(uniq1, ciw1, lvl1, final, buckets,
                             max_total_windows)
    pos0 = sinusoidal_window_pos(ciw0, window_shape, d_model,
                                 pos_temperature, normalize_pos)
    pos1 = sinusoidal_window_pos(ciw1, window_shape, d_model,
                                 pos_temperature, normalize_pos)
    if perm is not None:
        # per-row fields back to the given order; the slot -> row tables
        # hold shuffled row ids, and shuffled row i is given row perm[i]
        perm32 = perm.to(torch.int32)

        def unshuffle(f: FlatToWindow) -> FlatToWindow:
            return dataclasses.replace(
                f, drop_lvl=f.drop_lvl[inv], flat_inds=f.flat_inds[inv],
                valid=f.valid[inv], coors_in_win=f.coors_in_win[inv],
                inv_inds=tuple(torch.where(
                    iv < n, perm32[torch.clamp(iv, max=n - 1).long()], n)
                    for iv in f.inv_inds))

        f2w0, f2w1 = unshuffle(f2w0), unshuffle(f2w1)
        pos0, pos1 = pos0[inv], pos1[inv]
    return SSTPlan(f2w=(f2w0, f2w1), pos=(pos0, pos1),
                   valid=f2w0.valid & f2w1.valid,
                   num_seat_trimmed=num_seat_trimmed)
