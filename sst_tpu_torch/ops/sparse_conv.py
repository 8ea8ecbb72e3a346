"""Submanifold / strided / inverse 3D sparse convolution: the active-site
grids, the rulebook and the dispatcher.

Counterpart of ``sst_tpu/ops/sparse_conv.py`` (``SparseGrid``,
``make_sparse_grid``, ``downsample_grid``) and of the plan half of
``sst_tpu/ops/sparse_conv_pallas.py`` (``ConvPlan``, ``_full_targets``,
``nbr_from_targets``, ``build_conv_plans``, ``windowed_sparse_conv``).

Every conv is planned as a ``[K, Vout]`` int32 neighbour table whose taps
follow the weight order (dz, dy, dx) lexicographically, with ``Vin`` marking
a missing neighbour: the sites of a grid are sorted by linearized key, so
each tap's neighbour is found by one ``torch.searchsorted``. The compute is
``ops/sparse_conv_gemm.py`` (the Hopper kernel and its plain twin, which is
JAX's ``gather_gemm``). The kernel runs over the table's mask-sorted row
schedule (``conv_schedule``), which the plan builds once and caches, as it
does the transposed table and its schedule.

Training runs the conv through one ``torch.autograd.Function`` (JAX's
``_windowed_conv`` custom vjp). Its input gradient is the transposed conv,
the same kernel over the transposed table ``nbr_t`` [K, Vin] (``Vout``
marking a missing neighbour) with ``W[k].T``: each input row appears at most
once per tap in these tables, so ``nbr_t[k, nbr[k, v]] = v`` is a unique
scatter. That is JAX's mapping in ``_windowed_conv_bwd``: a subm conv's
transposed table is its own with the taps reversed, and a strided conv's
and its inverse's are each other's, in the same tap order. The weight
gradient is ``ops/sparse_conv_dw.py``, over the forward's schedule.

Not ported, because they exist only to feed or gate the TPU kernel:
``WindowPlan``, ``build_window_plan``, ``_center_targets``, ``_pack``,
``plan_nbr``, ``pallas_eligible``, ``use_window_plans`` and the
``SST_TPU_NO_SPARSE_CONV_PALLAS`` switch (the VMEM weight limit, the 2**24
plane limit of keys carried in f32 lanes, and the window bounds of the
one-hot match matmul). On the GPU every sparse conv of a CUDA tensor runs
the kernel.

The canvas tables (``subm_neighbor_table``, ``strided_neighbor_table``,
``inverse_neighbor_table``) are JAX's other route to the same ``[27, Vout]``
tables, which SECOND's ``SparseEncoder`` takes (``models/middle_encoders.py``).
JAX looks each tap up in a column canvas with a row gather and a one-hot
select over z (a TPU workaround); here they are the rulebook's tables, from
the sorted keys, and take no canvas. ``build_canvas`` is ported as JAX's
function, for its callers; no table of the port reads it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from sst_tpu_torch.ops.segment import INT_SENTINEL
from sst_tpu_torch.ops.sparse_conv_dw import sparse_conv_dw
from sst_tpu_torch.ops.sparse_conv_gemm import (
    ConvSchedule,
    conv_schedule,
    sparse_conv_gemm,
)


@dataclass
class SparseGrid:
    """Active sites of one resolution level (sorted-key invariant).

    keys: [V] int32 linearized (b, z, y, x), ascending, INT_SENTINEL pad.
    coords: [V, 4] int32 (b, z, y, x); -1 pad.
    valid: [V] bool.
    grid: (nz, ny, nx).
    """

    keys: torch.Tensor
    coords: torch.Tensor
    valid: torch.Tensor
    grid: tuple
    batch_size: int

    @property
    def cap(self) -> int:
        return self.keys.shape[0]


@dataclass
class ConvPlan:
    """One conv's rulebook: ``nbr`` [K, Vout] int32 (Vin = missing), and the
    conv's mode ('subm' | 'strided' | 'inverse', or 'zdown' for the 3-tap
    z-only conv of ``models/middle_encoders.py``). Three caches, each built
    by the first conv over this plan that needs it: ``sched``, the kernel's
    row schedule of ``nbr``; ``nbr_t``, the transposed table
    (:func:`transpose_table`), and ``sched_t``, its schedule, for the input
    gradient. Every subm conv of a level shares its plan, and so the
    caches."""

    nbr: torch.Tensor
    mode: str
    nbr_t: torch.Tensor | None = None
    sched: ConvSchedule | None = None
    sched_t: ConvSchedule | None = None

    def transposed(self, vin: int) -> torch.Tensor:
        if self.nbr_t is None:
            self.nbr_t = transpose_table(self.nbr, vin)
        elif self.nbr_t.shape[1] != vin:
            raise ValueError(f"plan transposed for {self.nbr_t.shape[1]} "
                             f"input rows, called with {vin}")
        return self.nbr_t

    def schedule(self, vin: int) -> ConvSchedule:
        """The row schedule of ``nbr`` read against ``vin`` input rows."""
        if self.sched is None:
            self.sched = conv_schedule(self.nbr, vin)
        elif self.sched.vin != vin:
            raise ValueError(f"plan scheduled for {self.sched.vin} input "
                             f"rows, called with {vin}")
        return self.sched

    def transposed_schedule(self, vin: int) -> ConvSchedule:
        """The row schedule of ``nbr_t``, whose entries index the forward's
        ``Vout`` output rows."""
        nbr_t = self.transposed(vin)
        if self.sched_t is None:
            self.sched_t = conv_schedule(nbr_t, self.nbr.shape[1])
        return self.sched_t


def _offsets(device) -> torch.Tensor:
    """[27, 3] int32 (dz, dy, dx), lexicographic: the weight-tensor order."""
    r = torch.arange(-1, 2, dtype=torch.int32, device=device)
    dz, dy, dx = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([dz.reshape(-1), dy.reshape(-1), dx.reshape(-1)], -1)


def make_sparse_grid(coords, valid, grid, batch_size):
    """A sorted SparseGrid from (possibly unsorted) coords, and the stable
    sort order that produced it."""
    nz, ny, nx = grid
    keys = ((coords[:, 0] * nz + coords[:, 1]) * ny + coords[:, 2]) * nx \
        + coords[:, 3]
    keys = torch.where(valid, keys, INT_SENTINEL).to(torch.int32)
    keys, order = torch.sort(keys, stable=True)
    sg = SparseGrid(keys=keys, coords=coords[order], valid=valid[order],
                    grid=tuple(grid), batch_size=batch_size)
    return sg, order


def _floor_div(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def downsample_grid(sg: SparseGrid, cap_out: int,
                    stride: Sequence[int] = (2, 2, 2),
                    padding: Sequence[int] = (1, 1, 1),
                    kernel_size: int | Sequence[int] = 3) -> SparseGrid:
    """Active output sites of a strided sparse conv (spconv semantics: an
    output site exists iff any input site falls in its receptive field).

    ``kernel_size`` is one size or one per dim (z, y, x). Each input site
    contributes to at most 2 output sites per dim where k <= 2s (k = 3,
    s = 2; or k = s = 1, as SECOND's z-only ``conv_out``); the 8 candidates
    mark an occupancy canvas over the output grid, whose
    prefix sum ranks the occupied cells in ascending key order. Ranks past
    ``cap_out`` are dropped (JAX's ``mode="drop"``): they are written to one
    extra row that is sliced off."""
    dev = sg.keys.device
    nz, ny, nx = sg.grid
    s = torch.tensor(stride, dtype=torch.int32, device=dev)
    p = torch.tensor(padding, dtype=torch.int32, device=dev)
    ks = ((kernel_size,) * 3 if isinstance(kernel_size, int)
          else tuple(kernel_size))
    k = torch.tensor(ks, dtype=torch.int32, device=dev)
    out_shape = tuple(int((d + 2 * pp - kk) // ss + 1)
                      for d, pp, kk, ss in zip((nz, ny, nx), padding, ks,
                                               stride))
    oz, oy, ox = out_shape

    zyx = sg.coords[:, 1:4]
    b = sg.coords[:, 0]
    # per dim: o in [ceil((i - k + 1 + p) / s), floor((i + p) / s)]
    lo = -_floor_div(-(zyx - k + 1 + p), s)
    hi = _floor_div(zyx + p, s)
    dims = torch.tensor((oz, oy, ox), dtype=torch.int32, device=dev)
    keys, oks = [], []
    for dz in range(2):
        for dy in range(2):
            for dx in range(2):
                o = lo + torch.tensor((dz, dy, dx), dtype=torch.int32,
                                      device=dev)
                ok = ((o <= hi) & (o >= 0) & (o < dims)).all(-1) & sg.valid
                key = ((b * oz + o[:, 0]) * oy + o[:, 1]) * ox + o[:, 2]
                keys.append(key)
                oks.append(ok)
    all_keys = torch.cat(keys)
    all_ok = torch.cat(oks)
    size = sg.batch_size * oz * oy * ox
    occ = torch.zeros(size + 1, dtype=torch.bool, device=dev)
    occ[torch.where(all_ok, all_keys, size).long()] = True
    occ = occ[:size]
    rank = torch.cumsum(occ, 0, dtype=torch.int32) - 1
    slot = torch.where(occ, torch.clamp(rank, max=cap_out), cap_out)
    out_keys = torch.full((cap_out + 1,), INT_SENTINEL, dtype=torch.int32,
                          device=dev)
    out_keys[slot.long()] = torch.arange(size, dtype=torch.int32, device=dev)
    out_keys = out_keys[:cap_out]
    out_valid = out_keys != INT_SENTINEL
    uk = torch.where(out_valid, out_keys, 0)
    x = uk % ox
    r = uk // ox
    y = r % oy
    r = r // oy
    z = r % oz
    bb = r // oz
    out_coords = torch.where(out_valid[:, None],
                             torch.stack([bb, z, y, x], -1), -1)
    return SparseGrid(keys=out_keys, coords=out_coords.to(torch.int32),
                      valid=out_valid, grid=out_shape,
                      batch_size=sg.batch_size)


def build_canvas(sg: SparseGrid) -> torch.Tensor:
    """Column canvas [B*ny*nx + 1, nz + 2] int32: row (b*ny + y)*nx + x,
    column z + 1 holds the index of the site at (b, z, y, x), and ``cap``
    every empty slot. The ghost columns 0 and nz + 1 and the trailing row
    stay ``cap``, so a lookup one step outside the grid, or at a masked
    cell, reads a missing neighbour. (JAX's canvas writes its padding sites
    into the trailing row's first slot; no table reads it unmasked.)"""
    nz, ny, nx = sg.grid
    nzp = nz + 2
    ncells = sg.batch_size * ny * nx
    c = sg.coords.long()
    pos = ((c[:, 0] * ny + c[:, 2]) * nx + c[:, 3]) * nzp + c[:, 1] + 1
    size = (ncells + 1) * nzp
    pos = torch.where(sg.valid, pos, size)
    flat = torch.full((size + 1,), sg.cap, dtype=torch.int32,
                      device=pos.device)
    flat[pos] = torch.arange(sg.cap, dtype=torch.int32, device=pos.device)
    return flat[:size].view(ncells + 1, nzp)


def subm_neighbor_table(sg: SparseGrid) -> torch.Tensor:
    """[27, V] int32 neighbour site indices of a submanifold 3x3x3 conv
    (``cap`` = missing), taps in (dz, dy, dx) order: JAX's canvas table,
    built from the sorted keys by :func:`build_conv_plans`."""
    return build_conv_plans(sg, sg, "subm").nbr


def strided_neighbor_table(out_sg: SparseGrid, in_sg: SparseGrid,
                           stride=(2, 2, 2),
                           padding=(1, 1, 1)) -> torch.Tensor:
    """[27, Vout] input site indices of a strided 3x3x3 conv: tap k of
    output o reads the input site at ``o * s - p + offs[k]``."""
    return build_conv_plans(out_sg, in_sg, "strided", stride, padding).nbr


def inverse_neighbor_table(out_sg: SparseGrid, down_sg: SparseGrid,
                           stride=(2, 2, 2),
                           padding=(1, 1, 1)) -> torch.Tensor:
    """[27, Vout] table of the inverse conv back to ``out_sg`` (the level
    before the downsample): tap k of output i reads the downsampled site o
    with ``o * s - p + offs[k] == i``, where that o is integral."""
    return build_conv_plans(out_sg, down_sg, "inverse", stride,
                            padding).nbr


def _full_targets(out_sg: SparseGrid, in_grid, mode: str, stride, padding):
    """All 27 per-tap input keys [27, Vout] int32 (-1 = no neighbour), taps
    in lexicographic (dz, dy, dx) order: the weight-tensor order."""
    dev = out_sg.keys.device
    nz, ny, nx = in_grid
    plane = nz * ny * nx
    offs = _offsets(dev)[:, :, None]  # [27, 3, 1]
    c = out_sg.coords.T[None]  # [1, 4, Vout]
    b, zyx = c[:, 0], c[:, 1:4]
    s = torch.tensor(stride, dtype=torch.int32, device=dev)[None, :, None]
    p = torch.tensor(padding, dtype=torch.int32, device=dev)[None, :, None]
    ok = out_sg.valid[None]
    if mode == "subm":
        izyx = zyx + offs
    elif mode == "strided":
        izyx = zyx * s - p + offs
    elif mode == "inverse":
        num = zyx + p - offs
        izyx = _floor_div(num, s)
        ok = ok & (izyx * s == num).all(1)
    else:
        raise ValueError(f"unknown conv mode {mode!r}")
    dims = torch.tensor(in_grid, dtype=torch.int32, device=dev)[None, :, None]
    ok = ok & ((izyx >= 0) & (izyx < dims)).all(1)
    key = b * plane + (izyx[:, 0] * ny + izyx[:, 1]) * nx + izyx[:, 2]
    return torch.where(ok, key, -1).to(torch.int32)


def nbr_from_targets(tfull: torch.Tensor, in_keys: torch.Tensor,
                     cap_in: int) -> torch.Tensor:
    """[K, Vout] neighbour site indices (cap_in = missing) by binary search
    over the sorted (INT_SENTINEL-padded) key array."""
    idx = torch.searchsorted(in_keys, tfull, out_int32=True)
    idx_c = torch.clamp(idx, max=in_keys.shape[0] - 1)
    hit = (in_keys[idx_c.long()] == tfull) & (tfull >= 0) & (idx_c < cap_in)
    return torch.where(hit, idx_c, cap_in)


def build_conv_plans(out_sg: SparseGrid, in_sg: SparseGrid, mode: str,
                     stride=(2, 2, 2), padding=(1, 1, 1)) -> ConvPlan:
    """The rulebook of one conv from ``in_sg`` to ``out_sg``."""
    if mode == "subm":
        stride, padding = (1, 1, 1), (0, 0, 0)
    tfull = _full_targets(out_sg, in_sg.grid, mode, stride, padding)
    return ConvPlan(nbr=nbr_from_targets(tfull, in_sg.keys, in_sg.cap),
                    mode=mode)


def transpose_table(nbr: torch.Tensor, vin: int) -> torch.Tensor:
    """The transposed conv's table [K, Vin] int32: ``nbr_t[k, i]`` is the
    output row that read input row ``i`` at tap ``k``, ``Vout`` where none
    did. Missing entries of ``nbr`` (outside [0, Vin)) scatter into one
    extra column that is sliced off."""
    taps, vout = nbr.shape
    idx = nbr.long()
    idx = torch.where((idx >= 0) & (idx < vin), idx, vin)
    rows = torch.arange(vout, dtype=torch.int32, device=nbr.device)
    out = torch.full((taps, vin + 1), vout, dtype=torch.int32,
                     device=nbr.device)
    out.scatter_(1, idx, rows.expand(taps, vout))
    return out[:, :vin].contiguous()


class _SparseConv(torch.autograd.Function):
    """The conv with JAX's backward (``_windowed_conv_bwd``): dfeats by the
    conv kernel over the transposed table (and its schedule) with
    ``W[k].T``, dW by the weight gradient kernel over the forward's
    schedule (their twins for CPU tensors). At bfloat16 every operand and
    result is bf16, as in JAX: the output gradient reaches the backward in
    the output's dtype, the input gradient is the bf16 conv route, and dW
    is rounded to bf16 once (``.astype(weights.dtype)``); the cast of the
    float32 parameter to bf16 before the call returns it to float32."""

    @staticmethod
    def forward(ctx, feats, weights, nbr, nbr_t, sched, sched_t, mode):
        ctx.save_for_backward(feats, weights, nbr, nbr_t)
        ctx.mode = mode
        ctx.sched, ctx.sched_t = sched, sched_t
        return sparse_conv_gemm(feats, nbr, weights, mode, schedule=sched)

    @staticmethod
    def backward(ctx, grad):
        feats, weights, nbr, nbr_t = ctx.saved_tensors
        grad = grad.contiguous()
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = sparse_conv_gemm(grad, nbr_t,
                                      weights.transpose(1, 2).contiguous(),
                                      ctx.mode, kind="dgrad",
                                      schedule=ctx.sched_t)
        if ctx.needs_input_grad[1]:
            dw = sparse_conv_dw(feats, nbr, grad, ctx.mode,
                                schedule=ctx.sched)
        return dfeats, dw, None, None, None, None, None


def windowed_sparse_conv(feats: torch.Tensor, weights: torch.Tensor,
                         cp: ConvPlan) -> torch.Tensor:
    """One sparse conv: feats [Vin, Cin], weights [K, Cin, Cout] of the same
    dtype (float32 or bfloat16) → [Vout, Cout] in that dtype, through the kernel wrapper (its twin on the CPU) over the
    plan's row schedule. Where autograd needs its gradient it runs through
    :class:`_SparseConv`, and the plan's transposed table and its schedule
    are built (once) for the input gradient."""
    vin = feats.shape[0]
    if torch.is_grad_enabled() and (feats.requires_grad
                                    or weights.requires_grad):
        return _SparseConv.apply(feats, weights, cp.nbr, cp.transposed(vin),
                                 cp.schedule(vin),
                                 cp.transposed_schedule(vin), cp.mode)
    return sparse_conv_gemm(feats, cp.nbr, weights, cp.mode,
                            schedule=cp.schedule(vin))
