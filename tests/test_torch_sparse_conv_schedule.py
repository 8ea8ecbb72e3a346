"""The sparse conv kernel's mask-sorted row schedule
(``sst_tpu_torch/ops/sparse_conv_gemm.py conv_schedule``), on the CPU.

The kernel (``csrc/sparse_conv_gemm.cu``) runs only on the card. Here the
schedule is checked for what the kernel relies on (a permutation of the
output rows, sorted stably by tap mask, and each tile's mask the OR of its
rows'), and a plain emulation of the kernel's tile loop (tile ``i`` computes
rows ``perm[64 i : 64 (i + 1)]`` over the taps set in ``tile_mask[i]`` only,
and writes each row through ``perm``) is held against the twin within 1e-6:
on random tables and on the rulebooks the port builds for
``tiny_fsdv2_flagship``. The plans build each schedule once and cache it.
"""

import numpy as np
import pytest
import torch

from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.models.sparse_unet import SparseConvLayer
from sst_tpu_torch.ops import sparse_conv as tsc
from sst_tpu_torch.ops import sparse_conv_gemm as scg

TILE = scg.TILE_ROWS


def _table(seed, vin, vout, taps, missing=0.6):
    """A [K, Vout] table whose entries are missing (Vin, -1 or past Vin)
    with probability ``missing``."""
    rng = np.random.RandomState(seed)
    nbr = rng.randint(0, max(vin, 1), (taps, vout))
    drop = rng.rand(taps, vout) < missing
    nbr = np.where(drop, rng.choice([vin, -1, vin + 7], (taps, vout)), nbr)
    return torch.from_numpy(nbr.astype(np.int32))


# (vin, vout, taps, missing): K = 3, 27 and 32 (bit 31 is the int32 sign);
# Vout on and off the 64-row tile, below one tile; a table with every
# entry missing; one with a tap that no row has
TABLES = [(300, 500, 27, 0.6), (700, 400, 3, 0.5), (900, 640, 27, 0.9),
          (1200, 1000, 32, 0.7), (50, 37, 27, 0.4), (200, 256, 27, 1.0),
          (400, 777, 5, 0.0)]


def _row_masks(nbr, vin):
    has = ((nbr >= 0) & (nbr < vin)).numpy()
    return (has.astype(np.int64) << np.arange(nbr.shape[0])[:, None]).sum(0)


@pytest.mark.parametrize("vin,vout,taps,missing", TABLES)
def test_schedule_sorts_rows_by_tap_mask(vin, vout, taps, missing):
    """``perm`` is a permutation of [0, Vout), stably sorted by mask (the
    mask-0 rows first, together), and ``tile_mask`` is the OR of each
    tile's row masks."""
    nbr = _table(vin + vout + taps, vin, vout, taps, missing)
    if taps == 5:
        nbr[2] = vin  # a tap that no row has
    sched = scg.conv_schedule(nbr, vin)
    perm = sched.perm.numpy()
    assert sched.perm.dtype == torch.int32 and sched.vin == vin
    assert sched.tile_mask.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(perm), np.arange(vout))
    masks = _row_masks(nbr, vin)
    sorted_masks = masks[perm]
    assert (np.diff(sorted_masks) >= 0).all()
    same = np.diff(sorted_masks) == 0
    assert (np.diff(perm)[same] > 0).all()  # stable: ties keep row order
    n_zero = int((masks == 0).sum())
    assert (sorted_masks[:n_zero] == 0).all()
    assert (sorted_masks[n_zero:] != 0).all()
    tiles = -(-vout // TILE)
    assert sched.tile_mask.shape == (tiles,)
    got = sched.tile_mask.numpy().astype(np.int64) & 0xFFFFFFFF
    want = [np.bitwise_or.reduce(sorted_masks[i * TILE:(i + 1) * TILE])
            for i in range(tiles)]
    np.testing.assert_array_equal(got, want)
    if taps == 5:
        assert not (got & (1 << 2)).any()
    if missing == 1.0:
        assert (got == 0).all()


def _tiled_emulation(feats, nbr, weights, sched):
    """The kernel's loop in plain torch: tile by tile, the set taps in
    order, each accumulating its gathered rows' products; each tile's rows
    written once through ``perm`` into an output that starts as NaN."""
    vin = feats.shape[0]
    ext = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
    out = torch.full((nbr.shape[1], weights.shape[2]), float("nan"))
    for i, m in enumerate(sched.tile_mask.tolist()):
        rows = sched.perm[i * TILE:(i + 1) * TILE].long()
        acc = feats.new_zeros((rows.shape[0], weights.shape[2]))
        for k in range(nbr.shape[0]):
            if (m & 0xFFFFFFFF) >> k & 1:
                idx = nbr[k, rows].long()
                idx = torch.where((idx >= 0) & (idx < vin), idx, vin)
                acc += ext[idx] @ weights[k]
        out[rows] = acc
    return out


@pytest.mark.parametrize("vin,vout,taps,missing", TABLES)
def test_tiled_emulation_matches_twin(vin, vout, taps, missing):
    nbr = _table(vin + vout + taps + 1, vin, vout, taps, missing)
    gen = torch.Generator().manual_seed(vout)
    feats = torch.randn(vin, 24, generator=gen)
    weights = torch.randn(taps, 24, 40, generator=gen) / (taps * 24) ** 0.5
    got = _tiled_emulation(feats, nbr, weights, scg.conv_schedule(nbr, vin))
    ref = scg.sparse_conv_gemm_ref(feats, nbr, weights)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def flagship_convs():
    """Every conv of ``tiny_fsdv2_flagship`` predicting one synthetic frame
    (random weights from seed 0): its plan, weight and input features,
    recorded by hooks on each SparseConvLayer."""
    model = tflag.init_weights(tflag.tiny_fsdv2_flagship(device="cpu"),
                               torch.Generator().manual_seed(0)).eval()
    batch = tflag.synthetic_waymo_batch(1, 2048, pcr_half=3.8).to("cpu")
    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: calls.append((args[1], m.weight.detach(), args[0])))
        for m in model.modules() if isinstance(m, SparseConvLayer)]
    try:
        with torch.inference_mode():
            model.predict(batch)
    finally:
        for h in hooks:
            h.remove()
    assert calls
    return calls


def test_tiled_emulation_matches_twin_on_flagship_rulebooks(flagship_convs):
    """The main path's own plans: each conv's schedule (cached on its plan
    by the predict) is the one ``conv_schedule`` builds, and the emulated
    tile loop over it equals the twin on the conv's input."""
    seen = set()
    for cp, w, feats in flagship_convs:
        vin = feats.shape[0]
        assert cp.sched is not None and cp.sched.vin == vin
        fresh = scg.conv_schedule(cp.nbr, vin)
        assert torch.equal(cp.sched.perm, fresh.perm)
        assert torch.equal(cp.sched.tile_mask, fresh.tile_mask)
        key = (id(cp), w.shape)
        if key in seen:
            continue
        seen.add(key)
        got = _tiled_emulation(feats, cp.nbr, w, cp.sched)
        ref = scg.sparse_conv_gemm_ref(feats, cp.nbr, w)
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    modes = {cp.mode for cp, _, _ in flagship_convs}
    assert modes == {"subm", "strided", "inverse"}


def test_plan_builds_each_schedule_once(flagship_convs):
    """``ConvPlan.schedule`` and ``transposed_schedule`` build once and
    return the cached schedule; the transposed one is that of ``nbr_t``,
    whose entries index the forward's output rows."""
    cp, _, feats = flagship_convs[0]
    plan = tsc.ConvPlan(nbr=cp.nbr, mode=cp.mode)
    vin, vout = feats.shape[0], cp.nbr.shape[1]
    sched = plan.schedule(vin)
    assert plan.schedule(vin) is sched and plan.sched is sched
    sched_t = plan.transposed_schedule(vin)
    assert plan.transposed_schedule(vin) is sched_t
    assert plan.nbr_t is not None and sched_t.vin == vout
    fresh = scg.conv_schedule(plan.nbr_t, vout)
    assert torch.equal(sched_t.perm, fresh.perm)
    assert torch.equal(sched_t.tile_mask, fresh.tile_mask)
    with pytest.raises(ValueError):
        plan.schedule(vin + 1)


def test_training_conv_builds_both_schedules(flagship_convs):
    """A conv under autograd caches the forward and transposed schedules on
    its plan; its gradients through the twins are those of autograd
    through the twin (f32 sums in other orders)."""
    cp, w, feats = flagship_convs[0]
    plan = tsc.ConvPlan(nbr=cp.nbr.clone(), mode=cp.mode)
    grads = []
    for conv in (lambda f, ww: tsc.windowed_sparse_conv(f, ww, plan),
                 lambda f, ww: scg.sparse_conv_gemm_ref(f, plan.nbr, ww)):
        f = feats.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        conv(f, ww).square().sum().backward()
        grads.append((f.grad, ww.grad))
    assert plan.sched is not None and plan.sched_t is not None
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_schedule_refuses_more_than_32_taps():
    with pytest.raises(ValueError):
        scg.conv_schedule(_table(0, 10, 20, 33), 10)


def test_wrapper_checks_a_given_schedule():
    """A schedule built for another Vin is refused before any launch; on
    the CPU the twin needs none and ignores it."""
    nbr = _table(1, 100, 80, 27)
    feats = torch.randn(100, 8)
    w = torch.randn(27, 8, 8)
    sched = scg.conv_schedule(nbr, 100)
    torch.testing.assert_close(
        scg.sparse_conv_gemm(feats, nbr, w, schedule=sched),
        scg.sparse_conv_gemm_ref(feats, nbr, w))
    with pytest.raises(ValueError):
        scg.check_schedule(scg.conv_schedule(nbr, 99), nbr, 100)
    scg.check_schedule(sched, nbr, 100)
