"""Gradients of the port's sparse conv and segment reductions against the
JAX package, on the CPU (where every kernel wrapper takes its plain twin).

- dfeats and dW of one subm, strided and inverse conv (16 -> 24 channels,
  ~200 sites) against ``jax.grad`` through JAX's ``gather_gemm`` at
  rtol/atol 1e-5, and against ``jax.grad`` through ``windowed_sparse_conv``
  on window plans with ``SST_TPU_PALLAS_INTERPRET=1``, which runs the
  Pallas ``_dw_kernel`` and the forward kernel over the transposed plans in
  interpret mode, at 1e-4. Both sum the same f32 products in other orders;
  the largest gaps measured were 8.3e-7 in dfeats and 2.3e-5 in dW (subm,
  where |dW| reaches 51: 4.5e-7 of it), on either JAX path.
- The transposed tables equal JAX's transposed plans exactly: a subm
  table with reversed taps, a strided table and its inverse's.
- The sorted reduce's backward against JAX's custom vjp (Pallas kernel in
  interpret mode), and the scatter reductions' against JAX autodiff, with
  ties at positive values: exactly (each gradient is one of the upstream
  values, or an even split of one).
- Rematerialisation leaves outputs, gradients and running statistics as
  they are without it, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.ops import segment as jseg
from sst_tpu.ops import sparse_conv as jsc
from sst_tpu.ops import sparse_conv_pallas as jscp
from sst_tpu.ops.sorted_reduce import sorted_segment_reduce as jax_sorted
from sst_tpu_torch.models import sparse_unet as tsu
from sst_tpu_torch.ops import segment as tseg
from sst_tpu_torch.ops import sorted_reduce as sr
from sst_tpu_torch.ops import sparse_conv as tsc
from sst_tpu_torch.ops import sparse_conv_dw as scd
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from sst_tpu_torch.utils import remat
from test_torch_sparse_conv import _coords, _masked
from test_torch_sparse_unet import CAPS, PADDINGS, STRIDES, UNET, _grids
from torch_threads import torch_threads_per_worker  # noqa: F401

CIN, COUT = 16, 24


def _jax_plans(coords, valid):
    """JAX's grids, its table plans of the three conv families and its
    window plans, wired as ``build_unet_plan`` wires them (traced once
    under jit: op by op they would take seconds)."""
    j0, _ = jsc.make_sparse_grid(coords, valid, (8, 24, 24), 2)
    j1 = jsc.downsample_grid(j0, 128)
    tables = {mode: jscp.build_conv_plans(*io, mode, use_windows=False)
              for mode, io in (("subm", (j0, j0)), ("strided", (j1, j0)),
                               ("inverse", (j0, j1)))}
    wp_s = jscp.build_window_plan(j1, j0, "strided")
    wp_i = jscp.build_window_plan(j0, j1, "inverse")
    fast = {"subm": jscp.build_conv_plans(j0, j0, "subm", use_windows=True),
            "strided": jscp.ConvPlan(fwd=wp_s, bwd=wp_i),
            "inverse": jscp.ConvPlan(fwd=wp_i, bwd=wp_s)}
    return j0, j1, tables, fast


@pytest.fixture(scope="module")
def conv_cases():
    """Per mode: JAX's table plan and window plan, the port's plan, input
    features, weights and an upstream gradient masked at invalid output
    rows."""
    rng = np.random.RandomState(0)
    coords, valid = _coords(rng, cap=256, fill=220)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SST_TPU_PALLAS_INTERPRET", "1")
        j0, j1, tables, fast = jax.jit(_jax_plans)(coords, valid)
    t0, _ = tsc.make_sparse_grid(torch.from_numpy(coords),
                                 torch.from_numpy(valid), (8, 24, 24), 2)
    t1 = tsc.downsample_grid(t0, 128)
    cases = {}
    for mode, (tin, tout) in (("subm", (t0, t0)), ("strided", (t0, t1)),
                              ("inverse", (t1, t0))):
        tp = tsc.build_conv_plans(tout, tin, mode)
        np.testing.assert_array_equal(tp.nbr.numpy(),
                                      np.asarray(tables[mode].nbr))
        cases[mode] = dict(
            jp=tables[mode], fast=fast[mode], tp=tp,
            feats=_masked(rng, tin.cap, CIN, tin.valid),
            w=(rng.randn(27, CIN, COUT) * 0.2).astype(np.float32),
            g=_masked(rng, tout.cap, COUT, tout.valid))
    return cases


def _jax_grads(c, plan, argnums=(0, 1)):
    def loss(f, ww):
        return (jscp.windowed_sparse_conv(f, ww, plan) * c["g"]).sum()

    grads = jax.jit(jax.grad(loss, argnums=argnums))(jnp.asarray(c["feats"]),
                                                     jnp.asarray(c["w"]))
    return [np.asarray(x) for x in grads]


def _torch_grads(c):
    f = torch.from_numpy(c["feats"]).requires_grad_()
    ww = torch.from_numpy(c["w"]).requires_grad_()
    scg.reset_launch_counts()
    scd.reset_launch_counts()
    (tsc.windowed_sparse_conv(f, ww, c["tp"]) * torch.from_numpy(c["g"])) \
        .sum().backward()
    assert scg.launches == 0 and scd.launches == 0  # CPU tensors: twins
    return f.grad.numpy(), ww.grad.numpy()


@pytest.mark.parametrize("mode", ["subm", "strided", "inverse"])
def test_conv_grads_match_jax_gather_gemm(conv_cases, monkeypatch, mode):
    """dfeats and dW against ``jax.grad`` through ``gather_gemm`` at
    rtol/atol 1e-5 (largest gap measured 2.3e-5, subm dW of magnitude 51)."""
    monkeypatch.delenv("SST_TPU_PALLAS_INTERPRET", raising=False)
    c = conv_cases[mode]
    assert c["jp"].nbr is not None  # JAX's neighbour-table path
    gf_j, gw_j = _jax_grads(c, c["jp"])
    gf_t, gw_t = _torch_grads(c)
    np.testing.assert_allclose(gf_t, gf_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gw_t, gw_j, rtol=1e-5, atol=1e-5)
    assert np.abs(gf_j).sum() > 0 and np.abs(gw_j).sum() > 0


@pytest.mark.parametrize("mode", ["subm", "strided", "inverse"])
def test_conv_grads_match_jax_pallas_dw_kernel(conv_cases, monkeypatch,
                                               mode):
    """JAX's ``_windowed_conv`` custom vjp in interpret mode: dW by the
    Pallas ``_dw_kernel``, and for subm dfeats by the forward kernel on the
    transposed plan. The strided and inverse dfeats are held against the
    ``gather_gemm`` path above (each interpret-mode kernel costs seconds to
    trace), over tables that equal JAX's transposed plans (the next
    tests). rtol/atol 1e-4 (largest gap measured 2.3e-5, subm dW)."""
    monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    c = conv_cases[mode]
    assert c["fast"].fwd is not None and c["fast"].bwd is not None
    argnums = (0, 1) if mode == "subm" else (1,)
    ref = _jax_grads(c, c["fast"], argnums)
    got = _torch_grads(c)
    for i, r in zip(argnums, ref):
        np.testing.assert_allclose(got[i], r, rtol=1e-4, atol=1e-4)


def test_dw_twin_is_autograd_of_the_conv_twin(rng):
    """The dW twin against autograd through the forward twin, with missing
    entries written as Vin, -1 and past Vin, at rtol/atol 1e-5 (largest
    gap measured 0: the same products in the same order)."""
    vin, vout, taps = 60, 90, 27
    nbr = rng.randint(0, vin, (taps, vout))
    drop = rng.rand(taps, vout) < 0.6
    nbr = np.where(drop, rng.choice([vin, -1, vin + 5], (taps, vout)), nbr)
    nbr = torch.from_numpy(nbr.astype(np.int32))
    feats = torch.randn(vin, 8, generator=torch.Generator().manual_seed(0))
    w = torch.randn(taps, 8, 12, requires_grad=True)
    g = torch.randn(vout, 12)
    (scg.sparse_conv_gemm_ref(feats, nbr, w) * g).sum().backward()
    got = scd.sparse_conv_dw(feats, nbr, g, "subm")
    torch.testing.assert_close(got, w.grad, rtol=1e-5, atol=1e-5)


def test_transposed_tables_equal_jax_transposed_plans():
    """Subm: ``nbr_t`` is the table with its taps reversed. Strided and
    inverse at one level: each one's ``nbr_t`` is the other's table (JAX's
    ``bwd`` plans), with the same missing marker."""
    _, tsg = _grids()
    tp = tsu.build_unet_plan(tsg, CAPS, STRIDES, PADDINGS)
    for lvl, cp in enumerate(tp.subm):
        vin = tp.levels[lvl].cap
        nbr_t = cp.transposed(vin)
        assert cp.transposed(vin) is nbr_t  # built once, then cached
        np.testing.assert_array_equal(nbr_t.numpy(), cp.nbr.flip(0).numpy(),
                                      err_msg=f"subm level {lvl}")
    for lvl, (down, inv) in enumerate(zip(tp.down, tp.inv)):
        fine, coarse = tp.levels[lvl].cap, tp.levels[lvl + 1].cap
        np.testing.assert_array_equal(down.transposed(fine).numpy(),
                                      inv.nbr.numpy())
        np.testing.assert_array_equal(inv.transposed(coarse).numpy(),
                                      down.nbr.numpy())
        assert (down.nbr < fine).any() and (inv.nbr < coarse).any()


def test_inference_builds_no_transposed_table():
    """Predict pays nothing: the transposed table is built only when
    autograd needs a conv's gradient."""
    _, tsg = _grids()
    tp = tsu.build_unet_plan(tsg, CAPS, STRIDES, PADDINGS)
    conv = tsu.SparseConvLayer(8, 8)
    feats = torch.randn(tsg.cap, 8)
    with torch.inference_mode():
        conv(feats, tp.subm[0], tsg.valid)
    with torch.no_grad():
        conv(feats, tp.subm[0], tsg.valid, train=True)
    assert tp.subm[0].nbr_t is None
    conv(feats, tp.subm[0], tsg.valid, train=True)
    assert tp.subm[0].nbr_t is not None


def _sorted_rows(seed, n=400, v=120, c=6, tie_rows=60):
    """Rows grouped by segment id, with ``tie_rows`` rows repeating the
    positive maximum of their segment, ids outside [0, v) included."""
    rng = np.random.RandomState(seed)
    seg = np.sort(rng.randint(-3, v + 4, n)).astype(np.int32)
    data = rng.randn(n, c).astype(np.float32)
    for r in rng.choice(n, tie_rows, replace=False):
        same = np.nonzero(seg == seg[r])[0]
        data[r] = np.abs(data[same]).max(0) + 0.5
        data[same[-1]] = data[r]  # a later row of the segment ties it
    return data, seg


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_sorted_reduce_backward_matches_jax_custom_vjp(mode):
    """Exactly: each row's gradient is one upstream value or 0."""
    data, seg = _sorted_rows(seed=3)
    v = 120
    g = np.random.RandomState(4).randn(v, data.shape[1]).astype(np.float32)

    def jloss(d):
        return (jax_sorted(d, jnp.asarray(seg), v, mode, 128, True)
                * g).sum()

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(data)))
    d = torch.from_numpy(data).requires_grad_()
    (sr.sorted_segment_reduce(d, torch.from_numpy(seg), v, mode)
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(d.grad.numpy(), ref)
    if mode == "max":  # one row of each segment takes its gradient
        for s in range(v):
            assert ((ref[seg == s] != 0).sum(0) <= 1).all()


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_segment_reduce_backward_matches_jax(mode):
    """The scatter path: JAX's segment_max splits a tie evenly, and so does
    torch's scatter_reduce; ``gather_segments`` scatters its gradient. At
    rtol/atol 1e-6 (largest gap measured 0)."""
    data, seg = _sorted_rows(seed=5)
    rng = np.random.RandomState(6)
    perm = rng.permutation(len(seg))  # the scatter path takes any order
    data, seg = data[perm], seg[perm]
    v = 120
    g = rng.randn(v, data.shape[1]).astype(np.float32)
    gp = rng.randn(len(seg), data.shape[1]).astype(np.float32)

    def jloss(d):
        out = jseg.segment_reduce(d, jnp.asarray(seg), v, mode)
        back = jseg.gather_segments(out, jnp.asarray(np.maximum(seg, 0)))
        return (out * g).sum() + (back * gp).sum()

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(data)))
    d = torch.from_numpy(data).requires_grad_()
    out = tseg.segment_reduce(d, torch.from_numpy(seg), v, mode)
    back = tseg.gather_segments(out, torch.from_numpy(np.maximum(seg, 0)))
    ((out * torch.from_numpy(g)).sum()
     + (back * torch.from_numpy(gp)).sum()).backward()
    np.testing.assert_allclose(d.grad.numpy(), ref, rtol=1e-6, atol=1e-6)


def _unet_and_plan(remat_on):
    torch.manual_seed(0)
    unet = tsu.SimpleSparseUNet(16, remat=remat_on, **UNET)
    _, tsg = _grids()
    plan = tsu.build_unet_plan(tsg, CAPS, STRIDES, PADDINGS)
    return unet, plan, tsg


def test_remat_changes_nothing_but_memory():
    """Bit for bit: the recompute repeats the same f32 operations; the
    running statistics move once per forward."""
    feats = np.random.RandomState(7).randn(CAPS[0], 16).astype(np.float32)
    results = []
    seen = []
    for remat_on in (False, True):
        unet, plan, tsg = _unet_and_plan(remat_on)
        bn = unet.merge_1.MaskedBatchNorm_0
        bn.register_forward_pre_hook(
            lambda m, a: seen.append((remat_on, remat.recomputing())))
        x = torch.from_numpy(np.where(tsg.valid[:, None].numpy(), feats, 0))
        out = unet(x.requires_grad_(), plan, train=True)["voxel_feats"]
        (out * torch.arange(out.numel()).reshape(out.shape).sin()).sum() \
            .backward()
        results.append((out.detach(), x.grad,
                        {n: p.grad for n, p in unet.named_parameters()},
                        {n: b.clone() for n, b in unet.named_buffers()}))
    (o0, x0, g0, b0), (o1, x1, g1, b1) = results
    assert torch.equal(o0, o1) and torch.equal(x0, x1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for n in b0:  # one running-statistics update per forward, not two
        assert torch.equal(b0[n], b1[n]), n
    assert seen == [(False, False), (True, False), (True, True)]
    assert not remat.recomputing()


def test_dw_wrapper_rejects_what_the_kernel_does_not_take():
    """Types, shapes, contiguity and the mode are checked before a launch."""
    feats = torch.zeros(5, 4)
    nbr = torch.zeros(27, 6, dtype=torch.int32)
    dout = torch.zeros(6, 8)
    for args, err in (((feats.double(), nbr, dout), TypeError),
                      ((feats, nbr.long(), dout), TypeError),
                      ((feats, nbr, dout[:5]), ValueError),
                      ((feats, nbr, torch.zeros(8, 6).T), ValueError)):
        with pytest.raises(err):
            scd.sparse_conv_dw(*args)
    with pytest.raises(ValueError):
        scd.sparse_conv_dw(feats, nbr, dout, mode="dense")


@pytest.mark.parametrize("cin,cout,vout", [(64, 64, 204800), (512, 256, 2048),
                                           (16, 32, 100), (128, 128, 1)])
def test_dw_row_splits_cover_the_rows_and_fill_the_card(cin, cout, vout):
    """Each tap's tiles are cut into ``splits`` shares that together cover
    every 64-row tile of the schedule, a share holding at most 512 tiles
    (the kernel lists a share in shared memory); where the rows allow 8
    tiles a split, the grid holds eight waves of 4 blocks (128 registers a
    thread) on each of the H100's 132 SMs."""
    splits = scd.split_rows(27, cin, cout, vout)
    tiles = -(-vout // 64)
    share = -(-tiles // splits)  # the most tiles one split takes of a tap
    assert share <= 512 and splits * share * 64 >= vout
    blocks = 27 * -(-cin // 64) * -(-cout // 64)
    if tiles >= 8 * -(-132 * 4 * 8 // blocks):
        assert blocks * splits >= 132 * 4 * 8
