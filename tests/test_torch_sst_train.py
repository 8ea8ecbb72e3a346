"""Parity of the port's SST training path (DynamicVoxelNet ``loss`` in train
mode, the window MHA's backward, the anchor head's targets and losses) with
the JAX package, on the CPU.

The slice: ``tiny_sst`` with the same weights in both packages (the port's
seeded ``init_weights``, random running statistics, converted into a flax
variable tree) on ``tiny_batch``. JAX runs its fused attention
(``use_pallas=True``, the Pallas kernel in interpret mode through
``SST_TPU_PALLAS_INTERPRET``), so its gradient is the custom vjp
``_mha_bwd``, which the port's ``window_mha_backward`` ports. JAX draws the
voxel shuffle from its ``shuffle`` rng; the test records that permutation
and feeds it to the port. ``loss`` is held against JAX ``value_and_grad``
(jitted once): every loss and counter, the gradient of every parameter leaf
and the updated running statistics.

Tolerances, with the largest gaps measured. The attention rounds q, k, v,
its probabilities, its output and the gradients it returns to bf16, and an
element near a bf16 rounding boundary can round the other way after an f32
sum in another order (one bf16 ulp, 2^-8 relative). The forward's flips
move the BEV features by up to 1e-2 (test_torch_sst.py), and every
gradient below the head is taken at those features, so the gradients need
a looser bound than the f32 slices' 1e-4; a wrong backward or tie split
moves them by their own order. (Computing the attention's backward in f64
moves them by 1e-4 of their scale: the gap is the forward's rounding, not
the backward's.)
  - losses rtol 1e-4 (9.3e-6 relative), counters exactly;
  - gradients: each leaf within 3e-2 of its largest magnitude, plus rtol
    1e-2 (1.5e-2 of the largest magnitude, a VFE Dense kernel; the median
    leaf 3.2e-3);
  - running statistics rtol/atol 1e-4 (5.4e-7).

The pieces: the window MHA's gradients against JAX's ``window_mha`` (the
Pallas forward in interpret mode and ``_mha_bwd``) within one bf16 ulp
(rtol 2^-7) plus 2^-8 of each gradient's largest magnitude (largest gap
measured 5.5e-4 of that magnitude, on at most 0.01% of the elements); the
column views of one qkv buffer take their gradient in that buffer; the
voxel shuffle's plan against JAX's exactly; ``delta_encode`` at 1e-6
(4.8e-7); ``max_iou_assign`` exactly (IoU at 1e-6, equal); the anchor
head's targets exactly (box targets at 1e-5, 6.0e-8) and its losses and
their gradients at 1e-5 (1.5e-5 absolute on a loss of order 10^2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu.core import box_coders as jbc
from sst_tpu.core import target_assign as jta
from sst_tpu.core.iou import nearest_iou as jnearest_iou
from sst_tpu.models.detectors import dynamic_voxelnet as jdvn
from sst_tpu.models.heads.anchor3d import Anchor3DHead as JHead
from sst_tpu.ops.pallas_attention import window_mha as jwindow_mha
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.core import box_coders as tbc
from sst_tpu_torch.core import target_assign as tta
from sst_tpu_torch.core.iou import nearest_iou
from sst_tpu_torch.models.detectors import dynamic_voxelnet as tdvn
from sst_tpu_torch.models.heads.anchor3d import Anchor3DHead
from sst_tpu_torch.ops import window_mha as wm
from test_torch_fsdv2_dense_train import _flax_variables, _torch_leaf
from test_torch_fsdv2_train import _leaves
from test_torch_window import _plans, mha_inputs


@pytest.fixture(scope="module")
def slice_run():
    tm = tflag.init_weights(tflag.tiny_sst(device="cpu"),
                            torch.Generator().manual_seed(0))
    v = _flax_variables(tm)
    mp = pytest.MonkeyPatch()
    mp.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    perms = []

    def recording_input_layer(*args, shuffle_rng=None, **kw):
        if shuffle_rng is not None:
            perms.append(jax.random.permutation(shuffle_rng,
                                                args[0].shape[0]))
        return real_input_layer(*args, shuffle_rng=shuffle_rng, **kw)

    real_input_layer = jdvn.sst_input_layer
    mp.setattr(jdvn, "sst_input_layer", recording_input_layer)
    try:
        jm = jflag.tiny_sst()
        jm = jm.clone(backbone={**jm.backbone, "use_pallas": True})
        jb = jflag.tiny_batch()

        def loss_fn(params, stats, b):
            out, mut = jm.apply(
                {"params": params, "batch_stats": stats}, b, True,
                method=jm.loss, rngs={"shuffle": jax.random.PRNGKey(3)},
                mutable=["batch_stats"])
            total = sum(x for k, x in out.items() if k.startswith("loss"))
            return total, (out, mut["batch_stats"], perms[-1])

        (_, (jout, jstats, jperm)), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"], v["batch_stats"], jb)
    finally:
        mp.undo()
    jperm = np.asarray(jperm)
    tm = load_flax_variables(tflag.tiny_sst(device="cpu"), v)
    tb = tflag.tiny_batch().to("cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(tdvn, "voxel_permutation",
               lambda n, gen: torch.from_numpy(jperm).long())
    try:
        wm.reset_launch_counts()
        tout = tm.loss(tb, generator=torch.Generator())
        sum(x for k, x in tout.items() if k.startswith("loss")).backward()
        assert wm.launches == 0  # CPU tensors take the twin
    finally:
        mp.undo()
    return dict(tm=tm, jout=jout, jstats=jstats, jgrads=jgrads, tout=tout,
                jperm=jperm)


def test_train_parity_tiny_sst(slice_run):
    """Losses at rtol 1e-4, counters exactly, each gradient leaf within
    3e-2 of its largest magnitude plus rtol 1e-2, running statistics at
    rtol/atol 1e-4 (largest gaps measured: 9.3e-6, 1.5e-2 and 5.4e-7; the
    module docstring says why the gradients need more than 1e-4)."""
    r = slice_run
    jout = {k: float(x) for k, x in r["jout"].items()}
    tout = {k: float(x.detach()) for k, x in r["tout"].items()}
    assert sorted(tout) == sorted(jout)
    for k in jout:
        if k.startswith("loss"):
            np.testing.assert_allclose(tout[k], jout[k], rtol=1e-4,
                                       err_msg=k)
        else:
            assert tout[k] == jout[k], k
    assert jout["num_pos"] > 1 and jout["loss_dir"] > 0
    # the shuffle is not the identity, and the plan's caps drop voxels
    assert (r["jperm"] != np.arange(len(r["jperm"]))).any()
    assert jout["num_window_dropped_voxels"] > 0
    n = 0
    for path, ref in _leaves(r["jgrads"]):
        got = _torch_leaf(r["tm"], path, grad=True)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=1e-2, atol=3e-2 * scale,
                                   err_msg="/".join(path))
        n += 1
    assert n == sum(1 for _ in r["tm"].parameters())
    for path, ref in _leaves(r["jstats"]):
        got = _torch_leaf(r["tm"], path, grad=False)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                   err_msg="/".join(path))


def test_every_parameter_of_sst_gets_a_gradient(slice_run):
    """As in JAX, every parameter leaf has a gradient (no tolerance)."""
    missing = [n for n, p in slice_run["tm"].named_parameters()
               if p.grad is None]
    assert missing == []


def _assert_grads_close(got, ref, what):
    """Within 1 bf16 ulp (rtol 2^-7) plus 2^-8 of the largest magnitude."""
    got = got.float().numpy()
    tol = 2.0**-7 * np.abs(ref) + 2.0**-8 * np.abs(ref).max()
    assert np.isfinite(got).all(), what
    assert (np.abs(got - ref) <= tol).all(), (what, np.abs(got - ref).max())


@pytest.mark.parametrize("t,h", [(8, 2), (30, 8), (100, 8)])
def test_window_mha_grads_match_jax_custom_vjp(monkeypatch, t, h):
    """dq, dk and dv of the port's window_mha (its twin forward and the
    ported ``_mha_bwd``) against JAX's ``window_mha`` (the Pallas kernel in
    interpret mode and its custom vjp), at a bf16 cotangent that is zero on
    padded query rows, as the window-to-flat gather leaves it. An
    all-padded window and a one-token window are among the inputs."""
    monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    w = 12
    (q, k, v), pad = mha_inputs(w, t, h, seed=t + h)
    rng = np.random.RandomState(t * h)
    g = np.where(pad[..., None], 0.0, rng.randn(w, t, 16 * h)).astype(
        np.float32)
    g = np.array(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: jwindow_mha(a, b, c, jnp.asarray(pad),
                                                 h), jq, jk, jv)
    refs = [np.asarray(x.astype(jnp.float32))
            for x in vjp(jnp.asarray(g).astype(jnp.bfloat16))]
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_()
                  for x in (q, k, v))
    out = wm.window_mha(tq, tk, tv, torch.from_numpy(pad), h)
    out.backward(torch.from_numpy(g).bfloat16())
    for name, x, ref in zip("qkv", (tq, tk, tv), refs):
        assert x.grad.dtype == torch.bfloat16
        _assert_grads_close(x.grad, ref, f"d{name}")
    assert np.abs(refs[0]).max() > 0


def test_window_mha_grads_land_in_the_qkv_buffer():
    """The column views of one [W, T, 3C] buffer: the buffer's gradient is
    the three gradients side by side, each equal to the ported backward on
    contiguous copies, and the forward equals the twin's bit for bit."""
    (q, k, v), pad = mha_inputs(6, 30, 8, seed=11)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).bfloat16()
    qkv.requires_grad_()
    pad = torch.from_numpy(pad)
    g = torch.randn(6, 30, 128, generator=torch.Generator().manual_seed(0))
    out = wm.window_mha(*qkv.split(128, dim=-1), pad, 8)
    out.backward(g.bfloat16())
    with torch.no_grad():
        views = [x.contiguous() for x in qkv.split(128, dim=-1)]
        ref = wm.window_mha_ref(*views, pad, 8)
        grads = wm.window_mha_backward(*views, pad, 8, g.bfloat16())
    assert torch.equal(out.detach(), ref)
    assert torch.equal(qkv.grad, torch.cat(grads, dim=-1))


@pytest.mark.parametrize("case", ["caps overflow", "seat trim"])
def test_shuffled_window_plan_equals_jax(case):
    """The plan built on permuted voxel rows and mapped back (JAX's
    ``shuffle_rng`` path, fed the same permutation) equals JAX's exactly,
    with overflowing caps and with trimmed seats; the shuffle moves which
    voxels lose their seats."""
    import test_torch_window as ttw
    from sst_tpu.models import sst_input as jin
    from sst_tpu.ops import window as jwin
    from sst_tpu_torch.models import sst_input as tin
    from sst_tpu_torch.ops import window as twin

    coords, valid, sparse_shape, _, plain = _plans(case)
    cfg = ttw.CASES[case]
    key = jax.random.PRNGKey(5)
    perm = np.asarray(jax.random.permutation(key, coords.shape[0]))
    jp = jin.sst_input_layer(
        jnp.asarray(coords), jnp.asarray(valid), sparse_shape,
        cfg["window_shape"], tuple(jwin.BucketSpec(*b)
                                   for b in cfg["buckets"]), 32,
        cfg["max_total_windows"], shuffle_rng=key)
    tp = tin.sst_input_layer(
        torch.from_numpy(coords), torch.from_numpy(valid), sparse_shape,
        cfg["window_shape"], tuple(twin.BucketSpec(*b)
                                   for b in cfg["buckets"]), 32,
        cfg["max_total_windows"], perm=torch.from_numpy(perm))
    for jf, tf in zip(jp.f2w, tp.f2w):
        for name in ("drop_lvl", "flat_inds", "valid", "coors_in_win"):
            np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                          np.asarray(getattr(jf, name)))
        for ti, ji in zip(tf.inv_inds, jf.inv_inds):
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        for tpad, jpad in zip(tf.pads, jwin.window_key_padding(jf)):
            np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert int(tp.num_seat_trimmed) == int(jp.num_seat_trimmed)
    if case == "seat trim":
        assert int(tp.num_seat_trimmed) > 0
        assert not torch.equal(tp.valid, plain.valid)


def _boxes(rng, n, spread=4.0):
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1, 0, (n, 1)),
        rng.uniform(0.5, 4.0, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
    ], -1).astype(np.float32)


def test_delta_encode_matches_jax():
    """Anchor residuals of gt boxes at rtol/atol 1e-6, with and without
    extra channels; decode inverts encode."""
    rng = np.random.RandomState(0)
    anchors, gts = _boxes(rng, 200), _boxes(rng, 200)
    for extra in (0, 2):
        a = np.concatenate([anchors, rng.randn(200, extra)], -1).astype(
            np.float32)
        g = np.concatenate([gts, rng.randn(200, extra)], -1).astype(
            np.float32)
        ref = np.asarray(jbc.delta_encode(jnp.asarray(a), jnp.asarray(g)))
        got = tbc.delta_encode(torch.from_numpy(a), torch.from_numpy(g))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            tbc.delta_decode(torch.from_numpy(a), got).numpy(), g,
            rtol=1e-5, atol=1e-5)


def test_max_iou_assign_matches_jax():
    """Assignments exactly (positives, negatives, ignored, the low-quality
    matches of each gt's best anchors, first index on ties, invalid gts
    never taken) and the best IoU at 1e-6; JAX streams the anchors in
    chunks of 512 here."""
    rng = np.random.RandomState(1)
    anchors = _boxes(rng, 2000)
    anchors[1000:1010] = anchors[:10]  # tied anchors
    gts = _boxes(rng, 9)
    gts[4] = gts[2]  # a tied gt
    gt_valid = np.ones(9, bool)
    gt_valid[6] = False
    ref = jta.max_iou_assign(jnp.asarray(anchors), jnp.asarray(gts),
                             jnp.asarray(gt_valid), pos_thr=0.5,
                             neg_thr=0.3, min_pos_iou=0.2,
                             iou_fn=jnearest_iou, chunk=512)
    got = tta.max_iou_assign(torch.from_numpy(anchors),
                             torch.from_numpy(gts),
                             torch.from_numpy(gt_valid), pos_thr=0.5,
                             neg_thr=0.3, min_pos_iou=0.2,
                             iou_fn=nearest_iou)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-6, atol=1e-6)
    a = got[0].numpy()
    assert (a >= 0).any() and (a == -1).any() and (a == -2).any()
    assert not (a == 6).any()


def _head_case(seed=2, b=2, hw=(16, 16)):
    rng = np.random.RandomState(seed)
    half = 4.0
    ranges = ((-half, -half, -0.0345, half, half, -0.0345),
              (-half, -half, -0.1188, half, half, -0.1188),
              (-half, -half, 0.0, half, half, 0.0))
    kw = dict(num_classes=3, anchor_ranges=ranges,
              anchor_sizes=((2.0, 4.0, 1.7), (0.8, 1.2, 1.7),
                            (0.8, 1.0, 1.7)))
    a = 6
    preds = {"cls": rng.randn(b, *hw, a, 3).astype(np.float32),
             "reg": (rng.randn(b, *hw, a, 7) * 0.3).astype(np.float32),
             "dir": rng.randn(b, *hw, a, 2).astype(np.float32)}
    gts = np.stack([_boxes(rng, 8, spread=3.5) for _ in range(b)])
    gts[..., 3:6] = rng.uniform(0.8, 4.5, (b, 8, 3))
    labels = rng.randint(0, 3, (b, 8)).astype(np.int32)
    gvalid = rng.rand(b, 8) > 0.2
    return kw, preds, gts, labels, gvalid


def test_anchor_targets_match_jax():
    """Per-anchor labels (class, background, ignored), box weights and
    direction targets exactly, box targets at rtol/atol 1e-5, for each
    class's anchors."""
    kw, _, gts, labels, gvalid = _head_case()
    jh = JHead(feat_channels=8, **kw)
    th = Anchor3DHead(feat_channels=8, **kw)
    anchors = th.grid_anchors((16, 16))
    for i in range(gts.shape[0]):
        ref = jax.jit(jh.targets_single)(
            jnp.asarray(anchors.numpy()), jnp.asarray(gts[i]),
            jnp.asarray(labels[i]), jnp.asarray(gvalid[i]))
        got = th.targets_single(anchors, torch.from_numpy(gts[i]),
                                torch.from_numpy(labels[i]),
                                torch.from_numpy(gvalid[i]))
        for k in ("labels", "bbox_weights", "dir_targets", "num_pos"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(ref[k]), err_msg=k)
        np.testing.assert_allclose(got["bbox_targets"].numpy(),
                                   np.asarray(ref["bbox_targets"]),
                                   rtol=1e-5, atol=1e-5)
        lbl = got["labels"].numpy()
        assert (lbl < 3).any() and (lbl == 3).any() and (lbl == -1).any()


def test_anchor_loss_matches_jax():
    """The focal, L1 (sine yaw difference) and direction losses and
    ``num_pos``, and their gradients with respect to every prediction map,
    at rtol/atol 1e-5."""
    kw, preds, gts, labels, gvalid = _head_case()
    jh = JHead(feat_channels=8, **kw)
    th = Anchor3DHead(feat_channels=8, **kw)
    anchors = th.grid_anchors((16, 16))

    def jloss(p):
        out = jh.loss(p, anchors.numpy(), jnp.asarray(gts),
                      jnp.asarray(labels), jnp.asarray(gvalid))
        return sum(v for k, v in out.items() if k.startswith("loss")), out

    (_, ref), gref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    got = th.loss(tp, anchors, torch.from_numpy(gts),
                  torch.from_numpy(labels), torch.from_numpy(gvalid))
    sum(v for k, v in got.items() if k.startswith("loss")).backward()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in preds:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(ref["num_pos"]) > 1
