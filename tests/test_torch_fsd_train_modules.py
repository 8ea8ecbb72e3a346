"""Module parity of the port's FSD training pieces with the JAX package, on
the CPU: ``core/boxes.py corners``, ``core/iou.py boxes_iou_3d``,
``roi_head.py canonical_gt``, ``core/target_assign.py
iou_neg_piecewise_sample`` on JAX's own uniforms, ``GroupCorrectionHead``'s
``loss`` (losses and every gradient, sampler on and off), ``sample_class``
with ``add_gt_fg_points``' labels, and the gradient-safe gathers of the
training path.

Tolerances: geometry at rtol/atol 1e-6 (float32 trigonometry in two
libraries), every discrete output exactly, the RoI losses at rtol 1e-5 and
each gradient leaf within 1e-4 of its largest magnitude.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sst_tpu.models.fsd.roi_head as jroi
from sst_tpu import flagship as jflag
from sst_tpu.core import boxes as jboxes
from sst_tpu.core.iou import boxes_iou_3d as jiou3d
from sst_tpu.core.target_assign import iou_neg_piecewise_sample as jsample
from sst_tpu.models.fsd.roi_head import GroupCorrectionHead as JGCH
from sst_tpu.models.fsd.sir import SIR as JSIR
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.core.boxes import corners
from sst_tpu_torch.core.iou import boxes_iou_3d
from sst_tpu_torch.core.target_assign import iou_neg_piecewise_sample
from sst_tpu_torch.models.fsd import roi_head as troi
from sst_tpu_torch.models.fsd.roi_head import (
    GroupCorrectionHead,
    canonical_gt,
)
from sst_tpu_torch.models.fsd.sir import SIR
from sst_tpu_torch.models.fsd.two_stage import scatter_last_wins
from sst_tpu_torch.ops.segment import gather_segments
from test_torch_fsd import seeded_variables
from test_torch_fsdv2_train import _leaves, _torch_leaf
from torch_threads import torch_threads_per_worker  # noqa: F401

GEO = dict(rtol=1e-6, atol=1e-6)
T = torch.from_numpy


def _boxes(rng, n):
    return np.concatenate([
        rng.uniform(-10, 10, (n, 2)), rng.uniform(-2, 1, (n, 1)),
        rng.uniform(0.5, 5, (n, 3)), rng.uniform(-4, 4, (n, 1))],
        -1).astype(np.float32)


# ------------------------------------------------------- boxes, 3D IoU


def test_corners_match_jax(rng):
    """[N, 8, 3] corners, bottom four then top four, at 1e-6."""
    b = _boxes(rng, 64)
    ref = np.asarray(jax.jit(jboxes.corners)(jnp.asarray(b)))
    got = corners(T(b)).numpy()
    assert got.shape == (64, 8, 3)
    np.testing.assert_allclose(got, ref, **GEO)
    np.testing.assert_array_equal(got[:, :4, 2], np.repeat(b[:, 2:3], 4, 1))


def _iou_cases(rng):
    a = _boxes(rng, 40)
    b = np.concatenate([_boxes(rng, 30),
                        a[:10] + rng.randn(10, 7).astype(np.float32) * 0.3])
    b[30:, 3:6] = np.abs(b[30:, 3:6]) + 0.3
    base = np.array([[0, 0, 0, 2, 4, 1.5, 0.3]], np.float32)
    # identical; sharing a face along the box's own x (touching); stacked
    # in z (the top of one the bottom of the other); a half z overlap;
    # turned by 90 degrees about the same centre
    shift = np.zeros((5, 7), np.float32)
    shift[1, :2] = (2 * math.cos(0.3), -2 * math.sin(0.3))
    shift[2, 2] = 1.5
    shift[3, 2] = 0.5
    shift[4, 6] = math.pi / 2
    return {"rotated": (a, b), "edges": (base, base + shift)}


@pytest.mark.parametrize("case", ["rotated", "edges"])
def test_boxes_iou_3d_matches_jax(case):
    """Rotated boxes at 1e-6 of jitted JAX's. The edge cases (identical,
    touching, z-disjoint, half z overlap, turned by 90 degrees) at 1e-6 of
    JAX's op by op: their edges coincide, where jitted XLA's fused float
    order moves the sort-free overlap (identical boxes at yaw 0.3: 0.814);
    ROADMAP queue 3 declares it. A shared face's segment counts in both
    packages (touching boxes: 1/7, not 0)."""
    a, b = _iou_cases(np.random.RandomState(3))[case]
    got = boxes_iou_3d(T(a), T(b)).numpy()
    if case == "rotated":
        ref = np.asarray(jax.jit(jiou3d)(jnp.asarray(a), jnp.asarray(b)))
        assert (ref > 0.3).sum() >= 5 and (ref == 0).sum() > 100
    else:
        with jax.disable_jit():
            ref = np.asarray(jiou3d(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got[0, [0, 2, 3, 4]],
                                   [1.0, 0.0, 0.5, 1 / 3], atol=1e-6)
    np.testing.assert_allclose(got, ref, **GEO)


def test_canonical_gt_at_angle_wrap_edges():
    """Roi yaws at and around 0, +-pi, 2 pi and beyond; gt-roi yaw
    differences on the opposite-heading bounds (pi/2, 3 pi/2), at pi, and
    an ulp inside and outside each: angles exactly JAX's (up to XLA's
    flush of a subnormal result to zero), the rest at 1e-6."""
    yaws = np.array([0.0, math.pi, -math.pi, 2 * math.pi, -2 * math.pi,
                     7.0, -7.0, 1e-7, -1e-7, math.pi / 2, -math.pi / 2],
                    np.float32)
    diffs = np.array([0.0, math.pi / 2, 1.5 * math.pi, math.pi, -math.pi,
                      2 * math.pi, 0.25, -0.25, 3.0, -3.0], np.float32)
    diffs = np.concatenate([diffs, np.nextafter(diffs, np.float32(9)),
                            np.nextafter(diffs, np.float32(-9))])
    ry, dy = np.meshgrid(yaws, diffs, indexing="ij")
    n = ry.size
    rng = np.random.RandomState(4)
    rois = np.concatenate([rng.randn(n, 3), rng.uniform(1, 4, (n, 3)),
                           ry.reshape(-1, 1)], -1).astype(np.float32)
    gts = np.concatenate([rois[:, :3] + rng.randn(n, 3),
                          rng.uniform(1, 4, (n, 3)),
                          (ry + dy).reshape(-1, 1)], -1).astype(np.float32)
    ref = np.asarray(jax.jit(jroi.canonical_gt)(jnp.asarray(rois),
                                                jnp.asarray(gts)))
    got = canonical_gt(T(rois), T(gts)).numpy()
    tiny = np.finfo(np.float32).tiny  # the smallest normal float32
    np.testing.assert_allclose(got[:, 6], ref[:, 6], rtol=0, atol=tiny)
    np.testing.assert_array_equal(got[:, 2:6], ref[:, 2:6])
    np.testing.assert_allclose(got[:, :2], ref[:, :2], **GEO)
    assert np.abs(ref[:, 6]).max() <= math.pi / 2
    assert (np.abs(ref[:, 6]) == np.float32(math.pi / 2)).any()


# ------------------------------------------------------------- sampler

_SAMPLER = dict(neg_piece_fractions=(0.8, 0.2), neg_iou_piece_thrs=(0.55, 0.1))


def _sampler_cases():
    rng = np.random.RandomState(0)
    budgets = rng.uniform(0, 1, 200).astype(np.float32)
    mixed = rng.uniform(0, 1, 300).astype(np.float32)
    mixed[:40] = -1.0  # no gt of the proposal's class: in no piece
    mixed_valid = rng.rand(300) > 0.15
    short = np.concatenate([np.full(3, 0.3), np.full(100, 0.05),
                            np.full(10, 0.9)]).astype(np.float32)
    return {
        # tests/test_train_fidelity.py's two cases, on the same keys
        "budgets": (0, budgets, budgets > 0.6, np.ones(200, bool), 64, 0.5),
        "short piece extends": (1, short, short > 0.6, np.ones(113, bool),
                                64, 0.5),
        # more positives than the positive budget, invalid slots, -1 IoUs
        "positives bind": (7, mixed, mixed > 0.5, mixed_valid, 128, 0.55),
    }


@pytest.mark.parametrize("case", list(_sampler_cases()))
def test_piecewise_sampler_on_jax_draws(case):
    """The keep mask equals JAX's when the port is given JAX's uniforms
    (``jax.random.uniform(key, (P,))``, what JAX draws inside)."""
    seed, max_iou, is_pos, valid, num, frac = _sampler_cases()[case]
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jsample(key, jnp.asarray(max_iou), jnp.asarray(is_pos),
                             jnp.asarray(valid), num=num, pos_fraction=frac,
                             **_SAMPLER))
    draws = T(np.asarray(jax.random.uniform(key, (len(max_iou),))))
    got = iou_neg_piecewise_sample(T(max_iou), T(is_pos), T(valid), num,
                                   frac, draws=draws, **_SAMPLER).numpy()
    np.testing.assert_array_equal(got, ref)
    n_pos = (got & is_pos).sum()
    assert n_pos == min((is_pos & valid).sum(), int(num * frac))
    if case == "short piece extends":
        assert (got & (max_iou >= 0.1) & (max_iou < 0.55)).sum() == 3
        assert got.sum() == 64
    if case == "positives bind":
        assert (is_pos & valid).sum() > int(num * frac)
        assert not (got & (max_iou < 0)).any()


def test_piecewise_sampler_draws_from_a_generator():
    """Without ``draws`` the uniforms come from the generator: the same
    seed gives the same mask, and it is the mask of those draws."""
    rng = np.random.RandomState(2)
    max_iou = T(rng.uniform(0, 1, 500).astype(np.float32))
    is_pos = max_iou > 0.6
    valid = torch.ones(500, dtype=torch.bool)
    masks = [iou_neg_piecewise_sample(
        max_iou, is_pos, valid, 128, 0.55, generator=torch.Generator()
        .manual_seed(3), **_SAMPLER) for _ in range(2)]
    draws = torch.rand(500, generator=torch.Generator().manual_seed(3))
    ref = iou_neg_piecewise_sample(max_iou, is_pos, valid, 128, 0.55,
                                   draws=draws, **_SAMPLER)
    assert torch.equal(masks[0], masks[1]) and torch.equal(masks[0], ref)
    assert int(masks[0].sum()) == 128


# ------------------------------------------------------------- RoI loss

_ROI_CFG = dict(max_inbox_point=24, bbox_head=dict(
    num_blocks=2, feat_channels=((16, 16),) * 2,
    rel_mlp_hidden=((8, 8),) * 2, reg_mlp=(32, 32), cls_mlp=(32, 32)))
_ROI_SAMPLER = dict(num=40, pos_fraction=0.55, **_SAMPLER)
_FEATS = 21


def _roi_scene():
    """Sample 0: four gt boxes (car, pedestrian, cyclist, car) with their
    points; 72 proposals made from them with jitter of four sizes (so the
    best IoUs run from positives through the soft band to both negative
    pieces), a few with another class's label (no same-class gt: IoU -1)
    and some invalid. Sample 1: no valid gt, 24 proposals."""
    rng = np.random.RandomState(11)
    gts = np.zeros((2, 4, 7), np.float32)
    gts[0] = [[0, 0, -1, 1.8, 4.2, 1.6, 0.3], [4, 3, -1, 0.7, 0.8, 1.7, 1.0],
              [-4, 2, -1, 0.7, 1.8, 1.6, -2.0], [3, -4, -1, 2.0, 4.6, 1.5,
                                                 2.9]]
    gts[1] = [[1, 1, -1, 2, 4, 1.5, 0.0]] * 4
    labels = np.array([[0, 1, 2, 0], [0, 0, 0, 0]], np.int32)
    gvalid = np.array([[True] * 4, [False] * 4])
    props, plabels = [], []
    for j, scale in enumerate((0.04, 0.15, 0.4, 1.2)):
        for g in range(4):
            for _ in range(4 if j < 3 else 6):
                noise = rng.randn(7) * scale * np.array(
                    [1, 1, 0.3, 0.2, 0.2, 0.1, 0.5])
                props.append(gts[0, g] + noise.astype(np.float32))
                plabels.append(labels[0, g])
    props = np.stack(props)[:72]
    plabels = np.array(plabels[:72], np.int32)
    plabels[::11] = (plabels[::11] + 1) % 3  # another class's label
    props[:, 3:6] = np.abs(props[:, 3:6]) + 0.2
    pvalid = rng.rand(72) > 0.1
    extra = _boxes(rng, 24)
    extra[:, :2] = rng.uniform(-3, 5, (24, 2))
    extra[:, 2] = -1.0
    proposals = np.concatenate([props, extra])
    prop_labels = np.concatenate([plabels, rng.randint(0, 3, 24)]).astype(
        np.int32)
    prop_valid = np.concatenate([pvalid, rng.rand(24) > 0.1])
    prop_batch = np.repeat(np.arange(2, dtype=np.int32), [72, 24])
    # points inside and around the gt boxes of both samples
    pts, pbatch = [], []
    for i in range(2):
        for g in range(4):
            c = gts[i, g, :3] + [0, 0, gts[i, g, 5] / 2]
            pts.append(c + rng.randn(60, 3) * [0.8, 1.2, 0.4])
            pbatch.append(np.full(60, i))
    pts = np.concatenate(pts).astype(np.float32)
    pts = np.concatenate([pts, rng.rand(len(pts), 2).astype(np.float32)], -1)
    pts_batch = np.concatenate(pbatch).astype(np.int32)
    pts_valid = rng.rand(len(pts)) > 0.05
    feats = rng.randn(len(pts), _FEATS).astype(np.float32)
    return (pts, feats, pts_valid, pts_batch, proposals, prop_labels,
            prop_valid, prop_batch, gts, labels, gvalid)


@pytest.fixture(scope="module")
def roi_run(monkeypatch_module):
    args = _roi_scene()
    jargs = tuple(map(jnp.asarray, args))
    draws = []
    sample = jroi.iou_neg_piecewise_sample

    def recording_sample(rng, max_iou, *a, **kw):
        jax.debug.callback(lambda r: draws.append(np.asarray(r)),
                           jax.random.uniform(rng, max_iou.shape))
        return sample(rng, max_iou, *a, **kw)

    monkeypatch_module.setattr(jroi, "iou_neg_piecewise_sample",
                               recording_sample)
    heads = {s: JGCH(num_classes=3, sampler=_ROI_SAMPLER if s else None,
                     **_ROI_CFG) for s in (False, True)}
    v = seeded_variables(jax.eval_shape(lambda: heads[False].init(
        jax.random.PRNGKey(0), *jargs, True, method=heads[False].loss)))

    def reference(params, feats):
        out = {}
        for s, jm in heads.items():
            def f(p, x):
                a = list(jargs)
                a[1] = x
                losses = jm.apply({"params": p}, *a, True, method=jm.loss,
                                  rngs={"sampler": jax.random.PRNGKey(5)})
                assign = jm.apply({"params": p}, *jargs[4:8], *jargs[8:],
                                  method=jm.assign_and_sample)
                return (sum(x for k, x in losses.items()
                            if k.startswith("loss")), (losses, assign))

            (_, aux), grads = jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True)(params, feats)
            out[s] = (aux, grads)
        return out

    ref = jax.tree_util.tree_map(np.asarray, jax.jit(reference)(
        v["params"], jargs[1]))
    assert len(draws) == 1
    return dict(args=args, v=v, ref=ref, draws=T(draws[0]))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("sampler", [False, True])
def test_roi_loss_matches_jax(roi_run, sampler):
    """``GroupCorrectionHead.loss`` on jittered-gt proposals: the three
    losses at rtol 1e-5, the counters exactly, the gradient of every
    parameter leaf and of the point features within 1e-4 of its largest
    magnitude. The scene has positives, soft labels strictly between the
    class thresholds, negatives in both IoU pieces, car and non-car
    positives and a sample without valid gt; with the sampler on (JAX's
    uniforms fed in) it drops proposals from the loss."""
    (losses, (max_iou, argmax, is_pos)), (g_params, g_feats) = \
        roi_run["ref"][sampler]
    args = roi_run["args"]
    tm = load_flax_variables(GroupCorrectionHead(
        5, _FEATS, num_classes=3,
        sampler=_ROI_SAMPLER if sampler else None,
        **_ROI_CFG), roi_run["v"])
    targs = [T(a) for a in args]
    targs[1].requires_grad_()
    got = tm.loss(*targs, train=True, draws=roi_run["draws"])
    sum(x for k, x in got.items() if k.startswith("loss")).backward()

    # the scene covers every branch of the loss
    lbl, valid = args[5], args[6]
    ok = valid & (max_iou >= 0)
    assert is_pos.sum() >= 10
    assert {0, 1} <= set(args[9][0][argmax[is_pos]])  # car and non-car
    soft = ok & (max_iou > 0.2) & (max_iou < 0.8) & ~is_pos
    assert soft.sum() >= 5
    assert (ok & ~is_pos & (max_iou >= 0.1)).sum() >= 5
    assert (ok & ~is_pos & (max_iou < 0.1)).sum() >= 5
    assert (valid & (args[7] == 1)).sum() > 0 and not args[10][1].any()
    assert np.abs(max_iou[valid] - np.array([0.45, 0.35, 0.35])[
        np.minimum(lbl[valid], 2)]).min() > 1e-3  # no pinned positive

    g = {k: float(x.detach()) for k, x in got.items()}
    assert sorted(g) == sorted(losses)
    for k in ("num_pos_rois", "roi_membership_overflow"):
        assert g[k] == float(losses[k]), k
    for k in ("loss_rcnn_cls", "loss_rcnn_bbox", "loss_rcnn_corner"):
        assert float(losses[k]) > 0, k
        np.testing.assert_allclose(g[k], float(losses[k]), rtol=1e-5,
                                   atol=0, err_msg=k)
    n = 0
    for path, ref in _leaves(g_params):
        scale = np.abs(ref).max()
        np.testing.assert_allclose(_torch_leaf(tm, path, grad=True), ref,
                                   rtol=0, atol=1e-4 * scale,
                                   err_msg="/".join(path))
        n += 1
    assert n == sum(1 for _ in tm.parameters())
    np.testing.assert_allclose(targs[1].grad.numpy(), g_feats, rtol=0,
                               atol=1e-4 * np.abs(g_feats).max())
    if sampler:  # the sampler dropped some valid proposals
        assert float(losses["loss_rcnn_cls"]) != float(
            roi_run["ref"][False][0][0]["loss_rcnn_cls"])


def test_roi_loss_draws_from_a_generator(roi_run):
    """With the sampler on and no ``draws``, the loss takes its uniforms
    from a generator (the main path's route): every output a finite 0-dim
    tensor."""
    tm = load_flax_variables(GroupCorrectionHead(
        5, _FEATS, num_classes=3, sampler=_ROI_SAMPLER, **_ROI_CFG),
        roi_run["v"])
    out = tm.loss(*map(T, roi_run["args"]), train=True,
                  generator=torch.Generator().manual_seed(0))
    assert all(x.dim() == 0 and torch.isfinite(x) for x in out.values())


def test_corner_norm_gradient_at_zero_distance():
    """The corner loss's norm at an exactly zero corner distance: JAX's
    ``jnp.linalg.norm`` (sqrt of a sum of squares) has a NaN gradient
    there, the port's ``torch.linalg.vector_norm`` a zero one; elsewhere
    the two gradients agree at 1e-6. ROADMAP queue 3 declares it."""
    x = np.array([[0.0, 0.0, 0.0], [0.3, -0.4, 1.2]], np.float32)
    gj = np.asarray(jax.grad(lambda a: jnp.linalg.norm(a, axis=-1).sum())(
        jnp.asarray(x)))
    xt = T(x).requires_grad_()
    torch.linalg.vector_norm(xt, dim=-1).sum().backward()
    gt = xt.grad.numpy()
    assert np.isnan(gj[0]).all() and (gt[0] == 0).all()
    np.testing.assert_allclose(gt[1], gj[1], **GEO)


# ------------------------------------------------------- SIR with ties

_SIR_CFG = dict(num_blocks=2, feat_channels=((16, 16), (16, 16)),
                rel_mlp_hidden=((8, 8), (8, 8)))


def test_sir_gradients_with_tied_maxima_match_jax():
    """SIR in train mode on clusters whose every row appears twice (each
    segment maximum tied between two rows): the gradient of every
    parameter leaf and of the inputs within 1e-4 of its largest magnitude
    of JAX's. Both frameworks split a tied maximum's gradient equally
    between the rows that hold it. The row count is a multiple of 64: XLA's
    CPU code computes the rows past the last full vector in a remainder
    loop that rounds otherwise, and a copy there would tie no more."""
    rng = np.random.RandomState(12)
    n, f, c = 128, 11, 20
    valid = rng.rand(n) < 0.85
    seg = np.where(valid, rng.randint(0, c - 4, n), c).astype(np.int32)
    points = rng.randn(n, 5).astype(np.float32) * 4
    feats = rng.randn(n, f).astype(np.float32)
    f_cluster = rng.randn(n, 3).astype(np.float32)
    args = [np.concatenate([a, a]) for a in (points, feats, f_cluster, seg)]
    valid2 = np.concatenate([valid, valid])
    w = [np.tile(rng.randn(n, 16).astype(np.float32), (2, 1)),
         rng.randn(c, 64).astype(np.float32)]
    jm = JSIR(in_channels=(0, 0), **_SIR_CFG)
    jargs = tuple(map(jnp.asarray, args))
    v = seeded_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *jargs, c, jnp.asarray(valid2))))

    def f_j(params, pts, ft):
        out = jm.apply({"params": params}, pts, ft, *jargs[2:], c,
                       jnp.asarray(valid2), True)
        return sum((o * x).sum() for o, x in zip(out, w))

    g_params, g_pts, g_feats = jax.jit(jax.grad(f_j, argnums=(0, 1, 2)))(
        v["params"], jargs[0], jargs[1])
    tm = load_flax_variables(SIR(5, f, **_SIR_CFG), v)
    pts, ft = (T(a).requires_grad_() for a in args[:2])
    out = tm(pts, ft, T(args[2]), T(args[3]), c, T(valid2), True)
    sum((o * T(x)).sum() for o, x in zip(out, w)).backward()
    for path, ref in _leaves(g_params):
        np.testing.assert_allclose(
            _torch_leaf(tm, path, grad=True), ref, rtol=0,
            atol=1e-4 * np.abs(ref).max(), err_msg="/".join(path))
    for got, ref in ((pts.grad, g_pts), (ft.grad, g_feats)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
        # the two copies of a row share its gradient equally, in both
        np.testing.assert_array_equal(got.numpy()[:n], got.numpy()[n:])
        np.testing.assert_array_equal(ref[:n], ref[n:])


# --------------------------------------------------------- sample_class


def _seg_data(rng, n=400):
    return {
        "seg_logits": rng.randn(n, 3).astype(np.float32) - 1.5,
        "seg_vote_preds": rng.randn(n, 9).astype(np.float32),
        "valid": rng.rand(n) > 0.2,
        "seg_points": rng.uniform(-6, 6, (n, 5)).astype(np.float32),
        "offsets": (rng.randn(n, 9) * 0.5).astype(np.float32),
        "seg_feats": rng.randn(n, 8).astype(np.float32),
        "batch_idx": (rng.rand(n) > 0.5).astype(np.int32),
        "gt_point_labels": rng.randint(-1, 3, n).astype(np.int32),
    }


@pytest.mark.parametrize("gt_labels", [False, True])
def test_sample_class_with_gt_point_labels(rng, gt_labels):
    """fg selection of ``tiny_fsd`` per class, with and without
    ``add_gt_fg_points``' labels ORed in: selections exactly, points,
    features and centres at 1e-6."""
    data = _seg_data(rng)
    if not gt_labels:
        data.pop("gt_point_labels")
    jm = jflag.tiny_fsd()
    refs = jax.jit(lambda d: [jm.apply({}, d, c, 0.2, method=jm.sample_class)
                              for c in range(3)])(
        {k: jnp.asarray(x) for k, x in data.items()})
    tm = tflag.tiny_fsd(device="cpu")
    tdata = {k: T(x) for k, x in data.items()}
    for cls, ref in enumerate(refs):
        got = tm.sample_class(tdata, cls, 0.2)
        for k in ("idx", "valid", "batch_idx"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)
        for k in ("points", "feats", "centers"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       **GEO, err_msg=k)
        thr = np.float32(jm.score_thresh[cls] + 0.2)
        by_score = (1 / (1 + np.exp(-data["seg_logits"][:, cls])) > thr) \
            & data["valid"]
        n_sel = int(got["valid"].sum())
        if gt_labels:  # the gt labels add points the scores did not pick
            assert n_sel > min(by_score.sum(), jm.caps.fg_per_class[cls])
        else:
            assert n_sel == min(by_score.sum(), jm.caps.fg_per_class[cls])


# ------------------------------------------------ gradient-safe gathers


def _plain_gather(src, index, fill=0.0):
    """The gathers before the repair: padding slots read a clamped row
    (``src[index]``, whose backward is the sort-based index backward) and
    are masked."""
    inside = (index >= 0) & (index < src.shape[0])
    out = src[torch.clamp(index.long(), 0, src.shape[0] - 1)]
    return torch.where(inside[:, None], out, fill)


def _grad(fn, src, *args):
    x = src.clone().requires_grad_()
    out = fn(x, *args)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    (out * w).sum().backward()
    return out.detach(), x.grad


def test_scatter_last_wins_gradient_equals_plain_indexing():
    """The RoI point scatter: 9 of 10 rows named by no stream position
    (the padding the plain gather sent to ``values[0]``): outputs and
    gradients equal the plain indexing's bit for bit."""
    rng = np.random.RandomState(8)
    rows, n = 2000, 300
    idx = T(rng.randint(0, 200, n).astype(np.int32))
    idx[::7] = rows  # dropped
    vals = T(rng.randn(n, 6).astype(np.float32))

    def plain(v, index):
        pos = torch.arange(index.shape[0])
        inside = (index >= 0) & (index < rows)
        winner = torch.full((rows + 1,), -1, dtype=pos.dtype)
        winner.scatter_reduce_(0, torch.where(inside, index.long(), rows),
                               pos, "amax")
        return _plain_gather(v, winner[:rows])

    got, g_got = _grad(lambda v, i: scatter_last_wins(rows, i, v), vals, idx)
    ref, g_ref = _grad(plain, vals, idx)
    assert (got.abs().sum(1) == 0).float().mean() > 0.85
    assert torch.equal(got, ref) and torch.equal(g_got, g_ref)


@pytest.mark.parametrize("where", ["pool features", "pool points",
                                   "gather_segments"])
def test_padded_gathers_gradient_equals_plain_indexing(where, monkeypatch):
    """The RoI pool's gathers (about 70% empty slots at full width): the
    pairs' features, and the pairs' points read for the geometry and the
    head; and ``gather_segments`` (SIR's and SIR²'s broadcast, whose
    invalid rows hold the id S): outputs and gradients equal those of the
    plain clamped indexing (at 1e-6: the two backwards add a row's repeats
    in other orders)."""
    rng = np.random.RandomState(9)
    if where.startswith("pool"):
        which = 1 if where == "pool features" else 0
        args = [T(a) for a in _roi_scene()]
        tm = load_flax_variables(GroupCorrectionHead(
            5, _FEATS, num_classes=3, **_ROI_CFG), seeded_variables(
                jax.eval_shape(lambda: JGCH(num_classes=3, **_ROI_CFG).init(
                    jax.random.PRNGKey(0), *map(jnp.asarray, _roi_scene()),
                    True, method=JGCH(num_classes=3, **_ROI_CFG).loss))))

        def run(x):
            a = list(args)
            a[which] = x
            cls, reg, _, _ = tm.pool_and_forward(*a[:4], a[4][:, :7], a[6],
                                                 a[7], True)
            return torch.cat([cls[:, None], reg], -1)

        got, g_got = _grad(run, args[which])
        monkeypatch.setattr(troi, "gather_rows", _plain_gather)
        ref, g_ref = _grad(run, args[which])
    else:
        src = T(rng.randn(50, 8).astype(np.float32))
        seg = T(np.where(rng.rand(3000) < 0.7, 50, rng.randint(0, 50, 3000))
                .astype(np.int32))
        got, g_got = _grad(gather_segments, src, seg)
        ref, g_ref = _grad(_plain_gather, src, seg)
        assert (seg == 50).float().mean() > 0.6
    assert torch.equal(got, ref)
    np.testing.assert_allclose(g_got.numpy(), g_ref.numpy(), **GEO)
    assert g_got.abs().sum() > 0
