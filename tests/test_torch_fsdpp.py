"""FSD++ (``TwoStageFSDPP``) and its two ops against the JAX package, on the
CPU.

``tiny_fsdpp`` gets seeded variables of the shapes its flax init makes
(``jax.eval_shape``, never compiled) and both packages see
``temporal_batch(RandomState(4))`` (two samples of 1,024 points, frames
0-2, eight seed boxes; the residual selection keeps 348 and 320 points, so
every stage of the inner FSD has work). One jitted JAX function returns the
point selection (keep mask, the frame-age batch, the overflow) and both
predictions; the loss in train mode (with ``fp_rate`` and
``seed_drop_rate`` on, beside the tiny config's seed noise) runs once under
JAX's ``value_and_grad`` with ``jax.random.uniform`` / ``normal`` wrapped
to return their draws, which the port takes as ``draws``. The JAX side runs
its default CPU path; the port's CPU tensors take the sparse conv kernel's
plain twin.

Tolerances: masks, indices, labels and counters exactly; points exactly
(the selection copies rows); boxes and scores rtol/atol 1e-4 and losses
rtol 1e-5 (float32 sums in other orders, as tests/test_torch_fsd.py and
tests/test_torch_fsd_train.py); each gradient leaf within 1e-4 of its
largest magnitude (largest measured 3.5e-5); frame transforms 1e-5.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sst_tpu.models  # noqa: F401  (fills the JAX registry)
from sst_tpu import flagship as jflag
from sst_tpu.models.fsd import fsdpp as jfsdpp
from sst_tpu.ops import fps as jfps
from sst_tpu.ops import incremental as jinc
from sst_tpu.utils.builders import build_model_from_cfg as jbuild
from sst_tpu.utils.config import load_config as jload
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import check_flax_shapes, load_flax_variables
from sst_tpu_torch.models.fsd.fsdpp import SeedDraws, TwoStageFSDPP
from sst_tpu_torch.ops import fps as tfps
from sst_tpu_torch.ops import incremental as tinc
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from sst_tpu_torch.utils.builders import build_model_from_cfg
from sst_tpu_torch.utils.config import load_config
from test_torch_fsd import _everything as _fsd_everything
from test_torch_fsd import seeded_variables
from test_torch_fsdv2_train import _leaves, _torch_leaf
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
FSDPP_CFGS = ("configs/fsdpp/fsdpp_waymo_2x.py",
              "configs/fsdpp/fsdpp_waymo_2x_dense.py")
P = 1024


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _variables(jm, jb):
    return seeded_variables(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "seeds": jax.random.PRNGKey(1)},
        jb, train=False)))


def _batches(p=P):
    return (jflag.temporal_batch(np.random.RandomState(4), p=p),
            tflag.temporal_batch(np.random.RandomState(4), p=p).to("cpu"))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX references of :func:`predict_run` and :func:`loss_run`,
    traced in turn and compiled together in threads (XLA compiles without
    the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    jm = jflag.tiny_fsdpp()
    lm = jm.clone(fp_rate=0.5, seed_drop_rate=0.3)
    jb, _ = _batches()
    v = _variables(jm, jb)  # the rates change no variable

    def everything(m, b):
        # what predict() and predict(skip_rcnn=True) compute, from one
        # pipeline, so JAX compiles it once
        pb, overflow = m.to_point_batch(b, False)
        out = _fsd_everything(m.fsd_mod, pb)
        return pb.points, pb.valid, overflow, out["pred"], out["rpn"]

    draws = []
    uniform, normal = jax.random.uniform, jax.random.normal

    def recording(fn):
        def draw(*a, **k):
            x = fn(*a, **k)
            draws.append(x)
            return x
        return draw

    def loss_fn(params, stats, b):
        out, mut = lm.apply({"params": params, "batch_stats": stats}, b,
                            True, method=lm.loss,
                            rngs={"seeds": jax.random.PRNGKey(3)},
                            mutable=["batch_stats"])
        total = sum(x for k, x in out.items() if _is_loss(k))
        return total, (out, mut["batch_stats"], list(draws))

    pred = jax.jit(lambda v, b: jm.apply(v, b, method=everything)).lower(
        v, jb)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", recording(uniform))
        mp.setattr(jax.random, "normal", recording(normal))
        loss = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
            v["params"], v["batch_stats"], jb)
    with ThreadPoolExecutor(2) as pool:
        pred, loss = pool.map(lambda low: low.compile(), (pred, loss))
    (_, (jout, jstats, jdraws)), jgrads = loss(v["params"], v["batch_stats"],
                                               jb)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jm=jm, v=v, jb=jb, predict=to_np(pred(v, jb)),
                loss=to_np(dict(out=jout, stats=jstats, grads=jgrads,
                                draws=jdraws)))


@pytest.fixture(scope="module")
def predict_run(jax_refs):
    jm, v, jb, jout = (jax_refs[k] for k in ("jm", "v", "jb", "predict"))
    _, tb = _batches()
    tm = load_flax_variables(tflag.tiny_fsdpp(device="cpu"), v).eval()
    scg.reset_launch_counts()
    diag = {}
    with torch.inference_mode():
        pb, overflow = tm.to_point_batch(tb, False, diag=diag)
        pred, rpn = tm.predict(tb), tm.predict(tb, skip_rcnn=True)
        counts = tm.fsd_mod.rpn.run_pipeline(pb)["ex"]["counts"]
    assert scg.launches == 0  # CPU tensors take the twin
    return dict(jm=jm, v=v, jb=jb, tb=tb, jout=jout, pb=pb,
                overflow=overflow, pred=pred, rpn=rpn, counts=counts,
                diag=diag)


def test_point_selection_equals_jax(predict_run):
    """The keep mask (residual current points | seed-cropped previous
    points) and the frame-age batch equal JAX's exactly; the selection
    drops a noticeable share and keeps both kinds."""
    r = predict_run
    jpts, jvalid, jover = r["jout"][:3]
    np.testing.assert_array_equal(_np(r["pb"].valid), jvalid)
    np.testing.assert_array_equal(_np(r["pb"].points), jpts)
    assert float(r["overflow"]) == float(jover) == 0.0
    d = {k: int(x) for k, x in r["diag"].items()}
    assert d["num_input_points"] == int(jvalid.sum())
    assert 0 < d["num_residual_points"] and 0 < d["num_seed_cropped_points"]
    assert d["num_input_points"] < 0.5 * 2 * P
    ages = _np(r["pb"].points)[..., -1]
    assert set(np.unique(ages)) == {0.0, np.float32(-0.1), np.float32(-0.2)}


def test_tiny_fsdpp_exercises_every_stage(predict_run):
    c = {k: v.tolist() for k, v in predict_run["counts"].items()}
    caps = predict_run["jm"].fsd["single_stage"]["caps"]
    assert c["fg"] == list(caps.fg_per_class)
    assert all(n > 0 for n in c["clusters"])
    for which in ("pred", "rpn"):
        assert predict_run[which]["valid"].any(1).all(), which


@pytest.mark.parametrize("which, index", [("pred", 3), ("rpn", 4)])
def test_tiny_fsdpp_predict_parity(predict_run, which, index):
    """``predict()`` and ``predict(skip_rcnn=True)``: validity and labels
    exactly, boxes and scores at 1e-4."""
    ref, got = predict_run["jout"][index], predict_run[which]
    valid = ref["valid"]
    np.testing.assert_array_equal(_np(got["valid"]), valid)
    np.testing.assert_array_equal(_np(got["labels"])[valid],
                                  ref["labels"][valid])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(_np(got[k])[valid], ref[k][valid], **TOL,
                                   err_msg=k)


def test_residual_compaction_and_overflow(predict_run):
    """With ``residual_points_cap`` below the kept count, the kept points
    are compacted earliest index first, the rest counted as overflow:
    equal to JAX's exactly."""
    r = predict_run
    cap = 256
    jm = r["jm"].clone(residual_points_cap=cap)

    def select(m, b):
        pb, overflow = m.to_point_batch(b, False)
        return pb.points, pb.valid, overflow

    jpts, jvalid, jover = jax.jit(lambda v, b: jm.apply(
        v, b, method=select))(r["v"], r["jb"])
    tm = tflag.tiny_fsdpp(device="cpu")
    tm.residual_points_cap = cap
    pb, overflow = tm.to_point_batch(r["tb"], False)
    assert pb.points.shape == (2, cap, 6)
    np.testing.assert_array_equal(_np(pb.valid), np.asarray(jvalid))
    np.testing.assert_array_equal(_np(pb.points), np.asarray(jpts))
    kept = int(_np(r["pb"].valid).sum())
    assert float(overflow) == float(jover) == kept - 2 * cap > 0


@pytest.mark.parametrize("option", [dict(max_crop_points=8),
                                    dict(n_fps=4)])
def test_seed_crop_trims_equal_jax(predict_run, option):
    """The previous points inside seed boxes trimmed per box: the first 8 by
    index (``max_crop_points``) or 4 furthest-point samples
    (``n_fps``): JAX's keep masks exactly, each box within its budget."""
    r = predict_run
    jm = r["jm"].clone(**option)

    def masks(m, b):
        _, enlarged, sv = m.preprocess_seeds(b, False)
        return m.generate_point_mask(b, enlarged, sv)

    ref = np.asarray(jax.jit(lambda v, b: jm.apply(v, b, method=masks))(
        r["v"], r["jb"]))
    tm = tflag.tiny_fsdpp(device="cpu")
    for k, val in option.items():
        setattr(tm, k, val)
    tb = r["tb"]
    _, enlarged, sv = tm.preprocess_seeds(tb, False)
    np.testing.assert_array_equal(_np(tm.generate_point_mask(
        tb, enlarged, sv)), ref)
    residual, crop = tm.point_masks(tb, enlarged, sv)
    budget = next(iter(option.values()))
    for i in range(2):
        _, box = tm._seed_membership(tb.points[i, :, :3], enlarged[i], sv[i])
        per_box = np.bincount(_np(box)[_np(crop[i])], minlength=8)
        assert per_box.max() == budget
    full = _np(r["pb"].valid)
    assert ref.sum() < full.sum()


# ------------------------------------------------------------------ loss


def _is_loss(k):
    return k.startswith("loss")


@pytest.fixture(scope="module")
def loss_run(jax_refs):
    v, ref = jax_refs["v"], jax_refs["loss"]
    _, tb = _batches()
    # JAX's order: the drop uniforms, the copy uniforms and shifts, then
    # the centre, size and yaw normals
    sd = SeedDraws(*(torch.from_numpy(np.array(d)) for d in ref["draws"]))
    tm = load_flax_variables(tflag.tiny_fsdpp(device="cpu"), v)
    tm.fp_rate, tm.seed_drop_rate = 0.5, 0.3
    out = tm.loss(tb, draws=sd)
    sum(x for k, x in out.items() if _is_loss(k)).backward()
    return dict(ref=ref, tm=tm, out=out, tb=tb, sd=sd, v=v)


def test_seed_draws_have_jax_shapes(loss_run):
    b, s = 2, 8
    shapes = [tuple(x.shape) for x in loss_run["sd"]]
    assert shapes == [(b, s), (b, s), (b, s, 2), (b, s, 3), (b, s, 3),
                      (b, s, 1)]
    # the generator route draws the same shapes
    gen = torch.Generator().manual_seed(0)
    got = loss_run["tm"].draw_seed_noise(loss_run["tb"], gen)
    assert [tuple(x.shape) for x in got] == shapes


def test_tiny_fsdpp_loss_parity(loss_run):
    """Every loss at rtol 1e-5, every counter exactly (fg points, clusters,
    kept points, positives, overflows), the running statistics at rtol/atol
    1e-5, and the gradient of every parameter leaf within 1e-4 of its
    largest magnitude."""
    ref, tm, out = loss_run["ref"], loss_run["tm"], loss_run["out"]
    assert sorted(out) == sorted(ref["out"])
    for k, x in ref["out"].items():
        got = float(out[k].detach())
        if _is_loss(k):
            np.testing.assert_allclose(got, float(x), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        else:
            assert got == float(x), k
    assert ref["out"]["num_input_points"] > 0
    assert ref["out"]["loss_rcnn_cls"] > 0 and ref["out"]["loss_vote"] > 0
    n = 0
    for path, g in _leaves(ref["grads"]):
        got = _torch_leaf(tm, path, grad=True)
        np.testing.assert_allclose(got, g, rtol=0,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-12),
                                   err_msg="/".join(path))
        n += 1
    assert n == sum(1 for _ in tm.parameters())
    for path, s in _leaves(ref["stats"]):
        got = _torch_leaf(tm, path, grad=False)
        np.testing.assert_allclose(got, s, rtol=1e-5, atol=1e-5,
                                   err_msg="/".join(path))


def test_seed_noise_moves_drops_and_copies_seeds(loss_run):
    """The seeds after JAX's draws: dropped seeds invalid, copies of valid
    seeds in empty slots shifted by at most 10 m in x and y, the noise
    scaled as configured; equal to JAX's ``preprocess_seeds`` exactly."""
    tm, tb, sd = loss_run["tm"], loss_run["tb"], loss_run["sd"]
    jm = jflag.tiny_fsdpp().clone(fp_rate=0.5, seed_drop_rate=0.3)
    jb, _ = _batches()
    draws = iter(np.array(d) for d in loss_run["ref"]["draws"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", lambda *a, **k: next(draws))
        mp.setattr(jax.random, "normal", lambda *a, **k: next(draws))
        ref = jm.apply({"params": {}}, jb, True, jax.random.PRNGKey(0),
                       method=jm.preprocess_seeds)
    got = tm.preprocess_seeds(tb, True, sd)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_np(g), np.asarray(r))
    base = _np(tb.seed_valid) & (_np(tb.seed_scores) > 0.1)
    assert (_np(got[2]) != base).any()


def test_fp_insertion_fills_empty_slots():
    """Every valid seed copied (``fp_rate`` 1) into the empty slots, in
    order: 3 originals + 3 copies per sample, shifted in x and y only, as
    JAX's test of the same case."""
    b, s = 2, 8
    boxes = torch.tensor([1.0, 1.0, -0.5, 2, 2, 2, 0.0]).repeat(b, s, 1)
    valid = (torch.arange(s) < 3).repeat(b, 1)
    m = tflag.tiny_fsdpp(device="cpu")
    m.fp_rate = 1.0
    u = torch.zeros(b, s)
    shift = torch.rand(b, s, 2, generator=torch.Generator().manual_seed(0))
    labels = torch.zeros(b, s, dtype=torch.int32)
    nb, nl, ns, nv = m._fp_insertion(boxes, labels, torch.full((b, s), 0.9),
                                     valid, u, shift)
    assert int(nv.sum()) == 12
    new = nb[nv & ~valid]
    assert (torch.abs(new[:, :2] - 1.0) <= 10.0).all()
    assert torch.equal(new[:, 2:], boxes[0, :6, 2:])


# ------------------------------------------------------------------- ops


def test_delta_points_mask_equals_jax():
    """Current points whose 0.4 m voxel no previous point occupies, on a
    cloud with repeats of previous voxels, points out of range on each
    side, invalid rows and points on voxel faces: JAX's mask exactly, with
    JAX's function jitted and the range and voxel size constants, as the
    FSD++ model runs it (XLA then takes a face point's cell with the
    voxel's float32 reciprocal, see ``ops/voxelize.py f32_reciprocal``)."""
    rng = np.random.RandomState(0)
    pcr, vs = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0), (0.4, 0.4, 0.4)
    prev = rng.uniform(-9, 9, (600, 3)).astype(np.float32)
    prev[:, 2] = rng.uniform(-2.5, 4.5, 600)
    cur = np.concatenate([prev[:200] + rng.uniform(-0.05, 0.05, (200, 3)),
                          rng.uniform(-9, 9, (300, 3)),
                          np.round(prev[:40] / 0.4) * 0.4]).astype(np.float32)
    cv, pv = rng.rand(len(cur)) > 0.1, rng.rand(len(prev)) > 0.2
    ref = np.asarray(jax.jit(lambda *a: jinc.delta_points_mask(
        *a, pcr, vs))(cur, cv, prev, pv))
    got = tinc.delta_points_mask(*(torch.from_numpy(x) for x in (
        cur, cv, prev, pv)), pcr, vs)
    np.testing.assert_array_equal(_np(got), ref)
    assert 0 < ref.sum() < cv.sum()
    assert tinc._grid_size((-80.0, -80.0, -2.0, 80.0, 80.0, 4.0), vs) == (
        401, 401, 16)


def _pose(rng):
    th = rng.uniform(-np.pi, np.pi)
    pose = np.eye(4, dtype=np.float32)
    pose[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    pose[:3, 3] = rng.uniform(-5, 5, 3)
    return pose


def test_frame_transforms_equal_jax():
    """Points and 7- and 9-dof boxes from one ego pose to another: within
    1e-5 of JAX's (float32 products summed in other orders)."""
    rng = np.random.RandomState(1)
    pre, cur = _pose(rng), _pose(rng)
    cur_inv = np.linalg.inv(cur).astype(np.float32)
    pts = rng.randn(100, 3).astype(np.float32) * 10
    boxes = np.concatenate([rng.randn(20, 3) * 10, rng.uniform(1, 4, (20, 3)),
                            rng.uniform(-np.pi, np.pi, (20, 1)),
                            rng.randn(20, 2)], -1).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        _np(tinc.points_frame_transform(t(pts), t(pre), t(cur_inv))),
        np.asarray(jinc.points_frame_transform(pts, pre, cur_inv)),
        rtol=1e-5, atol=1e-5)
    for d in (7, 9):
        got = _np(tinc.box_frame_transform(t(boxes[:, :d]), t(pre),
                                           t(cur_inv)))
        ref = np.asarray(jinc.box_frame_transform(boxes[:, :d], pre,
                                                  cur_inv))
        assert got.shape == ref.shape == (20, d)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_valid", [0, 5, 180])
def test_furthest_point_sample_equals_jax(n_valid):
    """FPS from the first valid point, 16 picks: indices and the ``ok``
    tail equal JAX's, with no valid point, fewer valid points than picks
    and many (duplicated points make ties: the lowest index wins)."""
    rng = np.random.RandomState(n_valid)
    xyz = rng.randn(200, 3).astype(np.float32)
    xyz[100:120] = xyz[:20]
    valid = np.zeros(200, bool)
    valid[rng.permutation(200)[:n_valid]] = True
    ref = [np.asarray(x) for x in jfps.furthest_point_sample(
        jnp.asarray(xyz), jnp.asarray(valid), 16)]
    got = tfps.furthest_point_sample(torch.from_numpy(xyz),
                                     torch.from_numpy(valid), 16)
    np.testing.assert_array_equal(_np(got[1]), ref[1])
    np.testing.assert_array_equal(_np(got[0])[ref[1]], ref[0][ref[1]])
    assert got[0].dtype == torch.int32


@pytest.mark.parametrize("k", [1, 3, 7])
def test_group_fps_mask_equals_jax(k):
    """Per-group FPS over 12 groups (two empty, one of a single point, one
    of repeated points where ties go to the lowest index): JAX's keep mask
    exactly, at most k per group."""
    rng = np.random.RandomState(k)
    n, g = 300, 12
    xyz = rng.randn(n, 3).astype(np.float32)
    gid = rng.randint(0, g - 2, n).astype(np.int32)
    gid[gid == 3] = 4
    gid[10] = 3
    same = np.flatnonzero(gid == 5)
    xyz[same] = xyz[same[0]]
    valid = rng.rand(n) > 0.15
    valid[10] = True
    ref = np.asarray(jfps.group_fps_mask(jnp.asarray(xyz), jnp.asarray(gid),
                                         jnp.asarray(valid), g, k))
    got = _np(tfps.group_fps_mask(torch.from_numpy(xyz),
                                  torch.from_numpy(gid),
                                  torch.from_numpy(valid), g, k))
    np.testing.assert_array_equal(got, ref)
    counts = np.bincount(gid[got], minlength=g)
    assert counts.max() <= k and counts[3] == 1 and counts[g - 1] == 0


# ------------------------------------------------- configs and weights


def _shape_batch(num_points, num_seeds=256):
    sd = jax.ShapeDtypeStruct
    f32, i32 = jnp.float32, jnp.int32
    return jfsdpp.TemporalBatch(
        points=sd((1, num_points, 5), f32), valid=sd((1, num_points), bool),
        frame_inds=sd((1, num_points), i32), gt_boxes=sd((1, 4, 7), f32),
        gt_labels=sd((1, 4), i32), gt_valid=sd((1, 4), bool),
        seed_boxes=sd((1, num_seeds, 7), f32),
        seed_labels=sd((1, num_seeds), i32),
        seed_scores=sd((1, num_seeds), f32),
        seed_valid=sd((1, num_seeds), bool))


@pytest.mark.parametrize("path", FSDPP_CFGS)
def test_full_width_fsdpp_parameter_shapes_match_jax(path):
    """Both FSD++ configs at full width through the port's loader and
    builder (``train=False`` and ``train=True``): every leaf of JAX's init
    (``jax.eval_shape``: no compile) has its target at the same shape, the
    inner FSD sees the frame age as a sixth channel, the caps are the
    config's."""
    shapes = jax.eval_shape(lambda b: jbuild(jload(path), train=False).init(
        {"params": jax.random.PRNGKey(0), "seeds": jax.random.PRNGKey(1)},
        b, train=False), _shape_batch(262144))
    for train in (False, True):
        tm = build_model_from_cfg(load_config(path), train=train,
                                  device="cpu")
        assert isinstance(tm, TwoStageFSDPP) and tm.max_points == 262144
        assert check_flax_shapes(tm, shapes) == len(tm.state_dict())
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape))
        for s in jax.tree_util.tree_leaves(shapes["params"]))
    rpn = tm.fsd_mod.rpn
    assert tm.residual_points_cap == 65536 and rpn.caps.pre_voxels == 65536
    # x, y, z, 2 channels and the age, then the cluster- and voxel-centre
    # offsets
    assert rpn.segmentor_mod.vfe_mod.DynamicVFELayer_0.Dense_0 \
        .in_features == 6 + 3 + 3
    sparse = path.endswith("2x.py")
    n_convs = sum(type(m).__name__ == "SparseConvLayer"
                  for m in tm.modules())
    assert n_convs == (39 if sparse else 0)
    if sparse:
        assert rpn.segmentor_mod.unet_level_caps == (
            65536, 32768, 16384, 8192, 4096, 2048)


def test_flax_tiny_fsdpp_variables_load(predict_run):
    """flax's ``tiny_fsdpp`` tree (``fsd_mod/...``) loads into the port's
    module unchanged, every leaf matched; a leaf off by a row raises."""
    v = predict_run["v"]
    tm = tflag.tiny_fsdpp(device="cpu")
    n = sum(1 for _ in jax.tree_util.tree_leaves(v))
    assert check_flax_shapes(tm, v) == n == len(tm.state_dict())
    bad = {c: dict(t) for c, t in v.items()}
    seg = dict(bad["params"]["fsd_mod"])
    bad["params"] = dict(bad["params"], fsd_mod=dict(
        seg, rpn=dict(seg["rpn"], head_mod={})))
    with pytest.raises(KeyError):
        load_flax_variables(tflag.tiny_fsdpp(device="cpu"), bad)


def test_synthetic_temporal_batch_equals_bench_frames():
    """``synthetic_temporal_batch(seed)`` is ``bench.py bench_fsdpp``'s
    frame bit for bit (262,144 points, frames 0-6, 256 seeds)."""
    from sst_tpu.flagship import synthetic_waymo_batch

    seed = 1
    got = tflag.synthetic_temporal_batch(seed)
    base = synthetic_waymo_batch(batch_size=1, num_points=262144,
                                 num_extra_feats=2, pcr_half=79.8, seed=seed)
    rng = np.random.RandomState(seed)
    s = 256
    seeds = np.concatenate(
        [rng.uniform(-70, 70, (1, s, 2)), np.full((1, s, 1), -0.5),
         rng.uniform(1, 5, (1, s, 3)),
         rng.uniform(-np.pi, np.pi, (1, s, 1))], -1).astype(np.float32)
    frame_inds = rng.randint(0, 7, base.points.shape[:2]).astype(np.int32)
    labels = rng.randint(0, 3, (1, s)).astype(np.int32)
    scores = rng.rand(1, s).astype(np.float32)
    for name, ref in (("points", base.points), ("valid", base.valid),
                      ("frame_inds", frame_inds), ("seed_boxes", seeds),
                      ("seed_labels", labels), ("seed_scores", scores),
                      ("gt_boxes", base.gt_boxes)):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(ref),
                                      err_msg=name)
    assert got.points.shape == (1, 262144, 5)


def test_temporal_batch_equals_jax():
    jb, tb = _batches(p=256)
    for name in ("points", "valid", "frame_inds", "gt_boxes", "gt_labels",
                 "seed_boxes", "seed_labels", "seed_scores", "seed_valid"):
        np.testing.assert_array_equal(_np(getattr(tb, name)),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)


_LOADER_CHECK = r"""
import sys


class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, _NoJax())
import chip_smoke  # noqa: F401
import sst_tpu_torch.core.tracklet  # noqa: F401
import sst_tpu_torch.data.tracklet_dataset  # noqa: F401
import sst_tpu_torch.models.ctrl.tracklet_detector  # noqa: F401
import sst_tpu_torch.models.fsd.fsdv2  # noqa: F401
from sst_tpu_torch.utils.builders import build_model_from_cfg
from sst_tpu_torch.utils.config import load_config

out = {}
for path in sys.argv[1:]:
    cfg = load_config(path)
    out[path] = {k: cfg[k] for k in ("model", "capacity", "optimizer",
                                     "schedule")}
    if cfg["model"]["type"] == "TrackletDetector":
        build_model_from_cfg(cfg, device="cpu")
loaded = sorted(m for m in sys.modules
                if m == "sst_tpu" or m.startswith("sst_tpu."))
print(repr((loaded, out)))
"""


def test_config_loader_keeps_the_jax_package_out():
    """The FSD++ configs load the FSD config through the JAX package's
    ``load_config``. In a process where jax and flax cannot be imported,
    ``chip_smoke.py`` and the CTRL and FSDV2 modules import, the port's
    loader reads both FSD++ configs, fsdv2_waymo_1x.py and ctrl_veh_24e.py
    (which the builder then builds on the CPU) without putting any
    ``sst_tpu`` module into ``sys.modules``, and gives JAX's loader's model,
    capacity, optimizer and schedule."""
    paths = list(FSDPP_CFGS) + ["configs/fsdv2/fsdv2_waymo_1x.py",
                                "configs/ctrl/ctrl_veh_24e.py"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _LOADER_CHECK, *paths],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    loaded, got = eval(res.stdout.strip().splitlines()[-1])
    assert loaded == []
    for path in paths:
        ref = jload(os.path.join(root, path))
        for k in ("model", "capacity", "optimizer", "schedule"):
            assert got[path][k] == ref[k], (path, k)


def test_config_loader_refuses_other_jax_imports(tmp_path):
    cfg = tmp_path / "cfg.py"
    cfg.write_text("from sst_tpu.utils.registry import MODELS\nmodel = {}\n")
    with pytest.raises(ImportError, match="JAX package"):
        load_config(str(cfg))
