"""Parity of the port's training path (sparse-UNet FSDv2 ``loss``, the
optimizer and the train step) with the JAX package, on the CPU.

The slice: ``tiny_fsdv2_flagship`` with the same weights in both packages
(the port's seeded ``init_weights``, random running statistics, converted
into a flax variable tree), on a 2048-point labelled frame whose gt boxes lie
inside the +-3.8 m range and own their points. ``loss`` in train mode with
``pretrain=False`` is held against JAX ``value_and_grad`` (jitted once):
every loss, the gradient of every parameter leaf and the updated running
statistics. Both packages run the sparse conv and the segment reductions on
their plain paths (JAX's ``gather_gemm`` and scatters, the port's twins);
the Pallas kernels' gradients are covered by test_torch_sparse_conv_grad.py.

Tolerances, with the largest gaps measured:
  - losses rtol 1e-4 / atol 1e-6 (2.9e-7 relative);
  - gradients: each leaf within 1e-4 of its largest magnitude, plus rtol
    1e-4 (4.4e-6 of the largest magnitude, a BN scale of the mixer): the
    backward sums many f32 products in other orders through ~40 layers;
  - running statistics rtol/atol 1e-5 (1.2e-7).
The discrete steps (fg thresholds, per-class top-k cuts) could flip on a
near-tie, so the test first asserts every such margin is at least 10x the
seg-score gap between the packages.

The pieces: ``MaskedBatchNorm`` in train mode, the five losses,
``seg_targets``, ``base_point_encode``, ``points_in_boxes``,
``gt_point_class_labels``, ``sample_class`` in both modes, the schedules and
two optimizer steps against flax, JAX and optax at rtol/atol 1e-5 or
exactly, as each test says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from sst_tpu import flagship as jflag
from sst_tpu.core import box_coders as jbc
from sst_tpu.core import boxes as jboxes
from sst_tpu.core import losses as jloss
from sst_tpu.core.target_assign import gt_point_class_labels as jgt_labels
from sst_tpu.models import layers as fl
from sst_tpu.models.fsd.vote_segmentor import seg_targets as jseg_targets
from sst_tpu.train import schedules as jsched
from sst_tpu.train import state as jstate
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.core import box_coders as tbc
from sst_tpu_torch.core import boxes as tboxes
from sst_tpu_torch.core import losses as tloss
from sst_tpu_torch.core.target_assign import gt_point_class_labels
from sst_tpu_torch.models import layers as tl
from sst_tpu_torch.models.fsd.vote_segmentor import seg_targets
from sst_tpu_torch.models.sparse_unet import SparseConvLayer
from sst_tpu_torch.train import schedules as tsched
from sst_tpu_torch.train.state import cosine_onecycle, make_optimizer
from sst_tpu_torch.train.step import train_step
from test_torch_fsdv2 import _assert_margins
from torch_threads import torch_threads_per_worker  # noqa: F401

FRAME = dict(batch_size=1, num_points=2048, seed=2, num_extra_feats=0,
             pcr_half=3.8, num_objects=8, size_scale=0.5)


def _flax_variables(model: nn.Module, seed: int = 0) -> dict:
    """The torch model's parameters as a flax variable tree (the inverse of
    ``load_flax_variables``), with random running statistics."""
    rng = np.random.RandomState(seed)
    tree = {"params": {}, "batch_stats": {}}
    for key, value in model.state_dict().items():
        *path, leaf = key.split(".")
        mod = model.get_submodule(".".join(path))
        arr = value.detach().numpy().copy()
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", leaf[len("running_"):]
            arr = ((rng.randn(*arr.shape) * 0.1) if name == "mean" else
                   rng.uniform(0.5, 1.5, arr.shape)).astype(np.float32)
        elif leaf == "bias":
            coll, name = "params", "bias"
        elif isinstance(mod, nn.Linear):
            coll, name, arr = "params", "kernel", arr.T
        elif isinstance(mod, SparseConvLayer):
            coll, name = "params", "kernel"
        else:  # LayerNorm and MaskedBatchNorm scales
            coll, name = "params", "scale"
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def _torch_leaf(model: nn.Module, path: tuple, grad: bool) -> np.ndarray:
    """The torch counterpart of flax leaf ``path`` (params or batch_stats),
    in flax layout: a gradient, or a running statistic."""
    *mods, leaf = path
    mod = model.get_submodule(".".join(mods))
    if leaf in ("mean", "var"):
        return getattr(mod, f"running_{leaf}").numpy()
    t = mod.bias if leaf == "bias" else mod.weight
    arr = (t.grad if grad else t.detach()).numpy()
    return arr.T if isinstance(mod, nn.Linear) and leaf == "kernel" else arr


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _pipeline_losses(m, b, pretrain):
    """loss, and the seg outputs the margin check reads, in one trace."""
    pipe = m.run_pipeline(b, True, 0.0, pretrain)
    return m.losses_from_pipeline(b, pipe), {
        k: pipe["seg_out"][k] for k in ("seg_logits", "valid")}


@pytest.fixture(scope="module")
def slice_run():
    tm = tflag.init_weights(tflag.tiny_fsdv2_flagship(device="cpu"),
                            torch.Generator().manual_seed(0))
    v = _flax_variables(tm)
    jm = jflag.tiny_fsdv2_flagship()
    jb, _ = jflag.synthetic_labeled_batch(**FRAME)

    def loss_fn(params, stats, b):
        (out, seg), mut = jm.apply(
            {"params": params, "batch_stats": stats}, b, False,
            method=_pipeline_losses, mutable=["batch_stats"])
        total = sum(x for k, x in out.items() if k.startswith("loss"))
        return total, (out, seg, mut["batch_stats"])

    (_, (jout, jseg, jstats)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v["batch_stats"], jb)

    tb = tflag.synthetic_labeled_batch(**FRAME)[0].to("cpu")
    tm = load_flax_variables(tflag.tiny_fsdv2_flagship(device="cpu"), v)
    with torch.no_grad():
        tpre, tpre_seg = _pipeline_losses(tm, tb, True)
    tm = load_flax_variables(tflag.tiny_fsdv2_flagship(device="cpu"), v)
    tout, tseg = _pipeline_losses(tm, tb, False)
    sum(x for k, x in tout.items() if k.startswith("loss")).backward()
    return dict(jm=jm, tm=tm, v=v, jout=jout, jseg=jseg, jstats=jstats,
                jgrads=jgrads, tout=tout, tseg=tseg, tpre=tpre,
                tpre_seg=tpre_seg)


def test_train_parity_tiny_fsdv2_flagship(slice_run):
    """Losses at rtol 1e-4 / atol 1e-6, each gradient leaf within 1e-4 of
    its largest magnitude plus rtol 1e-4, running statistics at rtol/atol
    1e-5 (largest gaps measured: 2.9e-7, 4.4e-6 and 1.2e-7 relative)."""
    r = slice_run
    _assert_margins(r["jm"], {"seg_out": r["jseg"]},
                    {"seg_out": {k: x.detach() for k, x in
                                 r["tseg"].items()}})
    jout = {k: float(x) for k, x in r["jout"].items()}
    tout = {k: float(x.detach()) for k, x in r["tout"].items()}
    assert sorted(tout) == sorted(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k], jout[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # segmentation and detection positives exist
    assert jout["loss_vote"] > 0 and jout["num_virtual"] > 0
    assert all(jout[f"loss_center.task{t}"] > 0 for t in range(3))
    n = 0
    for path, ref in _leaves(r["jgrads"]):
        got = _torch_leaf(r["tm"], path, grad=True)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg="/".join(path))
        n += 1
    assert n == sum(1 for _ in r["tm"].parameters())
    for path, ref in _leaves(r["jstats"]):
        got = _torch_leaf(r["tm"], path, grad=False)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg="/".join(path))


def test_pretrain_loss_tiny_fsdv2_flagship(slice_run):
    """``pretrain=True`` (top-k of every valid point, no threshold). On
    this frame more valid points than each class's cap score above the tiny
    model's 0.05 thresholds, so both modes select the same top-k points,
    and JAX's pretrain losses are its ``pretrain=False`` ones: the port's
    pretrain losses equal its own ``pretrain=False`` losses and JAX's at
    the slice tolerance (largest gap measured 2.9e-7 relative).
    ``test_sample_class_matches_jax`` holds the branch against JAX where the
    two modes select differently."""
    r = slice_run
    seg = r["tpre_seg"]
    scores = torch.sigmoid(seg["seg_logits"][seg["valid"]])
    jm = r["jm"]
    for c, thr in enumerate(jm.score_thresh):
        assert int((scores[:, c] > thr).sum()) > jm.caps.fg_per_class[c]
    jout = {k: float(x) for k, x in r["jout"].items()}
    tout = {k: float(x.detach()) for k, x in r["tout"].items()}
    for k, x in r["tpre"].items():
        assert float(x) == tout[k], k
        np.testing.assert_allclose(float(x), jout[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_every_parameter_gets_a_gradient(slice_run):
    """As in JAX, every parameter leaf has a gradient (no tolerance)."""
    missing = [n for n, p in slice_run["tm"].named_parameters()
               if p.grad is None]
    assert missing == []


def test_flax_variables_round_trip(slice_run):
    """The inverse conversion the slice test uses is exact and strict."""
    m = load_flax_variables(tflag.tiny_fsdv2_flagship(device="cpu"),
                            slice_run["v"])
    for path, ref in _leaves(slice_run["v"]["params"]):
        np.testing.assert_array_equal(_torch_leaf(m, path, grad=False), ref)


def _random_seg_data(rng, n=300, classes=3, extra=2):
    return {
        "seg_logits": rng.randn(n, classes).astype(np.float32),
        "valid": rng.rand(n) > 0.2,
        "seg_points": rng.uniform(-3.5, 3.5, (n, 3 + extra)).astype(
            np.float32),
        "offsets": (rng.randn(n, classes * 3) * 0.5).astype(np.float32),
        "seg_feats": rng.randn(n, 8).astype(np.float32),
        "batch_idx": np.zeros(n, np.int32),
        "gt_point_labels": rng.randint(-1, classes, n).astype(np.int32),
    }


@pytest.mark.parametrize("pretrain,gt_labels", [(False, False), (True, False),
                                                (False, True)])
def test_sample_class_matches_jax(rng, pretrain, gt_labels):
    """Per-class fg selection: threshold + top-k, the pretrain top-k of
    every valid point, and ``add_gt_fg_points``' gt-label recovery:
    selections exactly, centres and features at rtol/atol 1e-6 (largest gap
    measured 7.5e-9)."""
    data = _random_seg_data(rng)
    if not gt_labels:
        data.pop("gt_point_labels")
    jm = jflag.tiny_fsdv2_flagship()
    tm = tflag.tiny_fsdv2_flagship(device="cpu")
    sample = jax.jit(lambda d: [jm.apply({}, d, c, 0.05, pretrain,
                                         method=jm.sample_class)
                                for c in range(3)])
    refs = sample({k: jnp.asarray(x) for k, x in data.items()})
    for cls, ref in enumerate(refs):
        got = tm.sample_class({k: torch.from_numpy(x)
                               for k, x in data.items()}, cls, 0.05, pretrain)
        assert int(got["valid"].sum()) > 0
        for k in ("valid", "batch_idx"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        for k in ("centers", "proj_in"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-6)


def test_masked_batch_norm_train_matches_flax(rng):
    """Output, input and affine gradients and updated running statistics,
    with a mask and without one (every row), at rtol/atol 1e-5 (largest
    gap measured 9.5e-6 absolute, on values of order 10^2)."""
    x = (rng.randn(200, 12) * 2 + 1).astype(np.float32)
    mask = rng.rand(200) > 0.3
    g = rng.randn(200, 12).astype(np.float32)
    stats = {"mean": rng.randn(12).astype(np.float32),
             "var": rng.uniform(0.5, 2, 12).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, 12).astype(np.float32),
              "bias": rng.randn(12).astype(np.float32)}
    for m in (mask, None):
        jmask = jnp.ones(200, bool) if m is None else jnp.asarray(m)

        def f(p, xx):
            y, mut = fl.MaskedBatchNorm().apply(
                {"params": p, "batch_stats": stats}, xx, jmask, True,
                mutable=["batch_stats"])
            return (y * g).sum(), (y, mut["batch_stats"])

        (_, (y_ref, st_ref)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
        bn = tl.MaskedBatchNorm(12)
        load_flax_variables(bn, {"params": params, "batch_stats": stats})
        xt = torch.from_numpy(x).requires_grad_()
        y = bn(xt, None if m is None else torch.from_numpy(m), train=True)
        (y * torch.from_numpy(g)).sum().backward()
        tol = dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y.detach().numpy(), y_ref, **tol)
        np.testing.assert_allclose(xt.grad.numpy(), gx, **tol)
        np.testing.assert_allclose(bn.weight.grad.numpy(), gp["scale"], **tol)
        np.testing.assert_allclose(bn.bias.grad.numpy(), gp["bias"], **tol)
        np.testing.assert_allclose(bn.running_mean.numpy(), st_ref["mean"],
                                   **tol)
        np.testing.assert_allclose(bn.running_var.numpy(), st_ref["var"],
                                   **tol)


def test_losses_match_jax(rng):
    """The five losses and their gradients, at rtol/atol 1e-5 (largest gap
    measured 3.8e-6)."""
    logits = rng.randn(50, 3).astype(np.float32) * 2
    labels = rng.randint(0, 4, 50).astype(np.int32)  # 3 = background
    onehot = rng.rand(50, 3).astype(np.float32)
    target = rng.randn(50, 3).astype(np.float32)
    w = rng.rand(50).astype(np.float32)
    ce_labels = rng.randint(-1, 3, 50).astype(np.int32)
    cases = [
        ("sigmoid_focal_loss", (labels,), dict(gamma=3.0, alpha=0.8,
                                               avg_factor=7.0)),
        ("sigmoid_focal_loss", (onehot,), dict(avg_factor=3.0)),
        ("l1_loss", (target,), dict(avg_factor=5.0)),
        ("smooth_l1_loss", (target,), dict(beta=0.5, avg_factor=5.0)),
        ("cross_entropy_loss", (ce_labels,), dict(avg_factor=9.0)),
        ("binary_cross_entropy_loss", (onehot,), dict(avg_factor=2.0)),
    ]
    for name, extra, kw in cases:
        def jf(x):
            return getattr(jloss, name)(x, *map(jnp.asarray, extra),
                                        weight=jnp.asarray(w), **kw)

        ref, gref = jax.jit(jax.value_and_grad(jf))(jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_()
        got = getattr(tloss, name)(x, *map(torch.from_numpy, extra),
                                   weight=torch.from_numpy(w), **kw)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(gref),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _scene(rng, n=400, g=6):
    """Points and overlapping gt boxes (so that the first box must win),
    box 3 invalid."""
    pts = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.5, 1.5, n)
    boxes = np.concatenate([
        rng.uniform(-2, 2, (g, 2)), np.full((g, 1), -1.0),
        rng.uniform(1.0, 3.0, (g, 3)), rng.uniform(-np.pi, np.pi, (g, 1)),
    ], -1).astype(np.float32)
    labels = rng.randint(0, 3, g).astype(np.int32)
    gvalid = np.arange(g) != 3
    return pts, rng.rand(n) > 0.1, boxes, labels, gvalid


def test_box_targets_match_jax(rng):
    """points_in_boxes, seg_targets and gt_point_class_labels exactly (the
    vote targets at rtol/atol 1e-6); base_point_encode at 1e-6 (largest gap
    measured 3.0e-8)."""
    pts, valid, boxes, labels, gvalid = _scene(rng)
    t = {k: torch.from_numpy(x) for k, x in dict(
        pts=pts, valid=valid, boxes=boxes, labels=labels,
        gvalid=gvalid).items()}
    inb = tboxes.points_in_boxes(t["pts"], t["boxes"]).numpy()
    np.testing.assert_array_equal(inb, np.asarray(jax.jit(
        jboxes.points_in_boxes)(jnp.asarray(pts), jnp.asarray(boxes))))
    assert (inb.sum(1) > 1).any()  # overlapping boxes: the first one wins
    ref = jax.jit(jseg_targets, static_argnums=5)(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(gvalid), 3)
    got = seg_targets(t["pts"], t["valid"], t["boxes"], t["labels"],
                      t["gvalid"], 3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert (got[0].numpy() < 3).any()
    bidx = (rng.rand(len(pts)) > 0.5).astype(np.int32)
    boxes2 = np.stack([boxes, boxes[::-1].copy()])
    labels2 = np.stack([labels, labels[::-1].copy()])
    gvalid2 = np.stack([gvalid, gvalid[::-1].copy()])
    ref = jax.jit(jgt_labels)(jnp.asarray(pts), jnp.asarray(bidx),
                              jnp.asarray(valid), jnp.asarray(boxes2),
                              jnp.asarray(labels2), jnp.asarray(gvalid2))
    got = gt_point_class_labels(t["pts"], torch.from_numpy(bidx), t["valid"],
                                torch.from_numpy(boxes2),
                                torch.from_numpy(labels2),
                                torch.from_numpy(gvalid2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    base = rng.randn(len(boxes), 3).astype(np.float32)
    ref = jbc.base_point_encode(jnp.asarray(base), jnp.asarray(boxes), 2.0)
    got = tbc.base_point_encode(torch.from_numpy(base), t["boxes"], 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_schedules_match_jax():
    """FSDDetectionSchedule and DisableAugmentationSchedule are copies:
    equal outputs at every probed step."""
    for kw in ({}, dict(enable_after=10, buffer_start=0.4,
                        delay_buffer_until=50, quantize=0.0)):
        j, t = jsched.FSDDetectionSchedule(**kw), tsched.FSDDetectionSchedule(
            **kw)
        for step in (0, 5, 10, 11, 30, 49, 50, 3999, 4000, 5000, 7999, 9000):
            assert t(step) == j(step), (kw, step)
    pipeline = [dict(type="LoadPoints"), dict(type="RandomFlip3D"),
                dict(type="ObjectSample")]
    j = jsched.DisableAugmentationSchedule(100)
    t = tsched.DisableAugmentationSchedule(100)
    for step in (0, 99, 100, 200):
        assert t.filter_pipeline(pipeline, step) == j.filter_pipeline(
            pipeline, step)
        assert t.boundary_crossed(step - 1, step) == j.boundary_crossed(
            step - 1, step)


def test_learning_rate_schedule_matches_optax():
    """The copy of optax's cosine one-cycle (in f64) against optax (in f32)
    at rtol 4e-6 plus 1e-6 of the peak rate: near the end f32 loses the
    small rate to cancellation (largest gap measured 9.6e-8 of the peak)."""
    for base_lr, total in ((1e-5, 10000), (2e-3, 37)):
        ref = jstate.cosine_onecycle(base_lr, total)
        got = cosine_onecycle(base_lr, total)
        for count in sorted({0, 1, 5, total // 3, int(0.4 * total) - 1,
                             int(0.4 * total), total // 2, total - 1, total,
                             total + 10}):
            np.testing.assert_allclose(got(count), float(ref(count)),
                                       rtol=4e-6, atol=1e-6 * base_lr,
                                       err_msg=count)


def test_two_optimizer_steps_match_optax(rng):
    """Global-norm clip (the first step's gradients clipped, the second's
    not), AdamW moments with bias correction, decoupled weight decay of
    every parameter, the learning rate of each step: parameters after two
    steps at rtol/atol 1e-6, and the pre-clip norms at rtol 1e-6 (largest
    gap measured 2.4e-7 absolute, 5.4e-7 relative)."""
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (5.0, 0.3)]
    tx = jstate.make_optimizer(base_lr=1e-2, weight_decay=0.05,
                               total_steps=10, clip_norm=10.0)
    jp = {k: jnp.asarray(x) for k, x in params.items()}
    opt_state = tx.init(jp)
    update = jax.jit(lambda g, st, p: (lambda u, s: (optax.apply_updates(
        p, u), s))(*tx.update(g, st, p)))
    tp = {k: nn.Parameter(torch.from_numpy(x.copy()))
          for k, x in params.items()}
    opt = make_optimizer(tp.values(), base_lr=1e-2, weight_decay=0.05,
                         total_steps=10, clip_norm=10.0)
    norms = []
    for g in grads:
        jg = {k: jnp.asarray(x) for k, x in g.items()}
        jp, opt_state = update(jg, opt_state, jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = opt.step()
        norms.append(float(norm))
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(jg)), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    assert norms[0] > 10.0 > norms[1] and opt.count == 2


def test_train_step_moves_the_model():
    """One step of the train loop on the tiny model: the metrics JAX's
    ``train_step`` returns, every parameter with a gradient, every running
    statistic moved, and every parameter moved but the zero biases whose
    gradient is 0 (a task without positives). ``loss_total`` is the sum of
    the losses at rtol 1e-6."""
    m = tflag.init_weights(tflag.tiny_fsdv2_flagship(device="cpu"),
                           torch.Generator().manual_seed(1))
    batch = tflag.synthetic_labeled_batch(**FRAME)[0].to("cpu")
    opt = make_optimizer(m.parameters(), base_lr=1e-3, total_steps=100)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    met = train_step(m, opt, batch, tsched.FSDDetectionSchedule()(0))
    total = sum(float(v) for k, v in met.items()
                if k.startswith("loss") and k != "loss_total")
    assert np.isclose(float(met["loss_total"]), total, rtol=1e-6)
    assert float(met["grad_norm"]) > 0 and opt.params_without_grad == 0
    params = dict(m.named_parameters())
    for k, v in m.state_dict().items():
        if torch.equal(before[k], v):
            assert k in params, k
            assert not params[k].grad.any() and not v.any(), k


def test_synthetic_labeled_batch_bit_identical():
    """The labelled frames equal the JAX package's bit for bit."""
    t, tmeta = tflag.synthetic_labeled_batch(**FRAME)
    j, jmeta = jflag.synthetic_labeled_batch(**FRAME)
    for name in ("points", "valid", "gt_boxes", "gt_labels", "gt_valid"):
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(tmeta, jmeta):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert bool(t.gt_valid[0, 0])  # box 0 encodes the negatives' targets
