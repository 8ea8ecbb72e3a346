"""Parity of the port's CTRL ``TrackletDetector`` (predict, loss and its
gradients) with the JAX package on the CPU, and the full-width config build.

``tiny_ctrl`` gets seeded variables of the port model's shapes in flax's
layout (``seeded_port_variables``: no flax init is traced or compiled; the
JAX side's ``apply`` reads every leaf at its shape); both packages see
``tracklet_batch(RandomState(0), b=2, p=512, f=8)``: two tracks of 512
points over 8 frames, gt candidates the tracker boxes plus N(0, 0.05). One
JAX reference gives predict, and one the train-mode losses with the
updated running statistics and the gradient of the summed losses (each
jitted, compiled together: ``run_jitted``). The JAX side runs
its default CPU path (the sparse convs' ``gather_gemm``, the scatter VFE:
``SST_TPU_PALLAS_INTERPRET`` unset, which would move its VFE onto the sorted
path); the port's CPU tensors take the kernels' plain twins.

Tolerances: predict's boxes and scores at rtol/atol 1e-4, valid and labels
exactly; losses rtol 1e-5 and ``roi_membership_overflow`` exactly; each
gradient leaf within 1e-4 of that leaf's largest magnitude; running
statistics rtol/atol 1e-5. The pool's pairing (in-box tests on the raw
points) is held equal first, so no decision is pinned.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import sst_tpu.models  # noqa: F401  (fills the JAX registry)
from sst_tpu import flagship as jflag
from sst_tpu.models.ctrl import TrackletBatch as JTrackletBatch
from sst_tpu.models.fsd.roi_head import dynamic_point_pool as jpool
from sst_tpu.utils.builders import build_model_from_cfg as jbuild
from sst_tpu.utils.config import load_config as jload
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import check_flax_shapes, load_flax_variables
from sst_tpu_torch.models.ctrl import TrackletDetector
from sst_tpu_torch.models.fsd.roi_head import dynamic_point_pool
from sst_tpu_torch.models.sparse_unet import SparseConvLayer
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from sst_tpu_torch.utils.builders import (
    build_model_from_cfg,
    optimizer_from_cfg,
)
from sst_tpu_torch.utils.config import load_config
from test_torch_fsdv2_train import _leaves, _torch_leaf

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest magnitude
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
CTRL_CFG = "configs/ctrl/ctrl_veh_24e.py"
_FIELDS = ("points", "valid", "frame_inds", "trk_boxes", "trk_scores",
           "trk_valid", "labels", "gt_boxes", "gt_valid")


def _is_loss(k):
    return k.startswith("loss")


def run_jitted(fns, *args):
    """Each of ``fns`` jitted and run on ``args``, as numpy trees: traced
    one after another, compiled together in threads (XLA compiles without
    the interpreter lock), so the references' compile times overlap."""
    lowered = [jax.jit(f).lower(*args) for f in fns]
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = list(pool.map(lambda low: low.compile(), lowered))
    return [jax.tree_util.tree_map(np.asarray, c(*args)) for c in compiled]


def seeded_port_variables(model: nn.Module, seed: int = 0) -> dict:
    """Seeded float32 variables of ``model``'s state in flax's tree and
    layout (the inverse of ``load_flax_variables``): kernels normal with
    variance 1/fan_in, biases normal(0, 0.1), LayerNorm and BatchNorm
    scales uniform(0.5, 1.5), running means normal(0, 0.1) and variances
    uniform(0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    tree = {"params": {}, "batch_stats": {}}
    for key, value in model.state_dict().items():
        *path, leaf = key.split(".")
        mod = model.get_submodule(".".join(path))
        shape = tuple(value.shape)
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", leaf[len("running_"):]
            arr = (rng.randn(*shape) * 0.1 if name == "mean"
                   else rng.uniform(0.5, 1.5, shape))
        elif leaf == "bias":
            coll, name, arr = "params", "bias", rng.randn(*shape) * 0.1
        elif isinstance(mod, (nn.Linear, SparseConvLayer)):
            if isinstance(mod, nn.Linear):
                shape = shape[::-1]
            coll, name = "params", "kernel"
            arr = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        else:  # LayerNorm and MaskedBatchNorm scales
            coll, name, arr = "params", "scale", rng.uniform(0.5, 1.5, shape)
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = arr.astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def both(monkeypatch_module):
    monkeypatch_module.delenv("SST_TPU_PALLAS_INTERPRET", raising=False)
    jm = jflag.tiny_ctrl()
    jb = jflag.tracklet_batch(np.random.RandomState(0))
    v = seeded_port_variables(tflag.tiny_ctrl(device="cpu"))

    def predict(params, stats, b):
        return jm.apply({"params": params, "batch_stats": stats}, b,
                        method=jm.predict)

    def train(params, stats, b):
        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats}, b,
                                train=True, method=jm.loss,
                                mutable=["batch_stats"])
            return (sum(x for k, x in out.items() if _is_loss(k)),
                    (out, mut["batch_stats"]))

        (_, (out, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return dict(losses=out, stats=new_stats, grads=grads)

    pred, ref = run_jitted((predict, train), v["params"], v["batch_stats"],
                           jb)
    ref["pred"] = pred

    tb = tflag.tracklet_batch(np.random.RandomState(0), device="cpu")
    scg.reset_launch_counts()
    tm = load_flax_variables(tflag.tiny_ctrl(device="cpu"), v).eval()
    pred = tm.predict(tb)
    tm.train()
    losses = tm.loss(tb, train=True)
    sum(x for k, x in losses.items() if _is_loss(k)).backward()
    assert scg.launches == 0  # CPU tensors never launch a kernel
    return dict(jm=jm, jb=jb, v=v, ref=ref, tb=tb, tm=tm, pred=pred,
                losses=losses)


def test_tracklet_batch_draws_equal_jax(both):
    """``flagship.tracklet_batch`` takes JAX's numpy draws from the same
    RandomState, bit for bit."""
    for name in _FIELDS:
        np.testing.assert_array_equal(getattr(both["tb"], name).numpy(),
                                      np.asarray(getattr(both["jb"], name)),
                                      err_msg=name)


def test_ctrl_predict_matches_jax(both):
    ref, got = both["ref"]["pred"], both["pred"]
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
    assert ref["valid"].all()  # every frame's roi holds points
    for k in ("boxes", "scores"):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), ref[k], **TOL, err_msg=k)


def test_ctrl_losses_match_jax(both):
    ref = both["ref"]["losses"]
    got = {k: float(x.detach()) for k, x in both["losses"].items()}
    assert sorted(got) == sorted(ref)
    assert got["roi_membership_overflow"] == float(
        ref["roi_membership_overflow"]) == 0.0
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=LOSS_RTOL,
                                   atol=0, err_msg=k)
    assert float(ref["mean_roi_iou"]) > 0.3  # near-gt rois
    assert all(float(ref[k]) > 0 for k in ref if _is_loss(k))


def test_ctrl_gradients_match_jax(both):
    """Every parameter leaf's gradient within GRAD_TOL of its largest
    magnitude; every torch parameter has its leaf and a gradient."""
    tm, n = both["tm"], 0
    for path, ref in _leaves(both["ref"]["grads"]):
        got = _torch_leaf(tm, path, grad=True)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max(),
                                   err_msg="/".join(path))
        n += 1
    assert n == sum(1 for _ in tm.parameters())
    assert all(p.grad is not None for p in tm.parameters())


def test_ctrl_running_statistics_move_as_jax(both):
    tm, n = both["tm"], 0
    for path, ref in _leaves(both["ref"]["stats"]):
        np.testing.assert_allclose(_torch_leaf(tm, path, grad=False), ref,
                                   **STATS_TOL, err_msg="/".join(path))
        n += 1
    assert n == sum(1 for k in tm.state_dict() if "running_" in k) > 0
    moved = both["v"]["batch_stats"]["segmentor_mod"]["unet_mod"][
        "conv_input"]["MaskedBatchNorm_0"]["mean"]
    assert not np.allclose(moved, tm.segmentor_mod.unet_mod.conv_input
                           .MaskedBatchNorm_0.running_mean.numpy())


def test_ctrl_pool_counts_membership_overflow(both):
    """The frame pairing with a candidate cap below the in-roi points: the
    points past it are dropped and counted, as JAX's pool does; every pair
    joins a point with its own frame's roi."""
    b = both["tb"]
    pts, pt_group, rois, roi_group = both["tm"].roi_mod._flatten(b)
    valid = b.valid.reshape(-1)
    roi_valid = b.trk_valid.reshape(-1)
    args = (pts[:, :3], valid, pt_group, rois, roi_valid, roi_group,
            (0.5, 0.5, 0.5), 32, 200)
    got = dynamic_point_pool(*args)
    ref = jax.jit(lambda *t: jpool(*t, (0.5, 0.5, 0.5), 32, 200))(
        *(jnp.asarray(a.numpy()) for a in args[:6]))
    assert int(ref["membership_overflow"]) > 0
    for k in ("idx", "valid", "membership_overflow", "inbox_overflow"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["geo"].numpy(), np.asarray(ref["geo"]),
                               **TOL)
    pair_group = pt_group[got["idx"].long()]
    assert torch.equal(pair_group[got["valid"]],
                       roi_group[:, None].expand_as(pair_group)[
                           got["valid"]])


def test_full_width_ctrl_parameter_shapes_match_jax():
    """configs/ctrl/ctrl_veh_24e.py at full width: every leaf of JAX's init
    (``jax.eval_shape``: no compile, no allocation) has its torch target at
    the same shape, every torch tensor is set; the builder keeps the
    config's point cap and the optimizer its AdamW."""
    sd = jax.ShapeDtypeStruct
    b, p, f = 1, 4096, 8
    batch = JTrackletBatch(
        points=sd((b, p, 6), jnp.float32), valid=sd((b, p), jnp.bool_),
        frame_inds=sd((b, p), jnp.int32), trk_boxes=sd((b, f, 7),
                                                       jnp.float32),
        trk_scores=sd((b, f), jnp.float32), trk_valid=sd((b, f), jnp.bool_),
        labels=sd((b,), jnp.int32), gt_boxes=sd((b, f, 7), jnp.float32),
        gt_valid=sd((b, f), jnp.bool_))
    jm = jbuild(jload(CTRL_CFG), train=False)
    shapes = jax.eval_shape(lambda bb: jm.init(
        {"params": jax.random.PRNGKey(0)}, bb, train=False), batch)
    cfg = load_config(CTRL_CFG)
    tm = build_model_from_cfg(cfg, train=False, device="cpu")
    assert isinstance(tm, TrackletDetector) and tm.max_points == 32768
    assert check_flax_shapes(tm, shapes) == len(tm.state_dict())
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape))
        for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(type(m).__name__ == "SparseConvLayer"
               for m in tm.modules()) == 18
    assert not tm.segmentor_mod.vfe_mod.use_sorted_reduce
    opt = optimizer_from_cfg(tm, cfg, total_steps=100)
    assert opt.adamw.param_groups[0]["weight_decay"] == 0.01
    assert opt.clip_norm == 10.0
    assert max(opt.schedule(i) for i in range(100)) == pytest.approx(1e-4)
