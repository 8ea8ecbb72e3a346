"""Parity of the port's PointPillars with the JAX package: ``hard_voxelize``
(``sst_tpu_torch/ops/voxelize.py``), ``HardSimpleVFE``,
``PillarFeatureNet`` and ``DynamicPillarFeatureNet`` (``models/vfe.py``),
``SECOND`` and ``SECONDFPN`` (``models/second.py``), the detector
(``models/detectors/pointpillars.py``) and its config through the builder,
``convert.py`` and the CLIs.

The detector is ``tests/test_misc_components.py TestPointPillars._tiny``'s
build (0.5 m pillars over +-8 m, 512 pillars of 8 points, PFN 16, SECOND
(16, 32, 32), FPN 16 x 3 at strides (1, 2, 4)) on ``fsd_batch(
RandomState(0), b=2, p=512)``, with seeded variables of the port model's
shapes in flax's layout (no flax init is compiled). One jitted JAX function
gives its head maps, ``predict``, the train-mode ``loss`` terms, the
gradient of their sum and the updated running statistics. The modules'
references run eagerly, SECOND + FPN's under ``jax.jit``. The file holds
fewer than 8 test ids, so the tier-1 command's ``--dist loadfile`` runs it
beside ``tests/test_train_step.py``, not before it (ROADMAP.md, "Tier-1
headroom").

Tolerances: hard voxels, counts, coords and masks exactly; module outputs,
maps and input gradients at rtol 1e-5 and atol 1e-5 of each array's
largest magnitude (at least 1; f32 convs sum their products in another
order in torch than in XLA); losses rtol 1e-5, ``num_pos`` and
``num_voxels`` exactly; each gradient leaf and running statistic within
1e-5 relative plus 1e-5 of its largest magnitude; predict's boxes and
scores at rtol/atol 1e-5, labels and valid exactly, after a check that
every score-threshold and top-k cut lies at least 10x the packages'
largest logit difference away.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import sst_tpu.models  # noqa: F401  (fills the JAX registry)
from sst_tpu import flagship as jflag
from sst_tpu.models import second as jsecond
from sst_tpu.models import vfe as jvfe
from sst_tpu.models.detectors.dynamic_voxelnet import PointBatch as JPB
from sst_tpu.models.detectors.pointpillars import PointPillars as JPP
from sst_tpu.ops import voxelize as jvox
from sst_tpu.utils.builders import build_model_from_cfg as jbuild
from sst_tpu.utils.config import load_config as jload
from sst_tpu_torch.apis import inference_detector
from sst_tpu_torch.convert import check_flax_shapes, load_flax_variables
from sst_tpu_torch.models import PointBatch
from sst_tpu_torch.models import second as tsecond
from sst_tpu_torch.models import vfe as tvfe
from sst_tpu_torch.models.detectors.pointpillars import PointPillars
from sst_tpu_torch.ops import voxelize as tvox
from sst_tpu_torch.utils.builders import build_model_from_cfg
from sst_tpu_torch.utils.config import load_config
from test_torch_ctrl import seeded_port_variables
from test_torch_fsdv2_train import _leaves, _torch_leaf
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PP_CFG = "configs/pointpillars/pointpillars_waymoD5_3class.py"
TINY = dict(
    voxel_size=(0.5, 0.5, 6.0),
    point_cloud_range=(-8.0, -8.0, -2.0, 8.0, 8.0, 4.0),
    max_voxels=512, max_points_per_voxel=8,
    vfe=dict(feat_channels=(16,)),
    backbone=dict(out_channels=(16, 32, 32), layer_nums=(1, 1, 1)),
    neck=dict(out_channels=(16, 16, 16), upsample_strides=(1, 2, 4)),
    head=dict(num_classes=3, feat_channels=48,
              anchor_ranges=((-8, -8, -0.03, 8, 8, -0.03),) * 3),
    test_cfg=dict(score_thr=0.05, nms_thr=0.25, nms_pre=64, max_num=32,
                  use_rotate_nms=True))
PCR, VS = TINY["point_cloud_range"], TINY["voxel_size"]


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _port_leaf(model, path, grad):
    """``_torch_leaf`` with the convs' kernels in flax's HWIO layout too
    (a transposed conv's flipped back)."""
    arr = _torch_leaf(model, path, grad)
    mod = model.get_submodule(".".join(path[:-1]))
    if path[-1] == "kernel" and isinstance(mod, nn.ConvTranspose2d):
        return arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    if path[-1] == "kernel" and isinstance(mod, nn.Conv2d):
        return arr.transpose(2, 3, 1, 0)
    return arr


def _points(n=3000, seed=0):
    """Points in clusters (pillars past T) over +-9 m (some outside the
    range), 5 channels, one padded tail."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-8, 8, (40, 2))
    xy = centres[rng.randint(0, 40, n)] + rng.randn(n, 2) * 0.4
    xy[: n // 4] = rng.uniform(-9, 9, (n // 4, 2))
    pts = np.concatenate([xy, rng.uniform(-2.5, 4.5, (n, 1)),
                          rng.rand(n, 2)], 1).astype(np.float32)
    valid = np.arange(n) < n - 50
    batch_idx = (np.arange(n) >= n // 2).astype(np.int32)
    return pts, batch_idx, valid


def test_hard_voxelize_equals_jax():
    """A frame whose pillars overflow T = 8, and at a cap of 512 also
    ``max_voxels``."""
    pts, bi, valid = _points()
    vm = tvox.dynamic_voxelize(_t(pts), _t(bi), _t(valid), PCR, VS, 4096, 2)
    assert int(vm.unique.counts.max()) > 8  # pillars past T
    for max_voxels in (1024, 512):
        want = jvox.hard_voxelize(jnp.asarray(pts), jnp.asarray(bi),
                                  jnp.asarray(valid), PCR, VS, max_voxels, 8,
                                  2)
        got = tvox.hard_voxelize(_t(pts), _t(bi), _t(valid), PCR, VS,
                                 max_voxels, 8, 2)
        for g, w in zip(got, want):
            assert g.numpy().dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (int(vm.unique.num_unique) > max_voxels) == (max_voxels == 512)


def _hard_inputs():
    pts, bi, valid = _points(seed=1)
    return [np.asarray(x) for x in jvox.hard_voxelize(
        jnp.asarray(pts), jnp.asarray(bi), jnp.asarray(valid), PCR, VS, 600,
        8, 2)]


def test_hard_pillar_encoders_equal_jax():
    """``HardSimpleVFE``; ``PillarFeatureNet`` with two layers (the
    broadcast concat between them) and the distance channel, at inference
    and in train mode (the batch statistics over the valid points, the
    running statistics' update)."""
    voxels, num, coords, _ = _hard_inputs()
    want = jvfe.HardSimpleVFE().apply({}, jnp.asarray(voxels),
                                      jnp.asarray(num))
    _close(tvfe.HardSimpleVFE()(_t(voxels), _t(num)).numpy(), want)
    kw = dict(feat_channels=(16, 32), with_distance=True, voxel_size=VS,
              point_cloud_range=PCR)
    jm = jvfe.PillarFeatureNet(**kw)
    args = (jnp.asarray(voxels), jnp.asarray(num), jnp.asarray(coords))
    for train in (False, True):
        tm = tvfe.PillarFeatureNet(5, **kw)
        v = seeded_port_variables(tm, seed=2)
        load_flax_variables(tm, v)
        want, upd = jm.apply(v, *args, train, mutable=["batch_stats"])
        got = tm(_t(voxels), _t(num), _t(coords), train)
        _close(got.detach().numpy(), want)
        for path, w in _leaves(upd["batch_stats"]):
            _close(_port_leaf(tm, path, grad=False), w)


def test_dynamic_pillar_feature_net_equals_jax():
    """Both reduce routes (the sorted reduce's CPU twin and the scatters)
    against JAX's scatter route, over full-height pillars."""
    pts, bi, valid = _points(seed=3)
    kw = dict(feat_channels=(16, 16), voxel_size=VS, point_cloud_range=PCR)
    jvm = jvox.dynamic_voxelize(jnp.asarray(pts), jnp.asarray(bi),
                                jnp.asarray(valid), PCR, VS, 1024, 2)
    for sorted_reduce in (False, True):
        tm = tvfe.DynamicPillarFeatureNet(5, use_sorted_reduce=sorted_reduce,
                                          **kw)
        v = seeded_port_variables(tm, seed=4)
        load_flax_variables(tm, v)
        want = jvfe.DynamicPillarFeatureNet(use_sorted_reduce=False,
                                            **kw).apply(v, jnp.asarray(pts),
                                                        jvm)
        tvm = tvox.dynamic_voxelize(_t(pts), _t(bi), _t(valid), PCR, VS,
                                    1024, 2, need_ranks=sorted_reduce)
        with torch.no_grad():
            got = tm(_t(pts), tvm)
        assert tm.sorted_calls == int(sorted_reduce)
        _close(got.numpy(), want)


def test_second_and_fpn_equal_jax():
    """SECOND (16, 32, 32) at strides (2, 2, 2) and SECONDFPN at upsample
    strides (1, 2, 4): the transposed convs' flipped kernels. The map and
    the gradient of a seeded linear loss to the input, at inference and in
    train mode."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 32, 32, 8).astype(np.float32)
    bk = dict(out_channels=(16, 32, 32), layer_nums=(1, 1, 1))
    nk = dict(out_channels=(8, 8, 8), upsample_strides=(1, 2, 4))
    tb, tn = tsecond.SECOND(8, **bk), tsecond.SECONDFPN((16, 32, 32), **nk)
    vb, vn = seeded_port_variables(tb, 6), seeded_port_variables(tn, 7)
    load_flax_variables(tb, vb)
    load_flax_variables(tn, vn)
    jb, jn = jsecond.SECOND(**bk), jsecond.SECONDFPN(**nk)
    g = rng.randn(2, 16, 16, 24).astype(np.float32)

    def fwd(x, train):
        feats, _ = jb.apply(vb, x, train, mutable=["batch_stats"])
        out, _ = jn.apply(vn, feats, train, mutable=["batch_stats"])
        return jnp.sum(out * g), out

    for train in (False, True):
        (_, want), dx = jax.jit(jax.value_and_grad(fwd, has_aux=True),
                                static_argnums=1)(jnp.asarray(x), train)
        xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
        out = tn(tb(xt, train), train)
        (out * _t(g).permute(0, 3, 1, 2)).sum().backward()
        _close(out.detach().permute(0, 2, 3, 1).numpy(), want)
        _close(xt.grad.permute(0, 2, 3, 1).numpy(), dx)


def _labelled_batch():
    jb = jflag.fsd_batch(np.random.RandomState(0), b=2, p=512)
    tb = PointBatch(*(np.asarray(getattr(jb, f)) for f in (
        "points", "valid", "gt_boxes", "gt_labels", "gt_valid"))).to("cpu")
    return jb, tb


@pytest.fixture(scope="module")
def tiny_run():
    jm = JPP(**TINY)
    jb, tb = _labelled_batch()
    tm = PointPillars(5, **TINY)
    v = seeded_port_variables(tm, seed=0)
    assert check_flax_shapes(tm, jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jb, train=False))) == len(tm.state_dict())
    load_flax_variables(tm, v)

    def ref(params, stats, b):
        var = {"params": params, "batch_stats": stats}

        def loss_fn(p):
            out, upd = jm.apply({"params": p, "batch_stats": stats}, b,
                                train=True, method=jm.loss,
                                mutable=["batch_stats"])
            total = sum(x for k, x in out.items() if k.startswith("loss"))
            return total, (out, upd["batch_stats"])

        (_, (terms, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return (jm.apply(var, b), jm.apply(var, b, method=jm.predict), terms,
                grads, new_stats)

    want = jax.tree_util.tree_map(np.asarray, jax.jit(ref)(
        v["params"], v["batch_stats"], jb))
    tm.eval()
    with torch.no_grad():
        maps = tm(tb)
    det = tm.predict(tb)
    tm.train()
    terms = tm.loss(tb)
    sum(x for k, x in terms.items() if k.startswith("loss")).backward()
    return dict(tm=tm, want=want, maps=maps, det=det, terms=terms)


def test_tiny_pointpillars_equals_jax(tiny_run):
    """The head maps; predict, once every cut its decisions take lies 10x
    the largest logit difference away (boxes, scores, labels, valid); the
    loss terms; every gradient leaf and running statistic."""
    maps, det, terms, grads, stats = tiny_run["want"]
    tm = tiny_run["tm"]
    for k in ("cls", "reg", "dir"):
        _close(tiny_run["maps"][k].numpy(), maps[k])

    cls_t, cls_j = tiny_run["maps"]["cls"].numpy(), maps["cls"]
    thr = np.log(0.05 / 0.95)
    margin = 10 * float(np.abs(cls_t - cls_j).max()) + 1e-7
    assert np.abs(cls_j - thr).min() > margin
    k = TINY["test_cfg"]["nms_pre"]
    for i in range(cls_j.shape[0]):
        for c in range(cls_j.shape[-1]):
            s = np.sort(cls_j[i, ..., c].ravel())[::-1]
            if s[k] > thr:  # the top-k cut matters
                assert s[k - 1] - s[k] > margin, (i, c)
    got = {key: v.numpy() for key, v in tiny_run["det"].items()}
    np.testing.assert_array_equal(got["valid"], det["valid"])
    np.testing.assert_array_equal(got["labels"], det["labels"])
    assert got["valid"].sum() > 10
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key], det[key], rtol=1e-5, atol=1e-5)

    assert set(tiny_run["terms"]) == set(terms)
    for key, w in terms.items():
        g = float(tiny_run["terms"][key].detach())
        if key in ("num_pos", "num_voxels"):
            assert g == float(w), key
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=key)
    assert float(terms["num_pos"]) > 0 and float(terms["num_voxels"]) > 100

    n = 0
    for path, w in _leaves(grads):
        _close(_port_leaf(tm, path, grad=True), w)
        n += 1
    assert n == sum(1 for _ in tm.parameters())
    for path, w in _leaves(stats):
        _close(_port_leaf(tm, path, grad=False), w)


def test_full_width_parameter_shapes_match_jax():
    """The config's full-width PointPillars: every leaf of JAX's init (PFN
    64, SECOND (64, 128, 256), the transposed FPN convs at strides 2 and
    4, the head) has its torch target at the same shape."""
    cfg = load_config(os.path.join(ROOT, PP_CFG))
    jm = jbuild(jload(os.path.join(ROOT, PP_CFG)), train=False)
    sd = jax.ShapeDtypeStruct
    jb = JPB(points=sd((1, 4096, 5), jnp.float32),
             valid=sd((1, 4096), jnp.bool_),
             gt_boxes=sd((1, 1, 7), jnp.float32),
             gt_labels=sd((1, 1), jnp.int32), gt_valid=sd((1, 1), jnp.bool_))
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              train=False), jb)
    tm = build_model_from_cfg(cfg, train=False, device="cpu")
    assert check_flax_shapes(tm, shapes) == len(tm.state_dict())
    assert tuple(tm.neck_mod.deblock_conv_2.weight.shape) == (256, 128, 4, 4)
    assert tm.bev_shape == (468, 468) and tm.max_points == 196608


def _tiny_config(path) -> str:
    """The tiny PointPillars as a config file, its NMS at 16 candidates and
    8 boxes per class (the random weights score every anchor)."""
    model = dict(TINY, type="PointPillars",
                 test_cfg=dict(TINY["test_cfg"], nms_pre=16, max_num=8))
    with open(path, "w") as f:
        f.write(f"model = {model!r}\n"
                f"capacity = dict(max_points=2048)\n"
                f"data = dict(samples_per_device=2)\n"
                f"optimizer = dict(base_lr=1e-3, weight_decay=0.01, "
                f"clip_norm=35.0)\n")
    return str(path)


def test_config_predicts_trains_and_tests_on_cpu(tmp_path, monkeypatch):
    """The tiny PointPillars as a config file: ``inference_detector`` on a
    frame, then the train CLI (2 synthetic steps at 2 samples per device)
    and the test CLI on its checkpoint. The CLIs' TensorBoard writer is
    off (``tests/test_torch_tools.py`` covers it)."""
    from sst_tpu_torch.tools import test as test_cli
    from sst_tpu_torch.tools import train as train_cli

    monkeypatch.setattr(train_cli, "open_tensorboard", lambda wd: None)
    cfg = _tiny_config(tmp_path / "tiny_pointpillars.py")
    m = build_model_from_cfg(load_config(cfg), train=False,
                             device="cpu").eval()
    assert type(m).__name__ == "PointPillars" and m.max_points == 2048
    pts = np.asarray(jflag.fsd_batch(np.random.RandomState(1), b=1,
                                     p=1024).points[0])
    out = inference_detector(m, pts)
    assert out["boxes"].shape == (8, 7) and np.isfinite(out["boxes"]).all()
    wd = str(tmp_path / "wd")
    summary = train_cli.main([cfg, "--synthetic", "--device", "cpu",
                              "--max-steps", "2", "--work-dir", wd])
    assert summary["steps"] == 2 and np.isfinite(summary["loss_total"]).all()
    res = test_cli.main([cfg, os.path.join(wd, "ckpt_2"), "--synthetic",
                         "--device", "cpu", "--num-samples", "1", "--eval",
                         "ap3d"])
    assert res["frames"] == 1
