"""Slice-level parity of the port's FSD ``predict`` (single stage and two
stage) with the JAX package, and the config path that builds it.

``tiny_fsd_two_stage`` gets seeded variables of the shapes its flax init
makes (``jax.eval_shape``, never compiled) and both packages see the same
``fsd_batch`` frame (two samples of 512 points, x, y, z + 2 channels;
at 1,024 the tiny pre-voxel cap of 1,024 leaves the second sample five).
One jitted JAX function returns the pipeline's intermediates, the single
stage's boxes (``skip_rcnn=True``, which is ``tiny_fsd``'s ``predict`` on
the ``rpn`` subtree) and the refined boxes. The JAX side runs its default
CPU path (the sparse convs' ``gather_gemm``, its plain reference); the
port's CPU tensors take the sparse conv kernel's plain twin.

Tolerances: float outputs at rtol/atol 1e-4 (the packages sum the convs'
products in other orders); every discrete decision exactly: fg selections,
cluster ids, cluster validity, proposals, NMS keeps. Before comparing them
the test asserts that each threshold and top-k cut they pass lies at least
10x the two packages' largest score difference away, so no decision is
pinned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sst_tpu.models  # noqa: F401  (fills the JAX registry)
from sst_tpu import flagship as jflag
from sst_tpu.utils.builders import build_model_from_cfg as jbuild
from sst_tpu.utils.config import load_config as jload
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.apis import frame_to_numpy, prepare_batch
from sst_tpu_torch.convert import check_flax_shapes, load_flax_variables
from sst_tpu_torch.models import PointBatch
from sst_tpu_torch.models.fsd.two_stage import FSD
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from sst_tpu_torch.utils.builders import build_model_from_cfg
from sst_tpu_torch.utils.config import load_config
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
FSD_CFG = "configs/fsd/fsd_waymoD1_1x.py"
FSD_DENSE_CFG = "configs/fsd/fsd_waymoD1_1x_dense.py"


def seeded_variables(shapes, seed=0) -> dict:
    """Seeded numpy variables of the shapes a flax init makes: kernels
    normal with variance 1/fan_in, biases normal(0, 0.1), LayerNorm and
    BatchNorm scales uniform(0.5, 1.5), running means normal(0, 0.1) and
    variances uniform(0.5, 1.5), all float32."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            x = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("bias", "mean"):
            x = rng.randn(*shape) * 0.1
        else:  # scale, var
            x = rng.uniform(0.5, 1.5, shape)
        return x.astype(np.float32)

    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return {k: dict(v) for k, v in out.items()}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


_NMS_KEYS = ("nms_thr", "score_thr", "max_num", "use_rotate_nms")


def _everything(m, b):
    """The pipeline once, then both predictions from it (what
    ``predict(skip_rcnn=...)`` computes), so JAX compiles one function."""
    pipe = m.rpn.run_pipeline(b, train=False, detach_seg=False)
    ex = pipe["ex"]
    rpn = m.rpn.head_mod.get_bboxes(
        pipe["outs"], ex["cluster_xyz"], ex["cluster_batch"],
        ex["cluster_valid"], pipe["batch_size"], **m.rpn.test_cfg)
    props = m._proposals(pipe)
    pts, feats, pvalid, pbatch = m._roi_points(pipe)
    pred = m.roi.predict(pts, feats, pvalid, pbatch, *props,
                         pipe["batch_size"],
                         **{k: v for k, v in m.rpn.test_cfg.items()
                            if k in _NMS_KEYS})
    keep = ("cluster_xyz", "cluster_batch", "cluster_valid", "cluster_feats",
            "pt_feats", "pt_seg_ids", "pt_valid", "pt_idx")
    return {"seg_logits": pipe["seg_out"]["seg_logits"],
            "data": {k: pipe["data"][k] for k in ("seg_logits", "valid",
                                                  "seg_points")},
            "ex": {k: ex[k] for k in keep}, "outs": pipe["outs"],
            "props": props, "roi_feats": feats, "rpn": rpn, "pred": pred}


@pytest.fixture(scope="module")
def both():
    jm = jflag.tiny_fsd_two_stage()
    jb = jflag.fsd_batch(np.random.RandomState(1), p=512)
    v = seeded_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jb)))
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: jm.apply(v, b, method=_everything))(v, jb))

    batch = PointBatch(points=np.asarray(jb.points),
                       valid=np.asarray(jb.valid)).to("cpu")
    tm = load_flax_variables(tflag.tiny_fsd_two_stage(device="cpu"),
                             v).eval()
    ts = load_flax_variables(tflag.tiny_fsd(device="cpu"),
                             {c: t["rpn"] for c, t in v.items()}).eval()
    scg.reset_launch_counts()
    with torch.inference_mode():
        tout = _everything(tm, batch)
        preds = {"rpn": tm.predict(batch, skip_rcnn=True),
                 "pred": tm.predict(batch),
                 "single_stage": ts.predict(batch)}
        counts = tm.rpn.run_pipeline(batch)["ex"]["counts"]
    assert scg.launches == 0  # CPU tensors never launch a kernel
    return dict(jm=jm, v=v, jout=jout, tout=tout, preds=preds,
                counts=counts, batch=batch)


def _assert_margins(jm, jout, tout):
    """Every fg threshold and per-class top-k cut, and every proposal cut,
    lies >= 10x the packages' largest score difference away."""
    ss = jm.single_stage
    valid = jout["data"]["valid"]
    s_j = 1 / (1 + np.exp(-jout["data"]["seg_logits"].astype(np.float64)))
    s_t = 1 / (1 + np.exp(-_np(tout["data"]["seg_logits"]).astype(
        np.float64)))
    diff = np.abs(s_j - s_t)[valid].max()
    assert diff < 1e-5
    for c, thr in enumerate(ss["score_thresh"]):
        s = s_j[valid, c]
        assert np.abs(s - thr).min() >= 10 * diff, (c, "threshold")
        fg = np.sort(s[s > thr])[::-1]
        cap = ss["caps"].fg_per_class[c]
        if len(fg) > cap:
            assert fg[cap - 1] - fg[cap] >= 10 * diff, (c, "top-k cut")
    # proposals: each sample's top-k cut over its clusters' scores
    pdiff = np.abs(jout["props"][1] - _np(tout["props"][1])).max()
    scores = np.concatenate([
        (1 / (1 + np.exp(-lg.astype(np.float64)))).max(-1)
        for lg in jout["outs"]["cls_logits"]])
    n_tasks = len(jout["outs"]["cls_logits"])
    ok = np.tile(jout["ex"]["cluster_valid"], n_tasks)
    batch = np.tile(jout["ex"]["cluster_batch"], n_tasks)
    k = jm.rois_per_sample
    for i in range(jout["pred"]["valid"].shape[0]):
        s = np.sort(scores[ok & (batch == i)])[::-1]
        if len(s) > k:
            assert s[k - 1] - s[k] >= 10 * pdiff, (i, "proposal cut")


def test_tiny_fsd_decisions_equal_jax(both):
    jout, tout = both["jout"], both["tout"]
    _assert_margins(both["jm"], jout, tout)
    np.testing.assert_allclose(_np(tout["seg_logits"]), jout["seg_logits"],
                               **TOL)
    np.testing.assert_array_equal(_np(tout["data"]["valid"]),
                                  jout["data"]["valid"])
    for k in ("cluster_valid", "cluster_batch", "pt_seg_ids", "pt_valid",
              "pt_idx"):
        np.testing.assert_array_equal(_np(tout["ex"][k]), jout["ex"][k],
                                      err_msg=k)
    for k in ("cluster_xyz", "cluster_feats", "pt_feats"):
        np.testing.assert_allclose(_np(tout["ex"][k]), jout["ex"][k], **TOL,
                                   err_msg=k)
    for k in ("cls_logits", "reg_preds"):
        for got, ref in zip(tout["outs"][k], jout["outs"][k]):
            np.testing.assert_allclose(_np(got), ref, **TOL, err_msg=k)
    # proposals: boxes, scores, labels, valid, batch
    for got, ref in zip(tout["props"], jout["props"]):
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(_np(got), ref, **TOL)
        else:
            np.testing.assert_array_equal(_np(got), ref)
    np.testing.assert_allclose(_np(tout["roi_feats"]), jout["roi_feats"],
                               **TOL)


def test_tiny_fsd_fills_its_caps_and_clusters(both):
    """The frame exercises every stage: fg caps filled, more clusters than
    the cluster cap (so the cap binds), CCL rounds counted."""
    c = {k: v.tolist() for k, v in both["counts"].items()}
    caps = both["jm"].single_stage["caps"]
    assert c["fg"] == list(caps.fg_per_class)
    assert all(n > 0 for n in c["cluster_voxels"])
    assert any(n > cap for n, cap in zip(c["clusters"],
                                         caps.clusters_per_class))
    assert all(1 <= r < 64 for r in c["ccl_rounds"])
    assert int(both["tout"]["ex"]["cluster_valid"].sum()) > 0


@pytest.mark.parametrize("which", ["rpn", "pred", "single_stage"])
def test_tiny_fsd_predict_parity(both, which):
    """``tiny_fsd_two_stage.predict(skip_rcnn=True)`` ("rpn"), ``predict()``
    ("pred") and ``tiny_fsd.predict`` on the ``rpn`` variables
    ("single_stage", JAX's skip_rcnn output is the same function) against
    JAX: keep masks, labels exactly; boxes and scores at 1e-4."""
    ref = both["jout"]["rpn" if which == "single_stage" else which]
    got = both["preds"][which]
    # predict() recomputes the pipeline: the same numbers as _everything's
    same = both["tout"]["rpn" if which == "single_stage" else which]
    for k in got:
        np.testing.assert_array_equal(_np(got[k]), _np(same[k]), err_msg=k)
    valid = ref["valid"]
    assert valid.any(axis=1).all()
    assert got["boxes"].shape == ref["boxes"].shape
    np.testing.assert_array_equal(_np(got["valid"]), valid)
    np.testing.assert_array_equal(_np(got["labels"])[valid],
                                  ref["labels"][valid])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(_np(got[k])[valid], ref[k][valid], **TOL,
                                   err_msg=k)


def test_roi_points_overlap_takes_the_later_stream(both):
    """In this frame some pre-voxelized points are fg for two classes; the
    RoI point features of such a row are the later stream's, as JAX's
    scatter gives them on the CPU."""
    ex = both["tout"]["ex"]
    idx = _np(ex["pt_idx"])[_np(ex["pt_valid"])]
    assert len(idx) - len(np.unique(idx)) > 0
    pt_feats = _np(ex["pt_feats"])
    rows = np.flatnonzero(_np(ex["pt_valid"]))
    last = {}
    for r in rows:
        last[int(_np(ex["pt_idx"])[r])] = r
    c_sir = pt_feats.shape[1]
    roi = both["jout"]["roi_feats"]
    for p, r in last.items():
        np.testing.assert_allclose(roi[p, :c_sir], pt_feats[r], **TOL)


def test_converter_loads_every_leaf_of_tiny_fsd_two_stage(both):
    v = both["v"]
    tm = tflag.tiny_fsd_two_stage(device="cpu")
    n = sum(1 for _ in jax.tree_util.tree_leaves(v))
    assert check_flax_shapes(tm, v) == n == len(tm.state_dict())
    load_flax_variables(tm, v)
    blk = v["params"]["roi"]["bbox_head_mod"]["block_1"]
    np.testing.assert_array_equal(
        tm.roi.bbox_head_mod.block_1.rel_mlp.Dense_0.weight.detach().numpy(),
        blk["rel_mlp"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(
        tm.roi.bbox_head_mod.block_1.vfe_1.LayerNorm_0.weight.detach()
        .numpy(), blk["vfe_1"]["LayerNorm_0"]["scale"])
    sir = v["params"]["rpn"]["backbone_mod"]["block_0"]["vfe_0"]
    np.testing.assert_array_equal(
        tm.rpn.backbone_mod.block_0.vfe_0.Dense_0.weight.detach().numpy(),
        sir["Dense_0"]["kernel"].T)


@pytest.mark.parametrize("case", ["extra_leaf", "missing_leaf", "bad_shape"])
def test_converter_stays_strict_on_fsd(both, case):
    v = {c: dict(t) for c, t in both["v"].items()}
    roi = dict(v["params"]["roi"])
    head = dict(roi["bbox_head_mod"])
    cls = dict(head["conv_cls"])
    if case == "extra_leaf":
        cls["Dense_9"] = {"kernel": np.zeros((4, 4), np.float32)}
        err = KeyError
    elif case == "missing_leaf":
        del cls["Dense_2"]
        err = KeyError
    else:
        cls["Dense_2"] = {"kernel": cls["Dense_2"]["kernel"][:-1],
                          "bias": cls["Dense_2"]["bias"]}
        err = ValueError
    head["conv_cls"] = cls
    roi["bbox_head_mod"] = head
    v["params"] = dict(v["params"], roi=roi)
    with pytest.raises(err):
        load_flax_variables(tflag.tiny_fsd_two_stage(device="cpu"), v)


def _shape_batch(num_points):
    from sst_tpu.models.detectors.dynamic_voxelnet import PointBatch as JPB

    sd = jax.ShapeDtypeStruct
    return JPB(points=sd((1, num_points, 5), jnp.float32),
               valid=sd((1, num_points), jnp.bool_),
               gt_boxes=sd((1, 1, 7), jnp.float32),
               gt_labels=sd((1, 1), jnp.int32),
               gt_valid=sd((1, 1), jnp.bool_))


def test_full_width_fsd_parameter_shapes_match_jax():
    """configs/fsd/fsd_waymoD1_1x.py at full width: every leaf of JAX's
    init (traced by ``jax.eval_shape``: no compile, no allocation) has its
    torch target at the same shape, and every torch tensor is set."""
    cfg = load_config(FSD_CFG)
    jm = jbuild(jload(FSD_CFG), train=False)
    shapes = jax.eval_shape(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False),
        _shape_batch(4096))
    tm = build_model_from_cfg(cfg, train=False, device="cpu")
    n = check_flax_shapes(tm, {c: jax.tree_util.tree_map(
        lambda s: s, t) for c, t in shapes.items()})
    assert n == len(tm.state_dict())
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape))
        for s in jax.tree_util.tree_leaves(shapes["params"]))
    # the config's head in_channel (384) is not SIR's width (768)
    assert tm.rpn.head_mod.shared_mlp.Dense_0.in_features == 768


def test_full_width_fsd_build():
    """The port's builder on the FSD config: the module tree the chip
    phase runs (caps, 6-level UNet with 39 convs, SIR and RoI widths)."""
    m = build_model_from_cfg(load_config(FSD_CFG), train=False,
                             device="cpu")
    assert isinstance(m, FSD) and m.max_points == 196608
    seg = m.rpn.segmentor_mod
    assert seg.backbone == "sparse" and not seg.vfe_mod.use_sorted_reduce
    assert seg.unet_level_caps == (131072, 65536, 32768, 16384, 8192, 4096)
    assert sum(type(x).__name__ == "SparseConvLayer"
               for x in m.modules()) == 39
    assert m.rpn.caps.cluster_voxels_per_class == (8192,) * 3
    assert m.rpn.backbone_mod.cluster_channels == 768
    assert m.roi.max_inbox_point == 256 and m.rois_per_sample == 256
    assert m.roi.bbox_head_mod.conv_cls.Dense_0.in_features == 6 * 256


def test_config_loader_matches_jax():
    """``_base_`` inheritance and ``_delete_``: the port's loader gives the
    JAX loader's dict for the dense FSD config."""
    assert load_config(FSD_DENSE_CFG) == jload(FSD_DENSE_CFG)
    unet = load_config(FSD_DENSE_CFG)["model"]["single_stage"]["segmentor"][
        "unet"]
    assert "base_channels" not in unet and unet["out_channels"] == 128


def test_dense_fsd_config_predicts_at_shrunken_caps():
    """configs/fsd/fsd_waymoD1_1x_dense.py through the same builder on the
    CPU, its caps and range cut to a 16 m square (the 640² canvas is too
    large for a CPU test): one predict, finite boxes of the right shapes."""
    cfg = load_config(FSD_DENSE_CFG)
    ss = cfg["model"]["single_stage"]
    ss["point_cloud_range"] = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0)
    ss["caps"] = dict(fg_per_class=(256, 128, 128),
                      cluster_voxels_per_class=(256,) * 3,
                      clusters_per_class=(32,) * 3, pre_voxels=2048)
    ss["segmentor"]["max_voxels"] = 2048
    ss["score_thresh"] = (0.05, 0.05, 0.05)
    cfg["model"]["rois_per_sample"] = 32
    cfg["capacity"]["max_points"] = 2048
    m = tflag.init_weights(build_model_from_cfg(cfg, train=False,
                                                device="cpu"),
                           torch.Generator().manual_seed(0)).eval()
    assert m.rpn.segmentor_mod.backbone == "dense_bev"
    frame = tflag.synthetic_waymo_batch(1, 2048, num_extra_feats=2,
                                        pcr_half=7.8)
    batch = prepare_batch(m, frame.points[0], m.max_points)
    for skip in (True, False):
        out = frame_to_numpy(m.predict(batch, skip_rcnn=skip))
        rows = 500 if skip else 32
        assert out["boxes"].shape == (rows, 7)
        assert np.isfinite(out["boxes"]).all()
        assert out["valid"].sum() > 0


def test_builder_raises_on_types_not_ported():
    """Since PointPillars builds, the port registers the detector type of
    every config file; a type that no package registers raises, naming
    the types the port has."""
    import glob
    import os

    from sst_tpu_torch.utils.config import load_config
    from sst_tpu_torch.utils.registry import MODELS

    with pytest.raises(KeyError, match="NoSuchDetector.*PointPillars"):
        build_model_from_cfg({"model": {"type": "NoSuchDetector"}},
                             device="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    types = {load_config(p)["model"]["type"] for p in glob.glob(
        os.path.join(root, "configs", "*", "*.py")) if "_base_" not in p}
    assert "PointPillars" in types
    assert types <= set(MODELS._modules)


@pytest.mark.parametrize("kw, match", [
    (dict(assigner_per_class=("ccl", "ssg", "ccl")), "ssg.*item 7d"),
    (dict(dtype=torch.bfloat16), "float32"),
])
def test_fsd_options_outside_the_slice_raise(kw, match):
    from sst_tpu_torch.models.fsd.single_stage import SingleStageFSD

    cfg = tflag._tiny_fsd_cfg()
    cfg.update(kw)
    with pytest.raises(NotImplementedError, match=match):
        SingleStageFSD(**cfg)


def test_fsd_training_raises():
    """FSD trains since the training slice (``tests/test_torch_fsd_train.py``
    holds it against JAX), the FSDV2 two stage builds since CTRL's
    (``tests/test_torch_fsdv2_two_stage.py``) and group sampling is ported
    (``tests/test_torch_groups.py``); what of the family is not ported
    raises through the builder, naming its queue item: the key-point
    assigner (7d)."""
    cfg = {"model": {"type": "FSD", "single_stage": {
        "assigner_per_class": ("ccl", "ssg", "ccl")}}}
    with pytest.raises(NotImplementedError, match="queue 1 item 7d"):
        build_model_from_cfg(cfg, device="cpu")


def test_builders_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tflag.tiny_fsd()
    with pytest.raises(RuntimeError, match="cuda"):
        build_model_from_cfg(load_config(FSD_DENSE_CFG), train=False)
