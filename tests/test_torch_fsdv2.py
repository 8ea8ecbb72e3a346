"""Slice-level parity of the port's FSDv2 dense-BEV ``predict`` with the JAX
package on ``tiny_fsdv2_dense``: both flax variable trees are converted into
the torch model and both packages see the same synthetic frame.

Tolerances: segmentor outputs and pre-NMS head outputs at rtol/atol 1e-4
(XLA and torch accumulate the convolutions in different orders); ``valid``
exactly; boxes, scores and labels under ``valid`` at 1e-4. The discrete
steps (fg thresholds, per-class top-k cuts) could flip on a near-tie, so the
test first asserts that every such margin is at least 10x the measured
seg-score difference between the two packages.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.ops import sorted_reduce as sr
from test_torch_fsd import seeded_variables
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
SORTED_SEGMENTOR = dict(voxel_size=(0.05, 0.05, 0.05), max_voxels=4096,
                        vfe=dict(feat_channels=(16, 16), mode="max",
                                 use_sorted_reduce=True))


def _numpy_vars(variables, seed=0):
    """Flax variables as numpy, with random running statistics."""
    rng = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    out = {k: dict(v) for k, v in out.items()}

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "mean":
                tree[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    perturb(out["batch_stats"])
    return out


def _run_both(segmentor_overrides=None):
    jm = jflag.tiny_fsdv2_dense()
    if segmentor_overrides:
        jm = jm.clone(segmentor={**jm.segmentor, **segmentor_overrides})
    batch = tflag.synthetic_waymo_batch(1, 2048, pcr_half=3.8)
    jb = jflag.synthetic_waymo_batch(1, 2048, pcr_half=3.8)
    # the init, the pipeline and predict traced in turn (the last two on
    # the init's shapes) and compiled together in threads
    init = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b)).lower(jb)
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b), jb)
    pipe = jax.jit(lambda v, b: jm.apply(v, b, False, method=jm.run_pipeline)
                   ).lower(shapes, jb)
    pred = jax.jit(lambda v, b: jm.apply(v, b, method=jm.predict)).lower(
        shapes, jb)
    with ThreadPoolExecutor(3) as pool:
        init, pipe, pred = pool.map(lambda low: low.compile(),
                                    (init, pipe, pred))
    v = _numpy_vars(init(jb))
    jpipe, jpred = pipe(v, jb), pred(v, jb)

    tm = tflag.tiny_fsdv2_dense(segmentor_overrides=segmentor_overrides,
                                device="cpu")
    load_flax_variables(tm, v).eval()
    sr.launches = 0
    with torch.inference_mode():
        tpipe = tm.run_pipeline(batch.to("cpu"))
        tpred = tm.predict(batch.to("cpu"))
    assert sr.launches == 0  # CPU tensors never launch the kernel
    return jm, tm, jpipe, jpred, tpipe, tpred


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_margins(jm, jpipe, tpipe):
    """Every fg threshold and per-class top-k cut is >= 10x away from the
    seg-score difference between the packages."""
    seg_j, seg_t = jpipe["seg_out"], tpipe["seg_out"]
    valid = _np(seg_j["valid"])
    s_j = 1 / (1 + np.exp(-_np(seg_j["seg_logits"]).astype(np.float64)))
    s_t = 1 / (1 + np.exp(-_np(seg_t["seg_logits"]).astype(np.float64)))
    diff = np.abs(s_j - s_t)[valid].max()
    for c, thr in enumerate(jm.score_thresh):
        s = s_j[valid, c]
        assert np.abs(s - thr).min() >= 10 * diff, (c, "threshold")
        fg = np.sort(s[s > thr])[::-1]
        cap = jm.caps.fg_per_class[c]
        if len(fg) > cap:
            assert fg[cap - 1] - fg[cap] >= 10 * diff, (c, "top-k cut")


def _assert_slice_parity(jpipe, jpred, tpipe, tpred):
    for k in ("seg_logits", "seg_vote_preds", "seg_feats"):
        np.testing.assert_allclose(_np(tpipe["seg_out"][k]),
                                   _np(jpipe["seg_out"][k]), **TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(_np(tpipe["seg_out"]["valid"]),
                                  _np(jpipe["seg_out"]["valid"]))
    np.testing.assert_array_equal(_np(tpipe["ex"]["virtual_valid"]),
                                  _np(jpipe["ex"]["virtual_valid"]))
    assert int(tpipe["ex"]["num_virtual"]) == int(jpipe["ex"]["num_virtual"])
    for k in ("cls_logits", "reg_preds"):
        for got, ref in zip(tpipe["outs"][k], jpipe["outs"][k]):
            np.testing.assert_allclose(_np(got), _np(ref), **TOL, err_msg=k)
    valid = _np(jpred["valid"])
    np.testing.assert_array_equal(_np(tpred["valid"]), valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(_np(tpred["labels"])[valid],
                                  _np(jpred["labels"])[valid])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(_np(tpred[k])[valid], _np(jpred[k])[valid],
                                   **TOL, err_msg=k)


def test_predict_parity_tiny_fsdv2_dense():
    jm, tm, jpipe, jpred, tpipe, tpred = _run_both()
    assert tm.segmentor_mod.vfe_mod.sorted_calls == 0  # 16x16 grid: canvas
    _assert_margins(jm, jpipe, tpipe)
    _assert_slice_parity(jpipe, jpred, tpipe, tpred)


def test_predict_parity_sorted_reduce_path(monkeypatch):
    """Segmentor key space 120x160x160 > 2**21: both packages sort and take
    the sorted segment reduce (JAX: its Pallas kernel in interpret mode;
    port: the kernel's plain twin, since the tensors are on the CPU)."""
    monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    jm, tm, jpipe, jpred, tpipe, tpred = _run_both(SORTED_SEGMENTOR)
    assert tm.segmentor_mod.vfe_mod.sorted_calls == 2  # pipeline + predict
    assert tm.vfe_mod.sorted_calls == 0  # virtual grid: canvas unique
    _assert_margins(jm, jpipe, tpipe)
    _assert_slice_parity(jpipe, jpred, tpipe, tpred)


@pytest.mark.parametrize("kw", [
    dict(batch_size=1, num_points=4096, seed=0),
    dict(batch_size=2, num_points=1000, seed=3, num_extra_feats=2,
         pcr_half=79.8),
])
def test_synthetic_waymo_batch_bit_identical(kw):
    t = tflag.synthetic_waymo_batch(**kw)
    j = jflag.synthetic_waymo_batch(**kw)
    for name in ("points", "valid", "gt_boxes", "gt_labels", "gt_valid"):
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def tiny_vars():
    """Seeded variables of the shapes tiny_fsdv2_dense's init makes (traced
    by ``jax.eval_shape``, never compiled)."""
    jm = jflag.tiny_fsdv2_dense()
    jb = jflag.synthetic_waymo_batch(1, 256, pcr_half=3.8)
    return seeded_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jb)))


def test_converter_loads_every_leaf(tiny_vars):
    tm = load_flax_variables(tflag.tiny_fsdv2_dense(device="cpu"),
                             tiny_vars)
    k = tiny_vars["params"]["segmentor_mod"]["unet_mod"]["enc_0_0"]["Conv_0"][
        "kernel"]
    w = tm.segmentor_mod.unet_mod.enc_0_0.Conv_0.weight.detach().numpy()
    np.testing.assert_array_equal(w, k.transpose(3, 2, 0, 1))  # HWIO→OIHW
    d = tiny_vars["params"]["virtual_proj"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(tm.virtual_proj.Dense_0.weight.detach(),
                                  d.T)  # [in, out] → [out, in]
    rv = tiny_vars["batch_stats"]["segmentor_mod"]["head_mod"]["pre_seg"][
        "MaskedBatchNorm_1"]["var"]
    np.testing.assert_array_equal(
        tm.segmentor_mod.head_mod.pre_seg.MaskedBatchNorm_1.running_var, rv)


def _edit(tree, path, value=None, drop=False):
    tree = {k: dict(v) for k, v in tree.items()}
    node = tree
    for key in path[:-1]:
        node[key] = dict(node[key])
        node = node[key]
    if drop:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return tree


@pytest.mark.parametrize("case", ["extra_leaf", "missing_leaf", "bad_shape",
                                  "unknown_collection"])
def test_converter_is_strict(tiny_vars, case):
    ln = ("params", "ori_proj", "LayerNorm_0")
    if case == "extra_leaf":
        bad = _edit(tiny_vars, ln + ("offset",), np.zeros(64, np.float32))
        err = KeyError
    elif case == "missing_leaf":
        bad = _edit(tiny_vars, ln + ("scale",), drop=True)
        err = KeyError
    elif case == "bad_shape":
        bad = _edit(tiny_vars, ln + ("scale",), np.ones(63, np.float32))
        err = ValueError
    else:
        bad = dict(tiny_vars, cache={})
        err = ValueError
    with pytest.raises(err):
        load_flax_variables(tflag.tiny_fsdv2_dense(device="cpu"), bad)


def test_flagship_builder_uses_the_kernel_on_the_segmentor_only():
    m = tflag.fsdv2_waymo_dense(device="cpu")
    assert m.segmentor_mod.vfe_mod.use_sorted_reduce
    assert not m.vfe_mod.use_sorted_reduce
    assert m.segmentor_mod.grid == (30, 640, 640)
    assert 30 * 640 * 640 > 2**21  # so its voxel unique sorts
    assert m.vgrid == (12, 320, 320)


@pytest.mark.parametrize("kw", [
    dict(dtype=torch.float16),
])
def test_flagship_options_outside_the_slice_raise(kw):
    with pytest.raises(NotImplementedError):
        tflag.fsdv2_waymo_dense(device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(mixer_type="sparse"), dict(segmentor=dict(backbone="sst")),
    dict(centroid_alpha=0.5),
    dict(segmentor=dict(backbone="sparse")),
    dict(dtype=torch.float16),
    dict(mixer_type="sparse", segmentor=dict(backbone="sparse"),
         dtype=torch.bfloat16),
])
def test_model_options_outside_the_slice_raise(kw):
    cfg = dict(mixer_type="dense_bev",
               segmentor=dict(backbone="dense_bev"))
    cfg.update(kw)
    with pytest.raises(NotImplementedError):
        tflag.SingleStageFSDV2(**cfg)
