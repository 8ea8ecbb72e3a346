"""Slice-level parity of the port's sparse-UNet FSDv2 ``predict`` with the
JAX package on ``tiny_fsdv2_flagship``: the flax variables are converted
into the torch model and both packages see the same synthetic frame. The JAX
side runs its default CPU path, the neighbour-table ``gather_gemm``, which
is its plain reference; the port's CPU tensors take the sparse conv
kernel's plain twin.

Tolerances: segmentor outputs and pre-NMS head outputs at rtol/atol 1e-4
(the two packages sum the convs' products in different orders); ``valid``
exactly; boxes, scores and labels under ``valid`` at 1e-4. The discrete
steps (fg thresholds, per-class top-k cuts) could flip on a near-tie, so the
test first asserts that every such margin is at least 10x the measured
seg-score difference between the two packages.
"""

import jax
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.ops import sorted_reduce as sr
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from test_torch_fsdv2 import (
    _assert_margins,
    _assert_slice_parity,
    _edit,
    _numpy_vars,
)
from torch_threads import torch_threads_per_worker  # noqa: F401


def _pipeline_and_predict(m, b):
    """run_pipeline and the boxes from its outputs, in one trace (what
    ``predict`` does), so the frame is compiled once."""
    pipe = m.run_pipeline(b, train=False, detach_seg=False)
    ex = pipe["ex"]
    pred = m.head_mod.get_bboxes(pipe["outs"], ex["virtual_centers"],
                                 ex["virtual_batch"], ex["virtual_valid"],
                                 pipe["batch_size"], **m.test_cfg)
    seg = {k: pipe["seg_out"][k] for k in ("seg_logits", "seg_vote_preds",
                                           "seg_feats", "valid")}
    return {"seg_out": seg, "ex": ex, "outs": pipe["outs"]}, pred


@pytest.fixture(scope="module")
def both(monkeypatch_module):
    monkeypatch_module.delenv("SST_TPU_PALLAS_INTERPRET", raising=False)
    jm = jflag.tiny_fsdv2_flagship()
    jb = jflag.synthetic_waymo_batch(1, 2048, pcr_half=3.8)
    v = _numpy_vars(jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b))(jb))
    jpipe, jpred = jax.jit(lambda v, b: jm.apply(
        v, b, method=_pipeline_and_predict))(v, jb)

    tm = load_flax_variables(tflag.tiny_fsdv2_flagship(device="cpu"),
                             v).eval()
    batch = tflag.synthetic_waymo_batch(1, 2048, pcr_half=3.8).to("cpu")
    scg.reset_launch_counts()
    sr.reset_launch_counts()
    with torch.inference_mode():
        tpipe = tm.run_pipeline(batch)
        tpred = tm.predict(batch)
    # CPU tensors never launch a kernel
    assert scg.launches == 0 and sr.launches == 0
    return dict(jm=jm, tm=tm, v=v, jpipe=jpipe, jpred=jpred, tpipe=tpipe,
                tpred=tpred)


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_predict_parity_tiny_fsdv2_flagship(both):
    _assert_margins(both["jm"], both["jpipe"], both["tpipe"])
    _assert_slice_parity(both["jpipe"], both["jpred"], both["tpipe"],
                         both["tpred"])


def test_sparse_path_ran_its_convs(both):
    """The torch pipeline took the sparse segmentor and the sparse mixer,
    and the union grid fused the decoder features."""
    tm, tpipe = both["tm"], both["tpipe"]
    assert tm.segmentor_mod.backbone == "sparse"
    assert tm.mixer_type == "sparse"
    plan = tpipe["data"]["unet_plan"]
    assert [lvl.cap for lvl in plan.levels] == [256, 128, 64]
    assert len(tpipe["data"]["decoder_features"]) == 3
    np.testing.assert_array_equal(
        tpipe["ex"]["virtual_valid"].numpy(),
        np.asarray(both["jpipe"]["ex"]["virtual_valid"]))
    np.testing.assert_allclose(
        tpipe["ex"]["virtual_feats"].numpy(),
        np.asarray(both["jpipe"]["ex"]["virtual_feats"]), rtol=1e-4,
        atol=1e-4)


def test_converter_loads_every_leaf_of_the_sparse_model(both):
    v, tm = both["v"], both["tm"]
    k = v["params"]["segmentor_mod"]["unet_mod"]["conv_input"]["kernel"]
    assert k.ndim == 3  # [K, Cin, Cout], copied as it is
    np.testing.assert_array_equal(
        tm.segmentor_mod.unet_mod.conv_input.weight.detach().numpy(), k)
    k = v["params"]["mixer_mod"]["unet"]["lateral_2"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        tm.mixer_mod.unet.lateral_2.conv1.weight.detach().numpy(), k)
    rv = v["batch_stats"]["mixer_mod"]["conv_out"]["MaskedBatchNorm_0"]["var"]
    np.testing.assert_array_equal(
        tm.mixer_mod.conv_out.MaskedBatchNorm_0.running_var.numpy(), rv)


@pytest.mark.parametrize("case", ["missing_leaf", "bad_shape", "bad_rank"])
def test_converter_stays_strict_on_the_sparse_model(both, case):
    path = ("params", "segmentor_mod", "unet_mod", "merge_1", "kernel")
    k = both["v"]["params"]["segmentor_mod"]["unet_mod"]["merge_1"]["kernel"]
    if case == "missing_leaf":
        bad, err = _edit(both["v"], path, drop=True), KeyError
    elif case == "bad_shape":
        bad, err = _edit(both["v"], path, k[:, :-1]), ValueError
    else:
        bad, err = _edit(both["v"], path, k[None, None]), ValueError
    with pytest.raises(err):
        load_flax_variables(tflag.tiny_fsdv2_flagship(device="cpu"), bad)


def test_flagship_sparse_builder():
    m = tflag.fsdv2_waymo(backbone="sparse", device="cpu")
    seg = m.segmentor_mod
    assert seg.backbone == "sparse" and m.mixer_type == "sparse"
    assert seg.vfe_mod.use_sorted_reduce  # the segmentor grid sorts
    assert not m.vfe_mod.use_sorted_reduce
    assert seg.grid == (30, 640, 640) and 30 * 640 * 640 > 2**21
    assert seg.unet_level_caps == (131072, 204800, 98304, 32768, 8192, 2048)
    assert m.caps.union_voxels == 98304
    assert m.mixer_strides == ((2, 2, 2), (2, 2, 2))
    n_sparse = sum(type(mod).__name__ == "SparseConvLayer"
                   for mod in m.modules())
    assert n_sparse == 58  # 39 in the segmentor UNet, 19 in the mixer
    merge = seg.unet_mod.merge_6.weight
    assert tuple(merge.shape) == (27, 512, 256)
    dense = tflag.fsdv2_waymo(device="cpu")
    assert isinstance(dense, type(m))
    assert dense.segmentor_mod.backbone == "dense_bev"


def test_init_weights_scales_sparse_convs():
    m = tflag.init_weights(tflag.fsdv2_waymo(backbone="sparse", device="cpu"),
                           torch.Generator().manual_seed(0))
    w = m.segmentor_mod.unet_mod.merge_6.weight.detach()
    # normal with variance 1 / (K * Cin) = 1 / (27 * 512)
    assert abs(float(w.std()) * np.sqrt(27 * 512) - 1.0) < 0.01
    assert abs(float(w.mean())) < 1e-3


@pytest.mark.parametrize("kw", [
    dict(mixer_type="sparse", segmentor=dict(backbone="dense_bev")),
    dict(mixer_type="dense_bev", segmentor=dict(backbone="sparse")),
    dict(segmentor=dict(backbone="sst")),
])
def test_unsupported_pairings_raise(kw):
    with pytest.raises(NotImplementedError):
        tflag.SingleStageFSDV2(**kw)
