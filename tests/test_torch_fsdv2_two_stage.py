"""Parity of the port's ``FSDV2`` two stage (``SingleStageFSDV2`` with
``as_rpn`` as the RPN, ``GroupCorrectionHead`` over the recovered per-point
features) with the JAX package, on the CPU: predict (refined and
``skip_rcnn``), the losses and their gradients.

The JAX test's ``tiny_fsdv2_two_stage`` (tests/test_fsdv2.py) and the
port's build of the same dict through ``utils/builders.py``
``build_model_from_cfg`` (``type="FSDV2"``, the single stage's caps a
dict) get the same seeded variables (seed 1) of the port model's shapes in
flax's layout (``test_torch_ctrl.seeded_port_variables``; no flax init is
traced). Both see the JAX test's ``fsd_batch(RandomState(3))``: two
samples of 1,024 points (x, y, z + 2 channels) around six gt boxes each.
One jitted JAX reference returns the pipeline, the single stage's boxes,
the proposals and the refined boxes, one the train-mode losses with the
updated running statistics and the gradient of the summed losses. The JAX side runs its default CPU path (the
sparse convs' ``gather_gemm``, the scatter VFEs; ``SST_TPU_PALLAS_INTERPRET``
unset), the port's CPU tensors the kernels' plain twins.

Tolerances: float outputs at rtol/atol 1e-4, valid masks and labels
exactly; losses rtol 1e-5; each gradient leaf within 1e-4 of that leaf's
largest magnitude; running statistics rtol/atol 1e-5. Before comparing, the
test asserts that every fg threshold, per-class top-k cut and per-sample
proposal cut lies at least 10x the packages' score difference away and no
proposal's best IoU lies within 1e-3 of its positive threshold, so no
decision is pinned. With the variables of seed 0 that check refuses the
frame (class 1's 128th and 129th fg scores lie 4.7e-7 apart). Near-ties
reach the gradients too: with the variables of ``jax.eval_shape`` of the
flax init seeded as in tests/test_torch_fsd.py, JAX's own jitted and
eager gradients differ by 13% of a mixer batch norm's largest bias
gradient on this frame, and the port's lies where the eager one does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu_torch.convert import check_flax_shapes, load_flax_variables
from sst_tpu_torch.models import PointBatch
from sst_tpu_torch.models.fsd.fsdv2 import FSDV2
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from sst_tpu_torch.utils.builders import build_model_from_cfg
from sst_tpu_torch.utils.config import load_config
from test_fsdv2 import tiny_fsdv2_two_stage
from test_torch_ctrl import run_jitted, seeded_port_variables
from test_torch_fsdv2_train import _leaves, _torch_leaf

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest magnitude
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
_NMS_KEYS = ("nms_thr", "score_thr", "max_num", "use_rotate_nms")
FSDV2_CFG = "configs/fsdv2/fsdv2_waymo_1x.py"


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _is_loss(k):
    return k.startswith("loss")


def _sigmoid64(x):
    return 1 / (1 + np.exp(-np.asarray(x, np.float64)))


def _predict_all(m, b):
    """One pipeline, then the single stage's boxes and the refined ones
    from it (what ``predict(skip_rcnn=...)`` computes)."""
    pipe = m.rpn.run_pipeline(b, train=False, detach_seg=False)
    ex = pipe["ex"]
    rpn = m.rpn.head_mod.get_bboxes(
        pipe["outs"], ex["virtual_centers"], ex["virtual_batch"],
        ex["virtual_valid"], pipe["batch_size"], **m.rpn.test_cfg)
    props = m._proposals(pipe)
    pts, feats, pvalid, pbatch = m._roi_points(pipe)
    pred = m.roi.predict(pts, feats, pvalid, pbatch, *props,
                         pipe["batch_size"],
                         **{k: v for k, v in m.rpn.test_cfg.items()
                            if k in _NMS_KEYS})
    keep = ("virtual_valid", "virtual_batch", "pts_xyz", "pts_feats",
            "pts_valid", "pts_batch")
    return {"seg_logits": pipe["data"]["seg_logits"],
            "valid": pipe["data"]["valid"],
            "ex": {k: ex[k] for k in keep}, "outs": pipe["outs"],
            "props": props, "rpn": rpn, "pred": pred}


def _loss_with_aux(m, b):
    """The body of ``FSDV2.loss`` with what the margin checks read."""
    pipe = m.rpn.run_pipeline(b, True)
    losses = m.rpn.losses_from_pipeline(b, pipe)
    rois, rscores, rlabels, rvalid, rbatch = m._proposals(pipe)
    rois = jax.lax.stop_gradient(rois)
    pts, feats, pvalid, pbatch = m._roi_points(pipe)
    losses.update(m.roi.loss(pts, feats, pvalid, pbatch, rois, rlabels,
                             rvalid, rbatch, b.gt_boxes, b.gt_labels,
                             b.gt_valid, True))
    max_iou, _, _ = m.roi.assign_and_sample(
        rois, rlabels, rvalid, rbatch, b.gt_boxes, b.gt_labels, b.gt_valid)
    aux = {"seg_logits": pipe["data"]["seg_logits"],
           "valid": pipe["data"]["valid"], "cls_logits":
           pipe["outs"]["cls_logits"], "virtual_valid":
           pipe["ex"]["virtual_valid"], "virtual_batch":
           pipe["ex"]["virtual_batch"], "rscores": rscores,
           "rlabels": rlabels, "rvalid": rvalid, "max_iou": max_iou}
    return losses, aux


def _port_cfg(jm) -> dict:
    """JAX's module fields as the config dict the port's builder takes."""
    ss = dict(jm.single_stage)
    caps = ss["caps"]
    ss["caps"] = dict(fg_per_class=caps.fg_per_class, voxels=caps.voxels,
                      union_voxels=caps.union_voxels,
                      virtual_out=caps.virtual_out)
    return {"model": dict(type="FSDV2", single_stage=ss,
                          roi_head=dict(jm.roi_head),
                          rois_per_sample=jm.rois_per_sample)}


def _record(tm):
    """Wrap the port model's ``rpn.run_pipeline`` and ``_proposals``
    (instance attributes) to keep what they return."""
    rec = {}
    run, props = tm.rpn.run_pipeline, tm._proposals

    def run_rec(*a, **k):
        rec["pipe"] = run(*a, **k)
        return rec["pipe"]

    def props_rec(*a, **k):
        rec["props"] = props(*a, **k)
        return rec["props"]

    tm.rpn.run_pipeline, tm._proposals = run_rec, props_rec
    return rec


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def both(monkeypatch_module):
    monkeypatch_module.delenv("SST_TPU_PALLAS_INTERPRET", raising=False)
    jm = tiny_fsdv2_two_stage()
    jb = jflag.fsd_batch(np.random.RandomState(3))
    tm = build_model_from_cfg(_port_cfg(jm), train=False, device="cpu")
    v = seeded_port_variables(tm, seed=1)

    def predict(params, stats, b):
        return jm.apply({"params": params, "batch_stats": stats}, b,
                        method=_predict_all)

    def train(params, stats, b):
        def loss_fn(p):
            (losses, aux), mut = jm.apply(
                {"params": p, "batch_stats": stats}, b,
                method=_loss_with_aux, mutable=["batch_stats"])
            return (sum(x for k, x in losses.items() if _is_loss(k)),
                    (losses, aux, mut["batch_stats"]))

        (_, (losses, aux, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return dict(losses=losses, aux=aux, stats=new_stats, grads=grads)

    pred, ref = run_jitted((predict, train), v["params"], v["batch_stats"],
                           jb)
    ref["pred"] = pred

    batch = PointBatch(**{k: np.asarray(getattr(jb, k)) for k in (
        "points", "valid", "gt_boxes", "gt_labels", "gt_valid")}).to("cpu")
    scg.reset_launch_counts()
    tm = load_flax_variables(tm, v).eval()
    with torch.inference_mode():
        tout = _predict_all(tm, batch)
        preds = {"rpn": tm.predict(batch, skip_rcnn=True),
                 "pred": tm.predict(batch)}
    tm.train()
    rec = _record(tm)
    losses = tm.loss(batch, train=True)
    sum(x for k, x in losses.items() if _is_loss(k)).backward()
    assert scg.launches == 0  # CPU tensors never launch a kernel
    return dict(jm=jm, v=v, ref=ref, tout=tout, preds=preds, tm=tm,
                losses=losses, rec=rec)


def _assert_score_margins(jm, seg_logits_j, seg_logits_t, valid):
    """Every fg threshold and per-class top-k cut >= 10x the packages'
    seg-score difference away."""
    ss = jm.single_stage
    s_j = _sigmoid64(seg_logits_j)
    diff = np.abs(s_j - _sigmoid64(seg_logits_t))[valid].max()
    assert diff < 1e-5
    for c, thr in enumerate(ss["score_thresh"]):
        s = s_j[valid, c]
        assert np.abs(s - thr).min() >= 10 * diff, (c, "threshold")
        fg = np.sort(s[s > thr])[::-1]
        cap = ss["caps"].fg_per_class[c]
        if len(fg) > cap:
            assert fg[cap - 1] - fg[cap] >= 10 * diff, (c, "top-k cut")


def _assert_proposal_margins(jm, cls_logits, vvalid, vbatch, rscores_j,
                             rscores_t):
    pdiff = np.abs(rscores_j - rscores_t).max()
    scores = np.concatenate([_sigmoid64(lg).max(-1) for lg in cls_logits])
    ok = np.tile(vvalid, len(cls_logits))
    batch = np.tile(vbatch, len(cls_logits))
    k = jm.rois_per_sample
    for i in range(2):
        s = np.sort(scores[ok & (batch == i)])[::-1]
        if len(s) > k:
            assert s[k - 1] - s[k] >= 10 * pdiff, (i, "proposal cut")


def test_two_stage_pipeline_and_proposals_equal_jax(both):
    ref, got = both["ref"]["pred"], both["tout"]
    valid = ref["valid"]
    np.testing.assert_array_equal(_np(got["valid"]), valid)
    _assert_score_margins(both["jm"], ref["seg_logits"], got["seg_logits"],
                          valid)
    _assert_proposal_margins(both["jm"], ref["outs"]["cls_logits"],
                             ref["ex"]["virtual_valid"],
                             ref["ex"]["virtual_batch"], ref["props"][1],
                             _np(got["props"][1]))
    for k in ("virtual_valid", "virtual_batch", "pts_valid", "pts_batch"):
        np.testing.assert_array_equal(_np(got["ex"][k]), ref["ex"][k],
                                      err_msg=k)
    assert ref["ex"]["pts_valid"].sum() > 0
    for k in ("pts_xyz", "pts_feats"):
        np.testing.assert_allclose(_np(got["ex"][k]), ref["ex"][k], **TOL,
                                   err_msg=k)
    for got_p, ref_p in zip(got["props"], ref["props"]):
        if ref_p.dtype.kind == "f":
            np.testing.assert_allclose(_np(got_p), ref_p, **TOL)
        else:
            np.testing.assert_array_equal(_np(got_p), ref_p)
    assert ref["props"][3].sum() > 0  # valid proposals


@pytest.mark.parametrize("which", ["rpn", "pred"])
def test_two_stage_predict_matches_jax(both, which):
    """``predict(skip_rcnn=True)`` ("rpn") and ``predict()`` ("pred")
    against JAX: keep masks and labels exactly, boxes and scores at 1e-4;
    ``predict`` gives the numbers of the pipeline above."""
    ref, got = both["ref"]["pred"][which], both["preds"][which]
    for k in got:
        np.testing.assert_array_equal(_np(got[k]),
                                      _np(both["tout"][which][k]), err_msg=k)
    valid = ref["valid"]
    assert valid.any(axis=1).all()
    assert got["boxes"].shape == ref["boxes"].shape
    np.testing.assert_array_equal(_np(got["valid"]), valid)
    np.testing.assert_array_equal(_np(got["labels"])[valid],
                                  ref["labels"][valid])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(_np(got[k])[valid], ref[k][valid], **TOL,
                                   err_msg=k)


def test_two_stage_losses_match_jax(both):
    ref, aux = both["ref"]["losses"], both["ref"]["aux"]
    rec = both["rec"]
    valid = aux["valid"]
    _assert_score_margins(both["jm"], aux["seg_logits"],
                          _np(rec["pipe"]["data"]["seg_logits"]), valid)
    _assert_proposal_margins(both["jm"], aux["cls_logits"],
                             aux["virtual_valid"], aux["virtual_batch"],
                             aux["rscores"], _np(rec["props"][1]))
    thr = np.asarray(both["jm"].roi_head.get("pos_iou_thr",
                                             (0.45, 0.35, 0.35)))
    gap = np.abs(aux["max_iou"] - thr[np.minimum(aux["rlabels"], 2)])
    assert gap[aux["rvalid"]].min() >= 1e-3
    got = {k: float(x.detach()) for k, x in both["losses"].items()}
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=LOSS_RTOL,
                                   atol=0, err_msg=k)
    assert float(ref["loss_rcnn_cls"]) > 0 and ref["num_virtual"] > 0


def test_two_stage_gradients_match_jax(both):
    """Every parameter leaf's gradient within GRAD_TOL of its largest
    magnitude (a leaf no loss reaches, zero in JAX, has none in torch);
    the running statistics after the step."""
    tm, n = both["tm"], 0
    for path, ref in _leaves(both["ref"]["grads"]):
        *mods, leaf = path
        t = tm.get_submodule(".".join(mods))
        param = t.bias if leaf == "bias" else t.weight
        got = (np.zeros_like(ref) if param.grad is None
               else _torch_leaf(tm, path, grad=True))
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max(),
                                   err_msg="/".join(path))
        n += 1
    assert n == sum(1 for _ in tm.parameters())
    # the RoI head and the recovery are trained through the RoI losses
    assert tm.rpn.recover_proj.Dense_0.weight.grad.abs().sum() > 0
    m = 0
    for path, ref in _leaves(both["ref"]["stats"]):
        np.testing.assert_allclose(_torch_leaf(tm, path, grad=False), ref,
                                   **STATS_TOL, err_msg="/".join(path))
        m += 1
    assert m == sum(1 for k in tm.state_dict() if "running_" in k) > 0


def test_full_width_fsdv2_two_stage_parameter_shapes_match_jax():
    """``dict(type="FSDV2", single_stage=<configs/fsdv2/fsdv2_waymo_1x.py's
    model without its type>)`` through both packages' builders: every leaf
    of JAX's init (``jax.eval_shape``: no compile, no allocation) has its
    torch target at the same shape (the single stage's ``recover_proj``,
    the RoI head over 3 + 128 point channels), every torch tensor is set."""
    from sst_tpu.models.detectors.dynamic_voxelnet import PointBatch as JPB
    from sst_tpu.utils.builders import build_model_from_cfg as jbuild
    from sst_tpu.utils.config import load_config as jload

    ss = dict(jload(FSDV2_CFG)["model"])
    ss.pop("type")
    jm = jbuild({"model": dict(type="FSDV2", single_stage=ss)}, train=False)
    sd = jax.ShapeDtypeStruct
    batch = JPB(points=sd((1, 16384, 5), jnp.float32),
                valid=sd((1, 16384), jnp.bool_),
                gt_boxes=sd((1, 1, 7), jnp.float32),
                gt_labels=sd((1, 1), jnp.int32),
                gt_valid=sd((1, 1), jnp.bool_))
    shapes = jax.eval_shape(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False), batch)
    tss = dict(load_config(FSDV2_CFG)["model"])
    tss.pop("type")
    tm = build_model_from_cfg({"model": dict(type="FSDV2", single_stage=tss)},
                              train=False, device="cpu")
    assert isinstance(tm, FSDV2) and tm.rpn.as_rpn
    assert tm.rois_per_sample == 128 and tm.rpn.caps.voxels == 81920
    assert check_flax_shapes(tm, shapes) == len(tm.state_dict())
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape))
        for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert tm.roi.bbox_head_mod.block_0.vfe_0.Dense_0.in_features == \
        3 + 128 + 13
