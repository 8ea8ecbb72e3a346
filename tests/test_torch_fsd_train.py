"""Parity of the port's FSD training losses (``SingleStageFSD.loss`` and the
two-stage ``FSD.loss``, both ``pretrain`` modes) with the JAX package, on
the CPU.

``tiny_fsd_two_stage`` gets seeded variables of the shapes its flax init
makes (``jax.eval_shape``, never compiled), ``tiny_fsd`` the ``rpn``
subtree of the same tree; both packages see ``fsd_batch(p=512)`` (two
samples of 512 points, six gt boxes each). One jitted JAX function takes
the two-stage loss at ``pretrain=False`` once, with two pullbacks (the sum
of every loss, and the sum of the single stage's losses alone, which is
``tiny_fsd``'s gradient on the ``rpn`` leaves), and the loss at
``pretrain=True`` (the single stage's in both detectors) with its gradient,
each with its updated running statistics. The JAX side runs its default CPU
path (``gather_gemm`` and the scatters), the port's CPU tensors its kernels'
plain twins.

Tolerances: losses rtol 1e-5; each gradient leaf within 1e-4 of that
leaf's largest magnitude; running statistics rtol/atol 1e-5. The discrete
steps (fg thresholds, per-class top-k cuts, the proposal cut and the RoI
head's positive threshold) could flip on a near-tie, so the test first
asserts that each lies at least 10x the packages' score difference away:
no decision is pinned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import PointBatch
from test_torch_fsd import seeded_variables
from test_torch_fsdv2_train import _leaves, _torch_leaf
from torch_threads import torch_threads_per_worker  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest magnitude


def _is_loss(k):
    return k.startswith("loss")


def _rpn_loss(k):
    return _is_loss(k) and not k.startswith("loss_rcnn")


def _jax_fsd_loss(m, b):
    """The body of JAX's ``FSD.loss(pretrain=False)``, with the pipeline's
    values the margin checks read."""
    pipe = m.rpn.run_pipeline(b, True, 0.0)
    losses = m.rpn.losses_from_pipeline(b, pipe)
    rois, rscores, rlabels, rvalid, rbatch = m._proposals(pipe)
    rois = jax.lax.stop_gradient(rois)
    pts, feats, pvalid, pbatch = m._roi_points(pipe)
    losses.update(m.roi.loss(pts, feats, pvalid, pbatch, rois, rlabels,
                             rvalid, rbatch, b.gt_boxes, b.gt_labels,
                             b.gt_valid, True))
    max_iou, _, _ = m.roi.assign_and_sample(
        rois, rlabels, rvalid, rbatch, b.gt_boxes, b.gt_labels, b.gt_valid)
    outs, ex = pipe["outs"], pipe["ex"]
    aux = {"seg_logits": pipe["data"]["seg_logits"],
           "valid": pipe["data"]["valid"],
           "cls_logits": outs["cls_logits"],
           "cluster_valid": ex["cluster_valid"],
           "cluster_batch": ex["cluster_batch"],
           "rscores": rscores, "rlabels": rlabels, "rvalid": rvalid,
           "max_iou": max_iou}
    return losses, aux


def _record_pipeline(tm):
    """Wrap the port model's ``run_pipeline`` and ``_proposals`` (instance
    attributes) to keep what they return; launches nothing."""
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


def _sigmoid64(x):
    return 1 / (1 + np.exp(-np.asarray(x, np.float64)))


@pytest.fixture(scope="module")
def slice_run():
    jm = jflag.tiny_fsd_two_stage()
    jb = jflag.fsd_batch(np.random.RandomState(1), p=512)
    v = seeded_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jb)))

    def apply(params, stats, b, **kw):
        return jm.apply({"params": params, "batch_stats": stats}, b,
                        mutable=["batch_stats"], **kw)

    def reference(params, stats, b):
        def full(p):
            (losses, aux), mut = apply(p, stats, b, method=_jax_fsd_loss)
            return losses, (aux, mut["batch_stats"])

        losses, pull, (aux, new_stats) = jax.vjp(full, params, has_aux=True)

        def cotangent(pick):
            return {k: jnp.asarray(float(pick(k)), x.dtype)
                    for k, x in losses.items()}

        g_all, = pull(cotangent(_is_loss))
        g_rpn, = pull(cotangent(_rpn_loss))

        def pre(p):
            out, mut = apply(p, stats, b, method=jm.loss, train=True,
                             pretrain=True)
            return (sum(x for k, x in out.items() if _is_loss(k)),
                    (out, mut["batch_stats"]))

        (_, (pre_losses, pre_stats)), g_pre = jax.value_and_grad(
            pre, has_aux=True)(params)
        return dict(losses=losses, aux=aux, stats=new_stats, g_all=g_all,
                    g_rpn=g_rpn, pre_losses=pre_losses, pre_stats=pre_stats,
                    g_pre=g_pre)

    ref = jax.tree_util.tree_map(np.asarray, jax.jit(reference)(
        v["params"], v["batch_stats"], jb))

    batch = PointBatch(**{k: np.asarray(getattr(jb, k)) for k in (
        "points", "valid", "gt_boxes", "gt_labels", "gt_valid")}).to("cpu")
    rpn_v = {c: t["rpn"] for c, t in v.items()}
    got = {}
    for name, build, variables in (
            ("two_stage", tflag.tiny_fsd_two_stage, v),
            ("single_stage", tflag.tiny_fsd, rpn_v)):
        for pretrain in (False, True):
            m = load_flax_variables(build(device="cpu"), variables)
            rec = (_record_pipeline(m) if name == "two_stage"
                   and not pretrain else {})
            out = m.loss(batch, train=True, pretrain=pretrain)
            sum(x for k, x in out.items() if _is_loss(k)).backward()
            # a leaf no loss reached has a zero gradient, as in JAX (and in
            # train/state.py's optimizer)
            missing = [n for n, p in m.named_parameters() if p.grad is None]
            for n in missing:
                p = m.get_parameter(n)
                p.grad = torch.zeros_like(p)
            got[name, pretrain] = dict(model=m, losses=out, rec=rec,
                                       missing=missing)
    return dict(jm=jm, v=v, ref=ref, got=got, batch=batch)


def _assert_margins(r):
    """Every fg threshold, per-class top-k cut, per-sample proposal cut and
    RoI positive threshold lies >= 10x the packages' difference away."""
    jm, aux = r["jm"], r["ref"]["aux"]
    rec = r["got"]["two_stage", False]["rec"]
    tdata = rec["pipe"]["data"]
    valid = aux["valid"]
    np.testing.assert_array_equal(tdata["valid"].numpy(), valid)
    s_j = _sigmoid64(aux["seg_logits"])
    diff = np.abs(s_j - _sigmoid64(tdata["seg_logits"].detach()))[valid].max()
    assert diff < 1e-5
    ss = jm.single_stage
    for c, thr in enumerate(ss["score_thresh"]):
        s = s_j[valid, c]
        assert np.abs(s - thr).min() >= 10 * diff, (c, "threshold")
        fg = np.sort(s[s > thr])[::-1]
        cap = ss["caps"].fg_per_class[c]
        if len(fg) > cap:
            assert fg[cap - 1] - fg[cap] >= 10 * diff, (c, "top-k cut")
    pscore = rec["props"][1].detach().numpy()
    pdiff = np.abs(aux["rscores"] - pscore).max()
    scores = np.concatenate([_sigmoid64(lg).max(-1)
                             for lg in aux["cls_logits"]])
    n_tasks = len(aux["cls_logits"])
    ok = np.tile(aux["cluster_valid"], n_tasks)
    batch = np.tile(aux["cluster_batch"], n_tasks)
    k = jm.rois_per_sample
    for i in range(r["batch"].points.shape[0]):
        s = np.sort(scores[ok & (batch == i)])[::-1]
        if len(s) > k:
            assert s[k - 1] - s[k] >= 10 * pdiff, (i, "proposal cut")
    # the RoI head's positives: no proposal's best IoU near its threshold
    thr = np.asarray(jm.roi_head.get("pos_iou_thr", (0.45, 0.35, 0.35)))
    gap = np.abs(aux["max_iou"] - thr[np.minimum(aux["rlabels"], 2)])
    assert gap[aux["rvalid"]].min() >= 1e-3


def _assert_losses(got, ref, keys):
    got = {k: float(x.detach()) for k, x in got.items()}
    assert sorted(got) == sorted(keys)
    for k in keys:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=LOSS_RTOL,
                                   atol=0, err_msg=k)


def _assert_grads(model, grads, prefix=()):
    """Each leaf of ``grads`` (under ``prefix``) within GRAD_TOL of its
    largest magnitude; every torch parameter has its leaf. Returns the
    largest gap over the leaf's scale."""
    worst, n = 0.0, 0
    for path, ref in _leaves(grads):
        if path[:len(prefix)] != prefix:
            continue
        got = _torch_leaf(model, path[len(prefix):], grad=True)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg="/".join(path))
        if scale > 0:
            worst = max(worst, np.abs(got - ref).max() / scale)
        n += 1
    assert n == sum(1 for _ in model.parameters())
    return worst


def _assert_stats(model, stats, prefix=()):
    n = 0
    for path, ref in _leaves(stats):
        if path[:len(prefix)] != prefix:
            continue
        got = _torch_leaf(model, path[len(prefix):], grad=False)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg="/".join(path))
        n += 1
    assert n == sum(1 for k in model.state_dict() if "running_" in k) > 0


def test_two_stage_loss_matches_jax(slice_run):
    """``FSD.loss(pretrain=False)``: every loss and counter, every gradient
    leaf and the running statistics after the step."""
    r = slice_run
    _assert_margins(r)
    ref, got = r["ref"], r["got"]["two_stage", False]
    _assert_losses(got["losses"], ref["losses"], list(ref["losses"]))
    assert got["missing"] == []
    # the frame exercises the RoI stage: clusters, fg points, pairs
    assert ref["losses"]["num_clusters"] > 0
    assert ref["losses"]["loss_rcnn_cls"] > 0
    _assert_grads(got["model"], ref["g_all"])
    _assert_stats(got["model"], ref["stats"])


def test_single_stage_loss_matches_jax(slice_run):
    """``tiny_fsd.loss(pretrain=False)`` on the ``rpn`` variables: JAX's
    single-stage losses (the two-stage's without the RoI keys), its
    gradient (the pullback of their sum) and running statistics."""
    r = slice_run
    ref, got = r["ref"], r["got"]["single_stage", False]
    keys = [k for k in ref["losses"] if not k.startswith(
        ("loss_rcnn", "num_pos_rois", "roi_membership"))]
    _assert_losses(got["losses"], ref["losses"], keys)
    assert all(ref["losses"][f"loss_center.task{t}"] > 0 for t in range(3))
    assert got["missing"] == []
    _assert_grads(got["model"], ref["g_rpn"], ("rpn",))
    _assert_stats(got["model"], ref["stats"], ("rpn",))


@pytest.mark.parametrize("name", ["two_stage", "single_stage"])
def test_pretrain_loss_matches_jax(slice_run, name):
    """``pretrain=True``: the segmentor's two losses alone in both
    detectors, their gradient (zero on every leaf past the segmentor) and
    the running statistics."""
    r = slice_run
    ref, got = r["ref"], r["got"][name, True]
    _assert_losses(got["losses"], ref["pre_losses"],
                   ["loss_sem_seg", "loss_vote"])
    prefix = ("rpn",) if name == "single_stage" else ()
    _assert_grads(got["model"], ref["g_pre"], prefix)
    _assert_stats(got["model"], ref["pre_stats"], prefix)
    for n, p in got["model"].named_parameters():
        assert ("segmentor_mod" in n) == (n not in got["missing"]), n


def test_two_stage_loss_with_no_valid_gt_is_finite(slice_run):
    """All gt boxes invalid (the padded zero-size rows): every loss and
    every gradient finite, as the JAX package's test_fsd.py checks for its
    losses."""
    b = slice_run["batch"]
    empty = PointBatch(points=b.points, valid=b.valid, gt_boxes=b.gt_boxes,
                       gt_labels=b.gt_labels,
                       gt_valid=torch.zeros_like(b.gt_valid))
    m = load_flax_variables(tflag.tiny_fsd_two_stage(device="cpu"),
                            slice_run["v"])
    out = m.loss(empty, train=True)
    sum(x for k, x in out.items() if _is_loss(k)).backward()
    for k, x in out.items():
        assert np.isfinite(float(x.detach())), k
    assert float(out["num_pos_rois"]) == 0
    for n, p in m.named_parameters():
        assert torch.isfinite(p.grad).all(), n
