"""Parity of the port's group sampling (``SingleStageFSD`` with
``group_names``, ``SingleStageFSDV2``'s batched group sampling), the
cluster head's velocity, IoU and enlarged-box branches, and the
segmentor's ``voxel_downsample`` with the JAX package, on the CPU (the
full-width parameter shapes of the grouped configs are held in
``tests/test_torch_configs.py``).

``tiny_fsd_grouped`` (5 classes in 2 groups) and ``tiny_fsdv2_grouped``
(the clone of ``tiny_fsdv2`` in the JAX package's ``tests/test_fsdv2.py``,
here with the nuScenes velocity branch) get seeded variables of the port
models' shapes in flax's layout (``seeded_port_variables``: no flax init
is traced). Both packages
see ``fsd_batch(RandomState(1), p=512)``, its gt boxes given two velocity
columns for the FSDv2 model, and both models run with
``add_gt_fg_points`` so gt-label membership joins each group's selection.
One jitted JAX function per model returns the train-mode pipeline's
selections, the head's boxes from its outputs, the losses, the running
statistics after them and the gradient of their sum; each is lowered while
the ones before compile in threads (``_compile_overlapped``), with the
head's reference beside them. The port's eval-mode ``predict`` runs too
(finite boxes of the same shape). The JAX side runs its
default CPU path (``gather_gemm`` and the scatters), the port's CPU
tensors the kernels' plain twins.

Tolerances: boxes and the head module's outputs rtol/atol 1e-4; the
models' train-mode features and head outputs within 1e-4 of each array's
largest magnitude (at least 1); losses rtol 1e-5; each gradient leaf
within 1e-4 of that leaf's largest magnitude; running statistics rtol/atol
1e-5; fg selections, cluster ids, keeps and labels exactly. The seeded
voting kernel is scaled by 0.1 (``_calm_votes``).
Before comparing the discrete steps the test asserts that each group
threshold and top-k cut, and each member-argmax that picks a vote offset,
lies at least 10x the packages' largest score (or logit) difference away,
so no decision is pinned. No seed was refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sst_tpu.models  # noqa: F401  (fills the JAX registry)
from sst_tpu import flagship as jflag
from sst_tpu.models.detectors.dynamic_voxelnet import PointBatch as JPB
from sst_tpu.models.fsd.sparse_cluster_head import (
    SparseClusterHeadV2 as JHead,
)
from sst_tpu.models.fsd.vote_segmentor import VoteSegmentor as JSeg
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import PointBatch
from sst_tpu_torch.models.fsd.sparse_cluster_head import SparseClusterHeadV2
from sst_tpu_torch.models.fsd.vote_segmentor import VoteSegmentor
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from test_torch_ctrl import seeded_port_variables
from test_torch_fsdv2_train import _leaves, _torch_leaf
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest magnitude
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
FEAT_TOL = 1e-4  # of each train-mode feature array's largest magnitude


def _is_loss(k):
    return k.startswith("loss")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _jax_fsdv2_grouped():
    """The grouped clone of ``tests/test_fsdv2.py`` (its
    ``test_fsdv2_batched_group_sample``), with the velocity branch."""
    from tests.test_fsdv2 import tiny_fsdv2

    base = tiny_fsdv2()
    return base.clone(
        group_names=(("Car",), ("Pedestrian", "Cyclist")),
        score_thresh=(0.05, 0.05),
        segmentor={**base.segmentor,
                   "head": dict(num_classes=4, hidden_dims=(32, 32))},
        head={**base.head, "with_vel": True})


def _frames():
    """The numpy frame both packages see: ``fsd_batch``, and a copy whose
    gt boxes carry two velocity columns."""
    b = tflag.fsd_batch(np.random.RandomState(1), p=512)
    vel = np.random.RandomState(2).randn(*b.gt_boxes.shape[:2], 2)
    b9 = PointBatch(points=b.points, valid=b.valid,
                    gt_boxes=np.concatenate(
                        [b.gt_boxes, vel.astype(np.float32)], -1),
                    gt_labels=b.gt_labels, gt_valid=b.gt_valid)
    return b, b9


def _jbatch(b):
    return JPB(**{k: jnp.asarray(getattr(b, k)) for k in (
        "points", "valid", "gt_boxes", "gt_labels", "gt_valid")})


def _selection(kind, pipe):
    """The pipeline values the test compares and the margin checks read."""
    ex, data = pipe["ex"], pipe["data"]
    keys = (("cluster_xyz", "cluster_batch", "cluster_valid", "pt_seg_ids",
             "pt_valid", "pt_idx", "cluster_feats") if kind == "fsd" else
            ("virtual_centers", "virtual_batch", "virtual_valid",
             "virtual_feats", "num_virtual"))
    return {"seg_logits": data["seg_logits"], "valid": data["valid"],
            "gt_point_labels": data["gt_point_labels"],
            "ex": {k: ex[k] for k in keys}, "outs": pipe["outs"]}


def _boxes(m, kind, pipe):
    """The head's boxes from a pipeline's outputs (``predict``'s decode
    and NMS)."""
    ex = pipe["ex"]
    pre = "cluster" if kind == "fsd" else "virtual"
    xyz = ex["cluster_xyz"] if kind == "fsd" else ex["virtual_centers"]
    return m.head_mod.get_bboxes(pipe["outs"], xyz, ex[f"{pre}_batch"],
                                 ex[f"{pre}_valid"], pipe["batch_size"],
                                 **m.test_cfg)


def _reference(jm, kind):
    """One JAX function: the train-mode pipeline (``add_gt_fg_points`` on,
    so gt-label membership joins each group's selection), its losses,
    running statistics and gradient, and the head's boxes from its
    outputs."""
    def train(m, b):
        pipe = m.run_pipeline(b, True, 0.0)
        return (m.losses_from_pipeline(b, pipe), _selection(kind, pipe),
                _boxes(m, kind, pipe))

    def fn(params, stats, b):
        def total(p):
            (losses, sel, boxes), mut = jm.apply(
                {"params": p, "batch_stats": stats}, b, method=train,
                mutable=["batch_stats"])
            return (sum(x for k, x in losses.items() if _is_loss(k)),
                    (losses, sel, boxes, mut["batch_stats"]))

        (_, (losses, sel, boxes, new_stats)), g = jax.value_and_grad(
            total, has_aux=True)(params)
        return dict(sel=sel, boxes=boxes, losses=losses, stats=new_stats,
                    grads=g)

    return fn


def _port_run(build, v, batch):
    """The port's train-mode losses and gradient, its pipeline recorded
    and the head's boxes from it; and ``predict`` (eval mode)."""
    m = load_flax_variables(build(device="cpu"), v)
    m.add_gt_fg_points = True
    kind = "fsd" if hasattr(m, "num_units") else "fsdv2"
    rec = {}
    run = m.run_pipeline

    def run_rec(*a, **k):
        rec["pipe"] = run(*a, **k)
        return rec["pipe"]

    m.run_pipeline = run_rec
    losses = m.loss(batch, train=True)
    sum(x for k, x in losses.items() if _is_loss(k)).backward()
    for p in m.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    with torch.no_grad():
        boxes = _boxes(m, kind, rec["pipe"])
    m.run_pipeline = run
    predicted = m.eval().predict(batch)
    return dict(sel=_selection(kind, rec["pipe"]), boxes=boxes,
                losses=losses, model=m, predicted=predicted)


def _calm_votes(v):
    """The segmentor's voting kernel scaled by 0.1: at the seeded scale the
    decoded votes (pred * |pred|) reach 100 m in a 16 m range, and the
    float32 rounding of such centres, amplified by the cluster and virtual
    features' normalisations, exceeds the stated tolerances; scaled, they
    lie within a few metres of their points, as trained votes do."""
    k = v["params"]["segmentor_mod"]["head_mod"]["voting"]
    k["kernel"] = k["kernel"] * np.float32(0.1)
    return v


def _compile_overlapped(jobs):
    """Each (function, args) of ``jobs`` jitted: lowered one after another
    on this thread while the ones before compile in threads (XLA compiles
    without the interpreter lock); run, as numpy trees."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(jax.jit(fn).lower(*args).compile)
                   for fn, args in jobs]
        compiled = [f.result() for f in futures]
    return [jax.tree_util.tree_map(np.asarray, c(*args))
            for c, (_, args) in zip(compiled, jobs)]


@pytest.fixture(scope="module")
def runs():
    b, b9 = _frames()
    jv2 = _jax_fsdv2_grouped().clone(add_gt_fg_points=True)
    jfsd = jflag.tiny_fsd_grouped().clone(add_gt_fg_points=True)
    build_v2 = lambda device: tflag.tiny_fsdv2_grouped(  # noqa: E731
        with_vel=True, device=device)
    v2 = _calm_votes(seeded_port_variables(build_v2(device="cpu"), seed=1))
    vf = _calm_votes(seeded_port_variables(
        tflag.tiny_fsd_grouped(device="cpu")))
    head_fn, head_args, head = _head_job()
    ref_2, ref_f, head["ref"] = _compile_overlapped([
        (_reference(jv2, "fsdv2"),
         (v2["params"], v2["batch_stats"], _jbatch(b9))),
        (_reference(jfsd, "fsd"),
         (vf["params"], vf["batch_stats"], _jbatch(b))),
        (head_fn, head_args)])
    scg.reset_launch_counts()
    got_f = _port_run(tflag.tiny_fsd_grouped, vf, b.to("cpu"))
    got_2 = _port_run(build_v2, v2, b9.to("cpu"))
    assert scg.launches == 0  # CPU tensors never launch a kernel
    return {"fsd": dict(jm=jfsd, v=vf, ref=ref_f, got=got_f),
            "fsdv2": dict(jm=jv2, v=v2, ref=ref_2, got=got_2), "head": head}


def _groups(jm):
    names = jm.class_names
    return [[names.index(n) for n in g] for g in jm.group_names]


def _softmax64(x):
    x = np.asarray(x, np.float64)
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _assert_margins(jm, ref_sel, got_sel):
    """Each group's threshold and top-k cut lies >= 10x the packages'
    largest group-score difference away, and where a point of a
    multi-member group is selected, its two largest member logits lie
    >= 10x the logit difference apart."""
    valid = ref_sel["valid"]
    np.testing.assert_array_equal(_np(got_sel["valid"]), valid)
    np.testing.assert_array_equal(_np(got_sel["gt_point_labels"]),
                                  ref_sel["gt_point_labels"])
    lj = np.asarray(ref_sel["seg_logits"], np.float64)
    lt = _np(got_sel["seg_logits"]).astype(np.float64)
    pj, pt = _softmax64(lj), _softmax64(lt)
    ldiff = np.abs(lj - lt)[valid].max()
    caps = jm.caps.fg_per_class
    for g, ids in enumerate(_groups(jm)):
        sj, st = pj[:, ids].sum(-1), pt[:, ids].sum(-1)
        diff = np.abs(sj - st)[valid].max()
        assert diff < 1e-5
        thr = jm.score_thresh[g]
        member = np.isin(ref_sel["gt_point_labels"], ids)
        assert (valid & member).any() and (valid & ~member).any()
        s = sj[valid & ~member]
        assert np.abs(s - thr).min() >= 10 * diff, (g, "threshold")
        fg = valid & ((sj > thr) | member)
        top = np.sort(sj[fg])[::-1]
        if len(top) > caps[g]:
            assert top[caps[g] - 1] - top[caps[g]] >= 10 * diff, (g, "top-k")
        if len(ids) > 1:
            top2 = np.sort(lj[:, ids], -1)[:, -2:]
            gap = (top2[:, 1] - top2[:, 0])[fg]
            assert gap.min() >= 10 * ldiff, (g, "member argmax")


def _assert_close(got, ref, err_msg):
    """Train-mode features: within FEAT_TOL of the array's largest
    magnitude (batch statistics amplify the packages' summation-order
    differences where a feature's batch variance is small)."""
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=FEAT_TOL * max(np.abs(ref).max(), 1.0),
                               err_msg=err_msg)


def _assert_selection(ref_sel, got_sel):
    for k, ref in ref_sel["ex"].items():
        got = _np(got_sel["ex"][k])
        if ref.dtype.kind == "f":
            _assert_close(got, ref, k)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)
    for k in ("cls_logits", "reg_preds"):
        for got, ref in zip(got_sel["outs"][k], ref_sel["outs"][k]):
            _assert_close(_np(got), ref, k)


@pytest.mark.parametrize("kind", ["fsd", "fsdv2"])
def test_grouped_selection_and_boxes_match_jax(runs, kind):
    """Group selections (thresholds, gt-label membership per group, the
    member-argmax offsets), cluster ids (FSD) or virtual voxels (FSDv2),
    head outputs, and the head's boxes (valid and labels exactly). The
    port's ``predict`` (eval mode) gives finite boxes of the same shape."""
    r = runs[kind]
    ref, got = r["ref"], r["got"]
    _assert_margins(r["jm"], ref["sel"], got["sel"])
    _assert_selection(ref["sel"], got["sel"])
    valid = ref["boxes"]["valid"]
    # FSD: sample 0's clusters fill both groups' cluster caps (32), so
    # sample 1 keeps none
    assert (valid.any(axis=1).all() if kind == "fsdv2" else
            valid[0].any() and not valid[1].any())
    np.testing.assert_array_equal(_np(got["boxes"]["valid"]), valid)
    np.testing.assert_array_equal(_np(got["boxes"]["labels"])[valid],
                                  ref["boxes"]["labels"][valid])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(_np(got["boxes"][k])[valid],
                                   ref["boxes"][k][valid], **TOL, err_msg=k)
    labels = ref["boxes"]["labels"][valid]
    assert len(np.unique(labels)) > 1
    m = got["model"]
    pred = got["predicted"]
    assert pred["boxes"].shape == got["boxes"]["boxes"].shape
    assert torch.isfinite(pred["boxes"]).all()
    if kind == "fsd":
        # the head's tasks are the groups
        assert m.head_mod.tasks == r["jm"].group_names
        assert len(got["sel"]["outs"]["cls_logits"]) == 2
    else:
        assert ref["boxes"]["boxes"].shape[-1] == 9  # velocity columns
        assert len(got["sel"]["outs"]["cls_logits"]) == 3


@pytest.mark.parametrize("kind", ["fsd", "fsdv2"])
def test_grouped_loss_and_gradients_match_jax(runs, kind):
    """Train mode: every loss and counter, every gradient leaf and the
    running statistics; the seg loss's background column is trained."""
    r = runs[kind]
    ref, got = r["ref"], r["got"]
    losses = {k: float(x.detach()) for k, x in got["losses"].items()}
    assert sorted(losses) == sorted(ref["losses"])
    for k, x in ref["losses"].items():
        np.testing.assert_allclose(losses[k], float(x), rtol=LOSS_RTOL,
                                   atol=0, err_msg=k)
    if kind == "fsdv2":
        assert all(ref["losses"][f"loss_vel.task{t}"] > 0 for t in range(3))
    m = got["model"]
    n = 0
    for path, g in _leaves(ref["grads"]):
        np.testing.assert_allclose(_torch_leaf(m, path, grad=True), g,
                                   rtol=0, atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg="/".join(path))
        n += 1
    assert n == sum(1 for _ in m.parameters())
    seg_bias = ref["grads"]["segmentor_mod"]["head_mod"]["conv_seg"]["bias"]
    assert seg_bias.shape[0] == len(r["jm"].class_names) + 1
    assert seg_bias[-1] != 0  # the background column takes a gradient
    for path, s in _leaves(ref["stats"]):
        np.testing.assert_allclose(_torch_leaf(m, path, grad=False), s,
                                   **STATS_TOL, err_msg="/".join(path))


# ---------------------------------------------------------------- modules

_HEAD_KW = dict(
    num_classes=3, tasks=(("Car",), ("Pedestrian", "Cyclist")),
    class_names=("Car", "Pedestrian", "Cyclist"), in_channel=16,
    shared_mlp_dims=(32,),
    common_attrs=(("center", 3, 1, 16), ("dim", 3, 1, 16), ("rot", 2, 1, 16)),
    num_cls_layer=1, cls_hidden_dim=16, with_vel=True, with_iou=True,
    enlarge_width=0.1)


def _head_inputs():
    rng = np.random.RandomState(3)
    c, b, g = 64, 2, 5
    gt = np.concatenate([rng.uniform(-4, 4, (b, g, 2)),
                         np.full((b, g, 1), -0.5),
                         rng.uniform(1.0, 3.0, (b, g, 3)),
                         rng.uniform(-np.pi, np.pi, (b, g, 1)),
                         rng.randn(b, g, 2)], -1).astype(np.float32)
    # cluster centres near the boxes (some just past a face, so the
    # enlarged box decides) and elsewhere
    which = rng.randint(0, g, c)
    batch = rng.randint(0, b, c).astype(np.int32)
    xyz = (gt[batch, which, :3] + rng.randn(c, 3) * 0.8).astype(np.float32)
    xyz[: c // 4] = rng.uniform(-6, 6, (c // 4, 3))
    valid = rng.rand(c) < 0.9
    return dict(feats=rng.randn(c, 16).astype(np.float32), xyz=xyz,
                batch=batch, valid=valid, gt=gt,
                labels=rng.randint(0, 3, (b, g)).astype(np.int32),
                gt_valid=rng.rand(b, g) < 0.9)


def _head_job():
    """The head's JAX reference (forward, losses, the gradient of their
    sum, boxes) on seeded variables of the port head's shapes."""
    x = _head_inputs()
    jh = JHead(**_HEAD_KW)
    v = seeded_port_variables(SparseClusterHeadV2(**_HEAD_KW), seed=4)
    args = tuple(jnp.asarray(x[k]) for k in ("xyz", "batch", "valid"))
    gts = tuple(jnp.asarray(x[k]) for k in ("gt", "labels", "gt_valid"))

    def ref(params):
        def total(p):
            outs = jh.apply({"params": p}, x["feats"], x["valid"])
            losses = jh.loss(outs, *args, *gts)
            return sum(losses.values()), (losses, outs)

        (_, (losses, outs)), g = jax.value_and_grad(total, has_aux=True)(
            params)
        boxes = jh.get_bboxes(outs, *args, batch_size=2, score_thr=0.05,
                              nms_pre=64, max_num=16)
        return losses, outs, g, boxes

    return ref, (v["params"],), dict(x=x, v=v)


def test_head_velocity_iou_and_enlarged_boxes_match_jax(runs):
    """SparseClusterHeadV2 with ``with_vel``, ``with_iou`` and
    ``enlarge_width``: forward, every loss (the enlarged-box assignment,
    the velocity L1, the IoU target), the gradient of their sum and the
    rectified, velocity-carrying boxes, against JAX's jitted head."""
    (rl, ro, rg, rb), x, v = (runs["head"]["ref"], runs["head"]["x"],
                              runs["head"]["v"])
    args = (x["xyz"], x["batch"], x["valid"])
    gts = (x["gt"], x["labels"], x["gt_valid"])
    th = load_flax_variables(SparseClusterHeadV2(**_HEAD_KW), v)
    t = [torch.from_numpy(np.asarray(a)) for a in (x["feats"], *args, *gts)]
    outs = th(t[0], t[3])
    losses = th.loss(outs, *t[1:4], *t[4:])
    sum(losses.values()).backward()
    assert sorted(losses) == sorted(rl)
    assert {k.split(".")[0] for k in rl} >= {"loss_vel", "loss_iou"}
    for k in rl:
        np.testing.assert_allclose(float(losses[k].detach()), float(rl[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for k in ("cls_logits", "reg_preds", "iou_logits"):
        for got, r in zip(outs[k], ro[k]):
            np.testing.assert_allclose(_np(got), r, **TOL, err_msg=k)
    for path, g in _leaves(rg):
        np.testing.assert_allclose(_torch_leaf(th, path, grad=True), g,
                                   rtol=0, atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg="/".join(path))
    with torch.no_grad():
        boxes = th.get_bboxes(th(t[0], t[3]), *t[1:4], batch_size=2,
                              score_thr=0.05, nms_pre=64, max_num=16)
    valid = rb["valid"]
    assert valid.sum() > 0 and rb["boxes"].shape[-1] == 9
    np.testing.assert_array_equal(_np(boxes["valid"]), valid)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(_np(boxes[k])[valid], rb[k][valid],
                                   **TOL, err_msg=k)
    # the enlarged boxes assign clusters the plain ones would not
    plain = SparseClusterHeadV2(**dict(_HEAD_KW, enlarge_width=None))
    plain.load_state_dict(th.state_dict())
    with torch.no_grad():
        lp = plain.loss(th(t[0], t[3]), *t[1:4], *t[4:])
    assert any(float(lp[k]) != float(losses[k].detach()) for k in lp)


_DS_PCR = (-80.0, -80.0, -2.0, 80.0, 80.0, 4.0)  # fsd_waymoD1_1x_3f.py


def test_voxel_downsample_matches_jax():
    """``VoteSegmentor.voxel_downsample`` at the 3-sweep config's 0.05 m
    over its range: merged rows, validity and order equal JAX's jitted
    function, with points placed on cell boundaries (where a division and
    the product with the float32 reciprocal differ), duplicates from
    overlapping sweeps and points out of range."""
    rng = np.random.RandomState(5)
    b, p = 2, 4096
    xyz = rng.uniform(-10, 10, (b, p, 3)).astype(np.float32)
    xyz[..., 2] = rng.uniform(-2.5, 4.5, (b, p))
    # a third of the rows repeat an earlier row within 1 cm (a sweep's
    # revisit), a sixth sit exactly on a cell boundary
    rep = rng.randint(0, p // 2, p // 3)
    xyz[:, p // 2:p // 2 + p // 3] = xyz[:, rep] + rng.uniform(
        -0.01, 0.01, (b, p // 3, 3)).astype(np.float32)
    k = rng.randint(1400, 1800, (b, p // 6, 3)).astype(np.float32)
    edge = (np.float32(-80.0) + k * np.float32(0.05)).astype(np.float32)
    edge[..., 2] = rng.uniform(-1.9, 3.9, (b, p // 6))
    xyz[:, p - p // 6:] = edge
    pts = np.concatenate([xyz, rng.rand(b, p, 3).astype(np.float32)], -1)
    valid = rng.rand(b, p) < 0.95
    flat, fv = pts.reshape(b * p, -1), valid.reshape(-1)
    size = (0.05, 0.05, 0.05)
    js = JSeg(point_cloud_range=_DS_PCR, voxel_downsampling_size=size)
    ref_pts, ref_ok = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda a, m: js.apply({}, a, m, b, method=js.voxel_downsample))(
            flat, fv))
    ts = VoteSegmentor(6, point_cloud_range=_DS_PCR,
                       voxel_downsampling_size=size)
    got_pts, got_ok = ts.voxel_downsample(torch.from_numpy(flat),
                                          torch.from_numpy(fv), b)
    np.testing.assert_array_equal(got_ok.numpy(), ref_ok)
    assert 0 < ref_ok.sum() < fv.sum()  # duplicates merged
    np.testing.assert_allclose(got_pts.numpy()[ref_ok], ref_pts[ref_ok],
                               rtol=1e-6, atol=1e-6)
    # the boundary rows: a division would move some to the lower cell
    lo = np.float32(-80.0)
    c_div = np.floor((xyz[..., 0] - lo) / np.float32(0.05))
    c_mul = np.floor((xyz[..., 0] - lo) * (np.float32(1) / np.float32(0.05)))
    assert (c_div != c_mul).any()
