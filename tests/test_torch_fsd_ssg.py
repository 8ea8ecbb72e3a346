"""Parity of the port's key-point assigner (``SingleStageFSD.ssg_class``,
``"ssg"`` in ``assigner_per_class``) with the JAX package, on the CPU.

``tiny_fsd`` with ``assigner_per_class=("ccl", "ssg", "ssg")``,
``ssg_radius=(1.0, 0.5, 0.5)`` and ``ssg_num_fps=(16, 16, 16)`` (JAX's
``tests/test_fsd.py`` hybrid) gets seeded variables of its flax init's
shapes (``jax.eval_shape``, never compiled); both packages see
``fsd_batch(RandomState(2), p=512)``. One jitted JAX function takes the
train-mode pipeline and its losses (``pretrain=False``). The port's
``ssg_class`` is wrapped to record the samples it is given; JAX's
``ssg_class`` then runs (jitted) on the recorded samples, and on one of
them again with two samples' worth of batch ids and a voxel cap it
overflows.

Exact: every cluster id and validity; losses within 1e-5 relative. Before
comparing, the test asserts that no decision lies on a near-tie: the fg
thresholds and top-k cuts 10x the seg-score gap away, and for each
recorded ``ssg_class`` call, in float64 on the port's float32 voxel
centres, each FPS pick's lead over the runner-up (1e-5 of its squared
distance), each kept key's distance from ``2 * radius + 0.01`` and each
voxel's from ``radius`` and from its second-nearest key (1e-4 m). The
batch seed 2 passes them; none was refused.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu.models.fsd.single_stage import SingleStageFSD as JSingleStage
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import PointBatch
from sst_tpu_torch.models.fsd.single_stage import SingleStageFSD, _cell_coords
from sst_tpu_torch.ops.segment import (
    INT_SENTINEL,
    segment_reduce,
    unique_segments,
)
from sst_tpu_torch.utils.builders import build_model_from_cfg
from test_torch_fsd import seeded_variables
from torch_threads import torch_threads_per_worker  # noqa: F401

SSG = dict(assigner_per_class=("ccl", "ssg", "ssg"),
           ssg_radius=(1.0, 0.5, 0.5), ssg_num_fps=(16, 16, 16))
LOSS_RTOL = 1e-5


def _jax_pipeline_losses(m, b):
    pipe = m.run_pipeline(b, True, 0.0)
    ex = pipe["ex"]
    return m.losses_from_pipeline(b, pipe), {
        "seg_logits": pipe["data"]["seg_logits"],
        "valid": pipe["data"]["valid"],
        **{k: ex[k] for k in ("pt_seg_ids", "pt_valid", "pt_idx",
                              "cluster_valid", "cluster_batch")}}


def _ssg_margins(m: SingleStageFSD, sample: dict, cls: int) -> dict:
    """The near-tie margins of ``ssg_class`` on ``sample``, in float64 on
    the port's float32 voxel centres (their mean and batch shift as
    ``ssg_class`` takes them)."""
    vcap = m.caps.cluster_voxels_per_class[cls]
    radius = m.ssg_radius[cls]
    cvs = m.cluster_voxel_size[cls]
    pcr = m.point_cloud_range
    c = _cell_coords(sample["centers"], pcr, cvs)
    nx = int(round((pcr[3] - pcr[0]) / cvs[0])) + 2
    ny = int(round((pcr[4] - pcr[1]) / cvs[1])) + 2
    key = ((sample["batch_idx"] * ny + torch.clamp(c[:, 1], 0, ny - 1)) * nx
           + torch.clamp(c[:, 0], 0, nx - 1))
    uniq = unique_segments(key, sample["valid"], vcap)
    red = segment_reduce(torch.cat([sample["centers"],
                                    sample["batch_idx"].float()[:, None]],
                                   -1), uniq.seg_ids, vcap, "mean")
    vb = torch.round(red[:, 3])
    x = (red[:, 0] + vb * 1e4).numpy().astype(np.float64)
    xy = np.stack([x, red[:, 1].numpy().astype(np.float64)], -1)
    valid = (uniq.unique_keys != INT_SENTINEL).numpy()
    k = min(m.ssg_num_fps[cls], m.caps.clusters_per_class[cls])
    # FPS: each pick's lead over the runner-up
    mind = np.where(valid, 1e10, -1e10)
    picks = [int(np.argmax(valid))]
    lead = np.inf
    for _ in range(k - 1):
        d = ((xy - xy[picks[-1]]) ** 2).sum(-1)
        mind = np.minimum(mind, np.where(valid, d, -1e10))
        top2 = np.sort(mind)[-2:]
        if top2[1] > 0:
            lead = min(lead, (top2[1] - top2[0]) / top2[1])
        picks.append(int(np.argmax(mind)))
    nvalid = int(valid.sum())
    kok = np.arange(k) < nvalid
    kp = xy[picks]
    kd = np.sqrt(((kp[:, None] - kp[None]) ** 2).sum(-1))
    earlier = np.triu(np.ones((k, k), bool), 1) & kok[:, None] & kok[None]
    thr = 2 * radius + 0.01
    kvalid = kok & ~((kd < thr) & earlier).any(0)
    dmat = np.sqrt(((xy[:, None] - kp[None]) ** 2).sum(-1))
    dmat = np.where(kvalid[None], dmat, np.inf)[valid]
    near2 = np.sort(dmat, 1)[:, :2]
    reached = near2[:, 0] < radius
    return {"fps_lead": lead,
            "key_thr": np.abs(kd - thr)[earlier].min(initial=np.inf),
            "radius": np.abs(dmat[np.isfinite(dmat)] - radius).min(
                initial=np.inf),
            "nearest": (near2[reached, 1] - near2[reached, 0]).min(
                initial=np.inf),
            "kept": int(kvalid.sum()), "assigned": int(reached.sum())}


def _assert_ssg_margins(mg):
    assert mg["fps_lead"] >= 1e-5, mg
    for k in ("key_thr", "radius", "nearest"):
        assert mg[k] >= 1e-4, (k, mg)


@pytest.fixture(scope="module")
def hybrid():
    jm = jflag.tiny_fsd().clone(**SSG)
    jb = jflag.fsd_batch(np.random.RandomState(2), p=512)
    v = seeded_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jb)))
    (jlosses, jaux), _ = jax.jit(lambda v, b: jm.apply(
        v, b, method=_jax_pipeline_losses, mutable=["batch_stats"]))(v, jb)
    jlosses, jaux = jax.tree_util.tree_map(np.asarray, (jlosses, jaux))

    tm = load_flax_variables(
        SingleStageFSD(num_point_features=5,
                       **dict(tflag._tiny_fsd_cfg(), **SSG)), v)
    recorded = []
    ssg = tm.ssg_class

    def record(sample, cls, batch_size):
        recorded.append(({k: x.detach().clone() for k, x in sample.items()},
                         cls, batch_size, ssg(sample, cls, batch_size)))
        return recorded[-1][3]

    tm.ssg_class = record
    batch = PointBatch(**{k: np.asarray(getattr(jb, k)) for k in (
        "points", "valid", "gt_boxes", "gt_labels", "gt_valid")}).to("cpu")
    pipe = tm.run_pipeline(batch, train=True)
    losses = tm.losses_from_pipeline(batch, pipe)
    return dict(jm=jm, jlosses=jlosses, jaux=jaux, tm=tm, pipe=pipe,
                losses=losses, recorded=recorded)


def _jax_ssg(jm, sample, cls, batch_size):
    s = {k: np.asarray(x) for k, x in sample.items()}
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda s: jm.apply({}, s, cls, batch_size,
                           method=JSingleStage.ssg_class))(s))


def test_hybrid_pipeline_and_losses_match_jax(hybrid):
    """The train-mode pipeline with CCL for class 0 and the key-point
    assigner for classes 1-2: cluster ids, validity and batches exactly,
    every loss within 1e-5 relative."""
    jaux, pipe = hybrid["jaux"], hybrid["pipe"]
    tdata = pipe["data"]
    valid = jaux["valid"]
    np.testing.assert_array_equal(tdata["valid"].numpy(), valid)
    s_j = 1 / (1 + np.exp(-jaux["seg_logits"].astype(np.float64)))
    s_t = 1 / (1 + np.exp(-tdata["seg_logits"].detach().numpy().astype(
        np.float64)))
    diff = np.abs(s_j - s_t)[valid].max()
    ss = hybrid["jm"]
    for c, thr in enumerate(ss.score_thresh):
        s = s_j[valid, c]
        assert np.abs(s - thr).min() >= 10 * diff, (c, "threshold")
        fg = np.sort(s[s > thr])[::-1]
        cap = ss.caps.fg_per_class[c]
        if len(fg) > cap:
            assert fg[cap - 1] - fg[cap] >= 10 * diff, (c, "top-k cut")
    for sample, cls, _, _ in hybrid["recorded"]:
        _assert_ssg_margins(_ssg_margins(hybrid["tm"], sample, cls))
    ex = pipe["ex"]
    for k in ("pt_seg_ids", "pt_valid", "pt_idx", "cluster_valid",
              "cluster_batch"):
        np.testing.assert_array_equal(ex[k].numpy(), jaux[k], err_msg=k)
    got = {k: float(x.detach()) for k, x in hybrid["losses"].items()}
    assert sorted(got) == sorted(hybrid["jlosses"])
    for k, ref in hybrid["jlosses"].items():
        np.testing.assert_allclose(got[k], float(ref), rtol=LOSS_RTOL,
                                   atol=0, err_msg=k)
    assert got["num_clusters"] > 0


def test_ssg_class_on_recorded_samples_matches_jax(hybrid):
    """JAX's ``ssg_class`` on the samples the port's pipeline recorded,
    and on the class-1 sample again with its points split over two batch
    ids (the 1e4 x shift) and a voxel cap of 24 that it overflows: cluster
    slots and validity exactly; the counters as the margins' float64
    recomputation gives them."""
    tm, jm = hybrid["tm"], hybrid["jm"]
    recorded = hybrid["recorded"]
    assert [cls for _, cls, _, _ in recorded] == [1, 2]
    cases = [(tm, jm, s, cls, b, out) for s, cls, b, out in recorded]
    s1 = dict(recorded[0][0])
    s1["batch_idx"] = (torch.arange(s1["batch_idx"].shape[0]) % 2).to(
        torch.int32)
    caps = dataclasses.replace(tm.caps, cluster_voxels_per_class=(24,) * 3)
    small = SingleStageFSD(num_point_features=5, **dict(
        tflag._tiny_fsd_cfg(), **SSG, caps=caps))
    jsmall = jm.clone(caps=jm.caps.replace(
        cluster_voxels_per_class=(24,) * 3))
    cases.append((small, jsmall, s1, 1, 2, small.ssg_class(s1, 1, 2)))
    for m, j, sample, cls, b, (pc, pv, stats) in cases:
        mg = _ssg_margins(m, sample, cls)
        _assert_ssg_margins(mg)
        jpc, jpv = _jax_ssg(j, sample, cls, b)
        np.testing.assert_array_equal(pc.numpy(), jpc)
        np.testing.assert_array_equal(pv.numpy(), jpv)
        assert int(stats["clusters"]) == mg["kept"] > 1
        assert int(stats["cluster_voxels"]) == mg["assigned"] > 0
        assert int(stats["ccl_rounds"]) == 0
    # the overflow case drops points whose voxel fell past the cap
    pc, pv, _ = cases[-1][-1]
    assert int((s1["valid"] & ~pv).sum()) > 0


def test_hybrid_counts_per_class(hybrid):
    """``extract``'s counters: CCL rounds for class 0 only, key points
    kept and voxels assigned for the key-point classes."""
    c = {k: v.tolist() for k, v in hybrid["pipe"]["ex"]["counts"].items()}
    assert c["ccl_rounds"][0] >= 1 and c["ccl_rounds"][1:] == [0, 0]
    assert all(n > 0 for n in c["clusters"] + c["cluster_voxels"])
    for (_, cls, _, (_, _, stats)) in hybrid["recorded"]:
        assert c["clusters"][cls] == int(stats["clusters"])


def test_ssg_config_builds_and_trains_through_the_builder():
    """The FSD config with the hybrid assigner builds through the port's
    builder (train and test), and the tiny two stage with it takes a loss
    and a backward."""
    from sst_tpu_torch.utils.config import load_config

    cfg = load_config("configs/fsd/fsd_waymoD1_1x.py")
    cfg["model"]["single_stage"]["assigner_per_class"] = ("ccl", "ssg",
                                                          "ssg")
    for train in (True, False):
        m = build_model_from_cfg(cfg, train=train, device="cpu")
        assert m.rpn.assigner_per_class == ("ccl", "ssg", "ssg")
        assert m.rpn.ssg_radius == (1.0, 0.4, 0.6)
        assert m.rpn.ssg_num_fps == (256, 256, 256)
    tm = tflag.init_weights(tflag.tiny_fsd_two_stage(device="cpu"),
                            torch.Generator().manual_seed(0))
    tm.rpn.assigner_per_class = SSG["assigner_per_class"]
    tm.rpn.ssg_radius, tm.rpn.ssg_num_fps = SSG["ssg_radius"], \
        SSG["ssg_num_fps"]
    batch = tflag.fsd_batch(np.random.RandomState(9), p=512).to("cpu")
    out = tm.loss(batch, train=True)
    total = sum(x for k, x in out.items() if k.startswith("loss"))
    assert torch.isfinite(total)
    total.backward()
