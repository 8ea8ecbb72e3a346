"""Module parity of the port's FSD pieces with the JAX package: CCL and
label compaction, ``nms_bev``, ``dynamic_point_pool``, ``SIR``,
``GroupCorrectionHead.predict`` and the RoI point scatter, on seeded numpy
inputs. The flax modules get seeded variables of their init's shapes
(``jax.eval_shape``, never compiled).

Tolerances: labels, keep masks, pool indices, validity and counters
exactly; geometry and SIR / RoI head outputs at rtol/atol 1e-5 (float32
products summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.core.nms import nms_bev as jnms_bev
from sst_tpu.core.nms import topk_presort as jtopk_presort
from sst_tpu.models.fsd.roi_head import GroupCorrectionHead as JGCH
from sst_tpu.models.fsd.roi_head import dynamic_point_pool as jpool
from sst_tpu.models.fsd.sir import SIR as JSIR
from sst_tpu.ops.ccl import compact_labels as jcompact
from sst_tpu.ops.ccl import connected_components as jccl
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.core.nms import nms_bev, topk_presort
from sst_tpu_torch.models.fsd.roi_head import (
    GroupCorrectionHead,
    dynamic_point_pool,
)
from sst_tpu_torch.models.fsd.sir import SIR
from sst_tpu_torch.models.fsd.two_stage import scatter_last_wins
from sst_tpu_torch.ops import ccl
from sst_tpu_torch.ops.ccl import compact_labels, connected_components
from test_torch_fsd import seeded_variables

TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.from_numpy


# ------------------------------------------------------------------ CCL


def _rounds_ref(xy, batch, valid, thr, max_iters=64):
    """JAX's while_loop body count, in numpy float32."""
    m = len(xy)
    d2 = ((xy[:, None] - xy[None]) ** 2).sum(-1)
    adj = ((d2 < np.float32(thr**2)) & (batch[:, None] == batch[None])
           & valid[:, None] & valid[None])
    labels = np.where(valid, np.arange(m), m)
    it, changed = 0, True
    while changed and it < max_iters:
        new = np.minimum(labels, np.where(adj, labels[None], m).min(1))
        changed = (new != labels).any()
        labels, it = new, it + 1
    return labels, it


def _ccl_case(name):
    rng = np.random.RandomState(0)
    if name == "chain":  # 100 nodes, 99 hops: the 64-round cap binds
        xy = np.stack([np.arange(100) * 0.5, np.zeros(100)], -1)
        batch = np.zeros(100, np.int32)
        valid = np.ones(100, bool)
        perm = rng.permutation(100)  # the minimum starts mid-chain too
        return xy[perm].astype(np.float32), batch, valid, 0.6
    # seeded centres: blobs in two samples, every 7th row invalid
    centres = rng.uniform(-20, 20, (12, 2))
    xy = centres[rng.randint(0, 12, 400)] + rng.randn(400, 2) * 0.8
    batch = rng.randint(0, 2, 400).astype(np.int32)
    valid = np.arange(400) % 7 != 3
    return xy.astype(np.float32), batch, valid, 0.6


@pytest.mark.parametrize("check_every", [1, 5, 8, 64])
@pytest.mark.parametrize("case", ["blobs", "chain"])
def test_connected_components_equal_jax(case, check_every, monkeypatch):
    """Labels equal JAX's whatever the rounds between two host reads of
    ``changed``, and the rounds counted are JAX's loop's."""
    monkeypatch.setattr(ccl, "CCL_CHECK_EVERY", check_every)
    xy, batch, valid, thr = _ccl_case(case)
    ref = np.asarray(jccl(jnp.asarray(xy), jnp.asarray(batch),
                          jnp.asarray(valid), thr))
    labels, rounds = connected_components(T(xy), T(batch), T(valid), thr)
    np.testing.assert_array_equal(labels.numpy(), ref)
    ref_np, ref_rounds = _rounds_ref(xy, batch, valid, thr)
    np.testing.assert_array_equal(ref_np, ref)
    assert int(rounds) == ref_rounds
    assert (ref_rounds == 64) == (case == "chain")
    assert (ref[~valid] == len(xy)).all()
    # labels never join the two samples
    for lbl in np.unique(ref[valid]):
        assert len(np.unique(batch[valid][ref[valid] == lbl])) == 1


@pytest.mark.parametrize("cap", [8, 64])
def test_compact_labels_equal_jax(cap):
    xy, batch, valid, thr = _ccl_case("blobs")
    labels = np.asarray(jccl(jnp.asarray(xy), jnp.asarray(batch),
                             jnp.asarray(valid), thr))
    ids, n = jcompact(jnp.asarray(labels), jnp.asarray(valid), cap)
    got_ids, got_n = compact_labels(T(labels), T(valid), cap)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    assert int(got_n) == int(n) and int(n) > 8  # cap 8 binds


# ------------------------------------------------------------------ NMS


@pytest.mark.parametrize("rotate", [True, False])
def test_nms_bev_equal_jax(rotate):
    rng = np.random.RandomState(1)
    k = 300
    boxes = np.concatenate([
        rng.uniform(-10, 10, (k, 2)), rng.uniform(-1, 1, (k, 1)),
        rng.uniform(1, 4, (k, 3)), rng.uniform(-np.pi, np.pi, (k, 1))],
        -1).astype(np.float32)
    scores = rng.rand(k).astype(np.float32)
    mask = rng.rand(k) < 0.9
    idx, sel = jtopk_presort(jnp.asarray(scores), jnp.asarray(mask), 256)
    tidx, tsel = topk_presort(T(scores), T(mask), 256)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    ref = np.asarray(jnms_bev(jnp.asarray(boxes)[idx],
                              jnp.asarray(scores)[idx], sel, 0.25,
                              use_rotate_nms=rotate))
    got = nms_bev(T(boxes)[tidx], T(scores)[tidx], tsel, 0.25,
                  use_rotate_nms=rotate)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < sel.sum()  # some boxes suppressed, some kept


# ------------------------------------------------------ dynamic point pool


def _pool_inputs(seed=2, n=3000, r=24):
    rng = np.random.RandomState(seed)
    rois = np.concatenate([
        rng.uniform(-8, 8, (r, 2)), rng.uniform(-1.5, -0.5, (r, 1)),
        rng.uniform(1.0, 4.5, (r, 3)), rng.uniform(-np.pi, np.pi, (r, 1))],
        -1).astype(np.float32)
    # half the points around the rois (overlapping rois share points)
    near = rois[rng.randint(0, r, n // 2), :3] + rng.randn(n // 2, 3) * 1.2
    far = rng.uniform(-9, 9, (n - n // 2, 3))
    pts = np.concatenate([near, far])[rng.permutation(n)].astype(np.float32)
    pts_valid = rng.rand(n) < 0.95
    pts_batch = rng.randint(0, 2, n).astype(np.int32)
    roi_valid = rng.rand(r) < 0.9
    roi_batch = rng.randint(0, 2, r).astype(np.int32)
    return pts, pts_valid, pts_batch, rois, roi_valid, roi_batch


@pytest.mark.parametrize("case, k, m", [
    ("no cap binds", 256, 4096),
    ("max_paired_points binds", 256, 300),
    ("max_inbox_point binds", 12, 4096),
])
def test_dynamic_point_pool_equal_jax(case, k, m):
    args = _pool_inputs()
    kw = dict(extra_wlh=(0.5, 0.5, 0.5), max_inbox_point=k,
              max_paired_points=m, chunk=1024)
    ref = jax.jit(lambda *a: jpool(*a, **kw))(*map(jnp.asarray, args))
    got = dynamic_point_pool(*map(T, args), **kw)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(ref["valid"]))
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(ref["idx"]))
    np.testing.assert_allclose(got["geo"].numpy(), np.asarray(ref["geo"]),
                               **TOL)
    for c in ("membership_overflow", "inbox_overflow"):
        assert int(got[c]) == int(ref[c]), c
    mo, io = int(ref["membership_overflow"]), int(ref["inbox_overflow"])
    assert (mo > 0) == (case == "max_paired_points binds")
    assert (io > 0) == (case == "max_inbox_point binds")
    assert got["valid"].sum() > 100


# ------------------------------------------------------------ SIR, RoI head


_SIR_CFG = dict(num_blocks=2, feat_channels=((32, 32), (24, 24)),
                rel_mlp_hidden=((8, 8), (8, 16)))


def test_sir_equal_jax():
    rng = np.random.RandomState(3)
    n, f, c = 500, 19, 40
    points = rng.randn(n, 5).astype(np.float32) * 4
    feats = rng.randn(n, f).astype(np.float32)
    f_cluster = rng.randn(n, 3).astype(np.float32)
    valid = rng.rand(n) < 0.85
    seg = np.where(valid, rng.randint(0, c - 5, n), c).astype(np.int32)
    args = (points, feats, f_cluster, seg)
    jm = JSIR(in_channels=(0, 0), **_SIR_CFG)
    jargs = tuple(map(jnp.asarray, args))
    v = seeded_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *jargs, c, jnp.asarray(valid))))
    ref = jax.jit(lambda v, *a: jm.apply(v, *a, c, jnp.asarray(valid)))(
        v, *jargs)
    tm = load_flax_variables(SIR(5, f, **_SIR_CFG), v).eval()
    with torch.inference_mode():
        got = tm(*map(T, args), c, T(valid))
    assert tm.cluster_channels == got[1].shape[1] == 32 + 32 + 24 + 24
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


_ROI_CFG = dict(max_inbox_point=16, bbox_head=dict(
    num_blocks=2, feat_channels=((16, 16),) * 2,
    rel_mlp_hidden=((8, 8),) * 2, reg_mlp=(32, 32), cls_mlp=(32, 32)))


def test_group_correction_head_predict_equal_jax():
    pts, pv, pb, rois, rv, rb = _pool_inputs(seed=4, n=1500, r=40)
    rng = np.random.RandomState(5)
    pts5 = np.concatenate([pts, rng.rand(len(pts), 2).astype(np.float32)],
                          -1)
    feats = rng.randn(len(pts), 21).astype(np.float32)
    scores = rng.rand(len(rois)).astype(np.float32)
    labels = rng.randint(0, 3, len(rois)).astype(np.int32)
    args = (pts5, feats, pv, pb, rois, scores, labels, rv, rb)
    kw = dict(nms_thr=0.25, score_thr=0.1, max_num=32, use_rotate_nms=True)
    jm = JGCH(num_classes=3, **_ROI_CFG)
    jargs = tuple(map(jnp.asarray, args))
    v = seeded_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *jargs, 2, method=jm.predict, **kw)))
    ref = jax.jit(lambda v, *a: jm.apply(v, *a, 2, method=jm.predict,
                                         **kw))(v, *jargs)
    tm = load_flax_variables(GroupCorrectionHead(5, 21, num_classes=3,
                                                 **_ROI_CFG), v).eval()
    with torch.inference_mode():
        got = tm.predict(*map(T, args), 2, **kw)
    valid = np.asarray(ref["valid"])
    assert got["boxes"].shape == (2, 32, 7) and valid.any(1).all()
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)


def test_roi_point_scatter_last_wins_as_jax():
    """JAX's ``.at[idx].set(mode="drop")`` with duplicate indices keeps the
    last row on the CPU; the port names that winner explicitly."""
    rng = np.random.RandomState(6)
    rows, n = 50, 400
    idx = rng.randint(0, rows + 10, n).astype(np.int32)  # some dropped
    vals = rng.randn(n, 4).astype(np.float32)
    ref = np.asarray(jnp.zeros((rows + 1, 4)).at[jnp.asarray(idx)].set(
        jnp.asarray(vals), mode="drop")[:rows])
    got = scatter_last_wins(rows, T(idx), T(vals))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(idx[idx < rows]) > len(np.unique(idx[idx < rows]))
