"""Parity of the port's small ops with the JAX package, on the CPU:
``segment_max_with_argmax`` and ``scatter_v2`` (``ops/segment.py``),
``aligned_3d_nms`` (``core/nms.py``), ``boxes_overlap_1to1``
(``core/iou.py``), ``rotate_boxes`` / ``flip_boxes`` (``core/boxes.py``),
``tta_predict`` (``models/tta.py``) and ``roiaware_pool3d``
(``ops/roiaware.py``).

Exact: the argmax rows, the NMS keeps, TTA's keeps and labels, the max
pool. Within 1e-5: the overlaps, the turned and flipped boxes, TTA's
merged boxes and scores, the mean pool. Where a decision could flip on a
rounding (an IoU at the NMS threshold, a point on a sub-voxel or roi face),
the test first asserts the seeded inputs keep 1e-4 from it.
"""

import jax.numpy as jnp
import numpy as np
import torch

from sst_tpu.core import boxes as jboxes
from sst_tpu.core.iou import boxes_overlap_1to1 as joverlap
from sst_tpu.core.nms import aligned_3d_nms as jaligned
from sst_tpu.models.detectors.dynamic_voxelnet import PointBatch as JPB
from sst_tpu.models.tta import tta_predict as jtta
from sst_tpu.ops import segment as jseg
from sst_tpu.ops.roiaware import roiaware_pool3d as jroiaware
from sst_tpu_torch.core.boxes import flip_boxes, rotate_boxes
from sst_tpu_torch.core.iou import boxes_overlap_1to1
from sst_tpu_torch.core.nms import aligned_3d_nms
from sst_tpu_torch.models import PointBatch
from sst_tpu_torch.models.tta import tta_predict
from sst_tpu_torch.ops.roiaware import roiaware_pool3d
from sst_tpu_torch.ops.segment import (
    segment_max_with_argmax,
    segment_reduce,
    scatter_v2,
)
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, n, vel=False):
    cols = [rng.uniform(-5, 5, (n, 2)), rng.uniform(-1, 1, (n, 1)),
            rng.uniform(1, 4, (n, 3)), rng.uniform(-3, 3, (n, 1))]
    if vel:
        cols.append(rng.uniform(-2, 2, (n, 2)))
    return np.concatenate(cols, -1).astype(np.float32)


def test_segment_max_with_argmax_and_scatter_v2_match_jax():
    """Integer-valued rows (ties within segments), empty segments, ids out
    of range: the max and the lowest row holding it, bit for bit (1-D rows
    as the 2-D result's columns); ``scatter_v2`` in each mode, with a passed ``unique`` reused."""
    rng = np.random.RandomState(0)
    n, s = 300, 40
    seg = rng.randint(0, s + 8, n).astype(np.int32)  # ids >= s dropped
    seg[seg == 7] = 8  # segment 7 empty
    data = rng.randint(-4, 5, (n, 6)).astype(np.float32)
    ref = jseg.segment_max_with_argmax(jnp.asarray(data), jnp.asarray(seg), s)
    got = segment_max_with_argmax(_t(data), _t(seg), s)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[1].dtype == torch.int32
    # 1-D rows (JAX's takes 2-D only): each column alone gives its column
    for c in range(data.shape[1]):
        col = segment_max_with_argmax(_t(data[:, c]), _t(seg), s)
        for g, r in zip(col, got):
            assert torch.equal(g, r[:, c])
    keys = rng.randint(0, 90, n).astype(np.int32)
    valid = rng.rand(n) > 0.2
    feat = rng.randn(n, 5).astype(np.float32)
    for mode in ("mean", "sum", "max"):
        rv, ru = jseg.scatter_v2(jnp.asarray(feat), jnp.asarray(keys),
                                 jnp.asarray(valid), 64, mode)
        gv, gu = scatter_v2(_t(feat), _t(keys), _t(valid), 64, mode)
        np.testing.assert_allclose(gv.numpy(), np.asarray(rv), **TOL)
        np.testing.assert_array_equal(gu.seg_ids.numpy(),
                                      np.asarray(ru.seg_ids))
        again, same = scatter_v2(_t(feat) * 2, None, None, 64, mode, gu)
        assert same is gu
        np.testing.assert_allclose(
            again.numpy(), segment_reduce(_t(feat) * 2, gu.seg_ids, 64,
                                          mode).numpy(), rtol=0, atol=0)


def test_aligned_3d_nms_matches_jax():
    """64 seeded score-sorted boxes in three classes, some invalid: the
    keep mask exactly, once the IoUs keep 1e-4 from the threshold."""
    rng = np.random.RandomState(3)
    k = 64
    lo = np.concatenate([rng.uniform(-3, 3, (k, 2)),
                         rng.uniform(-1, 1, (k, 1))], -1)
    boxes = np.concatenate([lo, lo + rng.uniform(0.5, 2.5, (k, 3))],
                           -1).astype(np.float32)
    scores = np.sort(rng.rand(k))[::-1].astype(np.float32)
    cls = rng.randint(0, 3, k).astype(np.int32)
    valid = rng.rand(k) > 0.1
    b64 = boxes.astype(np.float64)
    inter = np.clip(np.minimum(b64[:, None, 3:], b64[None, :, 3:])
                    - np.maximum(b64[:, None, :3], b64[None, :, :3]), 0,
                    None).prod(-1)
    vol = (b64[:, 3:] - b64[:, :3]).prod(-1)
    iou = inter / (vol[:, None] + vol[None] - inter)
    for thr in (0.1, 0.25):
        assert np.abs(iou - thr).min() >= 1e-4
        ref = np.asarray(jaligned(jnp.asarray(boxes), jnp.asarray(scores),
                                  jnp.asarray(cls), jnp.asarray(valid), thr))
        got = aligned_3d_nms(_t(boxes), _t(scores), _t(cls), _t(valid), thr)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert 0 < (valid & ~ref).sum()


def test_boxes_overlap_1to1_matches_jax():
    """``iou`` and ``iof`` of paired rotated boxes, overlapping, nested
    and apart, within 1e-5."""
    rng = np.random.RandomState(1)
    a = _boxes(rng, 48)
    b = a.copy()
    b[:16, :2] += rng.uniform(-1, 1, (16, 2))
    b[16:32, 3:6] *= 0.5
    b[16:32, 6] += rng.uniform(-1, 1, 16)
    b[32:, :2] += 20.0
    for mode in ("iou", "iof"):
        ref = np.asarray(joverlap(jnp.asarray(a), jnp.asarray(b), mode))
        got = boxes_overlap_1to1(_t(a), _t(b), mode).numpy()
        np.testing.assert_allclose(got, ref, **TOL)
        assert (ref[:32] > 0).all() and (ref[32:] == 0).all()


def test_rotate_and_flip_boxes_match_jax():
    """With and without velocity columns, every flip axis, one angle."""
    rng = np.random.RandomState(2)
    for vel in (False, True):
        boxes = _boxes(rng, 20, vel)
        ref = np.asarray(jboxes.rotate_boxes(jnp.asarray(boxes), 0.7))
        np.testing.assert_allclose(rotate_boxes(_t(boxes), 0.7).numpy(), ref,
                                   **TOL)
        for axis in ("x", "y"):
            ref = np.asarray(jboxes.flip_boxes(jnp.asarray(boxes), axis))
            np.testing.assert_allclose(flip_boxes(_t(boxes), axis).numpy(),
                                       ref, **TOL)


def _objects(rng, b=2, per=40):
    """Three well-separated point blobs per sample, one per class."""
    centres = np.array([[-6.0, 2.0], [0.0, -5.0], [5.0, 4.0]])
    pts = []
    for _ in range(b):
        blob = [np.concatenate([c + rng.randn(per, 2) * 0.3,
                                rng.uniform(-1, 1, (per, 1))], -1)
                for c in centres + rng.uniform(-1, 1, (3, 2))]
        pts.append(np.concatenate(blob))
    return np.stack(pts).astype(np.float32)


def _fake_predict(xp, per=40):
    """A detector of the three blobs: a box at each blob's centroid (yaw
    0.3), a score that moves with the view, a class per blob, and a
    padding row."""
    def predict(batch):
        p = batch.points
        b = p.shape[0]
        rows = []
        for j in range(3):
            ctr = p[:, j * per:(j + 1) * per, :2].mean(1)
            score = 0.5 + 0.2 * xp.tanh(ctr[:, 0] + 0.5 * ctr[:, 1])
            rows.append((ctr, score))
        ctr = xp.stack([r[0] for r in rows], 1)
        ones = xp.ones((b, 3, 1))
        boxes = xp.concatenate([ctr, -0.5 * ones, 2 * ones, 4 * ones,
                                1.5 * ones, 0.3 * ones], -1)
        boxes = xp.concatenate([boxes, xp.zeros((b, 1, 7))], 1)
        scores = xp.concatenate([xp.stack([r[1] for r in rows], 1),
                                 xp.zeros((b, 1))], 1)
        labels = xp.asarray(np.tile([[0, 1, 2, 0]], (b, 1)).astype(np.int32))
        valid = xp.asarray(np.tile([[True, True, True, False]], (b, 1)))
        return dict(boxes=boxes, scores=scores, labels=labels, valid=valid)
    return predict


def test_tta_predict_matches_jax():
    """Four flips at two angles over a two-sample batch: scores and boxes
    within 1e-5 (box x within 1e-5 of the shifted x the class-aware merge
    computes at), keeps and labels exactly; each object merges to one
    box."""
    rng = np.random.RandomState(5)
    pts = _objects(rng)
    b, p, _ = pts.shape
    valid = np.ones((b, p), bool)
    kw = dict(flips=("none", "x", "y", "xy"), angles=(0.0, 0.5), max_num=12)
    ref = jtta(_fake_predict(jnp), JPB(points=jnp.asarray(pts),
                                       valid=jnp.asarray(valid)), **kw)
    got = tta_predict(_fake_predict(torch),
                      PointBatch(points=_t(pts), valid=_t(valid)), **kw)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    for k in ("valid", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"], **TOL)
    boxes = got["boxes"].numpy()
    np.testing.assert_allclose(boxes[..., 1:], ref["boxes"][..., 1:], **TOL)
    # the merge takes x at x + 1e4 * label (one float32 ulp there is 2e-3)
    shift = np.abs(ref["boxes"][..., 0]) + 1e4 * ref["labels"]
    assert (np.abs(boxes[..., 0] - ref["boxes"][..., 0])
            <= 1e-5 * shift + 1e-5).all()
    assert (ref["valid"].sum(1) == 3).all()


def test_roiaware_pool3d_matches_jax():
    """Six rotated rois over 400 seeded points (two samples), 32 points per
    roi, a (4, 3, 2) grid: ``max`` exactly, ``mean`` within 1e-5, after a
    margin check (no point within 1e-4 of a roi face or a sub-voxel edge)."""
    rng = np.random.RandomState(7)
    n, r = 400, 6
    pts = np.concatenate([rng.uniform(-4, 4, (n, 2)),
                          rng.uniform(-1.5, 1.5, (n, 1))], -1).astype(
        np.float32)
    pbatch = (np.arange(n) % 2).astype(np.int32)
    feats = rng.randn(n, 5).astype(np.float32)
    rois = np.concatenate([rng.uniform(-2, 2, (r, 2)),
                           np.full((r, 1), -1.2), rng.uniform(1.5, 3, (r, 3)),
                           rng.uniform(-3, 3, (r, 1))], -1).astype(np.float32)
    rbatch = (np.arange(r) % 2).astype(np.int32)
    out_size = (4, 3, 2)
    # box-local coordinates in float64, as a fraction of each grid's cells
    rel = pts[:, None, :].astype(np.float64) - rois[None, :, :3]
    c, s = np.cos(rois[:, 6]), np.sin(rois[:, 6])
    lw = rel[..., 0] * c - rel[..., 1] * s
    ll = rel[..., 0] * s + rel[..., 1] * c
    lz = rel[..., 2] - rois[:, 5] / 2
    dims = ((lw, rois[:, 3], out_size[0]), (ll, rois[:, 4], out_size[1]),
            (lz, rois[:, 5], out_size[2]))
    same = pbatch[:, None] == rbatch[None]
    inside = same & np.all([np.abs(loc) <= d / 2 for loc, d, _ in dims], 0)
    for loc, dim, g in dims:
        assert np.abs(np.abs(loc) - dim / 2)[same].min() >= 1e-4  # faces
        frac = (loc / dim + 0.5) * g
        assert np.abs(frac - np.round(frac))[inside].min() >= 1e-4  # edges
    args = (pts, feats, np.ones(n, bool), pbatch, rois, np.ones(r, bool),
            rbatch)
    for mode in ("max", "mean"):
        ref = np.asarray(jroiaware(*(jnp.asarray(a) for a in args),
                                   out_size=out_size, mode=mode,
                                   max_inbox_point=32))
        got = roiaware_pool3d(*(_t(a) for a in args), out_size=out_size,
                              mode=mode, max_inbox_point=32).numpy()
        assert got.shape == (r,) + out_size + (5,)
        if mode == "max":
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, **TOL)
        assert (ref != 0).any(-1).sum() > 10
