"""Parity of the port's evaluation protocols (``sst_tpu_torch/core``:
``evaluation.py``, ``eval_waymo.py``, ``eval_seg.py``) with the JAX
package's, numpy against numpy on seeded random frames: every metric
exactly or within 1e-12."""

import numpy as np
import pytest

from sst_tpu.core import eval_seg as jseg
from sst_tpu.core import eval_waymo as jwaymo
from sst_tpu.core import evaluation as jev
from sst_tpu_torch.core import eval_seg as tseg
from sst_tpu_torch.core import eval_waymo as twaymo
from sst_tpu_torch.core import evaluation as tev
from torch_threads import torch_threads_per_worker  # noqa: F401

CLASSES = ["Car", "Pedestrian", "Cyclist"]


def _frames(seed: int, n_frames: int = 6):
    """Ground truth of 0-12 boxes per frame within 70 m (with point counts
    and labeler difficulty), and predictions: jittered copies of most gt
    boxes (some with another label or a flipped heading) and false
    positives, with random scores."""
    r = np.random.RandomState(seed)
    preds, gts = [], []
    for f in range(n_frames):
        m = 0 if f == 2 else r.randint(1, 13)
        gb = np.concatenate([r.uniform(-70, 70, (m, 2)),
                             r.uniform(-1, 0, (m, 1)),
                             r.uniform(0.6, 5, (m, 3)),
                             r.uniform(-np.pi, np.pi, (m, 1))], 1)
        gl = r.randint(0, 3, m)
        keep = r.rand(m) < 0.8
        pb = gb[keep] + np.concatenate([r.randn(keep.sum(), 3) * 0.15,
                                        r.randn(keep.sum(), 3) * 0.05,
                                        r.randn(keep.sum(), 1) * 0.3], 1)
        pb[r.rand(len(pb)) < 0.2, 6] += np.pi
        pl = np.where(r.rand(len(pb)) < 0.1, r.randint(0, 3, len(pb)),
                      gl[keep])
        k = r.randint(0, 6)
        fp = np.concatenate([r.uniform(-70, 70, (k, 2)),
                             r.uniform(-1, 0, (k, 1)),
                             r.uniform(0.6, 5, (k, 3)),
                             r.uniform(-np.pi, np.pi, (k, 1))], 1)
        preds.append({"boxes": np.concatenate([pb, fp]).astype(np.float32),
                      "scores": r.rand(len(pb) + k).astype(np.float32),
                      "labels": np.concatenate([pl, r.randint(0, 3, k)])})
        gts.append({"boxes": gb.astype(np.float32), "labels": gl,
                    "num_points": r.randint(0, 40, m),
                    "difficulty": r.randint(1, 3, m)})
    return preds, gts


def _assert_close(got, ref, path="result"):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            _assert_close(got[k], ref[k], f"{path}/{k}")
    else:
        assert abs(got - ref) <= 1e-12, (path, got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["3d", "bev"])
def test_eval_ap_matches_jax(seed, mode):
    preds, gts = _frames(seed)
    ref = jev.eval_ap(preds, gts, CLASSES, mode=mode)
    _assert_close(tev.eval_ap(preds, gts, CLASSES, mode=mode), ref)
    assert ref["mAP"] > 0


@pytest.mark.parametrize("seed", [0, 3])
def test_eval_ap_breakdowns_matches_jax(seed):
    preds, gts = _frames(seed)
    ref = jev.eval_ap_breakdowns(preds, gts, CLASSES)
    assert "L2_proxy_hard" in ref
    _assert_close(tev.eval_ap_breakdowns(preds, gts, CLASSES), ref)


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("matcher", ["greedy", "hungarian"])
def test_waymo_eval_matches_jax(seed, matcher):
    preds, gts = _frames(seed, n_frames=8)
    ref = jwaymo.waymo_eval(preds, gts, tuple(CLASSES), matcher=matcher,
                            range_breakdowns=True)
    got = twaymo.waymo_eval(preds, gts, tuple(CLASSES), matcher=matcher,
                            range_breakdowns=True)
    _assert_close(got, ref)
    assert ref["Overall/L2 mAP"] > 0


def test_parse_metrics_stdout_matches_jax():
    text = ("OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1: [mAP 0.713] [mAPH 0.705]\n"
            "OBJECT_TYPE_TYPE_VEHICLE_LEVEL_2: [mAP 0.62] [mAPH 0.61]\n"
            "OBJECT_TYPE_TYPE_PEDESTRIAN_LEVEL_2: [mAP 0.5] [mAPH 0.4]\n"
            "RANGE_TYPE_VEHICLE_[0, 30)_LEVEL_2: [mAP 0.82] [mAPH 0.81]\n"
            "RANGE_TYPE_CYCLIST_[50, INF)_LEVEL_1: [mAP 0.1] [mAPH 0.09]\n")
    _assert_close(twaymo.parse_metrics_stdout(text),
                  jwaymo.parse_metrics_stdout(text))


@pytest.mark.parametrize("ignore_index", [None, 1])
def test_seg_eval_matches_jax(ignore_index):
    r = np.random.RandomState(5)
    gt = [r.randint(0, 4, n) for n in (100, 0, 257)]
    # a class never predicted, one never present: nan IoUs are skipped
    pred = [np.where(r.rand(len(g)) < 0.7, g, r.randint(0, 3, len(g)))
            for g in gt]
    classes = ("Car", "Pedestrian", "Cyclist", "Sign", "background")
    ref = jseg.seg_eval(gt, pred, classes, ignore_index=ignore_index)
    got = tseg.seg_eval(gt, pred, classes, ignore_index=ignore_index)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert (np.isnan(ref[k]) and np.isnan(got[k])) or \
            abs(got[k] - ref[k]) <= 1e-12, k
    np.testing.assert_array_equal(
        tseg.confusion_matrix(pred[0], gt[0], 4),
        jseg.confusion_matrix(pred[0], gt[0], 4))


def test_rotated_iou_matrix_edge_cases_match_jax():
    """Coincident boxes, boxes touching along an edge or at a corner,
    rotated copies, nested boxes and far-apart ones, in every mode; and
    ``greedy_match`` on the 3D matrix."""
    a = np.array([[0, 0, 0, 2, 4, 1.5, 0.0],
                  [10, 0, 0, 2, 2, 1, 0.3],
                  [0, 20, 0, 3, 3, 2, np.pi / 4],
                  [0, -20, 0, 4, 4, 2, 0.0]], np.float32)
    b = np.array([[0, 0, 0, 2, 4, 1.5, 0.0],          # coincident
                  [2, 0, 0, 2, 4, 1.5, 0.0],          # touching an edge
                  [12, 2, 0, 2, 2, 1, 0.0],           # touching a corner
                  [10, 0, 0, 2, 2, 1, 0.3 + np.pi / 2],  # rotated copy
                  [0, 20, 0.5, 1, 1, 1, 0.1],         # nested
                  [0, -20, 1, 4, 4, 2, 0.0],          # z-shifted half
                  [50, 50, 0, 1, 1, 1, 0.0]], np.float32)
    for mode in ("3d", "bev", "overlap"):
        ref = jev.rotated_iou_matrix(a, b, mode)
        got = tev.rotated_iou_matrix(a, b, mode)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), mode
    iou = tev.rotated_iou_matrix(a, b, "3d")
    order = np.array([3, 1, 0, 2])
    np.testing.assert_array_equal(tev.greedy_match(iou, order, 0.3),
                                  jev.greedy_match(iou, order, 0.3))
    ca, cb = tev._bev_corners(a[:2]), tev._bev_corners(b[:2])
    np.testing.assert_array_equal(tev.rect_intersection_area_np(ca, cb),
                                  jev.rect_intersection_area_np(ca, cb))
