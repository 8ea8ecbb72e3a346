"""The port's CenterHead and weighted-NMS pieces against the JAX package's
(``sst_tpu/models/heads/center_head.py``, ``sst_tpu/core/nms.py``), on
the same numpy-seeded inputs, on the CPU. The JAX side is jitted, as the
models run it (XLA divides by a constant as the product with its float32
reciprocal, and the port does the same).

- ``circle_nms``, ``weighted_nms_bev`` and ``box3d_multiclass_nms(
  use_wnms=True)`` on JAX's ``tests/test_center_head.py`` cases and on
  seeded clusters of overlapping boxes: keep masks, labels and validity
  exactly; merged boxes within 2e-5 and scores within 1e-6 (float32 sums
  of the members in another order; rotated IoUs within 1e-6).
- ``Anchor3DHead.get_bboxes(use_wnms=True)`` on seeded predictions over a
  16 x 16 grid: the whole grid decoded, the direction classifier, then
  the weighted NMS; the same tolerances.
- The CenterHead of JAX's ``ch_setup`` (32 x 32 BEV, three tasks) with
  the flax variables (random running statistics) carried over by
  ``convert.py``: ``gaussian_radius`` within rtol 1e-6, ``heatmap_targets``
  within 1e-6 and its centre masks exactly, the train-mode loss within
  rtol 1e-5, every gradient leaf within 1e-4 of its largest magnitude plus
  rtol 1e-4, the running statistics within 1e-5; ``get_bboxes`` on JAX's
  head outputs with rotated NMS and with circle NMS, every output as in
  the weighted NMS.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sst_tpu.core import nms as jnms
from sst_tpu.models.heads import center_head as jch
from sst_tpu.models.heads.anchor3d import Anchor3DHead as JAnchorHead
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.core import nms as tnms
from sst_tpu_torch.models.heads import center_head as tch
from sst_tpu_torch.models.heads.anchor3d import Anchor3DHead
from torch_threads import torch_threads_per_worker  # noqa: F401

BOX_TOL, SCORE_TOL = 2e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _clusters(rng, n_clusters=8, per=6):
    """Boxes in clusters of ``per`` heavily overlapping cars, score-sorted
    descending, and their scores."""
    centres = rng.uniform(-30, 30, (n_clusters, 2))
    rows = []
    for c in centres:
        xy = c + rng.normal(0, 0.35, (per, 2))
        rows.append(np.concatenate([
            xy, rng.uniform(-1.2, -0.8, (per, 1)),
            rng.uniform(1.8, 2.2, (per, 1)), rng.uniform(4.2, 4.8, (per, 1)),
            rng.uniform(1.4, 1.7, (per, 1)),
            rng.uniform(0.2, 0.5, (per, 1))], -1))
    boxes = np.concatenate(rows).astype(np.float32)
    scores = np.sort(rng.uniform(0.05, 0.95, len(boxes)))[::-1].astype(
        np.float32)
    return boxes, scores


def _assert_results(got: dict, ref: dict):
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(ref["boxes"]),
                               atol=BOX_TOL, rtol=0)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=SCORE_TOL,
                               rtol=0)


def _iou_margin(boxes, thrs):
    """The smallest distance of JAX's pairwise rotated IoUs to any
    threshold: the seeded cases keep clear of a near tie."""
    from sst_tpu.core.iou import boxes_iou_bev

    iou = np.asarray(jax.jit(boxes_iou_bev)(boxes[:, :7], boxes[:, :7]))
    return min(np.abs(iou - t).min() for t in thrs)


def test_circle_nms_matches_jax():
    centres = np.asarray([[0, 0], [0.5, 0], [10, 10]], np.float32)
    keep = tnms.circle_nms(_t(centres), _t([0.9, 0.8, 0.7]),
                           torch.ones(3, dtype=torch.bool), 1.0)
    assert keep.tolist() == [True, False, True]
    rng = np.random.RandomState(1)
    c = rng.uniform(-6, 6, (96, 2)).astype(np.float32)
    valid = rng.rand(96) > 0.1
    s = np.sort(rng.rand(96))[::-1].astype(np.float32)
    ref = np.asarray(jax.jit(jnms.circle_nms)(c, s, valid, 1.5))
    got = tnms.circle_nms(_t(c), _t(s), _t(valid), 1.5)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 10 < ref.sum() < valid.sum()


def test_weighted_nms_matches_jax():
    boxes = np.asarray([[0, 0, 0, 2, 4, 1.5, 0.0],
                        [0.2, 0.0, 0, 2, 4, 1.5, 0.0],
                        [10, 10, 0, 2, 4, 1.5, 0.5]], np.float32)
    merged, sc, keep = tnms.weighted_nms_bev(
        _t(boxes), _t(np.asarray([0.9, 0.6, 0.8], np.float32)),
        torch.ones(3, dtype=torch.bool), thr_lo=0.1, thr_hi=0.3)
    assert keep.tolist() == [True, False, True]
    assert 0.0 < float(merged[0, 0]) < 0.2
    np.testing.assert_allclose(merged[2].numpy(), boxes[2], atol=1e-5)

    rng = np.random.RandomState(2)
    boxes, scores = _clusters(rng)
    valid = rng.rand(len(boxes)) > 0.1
    assert _iou_margin(boxes, (0.1, 0.7)) > 1e-4
    fn = jax.jit(jnms.weighted_nms_bev, static_argnames=(
        "thr_lo", "thr_hi", "use_rotate_nms", "chunk"))
    rm, rs, rk = fn(boxes, scores, valid, thr_lo=0.1, thr_hi=0.7)
    gm, gs, gk = tnms.weighted_nms_bev(_t(boxes), _t(scores), _t(valid),
                                       0.1, 0.7)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    np.testing.assert_allclose(gm.numpy(), np.asarray(rm), atol=BOX_TOL,
                               rtol=0)
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), atol=SCORE_TOL,
                               rtol=0)
    # merges happened: kept boxes moved, their scores re-weighted
    moved = np.abs(np.asarray(rm) - boxes).max(-1) > 1e-3
    assert (moved & np.asarray(rk)).sum() >= 4


@pytest.mark.parametrize("case", ["jax_test", "clusters"])
def test_multiclass_wnms_matches_jax(case):
    # seed 10: the first whose clusters keep 1e-4 from both thresholds
    rng = np.random.RandomState(0 if case == "jax_test" else 10)
    if case == "jax_test":
        n = 64
        boxes = np.concatenate(
            [rng.uniform(-30, 30, (n, 2)), rng.uniform(-1, 0, (n, 1)),
             rng.uniform(1.5, 4, (n, 3)), rng.uniform(-3, 3, (n, 1))],
            1).astype(np.float32)
    else:
        boxes, _ = _clusters(rng, n_clusters=10, per=7)
        boxes = boxes[rng.permutation(len(boxes))]
        n = len(boxes)
    scores = rng.rand(n, 3).astype(np.float32)
    assert _iou_margin(boxes, (0.1, 0.7)) > 1e-4
    kw = dict(num_classes=3, score_thr=0.05, nms_thr=0.25, nms_pre=32,
              max_num=16, use_wnms=True)
    ref = jnms.box3d_multiclass_nms(boxes, scores, np.ones(n, bool), **kw)
    got = tnms.box3d_multiclass_nms(_t(boxes), _t(scores),
                                    torch.ones(n, dtype=torch.bool), **kw)
    _assert_results(got, ref)
    assert int(got["valid"].sum()) > 4


def test_anchor_head_wnms_decode_matches_jax():
    """The wnms path of ``get_bboxes``: every anchor of a 16 x 16 grid (3
    classes x 2 rotations) decoded, the direction classifier's half turn,
    the weighted NMS per class."""
    half = 6.4
    ranges = ((-half, -half, -0.0345, half, half, -0.0345),
              (-half, -half, -0.1188, half, half, -0.1188),
              (-half, -half, 0.0, half, half, 0.0))
    jh = JAnchorHead(num_classes=3, anchor_ranges=ranges)
    th = Anchor3DHead(num_classes=3, feat_channels=8, anchor_ranges=ranges)
    h = w = 16
    rng = np.random.RandomState(3)
    preds = {"cls": rng.normal(-1.0, 1.5, (2, h, w, 6, 3)),
             "reg": rng.normal(0, 0.1, (2, h, w, 6, 7)),
             "dir": rng.normal(0, 1, (2, h, w, 6, 2))}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    janchors = np.asarray(jh.grid_anchors((h, w)))
    tanchors = th.grid_anchors((h, w))
    np.testing.assert_allclose(tanchors.numpy(), janchors, atol=1e-6)
    kw = dict(score_thr=0.1, nms_thr=0.25, nms_pre=64, max_num=32,
              use_wnms=True, wnms_thr_lo=0.1, wnms_thr_hi=0.7)
    ref = jax.jit(lambda p, a: jh.get_bboxes(p, a, **kw))(preds, janchors)
    got = th.get_bboxes({k: _t(v) for k, v in preds.items()}, tanchors, **kw)
    _assert_results(got, ref)
    assert int(got["valid"].sum()) > 10


# --------------------------------------------------------------- CenterHead

PCR = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0)
HEAD_KW = dict(share_conv_channel=16, head_conv=16,
               common_heads=(("reg", 2, 1), ("height", 1, 1), ("dim", 3, 1),
                             ("rot", 2, 1)),
               point_cloud_range=PCR, voxel_size=(0.5, 0.5, 6.0),
               max_objs=16)


def _gt(rng, b=2, g=6):
    boxes = np.concatenate(
        [rng.uniform(-6, 6, (b, g, 2)), np.full((b, g, 1), -0.5),
         rng.uniform(1, 4, (b, g, 3)), rng.uniform(-3, 3, (b, g, 1))],
        -1).astype(np.float32)
    boxes[0, 0, :2] = (-7.5, 2.0)  # a centre on a pixel edge
    labels = rng.randint(0, 3, (b, g)).astype(np.int32)
    labels[:, :3] = (0, 1, 2)  # every task has a box
    valid = np.ones((b, g), bool)
    valid[1, -1] = False
    return boxes, labels, valid


@pytest.fixture(scope="module")
def heads():
    rng = np.random.RandomState(0)
    jhead = jch.CenterHead(in_channels=32, **HEAD_KW)
    bev = rng.randn(2, 32, 32, 32).astype(np.float32)
    variables = jax.jit(lambda x: jhead.init(jax.random.PRNGKey(0), x))(bev)
    v = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    v = {k: dict(x) for k, x in v.items()}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            v["batch_stats"])[0]:
        leaf[...] = (rng.randn(*leaf.shape) * 0.1 if path[-1].key == "mean"
                     else rng.uniform(0.5, 1.5, leaf.shape))
    thead = load_flax_variables(tch.CenterHead(in_channels=32, **HEAD_KW), v)
    return jhead, v, thead, bev, _gt(rng)


def test_gaussian_radius_matches_jax():
    wl = np.random.RandomState(4).uniform(0.5, 30, (200, 2)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jch.gaussian_radius)(wl))
    got = tch.gaussian_radius(_t(wl)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # each root halved, not divided by 2a: the quirk is kept
    assert (got > 0).all()


@pytest.mark.parametrize("task", [0, 1, 2])
def test_heatmap_targets_match_jax(heads, task):
    jhead, _, thead, _, (gb, gl, gv) = heads
    ref_hm, ref_pos = jax.jit(lambda b, l, v: jhead.heatmap_targets(
        (32, 32), b, l, v, task))(gb, gl, gv)
    hm, pos = thead.heatmap_targets((32, 32), _t(gb), _t(gl), _t(gv), task)
    np.testing.assert_allclose(hm.numpy(), np.asarray(ref_hm), atol=1e-6)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))
    assert float(hm.max()) > 0.9 and int(pos.sum()) >= 2


def test_center_head_loss_and_grads_match_jax(heads):
    jhead, v, thead, bev, (gb, gl, gv) = heads

    def loss_fn(params, stats):
        outs, mut = jhead.apply({"params": params, "batch_stats": stats},
                                bev, train=True, mutable=["batch_stats"])
        parts = jhead.loss(outs, gb, gl, gv)
        return sum(parts.values()), (parts, mut["batch_stats"])

    (_, (jparts, jstats)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v["batch_stats"])
    thead.train()
    tparts = thead.loss(thead(_t(bev).permute(0, 3, 1, 2), train=True),
                        _t(gb), _t(gl), _t(gv))
    sum(tparts.values()).backward()
    assert sorted(tparts) == sorted(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k].detach()),
                                   float(jparts[k]),
                                   rtol=1e-5, err_msg=k)
    n = 0
    for path, ref in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        keys = [p.key for p in path]
        mod = thead.get_submodule(".".join(keys[:-1]))
        t = mod.bias if keys[-1] == "bias" else mod.weight
        got = t.grad.numpy()
        ref = np.asarray(ref)
        if keys[-1] == "kernel":
            got = got.transpose(2, 3, 1, 0)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg="/".join(keys))
        n += 1
    assert n == sum(1 for _ in thead.parameters())
    for path, ref in jax.tree_util.tree_flatten_with_path(jstats)[0]:
        keys = [p.key for p in path]
        mod = thead.get_submodule(".".join(keys[:-1]))
        got = getattr(mod, f"running_{keys[-1]}").numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg="/".join(keys))


@pytest.mark.parametrize("circle", [False, True])
def test_center_head_decode_matches_jax(heads, circle):
    """``get_bboxes`` on JAX's eval-mode head outputs: the 3x3 max-pool
    peaks, the top-k over H * W * C, the decode, then rotated or circle
    NMS."""
    jhead, v, thead, bev, _ = heads
    kw = dict(nms_pre=64, max_num=32, use_circle_nms=circle)

    def run(x):
        outs = jhead.apply(v, x, train=False)
        return outs, jhead.get_bboxes(outs, **kw)

    jouts, ref = jax.jit(run)(bev)
    outs = [{k: _t(np.asarray(x)) for k, x in o.items()} for o in jouts]
    got = thead.get_bboxes(outs, **kw)
    _assert_results(got, ref)
    assert int(got["valid"].sum()) > 8
    # the port's own forward gives the same head maps (a fresh copy: the
    # loss test's train-mode forward moved the fixture's statistics)
    fresh = load_flax_variables(tch.CenterHead(in_channels=32, **HEAD_KW), v)
    with torch.no_grad():
        mine = fresh.eval()(_t(bev).permute(0, 3, 1, 2))
    for t_out, j_out in zip(mine, jouts):
        for k in j_out:
            np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
