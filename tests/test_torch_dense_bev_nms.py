"""Parity of the port's dense-BEV modules (models/dense_bev.py), rotated BEV
IoU (core/iou.py) and multiclass NMS (core/nms.py) with the JAX package.

Dense-BEV modules at 1e-4: XLA and torch accumulate the convolutions in
different orders. IoU at 1e-5 (same f32 formula, elementwise). NMS keep sets,
labels and valid masks must match exactly; boxes and scores under ``valid``
at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.core.iou import boxes_iou_bev as jax_iou
from sst_tpu.core.nms import box3d_multiclass_nms as jax_nms
from sst_tpu.models import dense_bev as fd
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.core.iou import boxes_iou_bev
from sst_tpu_torch.core.nms import box3d_multiclass_nms
from sst_tpu_torch.models import dense_bev as td
from torch_threads import torch_threads_per_worker  # noqa: F401

BEV_TOL = dict(rtol=1e-4, atol=1e-4)


def _reference(fm, arrays, *static):
    """flax ``fm``'s variables (``_numpy_vars`` of its init) and its output
    on ``arrays`` followed by the non-array arguments ``static``: the init
    and the apply each jitted (run op by op they took seconds apiece)."""
    v = _numpy_vars(jax.jit(lambda *a: fm.init(
        jax.random.PRNGKey(0), *a, *static))(*arrays))
    return v, jax.jit(lambda v, *a: fm.apply(v, *a, *static))(v, *arrays)


def _numpy_vars(variables, seed=0):
    rng = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    out = {k: dict(v) for k, v in out.items()}

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "mean":
                tree[k] = (rng.randn(*v.shape) * 0.2).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k == "z_embed":  # large enough to push features negative
                tree[k] = rng.randn(*v.shape).astype(np.float32)

    for coll in out.values():
        perturb(coll)
    return out


def _voxels(n, b, nz, h, w, seed, unique_zyx=False):
    rng = np.random.RandomState(seed)
    if unique_zyx:
        flat = rng.choice(b * nz * h * w, n, replace=False)
        coords = np.stack(np.unravel_index(flat, (b, nz, h, w)), -1)
    else:
        coords = np.stack([rng.randint(0, b, n), rng.randint(0, nz, n),
                           rng.randint(0, h, n), rng.randint(0, w, n)], -1)
    valid = rng.rand(n) > 0.15
    coords = np.where(valid[:, None], coords, -1).astype(np.int32)
    return coords, valid


@pytest.mark.parametrize("z_groups,pre", [(1, 0), (2, 6)])
def test_bev_scatter(z_groups, pre):
    rng = np.random.RandomState(z_groups)
    n, c, nz, b, hw = 90, 8, 4, 2, (6, 5)
    feats = rng.randn(n, c).astype(np.float32)  # negatives: clamped to 0
    coords, valid = _voxels(n, b, nz, *hw, seed=1)
    fm = fd.BEVScatter(nz=nz, z_groups=z_groups, pre_channels=pre)
    v, ref = _reference(fm, (jnp.asarray(feats), jnp.asarray(coords),
                             jnp.asarray(valid)), b, hw)
    ref = np.asarray(ref)
    tm = load_flax_variables(td.BEVScatter(c, nz, z_groups, pre), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(coords),
                 torch.from_numpy(valid), b, hw).numpy()
    assert got.shape == ref.shape == (b, *hw, tm.out_channels)
    np.testing.assert_allclose(got, ref, **BEV_TOL)
    assert (got >= 0).all() and got.max() > 0


def test_dense_bev_unet():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    kw = dict(encoder_channels=((8, 8), (16, 16), (16, 16)),
              decoder_channels=(16, 8), out_channels=8)
    fm = fd.DenseBEVUNet(**kw)
    v, (ref_out, ref_maps) = _reference(fm, (jnp.asarray(x),))
    tm = load_flax_variables(td.DenseBEVUNet(4, **kw), v)
    with torch.no_grad():
        out, maps = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **BEV_TOL)
    assert len(maps) == len(ref_maps) == 2
    for got, ref in zip(maps, ref_maps):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **BEV_TOL)


@pytest.mark.parametrize("z_groups", [1, 2])
def test_dense_voxel_decode(z_groups):
    rng = np.random.RandomState(5)
    nz, gc = 4, 5
    c = z_groups * gc if z_groups > 1 else 6
    bev = rng.randn(2, 6, 5, c).astype(np.float32)
    coords, valid = _voxels(70, 2, nz, 6, 5, seed=2)
    fm = fd.DenseVoxelDecode(nz=nz, out_channels=8, z_groups=z_groups,
                             group_channels=gc)
    v, ref = _reference(fm, (jnp.asarray(bev), jnp.asarray(coords),
                             jnp.asarray(valid)))
    ref = np.asarray(ref)
    tm = load_flax_variables(td.DenseVoxelDecode(c, nz, 8, z_groups, gc), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(bev), torch.from_numpy(coords),
                 torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, ref, **BEV_TOL)


def test_dense_bev_mixer():
    rng = np.random.RandomState(6)
    n, c, nz, b, hw = 120, 8, 4, 2, (8, 8)
    feats = rng.randn(n, c).astype(np.float32)
    coords, valid = _voxels(n, b, nz, *hw, seed=3, unique_zyx=True)
    kw = dict(z_channels=4, output_channels=8,
              encoder_channels=((8, 8), (8, 8)), decoder_channels=(8,))
    fm = fd.DenseBEVMixer(nz=nz, **kw)
    v, ref = _reference(fm, (jnp.asarray(feats), jnp.asarray(coords),
                             jnp.asarray(valid)), b, hw)
    ref = np.asarray(ref)
    tm = load_flax_variables(td.DenseBEVMixer(c, nz, **kw), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(coords),
                 torch.from_numpy(valid), b, hw).numpy()
    np.testing.assert_allclose(got, ref, **BEV_TOL)
    assert np.abs(got).sum() > 0


def _boxes(n, seed, spread=6.0):
    rng = np.random.RandomState(seed)
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1, 1, (n, 1)),
        rng.uniform(0.5, 4.0, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
    ], -1).astype(np.float32)


def test_boxes_iou_bev():
    a = _boxes(20, 0, spread=3.0)
    b = np.concatenate([_boxes(25, 1, spread=3.0), a[:3]])  # identical pairs
    ref = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b)))
    got = boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.diag(got[:3, -3:]), 1.0, atol=1e-5)
    assert (got > 0.05).sum() > 10  # the case has real overlaps


def _nms_both(boxes, scores, valid, **kw):
    ref = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                  **kw)
    got = box3d_multiclass_nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores),
                               torch.from_numpy(valid), **kw)
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()})


def _assert_nms_equal(ref, got):
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    m = ref["valid"]
    np.testing.assert_array_equal(got["labels"][m], ref["labels"][m])
    np.testing.assert_allclose(got["boxes"][m], ref["boxes"][m], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["scores"][m], ref["scores"][m], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("use_rotate_nms", [True, False])
def test_box3d_multiclass_nms(use_rotate_nms):
    rng = np.random.RandomState(7)
    n = 300
    boxes = _boxes(n, 8, spread=5.0)  # dense: many overlaps to suppress
    scores = rng.rand(n, 3).astype(np.float32)
    valid = rng.rand(n) > 0.1
    ref, got = _nms_both(boxes, scores, valid, num_classes=3, score_thr=0.2,
                         nms_thr=0.25, nms_pre=64, max_num=100,
                         use_rotate_nms=use_rotate_nms)
    _assert_nms_equal(ref, got)
    assert 0 < ref["valid"].sum() < 3 * 64  # some kept, some suppressed


def test_nms_alternating_chain():
    """Each box overlaps only its neighbours, scores descend along the
    chain: greedy keeps every other box (a fixed point needs the whole
    chain's depth of rounds)."""
    k = 21
    boxes = np.zeros((k, 7), np.float32)
    boxes[:, 0] = np.arange(k) * 0.6  # 1 m boxes 0.6 m apart: IoU 0.25
    boxes[:, 3:6] = 1.0
    scores = np.zeros((k, 3), np.float32)
    scores[:, 1] = np.linspace(0.9, 0.5, k)
    valid = np.ones(k, bool)
    ref, got = _nms_both(boxes, scores, valid, num_classes=3, score_thr=0.1,
                         nms_thr=0.2, nms_pre=32, max_num=32)
    _assert_nms_equal(ref, got)
    kept = np.sort(got["boxes"][got["valid"]][:, 0])
    np.testing.assert_allclose(kept, np.arange(0, k, 2) * 0.6, atol=1e-6)
