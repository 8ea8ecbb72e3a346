"""Parity of the port's sort/segment primitives and dynamic voxelization
(sst_tpu_torch/ops/segment.py, ops/voxelize.py) with the JAX package.

The same numpy inputs go to both. Integer outputs must match exactly;
float outputs to 1e-6 (both sides reduce in f32, in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.ops import segment as jseg
from sst_tpu.ops import voxelize as jvox
from sst_tpu_torch.ops import segment as tseg
from sst_tpu_torch.ops import voxelize as tvox

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _keys(n, key_range, seed, frac_invalid=0.2):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, key_range, n).astype(np.int32)
    valid = rng.rand(n) > frac_invalid
    return keys, valid


def _assert_unique_equal(j, t, with_ranks=True):
    np.testing.assert_array_equal(np.asarray(j.seg_ids), t.seg_ids.numpy())
    np.testing.assert_array_equal(np.asarray(j.unique_keys),
                                  t.unique_keys.numpy())
    np.testing.assert_array_equal(np.asarray(j.counts), t.counts.numpy())
    assert int(j.num_unique) == int(t.num_unique)
    np.testing.assert_array_equal(np.asarray(j.valid), t.valid.numpy())
    if with_ranks:
        np.testing.assert_array_equal(np.asarray(j.ranks), t.ranks.numpy())


@pytest.mark.parametrize("n,key_range,num_segments", [
    (500, 200, 256),   # capacity to spare
    (500, 2000, 64),   # capacity overflow: ids past the cap map to the end
    (64, 5, 8),        # long runs of equal keys
])
def test_unique_segments(n, key_range, num_segments):
    keys, valid = _keys(n, key_range, seed=n + key_range)
    j = jseg.unique_segments(jnp.asarray(keys), jnp.asarray(valid),
                             num_segments)
    t = tseg.unique_segments(torch.from_numpy(keys), torch.from_numpy(valid),
                             num_segments)
    _assert_unique_equal(j, t)
    np.testing.assert_array_equal(np.asarray(j.order), t.order.numpy())
    assert t.seg_ids.dtype == t.ranks.dtype == t.unique_keys.dtype \
        == torch.int32


@pytest.mark.parametrize("n,key_space,num_segments", [
    (500, 1000, 512), (500, 3000, 64)])
def test_unique_segments_canvas(n, key_space, num_segments):
    keys, valid = _keys(n, key_space, seed=key_space)
    j = jseg.unique_segments_canvas(jnp.asarray(keys), jnp.asarray(valid),
                                    num_segments, key_space)
    t = tseg.unique_segments_canvas(torch.from_numpy(keys),
                                    torch.from_numpy(valid), num_segments,
                                    key_space)
    _assert_unique_equal(j, t)
    assert t.order is None and j.order is None


@pytest.mark.parametrize("mode", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("squeeze", [False, True])
def test_segment_reduce(mode, squeeze):
    rng = np.random.RandomState(7)
    n, v = 400, 50
    # ids == v are dropped; some segments stay empty; values of both signs,
    # plus one segment of only negative values (its max must stay negative)
    seg = rng.randint(0, v + 1, n).astype(np.int32)
    seg[seg == 3] = 4
    data = rng.randn(n, 6).astype(np.float32)
    data[seg == 7] = -np.abs(data[seg == 7]) - 1.0
    if squeeze:
        data = data[:, 0]
    j = jseg.segment_reduce(jnp.asarray(data), jnp.asarray(seg), v, mode)
    t = tseg.segment_reduce(torch.from_numpy(data), torch.from_numpy(seg), v,
                            mode)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), **FLOAT_TOL)
    empty = np.setdiff1d(np.arange(v), seg)
    assert len(empty) and (t.numpy()[empty] == 0).all()
    if mode == "max":
        assert (t.numpy()[7] < 0).all()


def test_gather_segments():
    rng = np.random.RandomState(1)
    vox = rng.randn(30, 5).astype(np.float32)
    seg = rng.randint(0, 34, 200).astype(np.int32)  # ids >= 30 get fill
    for fill in (0.0, -2.5):
        j = jseg.gather_segments(jnp.asarray(vox), jnp.asarray(seg), fill)
        t = tseg.gather_segments(torch.from_numpy(vox), torch.from_numpy(seg),
                                 fill)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("n,rows", [(50, 4000), (5000, 300)])
def test_gather_rows_fills_and_scatters_its_gradient(n, rows):
    """``gather_rows`` (JAX's gather through an inverse table; no JAX
    counterpart): rows read their source, or the fill where the index lies
    outside the sources (with more and with fewer rows than sources); each
    source's gradient is that of the one row that read it, 0 for a source
    no row read, exactly."""
    rng = np.random.RandomState(3)
    src = torch.from_numpy(rng.randn(n, 3).astype(np.float32))
    index = np.full(rows, n, np.int32)  # most rows are padding
    index[::7] = -1
    used = rng.choice(n, 30, replace=False)
    slots = rng.choice(rows, 30, replace=False)
    index[slots] = used
    src.requires_grad_()
    out = tseg.gather_rows(src, torch.from_numpy(index), fill=-3.0)
    want = np.full((rows, 3), -3.0, np.float32)
    want[slots] = src.detach().numpy()[used]
    np.testing.assert_array_equal(out.detach().numpy(), want)
    g = rng.randn(rows, 3).astype(np.float32)
    out.backward(torch.from_numpy(g))
    want_grad = np.zeros((n, 3), np.float32)
    want_grad[used] = g[slots]
    np.testing.assert_array_equal(src.grad.numpy(), want_grad)


@pytest.mark.parametrize("voxel_size,need_ranks,sorts", [
    ((0.5, 0.5, 0.5), False, False),   # 12x16x16 grid → canvas unique
    ((0.5, 0.5, 0.5), True, True),     # forced sort
    ((0.05, 0.05, 0.05), False, True),  # 120x160x160 > 2**21 → sort
])
def test_dynamic_voxelize(voxel_size, need_ranks, sorts):
    rng = np.random.RandomState(3)
    n, b = 1500, 2
    pts = np.concatenate([rng.uniform(-4.5, 4.5, (n, 2)),
                          rng.uniform(-2.5, 4.5, (n, 1)),
                          rng.rand(n, 2)], -1).astype(np.float32)
    bidx = rng.randint(0, b, n).astype(np.int32)
    valid = rng.rand(n) > 0.1
    pcr = (-4.0, -4.0, -2.0, 4.0, 4.0, 4.0)
    j = jvox.dynamic_voxelize(jnp.asarray(pts), jnp.asarray(bidx),
                              jnp.asarray(valid), pcr, voxel_size, 700, b,
                              need_ranks=need_ranks)
    t = tvox.dynamic_voxelize(torch.from_numpy(pts), torch.from_numpy(bidx),
                              torch.from_numpy(valid), pcr, voxel_size, 700,
                              b, need_ranks=need_ranks)
    assert (t.unique.order is not None) == sorts
    assert t.grid == j.grid and t.batch_size == j.batch_size
    for name in ("coords", "keys", "valid", "voxel_coords", "voxel_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(t, name).numpy(), err_msg=name)
    _assert_unique_equal(j.unique, t.unique, with_ranks=sorts)
    assert 0 < int(t.voxel_valid.sum()) <= 700
