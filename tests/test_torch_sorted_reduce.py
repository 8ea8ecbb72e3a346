"""The sorted segment reduce of the port (sst_tpu_torch/ops/sorted_reduce.py).

On the CPU the wrapper dispatches to the plain PyTorch twin, which is held
against the JAX package's Pallas kernel run in interpret mode, on the cases
of tests/test_sorted_reduce.py, at rtol/atol 1e-5 (the same bound that file
uses: both sides sum in f32 in different orders; max is order-free).

The CUDA kernel itself runs only on a GPU: see test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.ops.segment import unique_segments
from sst_tpu.ops.sorted_reduce import sorted_segment_reduce as jax_sorted
from sst_tpu_torch.ops import sorted_reduce as sr
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _mk(n, v, c, seed, frac_invalid=0.1):
    """Rows sorted by dense segment id, as the voxel sort hands them over."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, v * 3, n).astype(np.int32)
    valid = rng.rand(n) > frac_invalid
    uniq = unique_segments(jnp.asarray(keys), jnp.asarray(valid), v)
    order = np.asarray(uniq.order)
    data = rng.randn(n, c).astype(np.float32)
    return data[order], np.asarray(uniq.seg_ids)[order]


@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("n,v,c,block", [
    (700, 300, 24, 128),    # generic ragged sizes, multi-chunk blocks
    (256, 700, 64, 128),    # more segments than rows (sparse occupancy)
    (1024, 64, 8, 256),     # big segments spanning many chunks
])
def test_twin_matches_pallas_kernel(mode, n, v, c, block):
    data, seg = _mk(n, v, c, seed=n + v)
    ref = jax_sorted(jnp.asarray(data), jnp.asarray(seg), v, mode, block,
                     True)
    sr.reset_launch_counts()
    got = sr.sorted_segment_reduce(torch.from_numpy(data),
                                   torch.from_numpy(seg), v, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the CPU dispatch never launches the kernel
    assert sr.launches == 0 and sr.launch_counts == {}


def test_all_invalid_and_empty_segments():
    n, v, c = 128, 256, 16
    data = torch.ones((n, c))
    seg = torch.full((n,), v, dtype=torch.int32)  # everything dropped
    for mode in ("max", "sum"):
        out = sr.sorted_segment_reduce(data, seg, v, mode)
        ref = jax_sorted(jnp.asarray(data.numpy()), jnp.asarray(seg.numpy()),
                         v, mode, 128, True)
        np.testing.assert_array_equal(out.numpy(), 0.0)
        np.testing.assert_array_equal(np.asarray(ref), 0.0)


def test_negative_ids_dropped_and_negative_maxima_kept():
    seg = torch.tensor([-3, -1, 0, 0, 2, 2, 2, 5, 9], dtype=torch.int32)
    data = -torch.arange(1.0, 10.0)[:, None].repeat(1, 3)
    out = sr.sorted_segment_reduce(data, seg, 4, "max")
    np.testing.assert_array_equal(out[:, 0].numpy(), [-3.0, 0.0, -5.0, 0.0])
    ref = jax_sorted(jnp.asarray(data.numpy()), jnp.asarray(seg.numpy()), 4,
                     "max", 128, True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_nan_stays_in_its_segment():
    # a NaN touches no other segment: a segment holding one reads NaN in
    # that channel for sum, and 0 for max (JAX ``segment_reduce`` zeroes
    # every non-finite maximum). Held against numpy.
    seg = np.array([-1, 0, 0, 1, 1, 1, 3, 3, 5], np.int32)
    data = np.arange(36, dtype=np.float32).reshape(9, 4) - 20.0
    for r, c in ((0, 1), (1, 2), (4, 0), (8, 3)):
        data[r, c] = np.nan
    for mode, fn in (("max", np.max), ("sum", np.sum)):
        want = np.zeros((4, 4), np.float32)
        for s in range(4):
            rows = data[seg == s]
            if len(rows):
                want[s] = fn(rows, axis=0)
        if mode == "max":
            want = np.where(np.isfinite(want), want, 0.0)
        got = sr.sorted_segment_reduce(torch.from_numpy(data),
                                       torch.from_numpy(seg), 4, mode)
        np.testing.assert_array_equal(got.numpy(), want)


def _non_finite_rows():
    """Sorted rows whose segments hold NaN, +inf and -inf beside finite
    values, and one segment of -inf only."""
    seg = np.array([0, 0, 1, 1, 2, 2, 3, 4, 4, 6, 6, 6], np.int32)
    data = np.tile(np.arange(12, dtype=np.float32)[:, None] - 5.0, (1, 3))
    data[1, 0] = np.nan
    data[3, 1] = np.inf
    data[5, 2] = -np.inf
    data[6, :] = -np.inf
    data[8, 0] = np.nan
    data[10, 1] = np.inf
    return data, seg


@pytest.mark.parametrize("fn", ["segment_reduce", "sorted_segment_reduce"])
def test_non_finite_maxima_read_zero_as_in_jax(fn):
    from sst_tpu.ops.segment import segment_reduce as jax_segment_reduce
    from sst_tpu_torch.ops.segment import segment_reduce

    data, seg = _non_finite_rows()
    ref = np.asarray(jax_segment_reduce(jnp.asarray(data), jnp.asarray(seg),
                                        8, "max"))
    port = segment_reduce if fn == "segment_reduce" else \
        sr.sorted_segment_reduce
    got = port(torch.from_numpy(data), torch.from_numpy(seg), 8, "max")
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isfinite(ref).all() and (ref == 0).sum() > 8  # zeros written
    if fn == "segment_reduce":
        ref_min = np.asarray(jax_segment_reduce(
            jnp.asarray(data), jnp.asarray(seg), 8, "min"))
        got_min = segment_reduce(torch.from_numpy(data),
                                 torch.from_numpy(seg), 8, "min")
        np.testing.assert_array_equal(got_min.numpy(), ref_min)


@pytest.mark.parametrize("bad,err", [
    (dict(data=torch.ones(8, 2, dtype=torch.float64)), TypeError),
    (dict(seg=torch.zeros(8, dtype=torch.int64)), TypeError),
    (dict(data=torch.ones(8, 4)[:, ::2]), ValueError),   # not contiguous
    (dict(seg=torch.zeros(7, dtype=torch.int32)), ValueError),
    (dict(mode="mean"), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    args = dict(data=torch.ones(8, 2), seg=torch.zeros(8, dtype=torch.int32),
                num_segments=4, mode="sum")
    args.update(bad)
    with pytest.raises(err):
        sr.sorted_segment_reduce(**args)


def _ids(case):
    """Nondecreasing int32 ids and the segment count of an offsets case."""
    rng = np.random.RandomState(len(case))
    if case == "gaps between ids":
        return np.sort((np.arange(700) // 7 * 5).astype(np.int32)), 520
    if case == "ids < 0 and >= num_segments":
        return np.sort(rng.randint(-50, 700, 900)).astype(np.int32), 600
    if case == "one long segment":
        seg = np.zeros(4000, np.int32)
        seg[3000:] = 1
        return seg, 4
    if case == "all rows dropped":
        return np.full(300, 300, np.int32), 300
    if case == "mostly empty, as the VFE's trailing voxel slots":
        seg = np.sort(rng.randint(0, 90, 2000)).astype(np.int32)
        seg[1800:] = 1000  # invalid points carry num_segments
        return seg, 1000
    return np.zeros(0, np.int32), 17  # no rows


OFFSET_CASES = ["gaps between ids", "ids < 0 and >= num_segments",
                "one long segment", "all rows dropped",
                "mostly empty, as the VFE's trailing voxel slots", "no rows"]


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_segment_offsets_match_numpy_searchsorted(case):
    """Exactly: offsets[s] is the first row whose id is >= s, so segment s
    is rows offsets[s] to offsets[s + 1] and ids outside [0, S) fall
    outside every range."""
    seg, v = _ids(case)
    sr.reset_launch_counts()
    got = sr.segment_offsets(torch.from_numpy(seg), v)
    assert got.dtype == torch.int32 and got.shape == (v + 1,)
    np.testing.assert_array_equal(
        got.numpy(), np.searchsorted(seg, np.arange(v + 1), side="left"))
    assert sr.offsets_launches == 0  # CPU tensors take the twin
    counts = np.diff(got.numpy())
    keep = (seg >= 0) & (seg < v)
    np.testing.assert_array_equal(counts, np.bincount(seg[keep],
                                                      minlength=v))


def test_given_offsets_are_checked_and_change_nothing():
    """The VFE passes one offsets array to its three reductions: on the CPU
    the twin reads ``seg`` and the result is the same; an offsets array of
    another shape or type is refused before any launch."""
    data, seg = _mk(700, 300, 24, seed=9)
    data, seg = torch.from_numpy(data), torch.from_numpy(seg)
    offsets = sr.segment_offsets(seg, 300)
    for mode in ("sum", "max"):
        torch.testing.assert_close(
            sr.sorted_segment_reduce(data, seg, 300, mode, offsets),
            sr.sorted_segment_reduce(data, seg, 300, mode), rtol=0, atol=0)
    for bad in (offsets[:-1], offsets.long()):
        with pytest.raises(ValueError):
            sr.sorted_segment_reduce(data, seg, 300, "sum", bad)
