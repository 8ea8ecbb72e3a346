"""The port's SST window plan (sst_tpu_torch/ops/window.py,
models/sst_input.py) and the window MHA twin (ops/window_mha.py) against the
JAX package.

The plan is integer bookkeeping: window ids, drop levels, seats, the
slot -> row tables, pads and the seat-trimmed count must equal JAX's
exactly, on tiny_sst's voxels and on configurations whose window caps and
window table overflow and whose windows hold more voxels than seats. The
position embedding is f32 arithmetic in another library: within 1e-6.

The window MHA twin is held against the Pallas kernel in interpret mode on
valid query rows, at 1 bf16 ulp of the output (rtol 2^-7) plus an
allowance of 2^-8 * max|v| for a bf16(p) that rounds the other way because
the f32 logits or row sums were summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu.models import sst_input as jin
from sst_tpu.ops import window as jwin
from sst_tpu.ops.pallas_attention import _window_mha_fwd_impl
from sst_tpu.ops.voxelize import dynamic_voxelize as j_voxelize
from sst_tpu_torch.models import sst_input as tin
from sst_tpu_torch.ops import window as twin
from sst_tpu_torch.ops import window_mha as wm

TINY = dict(window_shape=(4, 4), max_total_windows=128,
            buckets=((8, 0, 8, 64), (16, 8, 100000, 32)))
CASES = {
    "tiny_sst": TINY,
    # 5 and 2 windows per bucket, a 24-window table: both caps overflow
    "caps overflow": dict(window_shape=(4, 4), max_total_windows=24,
                          buckets=((8, 0, 8, 5), (16, 8, 100000, 2))),
    # 8x8 windows hold up to 64 voxels against 16 seats: SST trims seats;
    # windows of more than 40 voxels fall outside every bucket
    "seat trim": dict(window_shape=(8, 8), max_total_windows=64,
                      buckets=((12, 0, 12, 16), (16, 12, 40, 16))),
}


def _voxels(num_points=512, seed=0):
    """tiny_sst's voxelization of tiny_batch (2 samples), as numpy."""
    jm = jflag.tiny_sst()
    batch = jflag.tiny_batch(num_points=num_points, seed=seed)
    b, p, _ = batch.points.shape
    vm = j_voxelize(batch.points.reshape(b * p, -1),
                    jnp.repeat(jnp.arange(b, dtype=jnp.int32), p),
                    batch.valid.reshape(-1), jm.point_cloud_range,
                    jm.voxel_size, jm.max_voxels, b)
    ny, nx = jm.bev_shape
    return (np.array(vm.voxel_coords), np.array(vm.voxel_valid),
            (nx, ny, 1))


def _plans(case, num_points=512):
    coords, valid, sparse_shape = _voxels(num_points)
    cfg = CASES[case]
    jb = tuple(jwin.BucketSpec(*b) for b in cfg["buckets"])
    tb = tuple(twin.BucketSpec(*b) for b in cfg["buckets"])
    jp = jin.sst_input_layer(jnp.asarray(coords), jnp.asarray(valid),
                             sparse_shape, cfg["window_shape"], jb, 32,
                             cfg["max_total_windows"])
    tp = tin.sst_input_layer(torch.from_numpy(coords),
                             torch.from_numpy(valid), sparse_shape,
                             cfg["window_shape"], tb, 32,
                             cfg["max_total_windows"])
    return coords, valid, sparse_shape, jp, tp


def _eq(got, ref, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=what)


@pytest.mark.parametrize("shift", [False, True])
def test_get_window_coors_equal_jax(shift):
    coords, valid, sparse_shape = _voxels()
    for window_shape in ((4, 4), (12, 12), (3, 5, 1)):
        jw, jc = jwin.get_window_coors(jnp.asarray(coords), sparse_shape,
                                       window_shape, shift,
                                       jnp.asarray(valid))
        tw, tc = twin.get_window_coors(torch.from_numpy(coords),
                                       sparse_shape, window_shape, shift,
                                       torch.from_numpy(valid))
        _eq(tw, jw, f"window ids {window_shape}")
        _eq(tc, jc, f"coords in window {window_shape}")
        assert tw.dtype == tc.dtype == torch.int32
    assert (coords[valid] == 0).any()  # sites at coordinate 0 are covered


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_plan_equals_jax(case):
    _, valid, _, jp, tp = _plans(case)
    for s, (jf, tf) in enumerate(zip(jp.f2w, tp.f2w)):
        for name in ("drop_lvl", "flat_inds", "valid", "coors_in_win"):
            _eq(getattr(tf, name), getattr(jf, name), f"shift {s} {name}")
        assert len(tf.inv_inds) == len(jf.inv_inds) == len(tf.buckets)
        for b, (ti, ji) in enumerate(zip(tf.inv_inds, jf.inv_inds)):
            _eq(ti, ji, f"shift {s} bucket {b} inv_inds")
        for b, (tpad, jpad) in enumerate(zip(twin.window_key_padding(tf),
                                             jwin.window_key_padding(jf))):
            _eq(tpad, jpad, f"shift {s} bucket {b} pads")
        for tpos, jpos in zip(tp.pos, jp.pos):
            np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos),
                                       rtol=0, atol=1e-6)
    _eq(tp.valid, jp.valid, "plan valid")
    assert int(tp.num_seat_trimmed) == int(jp.num_seat_trimmed)
    lost = int((valid & ~tp.valid.numpy()).sum())
    assert lost >= int(tp.num_seat_trimmed)
    if case == "caps overflow":
        assert lost > int(tp.num_seat_trimmed)  # window caps dropped voxels
    if case == "seat trim":
        assert int(tp.num_seat_trimmed) > 0


@pytest.mark.parametrize("case", ["tiny_sst", "caps overflow"])
def test_flat2window_and_back_equal_jax(case):
    _, valid, _, jp, tp = _plans(case)
    rng = np.random.RandomState(3)
    feat = rng.randn(valid.shape[0], 6).astype(np.float32)
    for jf, tf in zip(jp.f2w, tp.f2w):
        jw = jwin.flat2window(jnp.asarray(feat), jf, padding=-2.0)
        tw = twin.flat2window(torch.from_numpy(feat), tf, padding=-2.0)
        for a, b in zip(tw, jw):
            _eq(a, b, "flat2window")
        _eq(twin.window2flat(tw, tf), jwin.window2flat(jw, jf),
            "window2flat")


@pytest.mark.parametrize("d_model,window_shape,normalize", [
    (32, (4, 4), False), (128, (12, 12), False), (36, (12, 12, 1), True),
    (50, (4, 4, 3), True),  # 3 x 16 channels, 2 of zero padding
])
def test_sinusoidal_window_pos_matches_jax(d_model, window_shape,
                                           normalize):
    rng = np.random.RandomState(d_model)
    ciw = np.stack([rng.randint(0, max(window_shape[-1], 1), 300)
                    if len(window_shape) == 3 else np.zeros(300, np.int64),
                    rng.randint(0, window_shape[1], 300),
                    rng.randint(0, window_shape[0], 300)], -1).astype(
                        np.int32)
    ref = jin.sinusoidal_window_pos(jnp.asarray(ciw), window_shape, d_model,
                                    normalize=normalize)
    got = tin.sinusoidal_window_pos(torch.from_numpy(ciw), window_shape,
                                    d_model, normalize=normalize)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def mha_inputs(w, t, h, seed):
    """bf16-rounded q, k, v [W, T, 16H] as f32 numpy, and a pad mask with
    an all-padded window (0) and a one-token window (1)."""
    rng = np.random.RandomState(seed)
    c = 16 * h
    qkv = [np.array(jnp.asarray(rng.randn(w, t, c).astype(np.float32) * s)
                    .astype(jnp.bfloat16).astype(jnp.float32))
           for s in (1.0, 1.0, 2.0)]
    pad = rng.rand(w, t) > 0.6
    pad[0] = True
    pad[1] = True
    pad[1, t // 2] = False
    return qkv, pad


@pytest.mark.parametrize("t", [8, 30, 100])
@pytest.mark.parametrize("h", [2, 8])
def test_window_mha_twin_matches_pallas_kernel(t, h):
    w = 16
    (q, k, v), pad = mha_inputs(w, t, h, seed=t * 10 + h)
    ref = np.asarray(_window_mha_fwd_impl(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(pad).astype(jnp.float32), h, interpret=True)
        .astype(jnp.float32))
    wm.reset_launch_counts()
    got = wm.window_mha(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                        torch.from_numpy(pad), h)
    assert wm.launches == 0  # CPU tensors take the twin
    assert got.dtype == torch.bfloat16 and got.shape == (w, t, 16 * h)
    got = got.float().numpy()
    assert np.isfinite(got).all()  # padded rows and the all-padded window
    rows = ~pad
    tol = 2.0**-7 * np.abs(ref) + 2.0**-8 * np.abs(v).max()
    assert (np.abs(got - ref)[rows] <= tol[rows]).all()
    # most outputs agree bit for bit
    assert (got[rows] == ref[rows]).mean() > 0.99


def test_window_mha_twin_accepts_strided_views():
    """The column blocks of one [W, T, 3C] buffer give what contiguous
    copies give."""
    (q, k, v), pad = mha_inputs(4, 30, 8, seed=5)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).bfloat16()
    views = qkv.split(128, dim=-1)
    assert not views[1].is_contiguous()
    pad = torch.from_numpy(pad)
    torch.testing.assert_close(
        wm.window_mha(*views, pad, 8),
        wm.window_mha(*(x.contiguous() for x in views), pad, 8),
        rtol=0, atol=0)


def test_skipped_rows_are_all_padded_windows_and_query_tiles():
    """The rows the kernel writes as zeros: every row of a window without a
    valid slot, and the rows of a 16-row query tile that are all padded
    (slots past T count as padded); no row of a tile with a valid slot."""
    pad = torch.zeros(3, 40, dtype=torch.bool)
    pad[0] = True  # no valid slot
    pad[1, 16:32] = True  # one whole tile
    pad[2, 32:] = True  # the last tile, 8 slots of it past T
    pad[2, 3] = True  # one padded row of a live tile
    want = torch.zeros(3, 40, dtype=torch.bool)
    want[0] = True
    want[1, 16:32] = True
    want[2, 32:] = True
    assert torch.equal(wm.skipped_rows(pad), want)


@pytest.mark.parametrize("bad,err", [
    (dict(q=torch.zeros(2, 8, 32)), TypeError),
    (dict(pad=torch.zeros(2, 8)), TypeError),
    (dict(pad=torch.zeros(2, 7, dtype=torch.bool)), ValueError),
    (dict(k=torch.zeros(2, 8, 16, dtype=torch.bfloat16)), ValueError),
    (dict(nhead=3), ValueError),
])
def test_window_mha_rejects_what_the_kernel_does_not_take(bad, err):
    args = dict(q=torch.zeros(2, 8, 32, dtype=torch.bfloat16),
                k=torch.zeros(2, 8, 32, dtype=torch.bfloat16),
                v=torch.zeros(2, 8, 32, dtype=torch.bfloat16),
                pad=torch.zeros(2, 8, dtype=torch.bool), nhead=2)
    args.update(bad)
    with pytest.raises(err):
        wm.window_mha(**args)
