"""Parity of the port's sparse-conv ops (``sst_tpu_torch/ops/sparse_conv.py``
and the twin in ``ops/sparse_conv_gemm.py``) with the JAX package.

Grids, downsampled grids and neighbour tables are integer results and must
equal JAX's exactly. The conv compute (the kernel's plain twin, on the CPU)
is held against JAX's Pallas kernel, run in interpret mode on window plans,
at rtol/atol 1e-5: both sum the same f32 products in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.ops import sparse_conv as jsc
from sst_tpu.ops import sparse_conv_pallas as jscp
from sst_tpu_torch.ops import sparse_conv as tsc
from sst_tpu_torch.ops import sparse_conv_gemm as scg

GRID = (8, 24, 24)


def _coords(rng, cap=320, batch=2, grid=GRID, fill=260):
    """Distinct (b, z, y, x) rows in random order, -1 padded to ``cap``."""
    nz, ny, nx = grid
    coords = np.stack([rng.randint(0, batch, fill), rng.randint(0, nz, fill),
                       rng.randint(0, ny, fill), rng.randint(0, nx, fill)],
                      1).astype(np.int32)
    coords = rng.permutation(np.unique(coords, axis=0))
    n = coords.shape[0]
    coords = np.concatenate([coords, -np.ones((cap - n, 4), np.int32)])
    return coords, np.arange(cap) < n


def _edge_coords():
    """Sites at coordinates 0 and 1 (and the far edge) in every dim, where
    padding 1 makes the candidate bounds and inverse targets negative."""
    pts = [(0, z, y, x) for z in (0, 1) for y in (0, 1) for x in (0, 1)]
    pts += [(1, 7, 23, 23), (1, 6, 22, 0), (0, 0, 23, 1)]
    coords = np.asarray(pts, np.int32)
    cap = 24
    coords = np.concatenate([coords,
                             -np.ones((cap - len(pts), 4), np.int32)])
    return coords, np.arange(cap) < len(pts)


def _both_grids(coords, valid, grid=GRID, batch=2):
    jsg, jorder = jsc.make_sparse_grid(jnp.asarray(coords), jnp.asarray(valid),
                                       grid, batch)
    tsg, torder = tsc.make_sparse_grid(torch.from_numpy(coords),
                                       torch.from_numpy(valid), grid, batch)
    return jsg, tsg, np.asarray(jorder), torder.numpy()


def _assert_grids_equal(jsg, tsg):
    assert tuple(jsg.grid) == tsg.grid and jsg.batch_size == tsg.batch_size
    for name in ("keys", "coords", "valid"):
        np.testing.assert_array_equal(getattr(tsg, name).numpy(),
                                      np.asarray(getattr(jsg, name)),
                                      err_msg=name)


def test_make_sparse_grid_matches_jax(rng):
    jsg, tsg, jorder, torder = _both_grids(*_coords(rng))
    _assert_grids_equal(jsg, tsg)
    np.testing.assert_array_equal(torder, jorder)  # stable argsort


# caps: room to spare, exactly tight-ish, and overflowing (ranks dropped)
@pytest.mark.parametrize("cap_out", [192, 64])
@pytest.mark.parametrize("stride,padding", [((2, 2, 2), (1, 1, 1)),
                                            ((2, 2, 2), (0, 1, 1)),
                                            ((1, 2, 2), (1, 0, 1))])
def test_downsample_grid_matches_jax(rng, cap_out, stride, padding):
    jsg, tsg, _, _ = _both_grids(*_coords(rng))
    jd = jsc.downsample_grid(jsg, cap_out, stride, padding)
    td = tsc.downsample_grid(tsg, cap_out, stride, padding)
    _assert_grids_equal(jd, td)
    if cap_out == 64:
        assert bool(td.valid.all())  # the overflow case really overflows


def test_downsample_grid_edges_match_jax():
    jsg, tsg, _, _ = _both_grids(*_edge_coords())
    jd = jsc.downsample_grid(jsg, 32)
    td = tsc.downsample_grid(tsg, 32)
    _assert_grids_equal(jd, td)
    assert int(td.valid.sum()) > 8


def _levels(coords, valid, cap_out, stride=(2, 2, 2), padding=(1, 1, 1)):
    jsg, tsg, _, _ = _both_grids(coords, valid)
    return (jsg, jsc.downsample_grid(jsg, cap_out, stride, padding),
            tsg, tsc.downsample_grid(tsg, cap_out, stride, padding))


def _plans(mode, j0, j1, t0, t1, stride, padding):
    """(JAX neighbour-table plan, port plan) of one conv family: subm on
    level 0, strided level 0 → 1, inverse level 1 → 0."""
    if mode == "subm":
        args_j, args_t = (j0, j0), (t0, t0)
    elif mode == "strided":
        args_j, args_t = (j1, j0), (t1, t0)
    else:
        args_j, args_t = (j0, j1), (t0, t1)
    jp = jscp.build_conv_plans(*args_j, mode, stride, padding,
                               use_windows=False)
    tp = tsc.build_conv_plans(*args_t, mode, stride, padding)
    return jp, tp


@pytest.mark.parametrize("mode", ["subm", "strided", "inverse"])
@pytest.mark.parametrize("stride,padding", [((2, 2, 2), (1, 1, 1)),
                                            ((2, 2, 2), (0, 1, 1))])
@pytest.mark.parametrize("edges", [False, True])
def test_neighbor_tables_equal_jax(rng, mode, stride, padding, edges):
    coords, valid = _edge_coords() if edges else _coords(rng)
    j0, j1, t0, t1 = _levels(coords, valid, 32 if edges else 192, stride,
                             padding)
    jp, tp = _plans(mode, j0, j1, t0, t1, stride, padding)
    assert tp.mode == mode and tp.nbr.dtype == torch.int32
    np.testing.assert_array_equal(tp.nbr.numpy(), np.asarray(jp.nbr))
    hits = tp.nbr.numpy() < (j0.cap if mode != "inverse" else j1.cap)
    assert hits.any() and not hits.all()


def _masked(rng, n, c, valid):
    x = rng.randn(n, c).astype(np.float32)
    return np.where(np.asarray(valid)[:, None], x, 0.0).astype(np.float32)


@pytest.mark.parametrize("mode,cin,cout", [("subm", 64, 64),
                                           ("subm", 64, 128),
                                           ("strided", 64, 64),
                                           ("inverse", 64, 64)])
def test_twin_matches_jax_pallas_kernel(rng, monkeypatch, mode, cin, cout):
    """The port's plain twin on the port's tables against JAX's Pallas
    kernel in interpret mode on its window plans (wired as in
    tests/test_sparse_conv_pallas.py)."""
    monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    j0, j1, t0, t1 = _levels(*_coords(rng), 192)
    if mode == "subm":
        fast = jscp.build_conv_plans(j0, j0, "subm", use_windows=True)
        vin_valid = j0.valid
    else:
        fast_s = jscp.build_conv_plans(j1, j0, "strided", use_windows=True)
        fast_i = jscp.build_conv_plans(j0, j1, "inverse", use_windows=True)
        fast_s = fast_s.replace(bwd=fast_i.fwd)
        fast_i = fast_i.replace(bwd=fast_s.fwd)
        fast = fast_s if mode == "strided" else fast_i
        vin_valid = j0.valid if mode == "strided" else j1.valid
    assert fast.fwd is not None  # the Pallas path, not a table
    feats = _masked(rng, vin_valid.shape[0], cin, vin_valid)
    w = (rng.randn(27, cin, cout) * 0.1).astype(np.float32)
    ref = np.asarray(jscp.windowed_sparse_conv(jnp.asarray(feats),
                                               jnp.asarray(w), fast))
    _, tp = _plans(mode, j0, j1, t0, t1, (2, 2, 2), (1, 1, 1))
    scg.reset_launch_counts()
    got = tsc.windowed_sparse_conv(torch.from_numpy(feats),
                                   torch.from_numpy(w), tp)
    assert scg.launches == 0  # CPU tensors take the twin
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.abs(ref).sum() > 0


def test_twin_reads_zeros_outside_the_input_rows():
    feats = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    nbr = torch.tensor([[0, 4, -1, 3, 99]], dtype=torch.int32)
    w = torch.eye(3)[None]
    out = scg.sparse_conv_gemm(feats, nbr, w)
    expect = torch.stack([feats[0], torch.zeros(3), torch.zeros(3), feats[3],
                          torch.zeros(3)])
    assert torch.equal(out, expect)


@pytest.mark.parametrize("case", ["dtype", "nbr_dtype", "shape", "taps",
                                  "contiguous", "mode"])
def test_wrapper_rejects_bad_inputs(case):
    feats = torch.zeros(5, 4)
    nbr = torch.zeros(27, 6, dtype=torch.int32)
    w = torch.zeros(27, 4, 8)
    mode = "subm"
    err = ValueError
    if case == "dtype":
        feats, err = feats.double(), TypeError
    elif case == "nbr_dtype":
        nbr, err = nbr.long(), TypeError
    elif case == "shape":
        w = torch.zeros(27, 3, 8)
    elif case == "taps":
        nbr = torch.zeros(3, 6, dtype=torch.int32)
    elif case == "contiguous":
        w = torch.zeros(27, 8, 4).transpose(1, 2)
    else:
        mode = "dense"
    with pytest.raises(err):
        scg.sparse_conv_gemm(feats, nbr, w, mode)
