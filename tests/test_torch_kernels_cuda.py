"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests carry the ``cuda`` marker and skip without a CUDA card: a CUDA
C++ kernel has no CPU or interpret mode. The file imports no JAX, so it runs
on a GPU machine without the JAX package's test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from sst_tpu_torch.ops import sorted_reduce as sr
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from sst_tpu_torch.ops import window_mha as wm
from sst_tpu_torch.ops.segment import unique_segments


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a "
                    "and has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _sorted_rows(n, v, c, seed, device):
    rng = np.random.RandomState(seed)
    keys = torch.from_numpy(rng.randint(0, v * 3, n).astype(np.int32))
    valid = torch.from_numpy(rng.rand(n) > 0.1)
    uniq = unique_segments(keys.to(device), valid.to(device), v)
    data = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(device)
    return data[uniq.order], uniq.seg_ids[uniq.order].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("n,v,c", [(4096, 1500, 64), (20000, 9000, 3),
                                   (3000, 40, 130)])
def test_sorted_reduce_kernel_matches_twin(mode, n, v, c):
    device = _cuda()
    data, seg = _sorted_rows(n, v, c, seed=n + c, device=device)
    sr.reset_launch_counts()
    got = sr.sorted_segment_reduce(data, seg, v, mode)
    torch.cuda.synchronize()
    assert sr.launches == 1 and sr.launch_counts == {(mode, c): 1}
    ref = sr.sorted_segment_reduce_ref(data, seg, v, mode)
    if mode == "max":
        assert torch.equal(got, ref)  # max is order-free: exact
    else:
        # row-order sum vs index_add's order, f32: rtol/atol 1e-5
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_sorted_reduce_kernel_refuses_autograd():
    device = _cuda()
    data = torch.ones(8, 2, device=device, requires_grad=True)
    seg = torch.zeros(8, dtype=torch.int32, device=device)
    with pytest.raises(NotImplementedError):
        sr.sorted_segment_reduce(data, seg, 4, "sum")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_sorted_reduce_kernel_lets_nan_through(mode):
    # a NaN passes through a sum; a max that is not finite (NaN, +-inf)
    # reads 0, as JAX segment_reduce does. Held against the twin on the
    # CPU: the twin on the card goes through ATen's CUDA atomics, whose NaN
    # rule is not documented
    device = _cuda()
    data, seg = _sorted_rows(4096, 1500, 16, seed=7, device=device)
    data[::97, ::5] = float("nan")
    data[5::89, 1::7] = float("inf")
    data[7::83, 2::6] = -float("inf")
    got = sr.sorted_segment_reduce(data, seg, 1500, mode).cpu()
    ref = sr.sorted_segment_reduce_ref(data.cpu(), seg.cpu(), 1500, mode)
    if mode == "max":
        assert torch.isfinite(got).all()
        assert torch.equal(got, ref)
    else:
        assert torch.equal(got.isnan(), ref.isnan())
        assert got.isnan().any()
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5,
                                   equal_nan=True)


def _conv_case(vin, vout, taps, cin, cout, seed, device, missing=0.6):
    """N(0, 1) features, N(0, 1/(K*Cin)) weights, and a neighbour table
    whose entries are missing (Vin, -1 or past Vin) with prob. ``missing``."""
    rng = np.random.RandomState(seed)
    nbr = rng.randint(0, max(vin, 1), (taps, vout))
    drop = rng.rand(taps, vout) < missing
    nbr = np.where(drop, rng.choice([vin, -1, vin + 7], (taps, vout)), nbr)
    feats = rng.randn(vin, cin).astype(np.float32)
    w = (rng.randn(taps, cin, cout) / np.sqrt(taps * cin)).astype(np.float32)
    return (torch.from_numpy(feats).to(device),
            torch.from_numpy(nbr.astype(np.int32)).to(device),
            torch.from_numpy(w).to(device))


def _edge_case(name, device):
    if name == "all-missing tile":
        feats, nbr, w = _conv_case(500, 300, 27, 64, 64, 1, device)
        nbr[:, 64:128] = 500
        return feats, nbr, w
    if name == "tap with no neighbour":
        feats, nbr, w = _conv_case(500, 300, 27, 64, 64, 2, device)
        nbr[13] = 500
        return feats, nbr, w
    if name == "K=3":
        return _conv_case(700, 400, 3, 32, 64, 3, device)
    if name == "Cin and Cout off the tile, 3->48":
        return _conv_case(900, 640, 27, 3, 48, 4, device)
    if name == "Vout off the row tile, 1000 rows, 40->72":
        return _conv_case(1200, 1000, 27, 40, 72, 5, device)
    if name == "merge width 512->256":
        return _conv_case(2048, 2048, 27, 512, 256, 6, device, missing=0.7)
    raise KeyError(name)


SPARSE_CONV_EDGE_CASES = ("all-missing tile", "tap with no neighbour", "K=3",
                          "Cin and Cout off the tile, 3->48",
                          "Vout off the row tile, 1000 rows, 40->72",
                          "merge width 512->256")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPARSE_CONV_EDGE_CASES)
def test_sparse_conv_kernel_matches_twin(name):
    device = _cuda()
    feats, nbr, w = _edge_case(name, device)
    scg.reset_launch_counts()
    got = scg.sparse_conv_gemm(feats, nbr, w, "subm")
    torch.cuda.synchronize()
    assert scg.launches == 1
    assert scg.launch_counts == {("subm", w.shape[1], w.shape[2]): 1}
    ref = scg.sparse_conv_gemm_ref(feats, nbr, w)
    # f32 sums over up to 27 * 512 terms in another order: 1e-4 abs + rel
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    if name == "all-missing tile":
        assert torch.equal(got[64:128], torch.zeros_like(got[64:128]))


@pytest.mark.cuda
def test_sparse_conv_kernel_refuses_autograd():
    device = _cuda()
    feats, nbr, w = _conv_case(64, 64, 27, 8, 8, 0, device)
    with pytest.raises(NotImplementedError):
        scg.sparse_conv_gemm(feats, nbr, w.requires_grad_(), "subm")


def _mha_case(w, t, h, seed, device, strided=True):
    """q, k, v [W, T, 16H] bf16 (the three column blocks of one [W, T, 48H]
    buffer when ``strided``) and a pad mask with, for W > 1, an all-padded
    window (0) and a one-token window (1)."""
    rng = np.random.RandomState(seed)
    c = 16 * h
    qkv = torch.from_numpy(rng.randn(w, t, 3 * c).astype(np.float32))
    qkv[..., 2 * c:] *= 2.0
    qkv = qkv.to(device=device, dtype=torch.bfloat16)
    pad = rng.rand(w, t) > 0.6
    if w > 1:
        pad[0] = True
        pad[1] = True
        pad[1, t // 2] = False
    pad = torch.from_numpy(pad).to(device)
    q, k, v = qkv.split(c, dim=-1)
    if not strided:
        q, k, v = (x.contiguous() for x in (q, k, v))
    return q, k, v, pad


def _assert_mha_close(got, ref, v, pad):
    """Valid query rows within 1 bf16 ulp (rtol 2^-7) plus 2^-8 * max|v|
    for a bf16(p) that rounds the other way after another f32 sum order;
    padded rows finite."""
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    rows = ~pad
    tol = 2.0**-7 * ref.abs() + 2.0**-8 * v.float().abs().max()
    assert bool(((got - ref).abs() <= tol)[rows].all())


# the buckets (T, windows) of sst_waymo(train_buckets=False) at d_model 128,
# 8 heads, and edge cases: T off the multiples of 16, W = 1, two heads
MHA_CASES = [(896, 30, 8), (768, 60, 8), (320, 100, 8), (160, 144, 8),
             (1, 30, 8), (16, 8, 2), (7, 100, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("w,t,h", MHA_CASES)
@pytest.mark.parametrize("strided", [True, False])
def test_window_mha_kernel_matches_twin(w, t, h, strided):
    device = _cuda()
    q, k, v, pad = _mha_case(w, t, h, seed=w + t + h, device=device,
                             strided=strided)
    wm.reset_launch_counts()
    got = wm.window_mha(q, k, v, pad, h)
    torch.cuda.synchronize()
    assert wm.launches == 1 and wm.launch_counts == {(t, 16 * h, h): 1}
    ref = wm.window_mha_ref(q, k, v, pad, h)
    _assert_mha_close(got, ref, v, pad)


@pytest.mark.cuda
def test_window_mha_kernel_refuses_autograd():
    device = _cuda()
    q, k, v, pad = _mha_case(4, 30, 8, seed=0, device=device)
    with pytest.raises(NotImplementedError):
        wm.window_mha(q, k.detach().requires_grad_(), v, pad, 8)
