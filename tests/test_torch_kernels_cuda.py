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
    # held against the twin on the CPU: the twin on the card goes through
    # ATen's CUDA atomics, whose NaN rule is not documented
    device = _cuda()
    data, seg = _sorted_rows(4096, 1500, 16, seed=7, device=device)
    data[::97, ::5] = float("nan")
    got = sr.sorted_segment_reduce(data, seg, 1500, mode).cpu()
    ref = sr.sorted_segment_reduce_ref(data.cpu(), seg.cpu(), 1500, mode)
    assert torch.equal(got.isnan(), ref.isnan())
    assert got.isnan().any()
    if mode == "max":
        assert torch.equal(got.nan_to_num(0.0), ref.nan_to_num(0.0))
    else:
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
