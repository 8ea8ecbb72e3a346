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
from sst_tpu_torch.ops import sparse_conv as tsc
from sst_tpu_torch.ops import sparse_conv_dw as scd
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from sst_tpu_torch.ops import window_mha as wm
from sst_tpu_torch.ops.segment import unique_segments
from torch_threads import torch_threads_per_worker  # noqa: F401


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
    assert sr.launches == 1
    assert sr.launch_counts == {(mode, c, "float32"): 1}
    ref = sr.sorted_segment_reduce_ref(data, seg, v, mode)
    if mode == "max":
        assert torch.equal(got, ref)  # max is order-free: exact
    else:
        # row-order sum vs index_add's order, f32: rtol/atol 1e-5
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at each value (the spacing of its binade)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0**-126)))
    return 2.0 ** (e - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("n,v,c,empty", [
    (4096, 1500, 64, False),    # 16-byte units of 8 bf16
    (20000, 9000, 3, False),    # a thread per segment
    (3000, 40, 130, False),     # C off the 8-channel unit: one per channel
    (196608, 131072, 64, True),  # the segmentor's shape, mostly empty
])
def test_sorted_reduce_kernel_bf16_route_matches_twin(mode, n, v, c, empty):
    """The bf16 route (bf16 rows reduced in f32, rounded to nearest even)
    against its twin on the same rows: bf16 out, counted under
    (mode, C, "bfloat16"); max equal bit for bit, sum within one bf16 ulp
    (the twin sums in another order before its one rounding); NaN and
    +-inf rows as the twin on the CPU; the same bits on a second run."""
    device = _cuda()
    if empty:
        gen = torch.Generator(device=device).manual_seed(c)
        seg = torch.sort(torch.randint(0, 40000, (n,), generator=gen,
                                       device=device).to(torch.int32)).values
        seg[-20000:] = v
        data = torch.randn(n, c, generator=gen, device=device) * 4
    else:
        data, seg = _sorted_rows(n, v, c, seed=n + c, device=device)
        data = data * 4
    data = data.bfloat16()
    data[::97, ::5] = float("nan")
    data[5::89, 1::3] = float("inf")
    data[7::83, ::4] = -float("inf")
    sr.reset_launch_counts()
    got = sr.sorted_segment_reduce(data, seg, v, mode)
    again = sr.sorted_segment_reduce(data, seg, v, mode)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert sr.launch_counts == {(mode, c, "bfloat16"): 2}
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    ref = sr.sorted_segment_reduce_ref(data.cpu(), seg.cpu(), v, mode)
    got = got.cpu()
    finite = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), finite)
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(got[torch.isinf(ref)], ref[torch.isinf(ref)])
    g, r = got[finite].float(), ref[finite].float()
    if mode == "max":
        assert torch.equal(g, r)
    else:
        assert bool(((g - r).abs() <= _bf16_ulp(r)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_sorted_reduce_kernel_bf16_backward_matches_twin(mode):
    """Autograd through the bf16 route against autograd through the twin
    on the CPU: bf16 gradients, equal bit for bit, ties included."""
    device = _cuda()
    data, seg = _sorted_rows(4096, 1500, 16, seed=13, device=device)
    data = data.bfloat16()
    data[1::7] = data[::7][:data[1::7].shape[0]]  # ties inside segments
    g = torch.randn(1500, 16, generator=torch.Generator().manual_seed(1))
    grads = []
    for dev in (device, "cpu"):
        d = data.detach().to(dev).requires_grad_()
        out = sr.sorted_segment_reduce(d, seg.to(dev), 1500, mode)
        out.backward(g.bfloat16().to(dev))
        grads.append(d.grad.cpu())
    assert grads[0].dtype == torch.bfloat16
    assert torch.equal(grads[0].view(torch.int16), grads[1].view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("c", [3, 64])
def test_sorted_reduce_kernel_mostly_empty_segments(mode, c):
    """The segmentor's shape: 196,608 rows over 131,072 segments of which
    only ~40,000 are occupied, the trailing slots empty and the invalid
    rows' ids at num_segments, as the voxel sort hands them over. The
    offsets kernel equals ``torch.searchsorted`` exactly; the reduce equals
    its twin (max exactly, sum within rtol/atol 1e-5), with the offsets
    computed by the wrapper or passed in (the same bits)."""
    device = _cuda()
    n, v = 196608, 131072
    gen = torch.Generator(device=device).manual_seed(c)
    seg = torch.sort(torch.randint(0, 40000, (n,), generator=gen,
                                   device=device).to(torch.int32)).values
    seg[-20000:] = v
    data = torch.randn(n, c, generator=gen, device=device)
    sr.reset_launch_counts()
    offsets = sr.segment_offsets(seg, v)
    got = sr.sorted_segment_reduce(data, seg, v, mode, offsets)
    again = sr.sorted_segment_reduce(data, seg, v, mode)
    torch.cuda.synchronize()
    assert sr.launches == 2 and sr.offsets_launches == 2
    assert torch.equal(offsets, sr.segment_offsets_ref(seg, v))
    assert torch.equal(got, again)
    ref = sr.sorted_segment_reduce_ref(data, seg, v, mode)
    if mode == "max":
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[40000:], torch.zeros_like(got[40000:]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_sorted_reduce_kernel_backward_matches_twin(mode):
    """Autograd through the kernel (JAX's backward, in plain PyTorch)
    against autograd through the twin on the CPU: exact, ties included."""
    device = _cuda()
    data, seg = _sorted_rows(4096, 1500, 16, seed=11, device=device)
    data[1::7] = data[::7][:data[1::7].shape[0]]  # ties inside segments
    g = torch.randn(1500, 16, generator=torch.Generator().manual_seed(0))
    grads = []
    for dev in (device, "cpu"):
        d = data.detach().to(dev).requires_grad_()
        sr.reset_launch_counts()
        (sr.sorted_segment_reduce(d, seg.to(dev), 1500, mode) * g.to(dev)) \
            .sum().backward()
        assert sr.launches == (1 if dev == device else 0)
        grads.append(d.grad.cpu())
    assert torch.equal(grads[0], grads[1])


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
    """Over a precomputed schedule and over one the wrapper builds: the
    same bits (no atomics, a fixed order), within 1e-4 of the twin."""
    device = _cuda()
    feats, nbr, w = _edge_case(name, device)
    sched = scg.conv_schedule(nbr, feats.shape[0])
    scg.reset_launch_counts()
    got = scg.sparse_conv_gemm(feats, nbr, w, "subm", schedule=sched)
    again = scg.sparse_conv_gemm(feats, nbr, w, "subm")
    torch.cuda.synchronize()
    assert scg.launches == 2
    assert scg.launch_counts == {("subm", w.shape[1], w.shape[2]): 2}
    assert torch.equal(got, again)
    ref = scg.sparse_conv_gemm_ref(feats, nbr, w)
    # f32 sums over up to 27 * 512 terms in another order, 3xTF32 products
    # (~2^-21 relative each): 1e-4 abs + rel
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    if name == "all-missing tile":
        assert torch.equal(got[64:128], torch.zeros_like(got[64:128]))


FSD_LEVEL_CAPS = (131072, 65536, 32768, 16384, 8192, 4096)


@pytest.fixture(scope="module")
def fsd_levels():
    """The six level grids of configs/fsd/fsd_waymoD1_1x.py's segmentor UNet
    (caps 131,072 → 4,096, k3 s2 p1 downsamples) over a 30x640x640 grid:
    ~100k voxels in 3,000 clusters of a few metres around z = 8, and
    levels 1 and 2 fill their caps, as the drop semantics allow."""
    device = _cuda()
    rng = np.random.RandomState(8)
    grid = (30, 640, 640)
    n = 120000
    centres = rng.randint(0, 640, (3000, 2))[rng.randint(0, 3000, n)]
    xy = np.clip(centres + np.round(rng.randn(n, 2) * 6), 0, 639)
    z = np.clip(np.round(8 + rng.randn(n) * 3), 0, 29)
    coords = np.unique(np.stack([np.zeros(n), z, xy[:, 1], xy[:, 0]],
                                1).astype(np.int32), axis=0)
    cap = FSD_LEVEL_CAPS[0]
    assert len(coords) <= cap
    coords = np.concatenate([coords, -np.ones((cap - len(coords), 4),
                                              np.int32)])
    valid = torch.from_numpy(np.arange(cap) < (coords[:, 0] >= 0).sum())
    g0, _ = tsc.make_sparse_grid(torch.from_numpy(coords).to(device),
                                 valid.to(device), grid, 1)
    levels = [g0]
    for c in FSD_LEVEL_CAPS[1:]:
        levels.append(tsc.downsample_grid(levels[-1], c))
    return levels


# (mode, level, Cin, Cout): encoder_0_0, encoder_1_0_down, upsample_2,
# the deepest encoder and decoder convs, merge_6
FSD_CONV_CASES = [("subm", 0, 64, 128), ("strided", 1, 128, 128),
                  ("inverse", 1, 128, 128), ("subm", 4, 256, 256),
                  ("strided", 5, 256, 256), ("inverse", 5, 256, 256),
                  ("subm", 5, 512, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,level,cin,cout", FSD_CONV_CASES)
def test_sparse_conv_kernel_at_fsd_shapes(fsd_levels, mode, level, cin,
                                          cout):
    """The FSD segmentor's level caps and widths: subm at a level, strided
    from level - 1 to level, inverse from level back to level - 1; within
    1e-4 of the twin."""
    if mode == "subm":
        out_g = in_g = fsd_levels[level]
    elif mode == "strided":
        out_g, in_g = fsd_levels[level], fsd_levels[level - 1]
    else:
        out_g, in_g = fsd_levels[level - 1], fsd_levels[level]
    plan = tsc.build_conv_plans(out_g, in_g, mode)
    assert (plan.nbr.shape[1], in_g.cap) == (out_g.cap, in_g.cap)
    gen = torch.Generator(device=plan.nbr.device).manual_seed(level)
    feats = torch.randn(in_g.cap, cin, generator=gen,
                        device=plan.nbr.device) * in_g.valid[:, None]
    w = torch.randn(27, cin, cout, generator=gen,
                    device=plan.nbr.device) / (27 * cin) ** 0.5
    scg.reset_launch_counts()
    got = scg.sparse_conv_gemm(feats, plan.nbr, w, mode,
                               schedule=plan.schedule(in_g.cap))
    torch.cuda.synchronize()
    assert scg.launch_counts == {(mode, cin, cout): 1}
    ref = scg.sparse_conv_gemm_ref(feats, plan.nbr, w)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert int(out_g.valid.sum()) > 0 and got.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode,level,cin,cout", FSD_CONV_CASES)
def test_sparse_conv_backward_at_fsd_shapes(fsd_levels, mode, level, cin,
                                            cout):
    """The FSD segmentor's training at its level caps and widths (the
    256-wide deepest levels and the 512 -> 256 merge included): the dW
    kernel over the plan's schedule, within 1e-4 of the twin on absolute
    values, and the input gradient (the conv kernel over the transposed
    table and its schedule, with W[k]^T) within 1e-4 of the twin."""
    if mode == "subm":
        out_g = in_g = fsd_levels[level]
    elif mode == "strided":
        out_g, in_g = fsd_levels[level], fsd_levels[level - 1]
    else:
        out_g, in_g = fsd_levels[level - 1], fsd_levels[level]
    plan = tsc.build_conv_plans(out_g, in_g, mode)
    dev = plan.nbr.device
    gen = torch.Generator(device=dev).manual_seed(10 + level)
    feats = torch.randn(in_g.cap, cin, generator=gen,
                        device=dev) * in_g.valid[:, None]
    dout = torch.randn(out_g.cap, cout, generator=gen,
                       device=dev) * out_g.valid[:, None]
    wt = (torch.randn(27, cin, cout, generator=gen, device=dev)
          / (27 * cin) ** 0.5).transpose(1, 2).contiguous()
    scg.reset_launch_counts()
    scd.reset_launch_counts()
    dw = scd.sparse_conv_dw(feats, plan.nbr, dout, mode,
                            schedule=plan.schedule(in_g.cap))
    nbr_t = plan.transposed(in_g.cap)
    dfeats = scg.sparse_conv_gemm(dout, nbr_t, wt, mode, kind="dgrad",
                                  schedule=plan.transposed_schedule(
                                      in_g.cap))
    torch.cuda.synchronize()
    assert scd.launch_counts == {(mode, cin, cout): 1}
    assert scg.kind_counts == {"dgrad": 1}
    assert _dw_close(dw, feats, plan.nbr, dout) and dw.abs().sum() > 0
    ref = scg.sparse_conv_gemm_ref(dout, nbr_t, wt)
    torch.testing.assert_close(dfeats, ref, rtol=1e-4, atol=1e-4)
    assert dfeats.shape == (in_g.cap, cin) and dfeats.abs().sum() > 0


FSDPP_LEVEL_CAPS = (65536, 32768, 16384, 8192, 4096, 2048)


@pytest.fixture(scope="module")
def fsdpp_levels():
    """The six level grids of configs/fsdpp/fsdpp_waymo_2x.py's segmentor
    UNet (FSD's at half caps, 65,536 → 2,048) over the 30x640x640 grid: a
    residual-sized cloud of ~55k voxels in 1,500 clusters; levels 1 and 2
    fill their caps."""
    device = _cuda()
    rng = np.random.RandomState(9)
    n = 60000
    centres = rng.randint(0, 640, (1500, 2))[rng.randint(0, 1500, n)]
    xy = np.clip(centres + np.round(rng.randn(n, 2) * 6), 0, 639)
    z = np.clip(np.round(8 + rng.randn(n) * 3), 0, 29)
    coords = np.unique(np.stack([np.zeros(n), z, xy[:, 1], xy[:, 0]],
                                1).astype(np.int32), axis=0)
    cap = FSDPP_LEVEL_CAPS[0]
    assert len(coords) <= cap
    valid = torch.from_numpy(np.arange(cap) < len(coords))
    coords = np.concatenate([coords, -np.ones((cap - len(coords), 4),
                                              np.int32)])
    g0, _ = tsc.make_sparse_grid(torch.from_numpy(coords).to(device),
                                 valid.to(device), (30, 640, 640), 1)
    levels = [g0]
    for c in FSDPP_LEVEL_CAPS[1:]:
        levels.append(tsc.downsample_grid(levels[-1], c))
    return levels


@pytest.mark.cuda
@pytest.mark.parametrize("mode,level,cin,cout", [
    ("subm", 0, 64, 128), ("strided", 2, 128, 128), ("inverse", 5, 256, 256),
    ("subm", 5, 512, 256)])
def test_sparse_conv_kernels_at_fsdpp_shapes(fsdpp_levels, mode, level, cin,
                                             cout):
    """FSD++'s segmentor at its half caps: the conv kernel (forward), the
    input gradient (the conv kernel over the transposed table) and the dW
    kernel, each within 1e-4 of its twin (dW on absolute values), one
    launch each."""
    if mode == "subm":
        out_g = in_g = fsdpp_levels[level]
    elif mode == "strided":
        out_g, in_g = fsdpp_levels[level], fsdpp_levels[level - 1]
    else:
        out_g, in_g = fsdpp_levels[level - 1], fsdpp_levels[level]
    plan = tsc.build_conv_plans(out_g, in_g, mode)
    dev = plan.nbr.device
    gen = torch.Generator(device=dev).manual_seed(20 + level)
    feats = torch.randn(in_g.cap, cin, generator=gen,
                        device=dev) * in_g.valid[:, None]
    w = torch.randn(27, cin, cout, generator=gen, device=dev) / (
        27 * cin) ** 0.5
    dout = torch.randn(out_g.cap, cout, generator=gen,
                       device=dev) * out_g.valid[:, None]
    scg.reset_launch_counts()
    scd.reset_launch_counts()
    got = scg.sparse_conv_gemm(feats, plan.nbr, w, mode,
                               schedule=plan.schedule(in_g.cap))
    nbr_t = plan.transposed(in_g.cap)
    wt = w.transpose(1, 2).contiguous()
    dfeats = scg.sparse_conv_gemm(dout, nbr_t, wt, mode, kind="dgrad",
                                  schedule=plan.transposed_schedule(
                                      in_g.cap))
    dw = scd.sparse_conv_dw(feats, plan.nbr, dout, mode,
                            schedule=plan.schedule(in_g.cap))
    torch.cuda.synchronize()
    assert scg.kind_counts == {"forward": 1, "dgrad": 1}
    assert scd.launch_counts == {(mode, cin, cout): 1}
    torch.testing.assert_close(got, scg.sparse_conv_gemm_ref(
        feats, plan.nbr, w), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dfeats, scg.sparse_conv_gemm_ref(
        dout, nbr_t, wt), rtol=1e-4, atol=1e-4)
    assert _dw_close(dw, feats, plan.nbr, dout)
    assert got.abs().sum() > 0 and dw.abs().sum() > 0


CTRL_LEVEL_CAPS = (16384, 8192, 4096)


@pytest.fixture(scope="module")
def ctrl_levels():
    """The three level grids of configs/ctrl/ctrl_veh_24e.py's tracklet
    UNet (caps 16,384 / 8,192 / 4,096, k3 s2 p1 downsamples) over its
    40x128x128 grid (0.1 x 0.1 x 0.2 m over +-6.4 m, +-4 m): one track's
    cloud, points normal with a 1.5 m spread as in ``bench.py bench_ctrl``,
    its voxels past the 16,384 cap dropped, as the voxelizer drops them."""
    device = _cuda()
    rng = np.random.RandomState(11)
    n = 32768
    xy = np.clip(np.floor(64 + rng.randn(n, 2) * 15), 0, 127)
    z = np.clip(np.floor(20 + rng.randn(n) * 7.5), 0, 39)
    coords = np.unique(np.stack([np.zeros(n), z, xy[:, 1], xy[:, 0]],
                                1).astype(np.int32), axis=0)
    cap = CTRL_LEVEL_CAPS[0]
    coords = coords[:cap]
    valid = torch.from_numpy(np.arange(cap) < len(coords))
    coords = np.concatenate([coords, -np.ones((cap - len(coords), 4),
                                              np.int32)])
    g0, _ = tsc.make_sparse_grid(torch.from_numpy(coords).to(device),
                                 valid.to(device), (40, 128, 128), 1)
    levels = [g0]
    for c in CTRL_LEVEL_CAPS[1:]:
        levels.append(tsc.downsample_grid(levels[-1], c))
    return levels


@pytest.mark.cuda
@pytest.mark.parametrize("mode,level,cin,cout", [
    ("subm", 0, 64, 64), ("strided", 1, 64, 64), ("strided", 2, 64, 128),
    ("subm", 2, 256, 128), ("inverse", 2, 128, 64), ("subm", 0, 128, 64)])
def test_sparse_conv_kernels_at_ctrl_shapes(ctrl_levels, mode, level, cin,
                                            cout):
    """CTRL's tracklet UNet at its level caps and widths (conv_input, the
    two strided encoders, merge_3, upsample_3, merge_1): the conv kernel,
    the input gradient (the conv kernel over the transposed table) and the
    dW kernel, each within 1e-4 of its twin (dW on absolute values), one
    launch each."""
    if mode == "subm":
        out_g = in_g = ctrl_levels[level]
    elif mode == "strided":
        out_g, in_g = ctrl_levels[level], ctrl_levels[level - 1]
    else:
        out_g, in_g = ctrl_levels[level - 1], ctrl_levels[level]
    plan = tsc.build_conv_plans(out_g, in_g, mode)
    dev = plan.nbr.device
    gen = torch.Generator(device=dev).manual_seed(30 + level)
    feats = torch.randn(in_g.cap, cin, generator=gen,
                        device=dev) * in_g.valid[:, None]
    w = torch.randn(27, cin, cout, generator=gen, device=dev) / (
        27 * cin) ** 0.5
    dout = torch.randn(out_g.cap, cout, generator=gen,
                       device=dev) * out_g.valid[:, None]
    scg.reset_launch_counts()
    scd.reset_launch_counts()
    got = scg.sparse_conv_gemm(feats, plan.nbr, w, mode,
                               schedule=plan.schedule(in_g.cap))
    nbr_t = plan.transposed(in_g.cap)
    wt = w.transpose(1, 2).contiguous()
    dfeats = scg.sparse_conv_gemm(dout, nbr_t, wt, mode, kind="dgrad",
                                  schedule=plan.transposed_schedule(
                                      in_g.cap))
    dw = scd.sparse_conv_dw(feats, plan.nbr, dout, mode,
                            schedule=plan.schedule(in_g.cap))
    torch.cuda.synchronize()
    assert scg.kind_counts == {"forward": 1, "dgrad": 1}
    assert scd.launch_counts == {(mode, cin, cout): 1}
    torch.testing.assert_close(got, scg.sparse_conv_gemm_ref(
        feats, plan.nbr, w), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dfeats, scg.sparse_conv_gemm_ref(
        dout, nbr_t, wt), rtol=1e-4, atol=1e-4)
    assert _dw_close(dw, feats, plan.nbr, dout)
    assert got.abs().sum() > 0 and dw.abs().sum() > 0
    assert int(out_g.valid.sum()) > 0


SECOND_SHAPE = (41, 1600, 1408)  # mmdet3d's SECOND KITTI sparse shape


@pytest.fixture(scope="module")
def second_tables():
    """The neighbour tables of SECOND's ``SparseEncoder`` at its default caps
    (level ratios 1, 0.75, 0.5, 0.35; paddings 1, 1 and (0, 1, 1)) over the
    KITTI sparse shape: 24,000 seeded sites in clusters, each level's subm
    and strided tables, and ``conv_out``'s 3-tap z-only table."""
    from sst_tpu_torch.models.middle_encoders import zdown_grid_and_table

    device = _cuda()
    rng = np.random.RandomState(12)
    n, cap = 32000, 24000
    centres = rng.uniform((0, 0), (1408, 1600), (400, 2))
    xy = np.floor(centres[rng.randint(0, 400, n)] + rng.randn(n, 2) * 12)
    xy = np.clip(xy, 0, (1407, 1599))
    z = rng.randint(4, 37, n)
    coords = np.unique(np.stack([np.zeros(n), z, xy[:, 1], xy[:, 0]],
                                1).astype(np.int32), axis=0)[:cap]
    valid = torch.from_numpy(np.arange(cap) < len(coords))
    coords = np.concatenate([coords, -np.ones((cap - len(coords), 4),
                                              np.int32)])
    grid, _ = tsc.make_sparse_grid(torch.from_numpy(coords).to(device),
                                   valid.to(device), SECOND_SHAPE, 1)
    tables = {"subm0": (grid, grid, tsc.subm_neighbor_table(grid))}
    for i, (ratio, pad) in enumerate(zip((0.75, 0.5, 0.35), (
            (1, 1, 1), (1, 1, 1), (0, 1, 1)))):
        nxt = tsc.downsample_grid(grid, int(cap * ratio), (2, 2, 2), pad)
        tables[f"strided{i + 1}"] = (nxt, grid, tsc.strided_neighbor_table(
            nxt, grid, (2, 2, 2), pad))
        grid = nxt
    tables["subm3"] = (grid, grid, tsc.subm_neighbor_table(grid))
    out_g, znbr = zdown_grid_and_table(grid, grid.cap)
    tables["zdown"] = (out_g, grid, znbr)
    return tables


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode,cin,cout", [
    ("subm0", "subm", 4, 16), ("strided1", "strided", 16, 32),
    ("strided3", "strided", 64, 64), ("subm3", "subm", 64, 64),
    ("zdown", "zdown", 64, 128)])
def test_sparse_conv_kernels_at_second_encoder_shapes(second_tables, name,
                                                      mode, cin, cout):
    """SECOND's ``SparseEncoder`` tables (27 taps, and 3 for the z-only
    ``conv_out``) at its narrow widths: the conv kernel, the input gradient
    and the dW kernel, each within 1e-4 of its twin (dW on absolute
    values), one launch each, dW of ``[taps, Cin, Cout]``; the outputs
    that read an input site."""
    out_g, in_g, nbr = second_tables[name]
    taps = nbr.shape[0]
    assert taps == (3 if mode == "zdown" else 27)
    plan = tsc.ConvPlan(nbr=nbr, mode=mode)
    dev = nbr.device
    gen = torch.Generator(device=dev).manual_seed(40 + taps)
    feats = torch.randn(in_g.cap, cin, generator=gen,
                        device=dev) * in_g.valid[:, None]
    w = torch.randn(taps, cin, cout, generator=gen, device=dev) / (
        taps * cin) ** 0.5
    dout = torch.randn(out_g.cap, cout, generator=gen,
                       device=dev) * out_g.valid[:, None]
    scg.reset_launch_counts()
    scd.reset_launch_counts()
    got = scg.sparse_conv_gemm(feats, nbr, w, mode,
                               schedule=plan.schedule(in_g.cap))
    nbr_t = plan.transposed(in_g.cap)
    wt = w.transpose(1, 2).contiguous()
    dfeats = scg.sparse_conv_gemm(dout, nbr_t, wt, mode, kind="dgrad",
                                  schedule=plan.transposed_schedule(
                                      in_g.cap))
    dw = scd.sparse_conv_dw(feats, nbr, dout, mode,
                            schedule=plan.schedule(in_g.cap))
    torch.cuda.synchronize()
    want = {(mode, cin, cout): 1}
    want[mode, cout, cin] = want.get((mode, cout, cin), 0) + 1  # dgrad
    assert scg.launch_counts == want
    assert scd.launch_counts == {(mode, cin, cout): 1}
    assert dw.shape == (taps, cin, cout)
    torch.testing.assert_close(got, scg.sparse_conv_gemm_ref(
        feats, nbr, w), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dfeats, scg.sparse_conv_gemm_ref(
        dout, nbr_t, wt), rtol=1e-4, atol=1e-4)
    assert _dw_close(dw, feats, nbr, dout)
    assert got.abs().sum() > 0 and dw.abs().sum() > 0
    hit = (nbr < in_g.cap).any(0)
    if mode == "strided":
        # JAX's strided taps read o * s - p + (-1, 0, 1), one voxel below
        # the receptive field by which downsample_grid seats the outputs
        # (o * s - p + (0, 1, 2)): some outputs read no input site
        assert bool(hit.any()) and not bool((hit & ~out_g.valid).any())
    else:  # a subm site reads itself; a zdown output exists by its inputs
        assert torch.equal(hit, out_g.valid)


def _dw_close(got, feats, nbr, dout):
    """|kernel - twin| <= 1e-4 * (|feats|^T |dout| per element, the twin on
    absolute values) + 1e-6: f32 sums in another order."""
    ref = scd.sparse_conv_dw_ref(feats, nbr, dout)
    tol = 1e-4 * scd.sparse_conv_dw_ref(feats.abs(), nbr, dout.abs()) + 1e-6
    return bool(((got - ref).abs() <= tol).all())


DW_CASES = ("tap with no neighbour", "all rows missing",
            "Vout off the row tile, 1000 rows, 40->72", "16->32",
            "merge width 512->256")


def _dw_case(name, device):
    if name == "tap with no neighbour":
        feats, nbr, w = _conv_case(500, 300, 27, 64, 64, 12, device)
        nbr[13] = 500
    elif name == "all rows missing":
        feats, nbr, w = _conv_case(500, 300, 27, 64, 64, 13, device)
        nbr[:] = -1
    elif name == "16->32":
        feats, nbr, w = _conv_case(3000, 2500, 27, 16, 32, 14, device)
    else:
        feats, nbr, w = _edge_case(name, device)
    dout = torch.randn(nbr.shape[1], w.shape[2],
                       generator=torch.Generator().manual_seed(1)).to(device)
    return feats, nbr, dout


@pytest.mark.cuda
@pytest.mark.parametrize("name", DW_CASES)
def test_sparse_conv_dw_kernel_matches_twin(name):
    """Over a precomputed schedule, again over the same one and over one
    the wrapper builds: the same bits (no float atomics, a fixed order),
    within 1e-4 of the twin on absolute values."""
    device = _cuda()
    feats, nbr, dout = _dw_case(name, device)
    sched = scg.conv_schedule(nbr, feats.shape[0])
    scd.reset_launch_counts()
    got = scd.sparse_conv_dw(feats, nbr, dout, "subm", schedule=sched)
    repeat = scd.sparse_conv_dw(feats, nbr, dout, "subm", schedule=sched)
    again = scd.sparse_conv_dw(feats, nbr, dout, "subm")
    torch.cuda.synchronize()
    assert scd.launches == 3
    assert scd.launch_counts == {("subm", feats.shape[1], dout.shape[1]): 3}
    assert torch.equal(got, repeat) and torch.equal(got, again)
    assert _dw_close(got, feats, nbr, dout)
    if name == "tap with no neighbour":
        assert torch.equal(got[13], torch.zeros_like(got[13]))
    if name == "all rows missing":
        assert torch.equal(got, torch.zeros_like(got))


def _grid_plans(device, seed=0, cap=3000, fill=2600, grid=(16, 64, 64)):
    """The subm, strided and inverse plans of a random two-level grid."""
    rng = np.random.RandomState(seed)
    nz, ny, nx = grid
    coords = np.unique(np.stack([
        rng.randint(0, 2, fill), rng.randint(0, nz, fill),
        rng.randint(0, ny, fill), rng.randint(0, nx, fill)], 1), axis=0)
    n = coords.shape[0]
    coords = np.concatenate([coords, -np.ones((cap - n, 4), np.int64)])
    valid = torch.from_numpy(np.arange(cap) < n).to(device)
    g0, _ = tsc.make_sparse_grid(
        torch.from_numpy(coords.astype(np.int32)).to(device), valid, grid, 2)
    g1 = tsc.downsample_grid(g0, 2048)
    return {"subm": (g0, g0), "strided": (g0, g1), "inverse": (g1, g0)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["subm", "strided", "inverse"])
def test_sparse_conv_autograd_runs_the_kernels(mode):
    """Autograd through the sparse conv on the card: dfeats by the conv
    kernel over the transposed table, dW by the weight-gradient kernel,
    against autograd through the twins on the CPU."""
    device = _cuda()
    gin, gout = _grid_plans(device)[mode]
    plan = tsc.build_conv_plans(gout, gin, mode)
    gen = torch.Generator().manual_seed(2)
    feats = torch.randn(gin.cap, 32, generator=gen) * gin.valid.cpu()[:, None]
    w = torch.randn(27, 32, 48, generator=gen) / 30.0
    g = torch.randn(gout.cap, 48, generator=gen) * gout.valid.cpu()[:, None]
    grads = []
    for dev in (device, "cpu"):
        cp = tsc.ConvPlan(nbr=plan.nbr.to(dev), mode=mode)
        f = feats.detach().to(dev).requires_grad_()
        ww = w.detach().to(dev).requires_grad_()
        scg.reset_launch_counts()
        scd.reset_launch_counts()
        (tsc.windowed_sparse_conv(f, ww, cp) * g.to(dev)).sum().backward()
        # the dgrad ran over the plan's transposed table and its schedule
        assert cp.sched_t is not None and cp.sched_t.vin == gout.cap
        if dev == device:
            torch.cuda.synchronize()
            assert scg.kind_counts == {"forward": 1, "dgrad": 1}
            assert scd.launches == 1
            again = scg.sparse_conv_gemm(
                g.to(dev).contiguous(), cp.nbr_t,
                ww.detach().transpose(1, 2).contiguous(), mode,
                kind="dgrad")
            assert torch.equal(f.grad, again)  # the same bits, fresh schedule
        grads.append((f.grad.cpu(), ww.grad.cpu()))
    (df_k, dw_k), (df_t, dw_t) = grads
    torch.testing.assert_close(df_k, df_t, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dw_k, dw_t, rtol=1e-4, atol=1e-4)
    assert df_t.abs().sum() > 0


def _mha_case(w, t, h, seed, device, strided=True):
    """q, k, v [W, T, 16H] bf16 (the three column blocks of one [W, T, 48H]
    buffer when ``strided``) and a pad mask with, for W > 1, an all-padded
    window (0), a one-token window (1) and, for W > 2 and T > 16, a window
    whose 16-row query tiles from row 16 to 47 are all padded (2)."""
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
    if w > 2:
        pad[2, 16:48] = True
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
# 8 heads, and edge cases: T off the multiples of 16, T at the kernel's 320,
# W = 1, two heads
MHA_CASES = [(896, 30, 8), (768, 60, 8), (320, 100, 8), (160, 144, 8),
             (1, 30, 8), (16, 8, 2), (7, 100, 2), (12, 320, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("w,t,h", MHA_CASES)
@pytest.mark.parametrize("strided", [True, False])
def test_window_mha_kernel_matches_twin(w, t, h, strided):
    """Within the tolerance on valid query rows; rows of all-padded windows
    and query tiles are zeros; a second run gives the same bits."""
    device = _cuda()
    q, k, v, pad = _mha_case(w, t, h, seed=w + t + h, device=device,
                             strided=strided)
    wm.reset_launch_counts()
    got = wm.window_mha(q, k, v, pad, h)
    again = wm.window_mha(q, k, v, pad, h)
    torch.cuda.synchronize()
    assert wm.launches == 2 and wm.launch_counts == {(t, 16 * h, h): 2}
    assert torch.equal(got, again)
    ref = wm.window_mha_ref(q, k, v, pad, h)
    _assert_mha_close(got, ref, v, pad)
    skipped = got[wm.skipped_rows(pad)]
    assert torch.equal(skipped, torch.zeros_like(skipped))
    if w > 2 and t > 16:
        assert wm.skipped_rows(pad)[2].any()


def _attention_grads_f64(q, k, v, pad, h, g):
    """The exact gradient of softmax attention (f32-free: every step in
    float64 by autograd) at the bf16 inputs: the function the ported
    ``_mha_bwd`` computes, up to its f32 sums."""
    w, t, c = q.shape
    q4, k4, v4 = (x.double().reshape(w, t, h, c // h).requires_grad_()
                  for x in (q, k, v))
    logits = torch.einsum("wthd,wshd->whts", q4, k4) / (c // h) ** 0.5
    logits = logits + pad[:, None, None, :].double() * -1e4
    out = torch.einsum("whts,wshd->wthd", torch.softmax(logits, -1), v4)
    grads = torch.autograd.grad(out, (q4, k4, v4),
                                g.double().reshape(w, t, h, c // h))
    return [x.reshape(w, t, c) for x in grads]


# the training buckets (T, windows) of sst_waymo at d_model 128, 8 heads,
# a window set with nothing to attend (every slot padded), and W = 1
MHA_TRAIN_CASES = [(1536, 30, 8), (1280, 60, 8), (768, 100, 8), (5, 30, 8),
                   (1, 100, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("w,t,h", MHA_TRAIN_CASES)
def test_window_mha_autograd_runs_the_kernel(w, t, h):
    """Under autograd the forward is the kernel (one launch), within the
    forward's tolerance of the twin; the gradients land in the qkv buffer
    of the column views and equal the ported backward (``_mha_bwd``) at the
    twin's inputs bit for bit; they are within 1 bf16 ulp (rtol 2^-7) plus
    2^-8 of each gradient's largest magnitude of the exact gradient in
    float64. The cotangent is zero on padded query rows, as the
    window-to-flat gather leaves it. Cases: the training buckets (their
    inputs hold an all-padded window, a one-token window and all-padded
    query tiles), every slot padded, and one window."""
    device = _cuda()
    q, k, v, pad = _mha_case(w, t, h, seed=w + t, device=device)
    if w == 5:
        pad[:] = True
    c = 16 * h
    qkv = torch.cat([q, k, v], dim=-1).requires_grad_()
    gen = torch.Generator(device=device).manual_seed(t)
    g = torch.randn(w, t, c, generator=gen, device=device)
    g = torch.where(pad[..., None], 0.0, g).to(torch.bfloat16)
    wm.reset_launch_counts()
    out = wm.window_mha(*qkv.split(c, dim=-1), pad, h)
    out.backward(g)
    torch.cuda.synchronize()
    assert wm.launches == 1 and out.grad_fn is not None
    _assert_mha_close(out.detach(), wm.window_mha_ref(q, k, v, pad, h), v,
                      pad)
    assert qkv.grad.dtype == torch.bfloat16
    ported = torch.cat(wm.window_mha_backward(q, k, v, pad, h, g), dim=-1)
    assert torch.equal(qkv.grad, ported)
    ref = torch.cat(_attention_grads_f64(q, k, v, pad, h, g), dim=-1)
    for i in range(3):
        got_i = qkv.grad[..., i * c:(i + 1) * c].double()
        ref_i = ref[..., i * c:(i + 1) * c]
        tol = 2.0**-7 * ref_i.abs() + 2.0**-8 * ref_i.abs().max()
        assert bool(((got_i - ref_i).abs() <= tol).all()), "qkv"[i]
    if w == 5:
        assert not qkv.grad.any()
    else:
        assert qkv.grad.abs().max() > 0


@pytest.mark.cuda
def test_window_mha_counts_its_remat_recompute():
    """A rematerialised call (``utils/remat.py``, as SST's blocks in
    training) launches the kernel in the forward and again in the backward's
    recompute; ``kind_counts`` tells them apart, and the gradient equals the
    call's without remat bit for bit."""
    from sst_tpu_torch.utils import remat

    device = _cuda()
    q, k, v, pad = _mha_case(768, 100, 8, seed=3, device=device)
    c = q.shape[-1]
    g = torch.randn(q.shape, generator=torch.Generator(
        device=device).manual_seed(4), device=device).to(torch.bfloat16)
    grads = []
    for use_remat in (False, True):
        qkv = torch.cat([q, k, v], dim=-1).requires_grad_()

        def attend(x):
            return wm.window_mha(*x.split(c, dim=-1), pad, 8)

        wm.reset_launch_counts()
        out = remat.checkpoint(attend, qkv) if use_remat else attend(qkv)
        out.backward(g)
        torch.cuda.synchronize()
        expected = {"forward": 1, "recompute": 1} if use_remat else {
            "forward": 1}
        assert wm.kind_counts == expected and wm.launches == len(expected)
        grads.append(qkv.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_preflight_passes_on_the_card():
    """``utils/preflight.py preflight_kernels`` builds every kernel and holds
    it against its twin at the models' shapes: the sorted reduce at C = 3,
    64, 128 (sum and max, float32 and bf16), the window MHA at the SST
    buckets, the sparse conv, its input gradient and dW at FSD's level 0."""
    from sst_tpu_torch.utils.preflight import preflight_kernels

    device = _cuda()
    errs = preflight_kernels(device)
    assert set(errs) == {"sorted_reduce", "window_mha", "sparse_conv",
                         "sparse_conv_dgrad", "sparse_conv_dw"}
    assert all(np.isfinite(v) for v in errs.values())
