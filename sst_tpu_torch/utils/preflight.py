"""Preflight of the hand-written kernels: each one built, launched and held
against its plain PyTorch twin on the card, at the shapes the models give
it (counterpart of ``sst_tpu/utils/preflight.py preflight_pallas``).

    from sst_tpu_torch.utils.preflight import preflight_kernels
    preflight_kernels("cuda")   # raises on the first disagreement

The checks and their shapes are the JAX preflight's:
  - the sorted segment reduce over 196,608 sorted rows into 27,648
    segments (7 rows past the range), C = 3 (the cluster-centre sum), 64
    and 128 (the VFE layers), sum and max, in float32 and bfloat16;
  - the window MHA at the SST buckets (W, T) = (512, 30), (256, 60),
    (64, 100), (32, 144), d_model 128 over 8 heads, a fifth of the keys
    padded;
  - the sparse conv, subm and strided, at FSD's level-0 scale (about
    120,000 active sites of a 32 x 640 x 640 grid under a 131,072 cap,
    64 -> 64 channels), and its input gradient (the same kernel over the
    transposed table) and weight gradient (``sparse_conv_dw``) there.

The tolerances are ``PERF.md`` section 2's, the ones ``chip_smoke.py``
holds the kernels to: a max equal bit for bit; a float32 sum within
1e-5 |twin| + 1e-5 sqrt(rows); a bfloat16 sum within one bf16 ulp; the
window MHA within 2^-7 |twin| + 2^-8 max|v| on valid query rows; the
conv and its input gradient within 1e-4 + 1e-4 |twin|; dW within
1e-4 (|feats|^T |dout|) + 1e-6. There is no kill switch and no fallback:
a kernel that fails raises, and the caller stops. On a CPU device the
preflight raises, since the kernels run only on a CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch


class PreflightError(AssertionError):
    """A kernel disagreed with its plain twin."""


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise PreflightError(what)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at each value (the spacing of its binade)."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0**-126)))
    return 2.0 ** (e - 7)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return torch.equal(a.contiguous().view(bits), b.contiguous().view(bits))


def check_sorted_reduce(device) -> float:
    """Every (C, mode, dtype) the models route through the kernel; returns
    the largest error."""
    from sst_tpu_torch.ops import sorted_reduce as sr

    rng = np.random.default_rng(0)
    n, v = 196_608, 27_648
    seg = np.sort(rng.integers(0, v, size=n)).astype(np.int32)
    seg[-7:] = v + 3  # rows past the range
    seg_t = torch.from_numpy(seg).to(device)
    rows = torch.bincount(seg_t[seg_t < v].long(), minlength=v).float()
    worst = 0.0
    for c in (3, 64, 128):
        base = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            data = base.to(device=device, dtype=dtype)
            for mode in ("sum", "max"):
                got = sr.sorted_segment_reduce(data, seg_t, v, mode)
                ref = sr.sorted_segment_reduce_ref(data, seg_t, v, mode)
                what = f"sorted_reduce C={c} {mode} {dtype}"
                _require(got.dtype == dtype, f"{what}: returned {got.dtype}")
                diff = (got.float() - ref.float()).abs()
                worst = max(worst, diff.max().item())
                if mode == "max":
                    ok = _same_bits(got, ref)
                elif dtype == torch.bfloat16:
                    ok = bool((diff <= _bf16_ulp(ref)).all())
                else:
                    tol = 1e-5 * ref.abs() + 1e-5 * rows.sqrt()[:, None]
                    ok = bool((diff <= tol).all())
                _require(ok, f"{what}: max_abs_err {diff.max().item():.3e}")
    return worst


def check_window_mha(device) -> float:
    """The SST buckets' shapes, q, k, v in bf16, on valid query rows."""
    from sst_tpu_torch.ops import window_mha as wm

    rng = np.random.default_rng(1)
    worst = 0.0
    for w, t in ((512, 30), (256, 60), (64, 100), (32, 144)):
        q, k, v = (torch.from_numpy(rng.normal(size=(w, t, 128)).astype(
            np.float32)).to(device=device, dtype=torch.bfloat16)
            for _ in range(3))
        pad = rng.random((w, t)) < 0.2
        pad[:, 0] = False  # no fully padded window
        pad = torch.from_numpy(pad).to(device)
        got = wm.window_mha(q, k, v, pad, 8).float()
        ref = wm.window_mha_ref(q, k, v, pad, 8).float()
        rows = ~pad
        diff = (got - ref).abs()[rows]
        tol = (2.0**-7 * ref.abs() + 2.0**-8 * v.float().abs().max())[rows]
        worst = max(worst, diff.max().item())
        _require(bool((diff <= tol).all())
                 and bool(torch.isfinite(got).all()),
                 f"window_mha W={w} T={t}: max_abs_err "
                 f"{diff.max().item():.3e}")
    return worst


def _fsd_level0(device):
    """The FSD segmentor's level 0 and its stride-2 level 1: about 120,000
    random sites of a 32 x 640 x 640 grid under a 131,072 cap."""
    from sst_tpu_torch.ops.sparse_conv import downsample_grid, make_sparse_grid

    rng = np.random.default_rng(2)
    grid, cap = (32, 640, 640), 131072
    keys = np.unique(rng.integers(0, grid[0] * grid[1] * grid[2],
                                  size=120_000))
    n = min(len(keys), cap)
    coords = np.full((cap, 4), -1, np.int32)
    coords[:n, 0] = 0
    coords[:n, 1] = keys[:n] // (grid[1] * grid[2])
    coords[:n, 2] = (keys[:n] // grid[2]) % grid[1]
    coords[:n, 3] = keys[:n] % grid[2]
    valid = np.arange(cap) < n
    sg, _ = make_sparse_grid(torch.from_numpy(coords).to(device),
                             torch.from_numpy(valid).to(device), grid, 1)
    return sg, downsample_grid(sg, cap // 2), rng


def check_sparse_conv(device) -> dict:
    """The conv, its input gradient and its weight gradient, subm and
    strided, at FSD's level-0 scale, 64 -> 64 channels; returns the
    largest error of each."""
    from sst_tpu_torch.ops import sparse_conv_dw as sdw
    from sst_tpu_torch.ops import sparse_conv_gemm as scg
    from sst_tpu_torch.ops.sparse_conv import build_conv_plans

    sg, down, rng = _fsd_level0(device)
    feats = torch.from_numpy(rng.normal(size=(sg.cap, 64)).astype(
        np.float32)).to(device)
    feats = torch.where(sg.valid[:, None], feats, 0.0)
    w = torch.from_numpy((rng.normal(size=(27, 64, 64)) * 0.1).astype(
        np.float32)).to(device)
    worst = {"sparse_conv": 0.0, "sparse_conv_dgrad": 0.0,
             "sparse_conv_dw": 0.0}
    for mode, out_sg in (("subm", sg), ("strided", down)):
        plan = build_conv_plans(out_sg, sg, mode)
        got = scg.sparse_conv_gemm(feats, plan.nbr, w, mode,
                                   schedule=plan.schedule(sg.cap))
        ref = scg.sparse_conv_gemm_ref(feats, plan.nbr, w)
        diff = (got - ref).abs()
        worst["sparse_conv"] = max(worst["sparse_conv"], diff.max().item())
        _require(bool((diff <= 1e-4 + 1e-4 * ref.abs()).all()),
                 f"sparse_conv {mode}: max_abs_err {diff.max().item():.3e}")

        dout = torch.from_numpy(rng.normal(size=(out_sg.cap, 64)).astype(
            np.float32)).to(device)
        dout = torch.where(out_sg.valid[:, None], dout, 0.0)
        nbr_t = plan.transposed(sg.cap)
        wt = w.transpose(1, 2).contiguous()
        got = scg.sparse_conv_gemm(dout, nbr_t, wt, mode, kind="dgrad",
                                   schedule=plan.transposed_schedule(sg.cap))
        ref = scg.sparse_conv_gemm_ref(dout, nbr_t, wt)
        diff = (got - ref).abs()
        worst["sparse_conv_dgrad"] = max(worst["sparse_conv_dgrad"],
                                         diff.max().item())
        _require(bool((diff <= 1e-4 + 1e-4 * ref.abs()).all()),
                 f"sparse_conv input gradient {mode}: max_abs_err "
                 f"{diff.max().item():.3e}")

        got = sdw.sparse_conv_dw(feats, plan.nbr, dout, mode,
                                 schedule=plan.schedule(sg.cap))
        ref = sdw.sparse_conv_dw_ref(feats, plan.nbr, dout)
        tol = 1e-4 * sdw.sparse_conv_dw_ref(feats.abs(), plan.nbr,
                                            dout.abs()) + 1e-6
        diff = (got - ref).abs()
        worst["sparse_conv_dw"] = max(worst["sparse_conv_dw"],
                                      diff.max().item())
        _require(bool((diff <= tol).all()),
                 f"sparse_conv_dw {mode}: max_abs_err "
                 f"{diff.max().item():.3e}")
    return worst


def preflight_kernels(device="cuda") -> dict:
    """Build and check every kernel on ``device`` (a CUDA device); returns
    {check: largest error against the twin}. Raises ``PreflightError`` on
    the first disagreement, and ``RuntimeError`` on a device that is not a
    card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(
            f"preflight_kernels checks the hand-written CUDA kernels, which "
            f"need a CUDA card; got device {device}")
    from sst_tpu_torch.utils.nvcc import load_kernel_libraries

    load_kernel_libraries(("sorted_reduce", "window_mha",
                           "sparse_conv_gemm", "sparse_conv_dw"))
    results = {"sorted_reduce": check_sorted_reduce(device),
               "window_mha": check_window_mha(device)}
    results.update(check_sparse_conv(device))
    torch.cuda.synchronize(device)
    return results
