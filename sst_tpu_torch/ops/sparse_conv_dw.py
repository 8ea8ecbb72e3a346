"""Weight gradient of the sparse 3D convolution, as a Hopper kernel.

Counterpart of ``sst_tpu/ops/sparse_conv_pallas.py`` ``_dw_kernel`` /
``_dw_impl``: for a conv with ``[K, Vout]`` neighbour table ``nbr``,

    dW[k] = sum_v feats[nbr[k, v]]^T  dout[v]        ([K, Cin, Cout])

with an index outside [0, Vin) reading a zero row. The kernel is
``csrc/sparse_conv_dw.cu``; the source note there says what bounds it and how
it is laid out. It runs over the forward's :class:`ConvSchedule` (the output
rows sorted by tap mask in 64-row tiles; ``ops/sparse_conv.py`` passes the
one its plan caches): tap k reads only the tiles whose mask has bit k. A
caller without a schedule gets one built by the wrapper.

Operands are float32 or bfloat16, feats and dout of one dtype. The
bfloat16 route is the TPU kernel's with ``_windowed_conv_bwd``'s rounding:
products of bf16 operands summed in f32, and dW rounded to bf16 once; the
twin computes it in f32 from the bf16 inputs and rounds once.

Dispatch is by the device of the tensors alone: a CPU tensor goes to the
plain PyTorch twin :func:`sparse_conv_dw_ref`, a CUDA tensor to the kernel
(or the call raises). ``launches`` counts kernel launches and
``launch_counts`` splits them by ``(mode, Cin, Cout)`` for float32 and by
``(mode, Cin, Cout, "bfloat16")`` for the bf16 route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sst_tpu_torch.ops.sparse_conv_gemm import (
    MODES,
    TILE_ROWS,
    ConvSchedule,
    check_schedule,
    conv_schedule,
)

# the kernel's entry point for each operand dtype
ENTRY_POINTS = {torch.float32: "sst_sparse_conv_dw_f32",
                torch.bfloat16: "sst_sparse_conv_dw_bf16"}

launches = 0  # kernel launches in this process
# by (mode, Cin, Cout), and (mode, Cin, Cout, "bfloat16") for the bf16 route
launch_counts: dict[tuple, int] = {}

_TILE = 64  # channels per tile side
# 4 resident blocks (128 registers a thread) on each of the H100's 132 SMs,
# eight waves of them, so that the taps' unequal work evens out
_TARGET_BLOCKS = 132 * 4 * 8
_MIN_TILES_PER_SPLIT = 8
_MAX_TILES_PER_SPLIT = 512  # a split's share of a tap's tiles, in shared mem


def reset_launch_counts() -> None:
    global launches
    launches = 0
    launch_counts.clear()


def _check(feats: torch.Tensor, nbr: torch.Tensor, dout: torch.Tensor,
           mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if feats.dim() != 2 or nbr.dim() != 2 or dout.dim() != 2:
        raise ValueError(f"expected feats [Vin, Cin], nbr [K, Vout] and dout "
                         f"[Vout, Cout], got {tuple(feats.shape)}, "
                         f"{tuple(nbr.shape)} and {tuple(dout.shape)}")
    if dout.shape[0] != nbr.shape[1]:
        raise ValueError(f"shapes disagree: nbr {tuple(nbr.shape)}, dout "
                         f"{tuple(dout.shape)}")
    if feats.dtype not in ENTRY_POINTS or dout.dtype != feats.dtype:
        raise TypeError(f"feats and dout must both be float32 or both "
                        f"bfloat16, got {feats.dtype} and {dout.dtype}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"nbr must be int32, got {nbr.dtype}")
    if not (feats.device == nbr.device == dout.device):
        raise ValueError(f"feats on {feats.device}, nbr on {nbr.device}, "
                         f"dout on {dout.device}")
    if not (feats.is_contiguous() and nbr.is_contiguous()
            and dout.is_contiguous()):
        raise ValueError("feats, nbr and dout must be contiguous")
    if max(feats.shape[0], nbr.shape[1]) >= 2**31 - 1:
        raise ValueError("row counts must fit in int32")


def sparse_conv_dw_ref(feats: torch.Tensor, nbr: torch.Tensor,
                       dout: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: per tap one ``index_select`` of the neighbour rows
    and one ``gathered.T @ dout``, in f32. bf16 operands are widened to f32
    (exactly) and dW is rounded to bf16 once."""
    if feats.dtype == torch.bfloat16:
        return sparse_conv_dw_ref(feats.float(), nbr, dout.float()).bfloat16()
    vin, cin = feats.shape
    ext = torch.cat([feats, feats.new_zeros((1, cin))])
    idx = nbr.long()
    idx = torch.where((idx >= 0) & (idx < vin), idx, vin)
    out = feats.new_empty((nbr.shape[0], cin, dout.shape[1]))
    for k in range(nbr.shape[0]):
        out[k] = ext.index_select(0, idx[k]).T @ dout
    return out


def split_rows(taps: int, cin: int, cout: int, vout: int) -> int:
    """The number of splits S: each tap's list of the schedule's 64-row
    tiles is cut into S equal shares, enough that the grid of (tap, Cin
    tile, Cout tile, split) blocks fills the card eight times over, while a
    split could take 8 tiles and takes at most 512."""
    blocks = taps * -(-cin // _TILE) * -(-cout // _TILE)
    tiles = -(-vout // TILE_ROWS)
    splits = max(1, min(-(-_TARGET_BLOCKS // blocks),
                        -(-tiles // _MIN_TILES_PER_SPLIT)),
                 -(-tiles // _MAX_TILES_PER_SPLIT))
    return splits


@functools.cache
def _kernel(dtype: torch.dtype):
    """The C entry point of ``dtype``'s route, bound once."""
    from sst_tpu_torch.utils.nvcc import load_kernel_library

    fn = getattr(load_kernel_library("sparse_conv_dw").lib,
                 ENTRY_POINTS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(feats: torch.Tensor, nbr: torch.Tensor, dout: torch.Tensor,
            mode: str, schedule: ConvSchedule | None) -> torch.Tensor:
    global launches
    vin, cin = feats.shape
    taps, vout = nbr.shape
    cout = dout.shape[1]
    dw = torch.empty((taps, cin, cout), dtype=feats.dtype,
                     device=feats.device)
    if taps == 0 or cin == 0 or cout == 0:
        return dw
    if vout == 0:
        return dw.zero_()
    if schedule is None:
        schedule = conv_schedule(nbr, vin)
    check_schedule(schedule, nbr, vin)
    splits = split_rows(taps, cin, cout, vout)
    tiles = schedule.tile_mask.shape[0]
    lists = torch.empty(taps * (tiles + 1), dtype=torch.int32,
                        device=feats.device)
    work = (torch.empty((splits, taps, cin, cout), dtype=torch.float32,
                        device=feats.device) if splits > 1 else None)
    with torch.cuda.device(feats.device):
        rc = _kernel(feats.dtype)(feats.data_ptr(), nbr.data_ptr(), dout.data_ptr(),
                       schedule.perm.data_ptr(),
                       schedule.tile_mask.data_ptr(), lists.data_ptr(),
                       work.data_ptr() if work is not None else None,
                       dw.data_ptr(), vin, vout, cin, cout, taps, splits,
                       torch.cuda.current_stream(feats.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sparse_conv_dw kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    key = ((mode, cin, cout) if feats.dtype == torch.float32
           else (mode, cin, cout, "bfloat16"))
    launch_counts[key] = launch_counts.get(key, 0) + 1
    return dw


def sparse_conv_dw(feats: torch.Tensor, nbr: torch.Tensor, dout: torch.Tensor,
                   mode: str = "subm",
                   schedule: ConvSchedule | None = None) -> torch.Tensor:
    """The weight gradient of one sparse conv from its neighbour table.

    Args:
      feats: [Vin, Cin] float32 or bfloat16, the conv's input.
      nbr: [K, Vout] int32; tap k of output v read row ``nbr[k, v]``, and an
        index outside [0, Vin) read zeros.
      dout: [Vout, Cout], the gradient of the conv's output, ``feats``'
        dtype.
      mode: 'subm' | 'strided' | 'inverse' | 'zdown'; only read by the
        launch count.
      schedule: :func:`conv_schedule` of ``(nbr, Vin)`` (the forward's),
        built here when None; read only by the kernel (the twin needs none).
    Returns [K, Cin, Cout] in ``feats``' dtype.
    """
    _check(feats, nbr, dout, mode)
    if feats.device.type == "cpu":
        return sparse_conv_dw_ref(feats, nbr, dout)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    return _launch(feats, nbr, dout, mode, schedule)
