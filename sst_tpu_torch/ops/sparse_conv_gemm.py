"""Sparse 3D convolution over a neighbour table, as a Hopper kernel.

Counterpart of the compute half of ``sst_tpu/ops/sparse_conv_pallas.py``
(``_conv_kernel``) and of ``sst_tpu/ops/sparse_conv.py gather_gemm``. The
rulebook (``ops/sparse_conv.py build_conv_plans``) gives each conv a
``[K, Vout]`` int32 neighbour table; this module computes

    out[v, :] = sum_k feats[nbr[k, v], :] @ W[k]

with an index outside [0, Vin) reading a zero row. The kernel is
``csrc/sparse_conv_gemm.cu``; the source note there says what bounds it and
how it is laid out. It runs over a :class:`ConvSchedule` of the table
(:func:`conv_schedule`): the output rows sorted by their tap mask, and per
64-row tile the taps any of its rows has. A plan builds it once per table
and shares it (``ops/sparse_conv.py ConvPlan.schedule``); a caller without
one gets one built by the wrapper.

Operands are float32 or bfloat16, feats and weights of one dtype. The
bfloat16 route is the TPU kernel's: products of bf16 operands summed in
f32, and the result rounded to bf16 once (``_fwd_impl`` casts its f32 sums
to ``feats.dtype``); the twin computes it in f32 from the bf16 inputs and
rounds once.

Dispatch is by the device of the tensors alone: a CPU tensor goes to the
plain PyTorch twin :func:`sparse_conv_gemm_ref`, a CUDA tensor to the kernel
(or the call raises). ``launches`` counts kernel launches and
``launch_counts`` splits them by ``(mode, Cin, Cout)`` for float32 and by
``(mode, Cin, Cout, "bfloat16")`` for the bf16 route, so a run can show
that its main path went through the kernel, and with which widths and
dtype;
``kind_counts`` splits them by what the launch computed: a conv's
``"forward"``, its ``"recompute"`` in the backward of a rematerialised call
(``utils/remat.py``), or the input gradient (``"dgrad"``: this kernel over
the transposed table, see ``ops/sparse_conv.py``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from sst_tpu_torch.utils import remat

# the conv's kind, read only by the launch counts: "zdown" is SECOND's
# z-only (3, 1, 1) conv_out, a 3-tap table
MODES = ("subm", "strided", "inverse", "zdown")
KINDS = ("forward", "dgrad")
TILE_ROWS = 64  # output rows per tile of the kernel (kRows)
MAX_TAPS = 32  # a tap mask is one 32-bit word

# the kernel's entry point for each operand dtype
ENTRY_POINTS = {torch.float32: "sst_sparse_conv_gemm_f32",
                torch.bfloat16: "sst_sparse_conv_gemm_bf16"}

launches = 0  # kernel launches in this process
# by (mode, Cin, Cout), and (mode, Cin, Cout, "bfloat16") for the bf16 route
launch_counts: dict[tuple, int] = {}
kind_counts: dict[str, int] = {}  # forward, recompute, dgrad


def reset_launch_counts() -> None:
    global launches
    launches = 0
    launch_counts.clear()
    kind_counts.clear()


def _check(feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor,
           mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if feats.dim() != 2 or nbr.dim() != 2 or weights.dim() != 3:
        raise ValueError(f"expected feats [Vin, Cin], nbr [K, Vout] and "
                         f"weights [K, Cin, Cout], got {tuple(feats.shape)}, "
                         f"{tuple(nbr.shape)} and {tuple(weights.shape)}")
    if weights.shape[0] != nbr.shape[0] or weights.shape[1] != feats.shape[1]:
        raise ValueError(f"shapes disagree: feats {tuple(feats.shape)}, nbr "
                         f"{tuple(nbr.shape)}, weights "
                         f"{tuple(weights.shape)}")
    if feats.dtype not in ENTRY_POINTS or weights.dtype != feats.dtype:
        raise TypeError(f"feats and weights must both be float32 or both "
                        f"bfloat16, got {feats.dtype} and {weights.dtype}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"nbr must be int32, got {nbr.dtype}")
    if not (feats.device == nbr.device == weights.device):
        raise ValueError(f"feats on {feats.device}, nbr on {nbr.device}, "
                         f"weights on {weights.device}")
    if not (feats.is_contiguous() and nbr.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("feats, nbr and weights must be contiguous")
    if max(feats.shape[0], nbr.shape[1]) >= 2**31 - 1:
        raise ValueError("row counts must fit in int32")


@dataclass(frozen=True)
class ConvSchedule:
    """The kernel's row schedule of one neighbour table.

    perm: [Vout] int32, the output rows sorted (stably) by their tap mask;
      tile ``i`` computes rows ``perm[64 i : 64 (i + 1)]``.
    tile_mask: [ceil(Vout / 64)] int32, bit ``k`` set if a row of the tile
      has a neighbour at tap ``k`` (the OR of its rows' masks; bit 31 reads
      as the sign).
    vin: the input rows the table was read against (valid entries lie in
      [0, vin)).
    """

    perm: torch.Tensor
    tile_mask: torch.Tensor
    vin: int


SIGN = -2**31  # int32 bit 31: XOR with it maps unsigned order onto signed


def conv_schedule(nbr: torch.Tensor, vin: int) -> ConvSchedule:
    """The mask-sorted row schedule of ``nbr`` [K, Vout] (K <= 32): a stable
    sort of the rows by tap mask, as unsigned 32-bit words (rows without
    neighbours, mask 0, come first and fill whole tiles of their own where
    they are many), and the OR of each tile's masks. Plain torch on the
    table's device, in int32 throughout, with no host synchronisation."""
    taps, vout = nbr.shape
    if taps > MAX_TAPS:
        raise ValueError(f"the kernel's tap masks hold {MAX_TAPS} taps, the "
                         f"table has {taps}")
    bits = 1 << torch.arange(taps, dtype=torch.int32, device=nbr.device)
    masks = torch.where((nbr >= 0) & (nbr < vin), bits[:, None], 0).sum(
        0, dtype=torch.int32)
    key, perm = torch.sort(masks ^ SIGN, stable=True)
    tiles = -(-vout // TILE_ROWS)
    key = torch.nn.functional.pad(key ^ SIGN, (0, tiles * TILE_ROWS - vout))
    has = (key.view(tiles, TILE_ROWS, 1) & bits).ne(0).any(1)
    tile_mask = torch.where(has, bits, 0).sum(-1, dtype=torch.int32)
    return ConvSchedule(perm=perm.to(torch.int32), tile_mask=tile_mask,
                        vin=vin)


def check_schedule(schedule: ConvSchedule, nbr: torch.Tensor,
                   vin: int) -> None:
    vout = nbr.shape[1]
    tiles = -(-vout // TILE_ROWS)
    if schedule.vin != vin:
        raise ValueError(f"schedule built for Vin={schedule.vin}, called "
                         f"with {vin}")
    for name, t, n in (("perm", schedule.perm, vout),
                       ("tile_mask", schedule.tile_mask, tiles)):
        if t.shape != (n,) or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"schedule {name} must be [{n}] int32 "
                             f"contiguous, got {tuple(t.shape)} {t.dtype}")
        if t.device != nbr.device:
            raise ValueError(f"schedule {name} on {t.device}, nbr on "
                             f"{nbr.device}")


def sparse_conv_gemm_ref(feats: torch.Tensor, nbr: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin (``gather_gemm`` semantics): one gather and one
    matmul per tap, accumulated in f32, so the ``[K, Vout, Cin]`` gathered
    tensor is never held whole. bf16 operands are widened to f32 (exactly)
    and the f32 result is rounded to bf16 once."""
    if feats.dtype == torch.bfloat16:
        return sparse_conv_gemm_ref(feats.float(), nbr,
                                    weights.float()).bfloat16()
    vin, cin = feats.shape
    ext = torch.cat([feats, feats.new_zeros((1, cin))])
    idx = nbr.long()
    idx = torch.where((idx >= 0) & (idx < vin), idx, vin)
    out = feats.new_zeros((nbr.shape[1], weights.shape[2]))
    for k in range(nbr.shape[0]):
        out += ext.index_select(0, idx[k]) @ weights[k]
    return out


@functools.cache
def _kernel(dtype: torch.dtype):
    """The C entry point of ``dtype``'s route, bound once."""
    from sst_tpu_torch.utils.nvcc import load_kernel_library

    fn = getattr(load_kernel_library("sparse_conv_gemm").lib,
                 ENTRY_POINTS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor,
            mode: str, kind: str,
            schedule: ConvSchedule | None) -> torch.Tensor:
    global launches
    fn = _kernel(feats.dtype)
    vin, cin = feats.shape
    taps, vout = nbr.shape
    cout = weights.shape[2]
    out = torch.empty((vout, cout), dtype=feats.dtype, device=feats.device)
    if vout == 0 or cout == 0:
        return out
    if schedule is None:
        schedule = conv_schedule(nbr, vin)
    check_schedule(schedule, nbr, vin)
    with torch.cuda.device(feats.device):
        rc = fn(feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
                schedule.perm.data_ptr(), schedule.tile_mask.data_ptr(),
                out.data_ptr(), vin, vout, cin, cout, taps,
                torch.cuda.current_stream(feats.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sparse_conv_gemm kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    key = ((mode, cin, cout) if feats.dtype == torch.float32
           else (mode, cin, cout, "bfloat16"))
    launch_counts[key] = launch_counts.get(key, 0) + 1
    if kind == "forward" and remat.recomputing():
        kind = "recompute"
    kind_counts[kind] = kind_counts.get(kind, 0) + 1
    return out


def sparse_conv_gemm(feats: torch.Tensor, nbr: torch.Tensor,
                     weights: torch.Tensor, mode: str = "subm",
                     kind: str = "forward",
                     schedule: ConvSchedule | None = None) -> torch.Tensor:
    """One sparse conv from its neighbour table.

    Args:
      feats: [Vin, Cin] float32 or bfloat16 input sites.
      nbr: [K, Vout] int32; tap k of output v reads row ``nbr[k, v]``, and
        an index outside [0, Vin) reads zeros.
      weights: [K, Cin, Cout], ``feats``' dtype.
      mode: 'subm' | 'strided' | 'inverse' | 'zdown'; only read by the
        launch count.
      kind: 'forward' | 'dgrad'; only read by the launch count.
      schedule: :func:`conv_schedule` of ``(nbr, Vin)``, built here when
        None; read only by the kernel (the twin needs none).
    Returns [Vout, Cout] in ``feats``' dtype.
    """
    _check(feats, nbr, weights, mode)
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if feats.device.type == "cpu":
        return sparse_conv_gemm_ref(feats, nbr, weights)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    return _launch(feats, nbr, weights, mode, kind, schedule)
