"""Fused multi-head attention inside SST's windows, as a Hopper kernel.

Counterpart of ``sst_tpu/ops/pallas_attention.py`` (``_mha_kernel``, reached
through ``window_mha``). For q, k, v ``[W, T, C]`` bf16 and a key padding
mask ``[W, T]`` (True = padded slot) it computes, per window and head of
width ``dh = C / H``, the Pallas kernel's function with its roundings: f32
logits of the bf16 inputs times ``1/sqrt(dh)``, ``-1e4`` added on padded
keys, a max-subtracted f32 ``exp``, the row sum over the unrounded
probabilities, ``sum bf16(p) * v`` accumulated in f32, divided by the row
sum after AV, rounded to bf16. Rows of padded queries are finite and
meaningless to the caller; the kernel writes zeros where a whole window or
a whole 16-row query tile is padded (it skips their work) and computes the
other padded rows. The kernel is ``csrc/window_mha.cu``; the source note
there says what bounds it and how it is laid out.

Dispatch is by the device of the tensors alone: a CPU tensor goes to the
plain PyTorch twin :func:`window_mha_ref`, a CUDA tensor to the kernel (or
the call raises). ``launches`` counts kernel launches and ``launch_counts``
splits them by ``(T, C, H)``, so a run can show that its main path went
through the kernel, and at which shapes; ``kind_counts`` splits them into a
call's ``"forward"`` and its ``"recompute"`` in the backward of a
rematerialised block (``utils/remat.py``).

Under autograd the call is a ``torch.autograd.Function`` (the JAX
package's ``jax.custom_vjp``): the forward as above, and the backward
:func:`window_mha_backward`, a port of JAX's ``_mha_bwd``, on either
device. That backward is no Pallas kernel in JAX (an f32 einsum recompute),
so plain PyTorch computes it here too.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from sst_tpu_torch.utils import remat

HEAD_DIM = 16  # the kernel's head width: SST's d_model 128 over 8 heads
MAX_TOKENS = 320  # the kernel's bound on T
TILE = 16  # the kernel's query rows per warp task and keys per chunk

launches = 0  # kernel launches in this process
launch_counts: dict[tuple[int, int, int], int] = {}  # by (T, C, H)
kind_counts: dict[str, int] = {}  # forward, recompute


def reset_launch_counts() -> None:
    global launches
    launches = 0
    launch_counts.clear()
    kind_counts.clear()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           pad: torch.Tensor, nhead: int) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected q, k, v of one shape [W, T, C], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    w, t, c = q.shape
    if pad.shape != (w, t):
        raise ValueError(f"expected pad [W, T] = {(w, t)}, got "
                         f"{tuple(pad.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"q, k, v must be bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if pad.dtype != torch.bool:
        raise TypeError(f"pad must be bool, got {pad.dtype}")
    if not (q.device == k.device == v.device == pad.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}, pad on {pad.device}")
    if nhead <= 0 or c % nhead:
        raise ValueError(f"C={c} is not a multiple of nhead={nhead}")


def window_mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pad: torch.Tensor, nhead: int) -> torch.Tensor:
    """Plain PyTorch twin: f32 einsums of the bf16 inputs with the kernel's
    roundings (bf16 probabilities into AV, the division after AV, a bf16
    output)."""
    w, t, c = q.shape
    dh = c // nhead
    q4, k4, v4 = (x.float().reshape(w, t, nhead, dh) for x in (q, k, v))
    logits = torch.einsum("wthd,wshd->whts", q4, k4) * (1.0 / math.sqrt(dh))
    logits = logits + pad.float()[:, None, None, :] * -1e4
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    s = p.sum(-1, keepdim=True).permute(0, 2, 1, 3)  # [W, T, H, 1]
    o = torch.einsum("whts,wshd->wthd", p.bfloat16().float(), v4)
    return (o / s).to(torch.bfloat16).reshape(w, t, c)


def skipped_rows(pad: torch.Tensor) -> torch.Tensor:
    """[W, T] bool: the rows the kernel writes as zeros without computing
    them, those of a window without a valid slot or of a 16-row query tile
    whose rows are all padded."""
    w, t = pad.shape
    tiles = -(-t // TILE)
    live = torch.zeros((w, tiles * TILE), dtype=torch.bool, device=pad.device)
    live[:, :t] = ~pad
    live = live.view(w, tiles, TILE).any(-1)
    return ~live.repeat_interleave(TILE, 1)[:, :t]


@functools.cache
def _kernel():
    """The C entry point, bound once."""
    from sst_tpu_torch.utils.nvcc import load_kernel_library

    fn = load_kernel_library("window_mha").lib.sst_window_mha_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            pad: torch.Tensor, nhead: int) -> torch.Tensor:
    global launches
    w, t, c = q.shape
    if c != nhead * HEAD_DIM:
        raise ValueError(f"the kernel takes heads of width {HEAD_DIM}; got "
                         f"C={c} over {nhead} heads")
    if t > MAX_TOKENS:
        raise ValueError(f"the kernel takes T <= {MAX_TOKENS}, got {t}")
    if not (q.stride() == k.stride() == v.stride()) or q.stride(2) != 1:
        raise ValueError(f"q, k, v must share their strides and have unit "
                         f"channel stride, got {q.stride()}, {k.stride()}, "
                         f"{v.stride()}")
    if any(st <= 0 or st % 8 for st in q.stride()[:2]) or any(
            x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"the kernel copies 16-byte rows: q, k, v need "
                         f"window and row strides that are positive "
                         f"multiples of 8 and 16-byte aligned data, got "
                         f"strides {q.stride()}")
    pad = pad.contiguous()
    fn = _kernel()
    out = torch.empty((w, t, c), dtype=torch.bfloat16, device=q.device)
    if w == 0 or t == 0:
        return out
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
                out.data_ptr(), w, t, c, nhead, q.stride(1), q.stride(0),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"window_mha kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    key = (t, c, nhead)
    launch_counts[key] = launch_counts.get(key, 0) + 1
    kind = "recompute" if remat.recomputing() else "forward"
    kind_counts[kind] = kind_counts.get(kind, 0) + 1
    return out


def window_mha_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pad: torch.Tensor, nhead: int,
                        grad_out: torch.Tensor):
    """The gradients (dq, dk, dv) of the attention at ``grad_out``, in q, k
    and v's dtype: JAX's ``_mha_bwd``. The probabilities P are recomputed
    in f32 from the bf16 inputs (f32 logits times ``1/sqrt(dh)``, ``-1e4``
    on padded keys, a softmax), then ``dv = P^T g``, ``dP = g v^T``,
    ``dS = P (dP - sum(dP P)) / sqrt(dh)``, ``dq = dS k``, ``dk = dS^T q``,
    all in f32. It is the gradient of softmax attention with f32
    probabilities, not of the forward's bf16(P) rounding, as in JAX."""
    w, t, c = q.shape
    dh = c // nhead
    scale = math.sqrt(dh)
    q4, k4, v4 = (x.float().reshape(w, t, nhead, dh) for x in (q, k, v))
    logits = torch.einsum("wthd,wshd->whts", q4, k4) / scale
    logits = logits + torch.where(pad[:, None, None, :], -1e4, 0.0)
    p = torch.softmax(logits, dim=-1)
    g4 = grad_out.float().reshape(w, t, nhead, dh)
    dv = torch.einsum("whts,wthd->wshd", p, g4)
    dp = torch.einsum("wthd,wshd->whts", g4, v4)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / scale
    dq = torch.einsum("whts,wshd->wthd", ds, k4)
    dk = torch.einsum("whts,wthd->wshd", ds, q4)
    return tuple(d.reshape(w, t, c).to(x.dtype)
                 for d, x in ((dq, q), (dk, k), (dv, v)))


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             pad: torch.Tensor, nhead: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return window_mha_ref(q, k, v, pad, nhead)
    return _launch(q, k, v, pad, nhead)


class _WindowMHA(torch.autograd.Function):
    """The forward of :func:`window_mha` with JAX's custom-vjp backward;
    no gradient for ``pad``."""

    @staticmethod
    def forward(ctx, q, k, v, pad, nhead):
        ctx.save_for_backward(q, k, v, pad)
        ctx.nhead = nhead
        return _forward(q, k, v, pad, nhead)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, pad = ctx.saved_tensors
        dq, dk, dv = window_mha_backward(q, k, v, pad, ctx.nhead, grad_out)
        return dq, dk, dv, None, None


def window_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pad: torch.Tensor, nhead: int) -> torch.Tensor:
    """Attention inside each window; differentiable in q, k and v
    (:func:`window_mha_backward`).

    Args:
      q, k, v: [W, T, C] bfloat16; on the card they may be the three column
        blocks of one [W, T, 3C] buffer (shared strides, multiples of 8,
        unit channel stride), so the split costs no copy; their gradients
        then land in that buffer's gradient.
      pad: [W, T] bool, True for a padded key slot.
      nhead: heads; on the card C must be ``nhead * 16`` and T at most 320.
    Returns [W, T, C] bfloat16, contiguous.
    """
    _check(q, k, v, pad, nhead)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _WindowMHA.apply(q, k, v, pad, nhead)
    # with no graph to record, skip the Function: its apply adds ~15-20 us
    # of host time per call on the card (chip_smoke.py phase 8), about a
    # third of the wrapper's, on a predict path bound by host time
    return _forward(q, k, v, pad, nhead)
