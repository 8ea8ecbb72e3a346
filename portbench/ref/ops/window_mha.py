"""Attention inside SST's windows, in plain PyTorch.

For q, k, v ``[W, T, C]`` and a key padding mask ``[W, T]`` (True = padded
slot), per window and head of width ``dh = C / H``: float32 logits times
``1/sqrt(dh)``, ``-1e4`` added on padded keys, a softmax, the product with
v. Every step is float32 and autograd takes the gradient; inside
``precision.lower_precision`` the operands of both products are rounded to
fp8 (the control)."""

from __future__ import annotations

import math

import torch

from portbench.ref.precision import operand


def window_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pad: torch.Tensor, nhead: int) -> torch.Tensor:
    w, t, c = q.shape
    dh = c // nhead
    q4, k4, v4 = (operand(x).reshape(w, t, nhead, dh) for x in (q, k, v))
    logits = torch.einsum("wthd,wshd->whts", q4, k4) * (1.0 / math.sqrt(dh))
    logits = logits + torch.where(pad[:, None, None, :], -1e4, 0.0)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("whts,wshd->wthd", operand(p), v4).reshape(w, t, c)
