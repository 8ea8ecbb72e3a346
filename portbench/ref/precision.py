"""The precision of the reference's products and maps.

The reference computes every product in float32 (TF32 off) and keeps every
map in float32. The control, which has to come out as not correct,
computes the same function one step below the configurations' bfloat16
policy (bfloat16 products and maps): the operands of every product (each
Dense, convolution, transposed convolution and attention product) and the
output of every Dense, convolution and norm layer rounded to float8 e4m3
under a per-tensor scale, and in training the gradient that flows back
through each of them rounded alike. Inside :func:`lower_precision` the
control's rounding applies; outside it nothing is rounded."""

from __future__ import annotations

import contextlib
import contextvars

import torch

_ON = contextvars.ContextVar("portbench_lower_precision", default=False)
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, rounded to float8 e4m3 after scaling its largest
    magnitude to e4m3's largest finite value (one scale per tensor)."""
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _RoundFP8(torch.autograd.Function):
    """A map rounded to float8 e4m3, and the gradient that flows back
    through it rounded too: the port's policy keeps a map's gradient in the
    map's precision, so the control keeps it in the precision below."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    return _RoundFP8.apply(x)


def operand(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product, or a layer's output map: float32, or
    rounded to float8 e4m3 in the control."""
    return round_fp8(x) if _ON.get() else x.float()


@contextlib.contextmanager
def lower_precision():
    token = _ON.set(True)
    try:
        yield
    finally:
        _ON.reset(token)
