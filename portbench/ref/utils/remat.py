"""Rematerialisation of a module call in the backward pass (the counterpart
of flax's ``nn.remat``), and a flag that tells the backward's recompute
apart from the first forward.

``torch.utils.checkpoint`` runs the wrapped call twice: in the forward,
keeping only its inputs, and again in the backward to rebuild what the
gradients need. JAX recomputes a pure function, so the recompute's
``batch_stats`` update is discarded; here :func:`recomputing` is True inside
the recompute, and ``MaskedBatchNorm`` skips its running-statistics update
there. The kernel wrappers read it to count recompute launches apart.
"""

from __future__ import annotations

import contextlib

import torch.utils.checkpoint

_depth = 0  # recomputes in progress (the autograd engine runs one at a time)


@contextlib.contextmanager
def _recompute():
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def recomputing() -> bool:
    """True while a :func:`checkpoint`-ed call is being recomputed."""
    return _depth > 0


def checkpoint(fn, *args):
    """``fn(*args)``, its intermediates recomputed in the backward instead
    of kept (non-reentrant ``torch.utils.checkpoint``)."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute()))
