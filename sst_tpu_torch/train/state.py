"""The optimizer and its learning-rate schedule (counterpart of
``sst_tpu/train/state.py``).

The JAX package chains optax's ``clip_by_global_norm(clip_norm)`` and
``adamw(cosine_onecycle(base_lr, total_steps), b1, b2, eps=1e-8,
weight_decay)``. Here that is ``torch.optim.AdamW`` with the same betas, eps
and decoupled weight decay on every parameter (optax's unmasked ``adamw``),
after an explicit global-norm clip, with the learning rate of each step set
from a copy of optax's ``cosine_onecycle_schedule`` at the step count before
the increment (optax's ``scale_by_schedule``). The model holds the
parameters and the running statistics; the optimizer holds the step count
and AdamW's moments.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def cosine_onecycle(base_lr: float, total_steps: int, pct_start: float = 0.4,
                    div_factor: float = 10.0,
                    final_div: float = 1e4) -> Callable[[int], float]:
    """optax ``cosine_onecycle_schedule(total_steps, base_lr, pct_start,
    div_factor, final_div)``: cosine from ``base_lr / div_factor`` up to
    ``base_lr`` over the first ``pct_start`` of the steps, then down to
    ``base_lr / (div_factor * final_div)``, which it keeps."""
    if total_steps <= 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    init = base_lr / div_factor
    values = (init, init * div_factor,
              init * div_factor * (1.0 / (div_factor * final_div)))

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (
                    math.cos(math.pi * pct) + 1.0)
        return values[-1] if count >= bounds[-1] else 0.0

    return schedule


class ClippedAdamW:
    """Global-norm clip, then AdamW at the schedule's rate for this step.

    A parameter that no loss reached gets a zero gradient, as every leaf
    does in JAX: its moments decay and its weight decays.
    ``params_without_grad`` counts them in the last step."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], clip_norm: float,
                 weight_decay: float, betas=(0.9, 0.999)):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.count = 0
        self.params_without_grad = 0
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0),
                                       betas=tuple(betas), eps=1e-8,
                                       weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, step, count; returns the global norm of the gradients
        before clipping (a 0-d tensor, not synchronised)."""
        missing = [p for p in self.params if p.grad is None]
        for p in missing:
            p.grad = torch.zeros_like(p)
        self.params_without_grad = len(missing)
        grads = [p.grad for p in self.params]
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        # optax: t unchanged below the limit, else (t / norm) * clip_norm
        keep = norm < self.clip_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   base_lr: float = 1e-5, weight_decay: float = 0.05,
                   total_steps: int = 100000, clip_norm: float = 10.0,
                   betas=(0.9, 0.999)) -> ClippedAdamW:
    """The JAX package's ``make_optimizer`` over ``params`` (for example
    ``model.parameters()``)."""
    return ClippedAdamW(params, cosine_onecycle(base_lr, total_steps),
                        clip_norm, weight_decay, betas)
