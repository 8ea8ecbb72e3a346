"""Static compaction helpers (counterpart of ``sst_tpu/ops/ccl.py``)."""

from __future__ import annotations

import torch


def stable_topk(values: torch.Tensor, k: int):
    """Top-k along the last axis with ``jax.lax.top_k``'s tie order (the
    lower index first): a stable descending sort, then a slice.
    ``torch.topk`` promises no order among ties."""
    top, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


def topk_compact(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Select up to k rows by score among ``mask``; returns (indices [k],
    valid [k]) — the static-shape replacement for boolean-mask compaction."""
    s = torch.where(mask, scores, -torch.inf)
    top, idx = stable_topk(s, k)
    return idx, torch.isfinite(top)
