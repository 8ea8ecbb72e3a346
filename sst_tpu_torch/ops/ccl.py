"""Connected-component labelling and static compaction helpers
(counterpart of ``sst_tpu/ops/ccl.py``).

FSD clusters its vote centres by the connected components of a thresholded
xy-distance graph: a dense [M, M] adjacency over at most a few thousand
cluster-voxel centres, and min-label propagation to its fixed point, capped
at ``max_iters`` rounds as the JAX package's ``lax.while_loop`` is.
"""

from __future__ import annotations

import torch

from sst_tpu_torch.ops.segment import unique_segments

CCL_CHECK_EVERY = 8  # propagation rounds between two reads of "changed"


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


def connected_components(xy: torch.Tensor, batch_idx: torch.Tensor,
                         valid: torch.Tensor, dist_thr: float,
                         max_iters: int = 64):
    """Label the connected components of the graph
    {(i, j): |xy_i - xy_j| < dist_thr, same batch, both valid}.

    Args:
      xy: [M, 2] float cluster centres.
      batch_idx: [M] int32; edges never cross samples.
      valid: [M] bool.

    Returns (labels, rounds): labels [M] int32 in [0, M), connected nodes
    sharing the minimum node index of their component, invalid rows M; and
    rounds, a 0-dim int32 tensor, the propagation rounds JAX's loop runs
    (those that changed a label, plus the one that found none changed,
    at most ``max_iters``).

    Labels only fall, and a round that changes nothing leaves a fixed
    point, so the loop reads ``changed`` on the host once every
    ``CCL_CHECK_EVERY`` rounds instead of after each: the rounds past the
    fixed point change nothing. The total stays capped at ``max_iters``, so
    where the cap binds the labels are those after exactly ``max_iters``
    rounds, as in JAX.
    """
    m = xy.shape[0]
    d2 = torch.sum((xy[:, None, :] - xy[None, :, :]) ** 2, dim=-1)
    adj = ((d2 < dist_thr**2) & (batch_idx[:, None] == batch_idx[None, :])
           & valid[:, None] & valid[None, :])
    del d2
    labels = torch.where(valid, torch.arange(m, dtype=torch.int32,
                                             device=xy.device), m)
    # rounds that changed a label: once one changes nothing, none after it
    # does, so JAX's loop ran these and one more, at most max_iters
    n_changed = torch.zeros((), dtype=torch.int32, device=xy.device)
    done = 0
    while done < max_iters:
        for _ in range(min(CCL_CHECK_EVERY, max_iters - done)):
            new = torch.minimum(
                labels, torch.where(adj, labels[None, :], m).amin(dim=1))
            moved = (new != labels).any()
            n_changed = n_changed + moved.to(torch.int32)
            labels = new
            done += 1
        if not bool(moved):  # the group's last round found a fixed point
            break
    return labels, torch.clamp(n_changed + 1, max=max_iters)


def compact_labels(labels: torch.Tensor, valid: torch.Tensor,
                   num_segments: int):
    """Root labels → dense 0..K-1 ids (make_continuous_inds analog);
    returns (ids [M] int32, num_unique)."""
    uniq = unique_segments(labels, valid, num_segments)
    return uniq.seg_ids, uniq.num_unique
