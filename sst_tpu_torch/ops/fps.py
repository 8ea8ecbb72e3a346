"""Furthest point sampling, global and per group, at static shapes
(counterpart of ``sst_tpu/ops/fps.py``).

- :func:`furthest_point_sample`: k rounds of a distance update and an
  argmax over one point set.
- :func:`group_fps_mask`: FPS inside each group (FSD++'s seed boxes), every
  group advancing one round at a time: per round one segment max, one
  segment min and one gather, so the cost is O(k N) whatever the number of
  groups.

Nothing reads the host: the picks stay on the device.
"""

from __future__ import annotations

import torch

_BIG = 1e10


def furthest_point_sample(xyz: torch.Tensor, valid: torch.Tensor, k: int):
    """Iterative FPS over one point set.

    Args: xyz [N, 3]; valid [N] bool; k the sample count.
    Returns (idx [k] int32, ok [k] bool). It starts at the first valid point
    (index 0 when none is); each pick is the valid point furthest from the
    picks so far (the lowest index on a tie). With fewer than k valid points
    the tail's ``ok`` is False (its indices are picks of the same rule among
    exhausted points)."""
    first = torch.argmax(valid.to(torch.uint8))
    nvalid = valid.sum()
    mindist = torch.where(valid, _BIG, -_BIG)
    picks = [first]
    for _ in range(k - 1):
        d = ((xyz - xyz[picks[-1]]) ** 2).sum(-1)
        mindist = torch.minimum(mindist, torch.where(valid, d, -_BIG))
        picks.append(torch.argmax(mindist))
    idx = torch.stack(picks).to(torch.int32)
    ok = torch.arange(k, device=xyz.device) < nvalid
    return idx, ok


def group_fps_mask(xyz: torch.Tensor, group_ids: torch.Tensor,
                   valid: torch.Tensor, num_groups: int,
                   k: int) -> torch.Tensor:
    """[N] bool keep mask: up to k FPS points in each group.

    Args: xyz [N, 3]; group_ids [N] in [0, num_groups) (anything for invalid
    rows); valid [N] bool; k the per-group budget. A group's first pick is
    its lowest valid index, each later one its valid point furthest from the
    group's picks so far, the lowest index winning a tie, as in JAX."""
    n = xyz.shape[0]
    dev = xyz.device
    gid = torch.where(valid, group_ids.long(), num_groups)
    own_group = torch.clamp(gid, max=num_groups - 1)
    iota = torch.arange(n, device=dev)
    mindist = torch.full((n,), _BIG, device=dev)
    taken = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(k):
        live = valid & ~taken
        score = torch.where(live, mindist, -_BIG)
        gmax = torch.full((num_groups + 1,), -torch.inf, device=dev)
        gmax.scatter_reduce_(0, gid, score, "amax")
        is_max = live & (score >= gmax[own_group]) & (score > -_BIG)
        # the lowest index among each group's maxima; n where none
        gmin = torch.full((num_groups + 1,), n, device=dev)
        gmin.scatter_reduce_(0, gid, torch.where(is_max, iota, n), "amin")
        gmin = gmin[:num_groups]
        has = gmin < n
        picked = torch.clamp(gmin, max=n - 1)
        newly = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        newly[torch.where(has, picked, n)] = True
        taken = taken | newly[:n]
        d = ((xyz - xyz[picked][own_group]) ** 2).sum(-1)
        mindist = torch.minimum(mindist, torch.where(has[own_group], d, _BIG))
    return taken & valid
