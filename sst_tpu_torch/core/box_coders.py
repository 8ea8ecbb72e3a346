"""Box coders (counterpart of ``sst_tpu/core/box_coders.py``; decode only)."""

from __future__ import annotations

import torch


def base_point_decode(base_points, preds, scale: float):
    """FSD coder: centre offset from a base point, log dims, (sin, cos) yaw;
    extra channels (velocity) pass through."""
    center = preds[..., :3] * scale + base_points
    dims = torch.exp(preds[..., 3:6])
    yaw = torch.atan2(preds[..., 6], preds[..., 7])
    out = torch.cat([center, dims, yaw[..., None]], dim=-1)
    if preds.shape[-1] > 8:
        out = torch.cat([out, preds[..., 8:]], dim=-1)
    return out
