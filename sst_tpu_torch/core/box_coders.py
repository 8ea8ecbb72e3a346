"""Box coders (counterpart of ``sst_tpu/core/box_coders.py``: the SECOND
anchor-residual coder and the FSD base-point coder)."""

from __future__ import annotations

import torch


def delta_encode(anchors, gts):
    """SECOND-style anchor residuals of gt boxes (the anchor head's
    regression targets): centre offsets over the anchor's BEV diagonal
    (z over its height, comparing centres from bottom-centre boxes), log
    size ratios and the yaw difference; extra channels subtract."""
    xa, ya, za, wa, la, ha, ra = anchors[..., :7].unbind(-1)
    xg, yg, zg, wg, lg, hg, rg = gts[..., :7].unbind(-1)
    za = za + ha / 2
    zg = zg + hg / 2
    diag = torch.sqrt(la**2 + wa**2)
    out = torch.stack([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha,
                       torch.log(wg / wa), torch.log(lg / la),
                       torch.log(hg / ha), rg - ra], dim=-1)
    if gts.shape[-1] > 7:
        out = torch.cat([out, gts[..., 7:] - anchors[..., 7:]], dim=-1)
    return out


def delta_decode(anchors, deltas):
    """SECOND-style anchor residuals -> boxes (the inverse of the JAX
    package's ``delta_encode``): z is the bottom centre on both sides, the
    residuals compare centres. Extra channels add to the anchor's."""
    xa, ya, za, wa, la, ha, ra = anchors[..., :7].unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = deltas[..., :7].unbind(-1)
    za = za + ha / 2
    diag = torch.sqrt(la**2 + wa**2)
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    wg = torch.exp(wt) * wa
    lg = torch.exp(lt) * la
    hg = torch.exp(ht) * ha
    rg = rt + ra
    zg = zg - hg / 2
    out = torch.stack([xg, yg, zg, wg, lg, hg, rg], dim=-1)
    if deltas.shape[-1] > 7:
        out = torch.cat([out, deltas[..., 7:] + anchors[..., 7:]], dim=-1)
    return out


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


def base_point_encode(base_points, gts, scale: float):
    """FSD coder targets w.r.t. a base point: centre offset / scale, log
    dims, (sin, cos) yaw; extra channels (velocity) pass through. As in the
    JAX package there is no clamp: a box of zero size encodes to -inf."""
    delta = (gts[..., :3] - base_points) / scale
    dims = torch.log(gts[..., 3:6])
    yaw = gts[..., 6]
    enc = torch.cat([delta, dims, torch.stack([torch.sin(yaw), torch.cos(yaw)],
                                              dim=-1)], dim=-1)
    if gts.shape[-1] > 7:
        enc = torch.cat([enc, gts[..., 7:]], dim=-1)
    return enc
