"""High-level inference API (counterpart of ``sst_tpu/apis.py``)."""

from __future__ import annotations

import numpy as np

from sst_tpu_torch.models import PointBatch

DEFAULT_MAX_POINTS = 65536  # the JAX API's cap, for models built without one


def prepare_batch(model, points: np.ndarray,
                  max_points: int | None = None) -> PointBatch:
    """Range-filter one raw [N, C] numpy point cloud and pad it to
    ``max_points`` rows: a batch of one on the model's device. The default
    cap is the model's ``max_points``, which the full-size builders of
    ``flagship.py`` set (65,536 for a model built without one). Serves
    ``SingleStageFSDV2`` and ``DynamicVoxelNet`` alike: both read
    ``point_cloud_range``."""
    pcr = model.point_cloud_range
    m = ((points[:, 0] >= pcr[0]) & (points[:, 0] < pcr[3])
         & (points[:, 1] >= pcr[1]) & (points[:, 1] < pcr[4])
         & (points[:, 2] >= pcr[2]) & (points[:, 2] < pcr[5]))
    pts = points[m]
    cap = max_points or getattr(model, "max_points", DEFAULT_MAX_POINTS)
    out = np.zeros((cap, points.shape[1]), np.float32)
    n = min(len(pts), cap)
    out[:n] = pts[:n]
    valid = np.zeros(cap, bool)
    valid[:n] = True
    device = next(model.parameters()).device
    return PointBatch(points=out[None], valid=valid[None]).to(device)


def inference_detector(model, points: np.ndarray,
                       max_points: int | None = None) -> dict:
    """Run one raw [N, C] numpy point cloud through :func:`prepare_batch`
    and ``model.predict``.

    Returns a dict of numpy arrays for the frame: boxes [max_num, 7], scores,
    labels and valid [max_num]."""
    res = model.predict(prepare_batch(model, points, max_points))
    return {k: v[0].cpu().numpy() for k, v in res.items()}
