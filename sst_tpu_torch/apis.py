"""High-level inference API (counterpart of ``sst_tpu/apis.py``)."""

from __future__ import annotations

import numpy as np
import torch

from sst_tpu_torch.models import PointBatch

DEFAULT_MAX_POINTS = 65536  # the JAX API's cap, whatever the model


def prepare_batch(model, points: np.ndarray,
                  max_points: int | None = None) -> PointBatch:
    """Range-filter one raw [N, C] numpy point cloud and pad it to
    ``max_points`` rows: a batch of one on the model's device. The default
    cap is 65,536 whatever the model, as JAX's ``inference_detector``: the
    points in range past it are dropped, the first ones kept. A caller that
    wants more passes ``max_points`` (the full-size builders keep their
    cap, 196,608 points, as ``model.max_points``). Serves every detector
    with a ``point_cloud_range``."""
    pcr = model.point_cloud_range
    m = ((points[:, 0] >= pcr[0]) & (points[:, 0] < pcr[3])
         & (points[:, 1] >= pcr[1]) & (points[:, 1] < pcr[4])
         & (points[:, 2] >= pcr[2]) & (points[:, 2] < pcr[5]))
    pts = points[m]
    cap = max_points or DEFAULT_MAX_POINTS
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
    labels and valid [max_num], in the dtypes of ``model.predict`` (JAX's),
    except that numpy has no bfloat16: a bfloat16 result (the scores of a
    bfloat16 model) comes back as the float32 array of the same values."""
    return frame_to_numpy(model.predict(prepare_batch(model, points,
                                                      max_points)))


def frame_to_numpy(res: dict) -> dict:
    """Frame 0 of ``model.predict``'s result as numpy arrays, bfloat16 ones
    as float32 (numpy has no bfloat16)."""
    return {k: (v[0].float() if v.dtype == torch.bfloat16 else v[0]).cpu()
            .numpy() for k, v in res.items()}
