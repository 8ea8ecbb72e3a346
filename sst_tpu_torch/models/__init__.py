"""Models of the port and the padded input batch they take."""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any

import numpy as np
import torch


@dataclass
class PointBatch:
    """Padded input batch (counterpart of ``sst_tpu``'s ``PointBatch``).

    points: [B, P, C] (xyz + extra channels); valid: [B, P] bool;
    gt_boxes: [B, G, 7+]; gt_labels: [B, G]; gt_valid: [B, G]. Fields hold
    numpy arrays or torch tensors; :meth:`to` makes tensors on a device.
    """

    points: Any
    valid: Any
    gt_boxes: Any = None
    gt_labels: Any = None
    gt_valid: Any = None

    def to(self, device) -> "PointBatch":
        return batch_to(self, device)


def batch_to(batch, device):
    """A copy of the batch dataclass ``batch`` whose fields are tensors on
    ``device`` (numpy arrays converted, None kept)."""
    def conv(x):
        if x is None:
            return None
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device)

    return type(batch)(**{f.name: conv(getattr(batch, f.name))
                          for f in fields(batch)})


# the detectors import PointBatch from here, so they come after it
from sst_tpu_torch.models.detectors.dynamic_voxelnet import (  # noqa: E402
    DynamicVoxelNet,
)
from sst_tpu_torch.models.fsd.fsdv2 import SingleStageFSDV2  # noqa: E402

__all__ = ["DynamicVoxelNet", "PointBatch", "SingleStageFSDV2", "batch_to"]
