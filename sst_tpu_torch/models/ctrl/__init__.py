"""CTRL, the track-centric auto-labelling detector."""

from sst_tpu_torch.models.ctrl.tracklet_detector import (
    TrackletBatch,
    TrackletDetector,
    TrackletRoIHead,
    TrackletSegmentor,
)

__all__ = ["TrackletBatch", "TrackletDetector", "TrackletRoIHead",
           "TrackletSegmentor"]
