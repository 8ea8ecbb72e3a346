"""IncrementalWaymoDataset: sequential multi-frame samples for FSD++ (the
port's counterpart of ``sst_tpu/data/incremental_dataset.py``, numpy code
copied, not imported).

Item i is the current frame plus up to ``num_previous_frames`` earlier
frames of the same sequence, moved into the current ego frame by their
poses, with each point's frame age (0 = the current frame, k = k frames
ago), and the seed boxes of those earlier frames (the previous round's
detections, ``tools/fsdpp/generate_seeds.py``) moved likewise. A sample
holding more points than ``max_points`` keeps ``max_points`` of them,
drawn by the dataset's ``np.random.RandomState`` as JAX's draws them.

Sequences follow the waymo-kitti numbering ``image_idx = seq * 1000 +
frame``; ego poses are ``info["pose"]`` (4x4 ego → world). Seeds are keyed
by ``(context_name, timestamp)`` where the converter's
``idx2timestamp.pkl`` and ``idx2contextname.pkl`` lie in ``data_root``,
else by the ``%07d`` image index.

:func:`run_sequential_eval` visits the frames in order and feeds frame t's
detections to frame t + 1 as its seeds; :func:`collate_temporal` stacks
samples into a ``TemporalBatch`` of CPU tensors, which the caller moves to
the card.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from sst_tpu_torch.data.datasets import WaymoDataset
from sst_tpu_torch.ops.incremental import box_frame_transform
from sst_tpu_torch.utils.registry import DATASETS


@DATASETS.register
class IncrementalWaymoDataset(WaymoDataset):
    def __init__(self, *args, seeds_path: str | None = None,
                 num_previous_frames: int = 6, max_points: int = 262144,
                 max_seeds: int = 256, max_gt: int = 128, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_previous_frames = num_previous_frames
        self.max_points = max_points
        self.max_seeds = max_seeds
        self.max_gt = max_gt
        self.seeds = {}
        if seeds_path:
            with open(seeds_path, "rb") as f:
                self.seeds = pickle.load(f)
        # (context, timestamp) seed keys from the converter's maps where
        # they exist; image-index keys otherwise
        self._idx2key = {}
        ts_p = os.path.join(self.data_root, "idx2timestamp.pkl")
        cx_p = os.path.join(self.data_root, "idx2contextname.pkl")
        if os.path.exists(ts_p) and os.path.exists(cx_p):
            with open(ts_p, "rb") as f:
                idx2ts = pickle.load(f)
            with open(cx_p, "rb") as f:
                idx2cx = pickle.load(f)
            self._idx2key = {
                k: (idx2cx[k], idx2ts[k]) for k in idx2ts if k in idx2cx
            }

    def _seq_and_frame(self, idx):
        sample_idx = self.infos[idx]["image"]["image_idx"]
        return sample_idx // 1000, sample_idx % 1000

    def _seed_key(self, idx):
        sample_idx = self.infos[idx]["image"]["image_idx"]
        k = f"{sample_idx:07d}"
        return self._idx2key.get(k, k)

    def __getitem__(self, idx):
        cur = self.get_sample(idx)
        cur_seq, _ = self._seq_and_frame(idx)
        cur_pose = np.asarray(self.infos[idx].get("pose", np.eye(4)),
                              np.float64)
        cur_inv = np.linalg.inv(cur_pose)

        pts_list = [cur["points"]]
        frame_list = [np.zeros(len(cur["points"]), np.int32)]
        seed_boxes, seed_labels, seed_scores = [], [], []
        for k in range(1, self.num_previous_frames + 1):
            j = idx - k
            if j < 0 or self._seq_and_frame(j)[0] != cur_seq:
                break
            prev = self.get_sample(j)
            pose = np.asarray(self.infos[j].get("pose", np.eye(4)), np.float64)
            mm = cur_inv @ pose
            p = prev["points"].copy()
            p[:, :3] = (p[:, :3] @ mm[:3, :3].T + mm[:3, 3]).astype(np.float32)
            pts_list.append(p)
            frame_list.append(np.full(len(p), k, np.int32))
            sd = self.seeds.get(self._seed_key(j))
            if sd is not None and len(sd["boxes"]):
                # float32, as JAX moves them (jnp arrays of the float64
                # poses)
                b = box_frame_transform(
                    torch.as_tensor(np.asarray(sd["boxes"][:, :7],
                                               np.float32)),
                    torch.as_tensor(pose, dtype=torch.float32),
                    torch.as_tensor(cur_inv, dtype=torch.float32)).numpy()
                seed_boxes.append(b)
                seed_labels.append(np.asarray(sd["labels"], np.int32))
                seed_scores.append(np.asarray(sd["scores"], np.float32))

        points = np.concatenate(pts_list)
        frame_inds = np.concatenate(frame_list)
        cap = self.max_points
        if len(points) > cap:
            sel = self._rng.choice(len(points), cap, replace=False)
            points, frame_inds = points[sel], frame_inds[sel]
        n = len(points)
        out_p = np.zeros((cap, points.shape[1]), np.float32)
        out_f = np.zeros(cap, np.int32)
        out_v = np.zeros(cap, bool)
        out_p[:n] = points
        out_f[:n] = frame_inds
        out_v[:n] = True

        sb = np.zeros((self.max_seeds, 7), np.float32)
        sl = np.zeros(self.max_seeds, np.int32)
        ss = np.zeros(self.max_seeds, np.float32)
        sv = np.zeros(self.max_seeds, bool)
        if seed_boxes:
            all_b = np.concatenate(seed_boxes)[: self.max_seeds]
            m = len(all_b)
            sb[:m] = all_b
            sl[:m] = np.concatenate(seed_labels)[:m]
            ss[:m] = np.concatenate(seed_scores)[:m]
            sv[:m] = True

        gb = np.zeros((self.max_gt, 7), np.float32)
        gl = np.zeros(self.max_gt, np.int32)
        gv = np.zeros(self.max_gt, bool)
        if "gt_boxes" in cur and len(cur["gt_boxes"]):
            g = min(len(cur["gt_boxes"]), self.max_gt)
            gb[:g] = cur["gt_boxes"][:g, :7]
            gl[:g] = cur["gt_labels"][:g]
            gv[:g] = True

        return dict(points=out_p, valid=out_v, frame_inds=out_f,
                    gt_boxes=gb, gt_labels=gl, gt_valid=gv,
                    seed_boxes=sb, seed_labels=sl, seed_scores=ss,
                    seed_valid=sv, idx=idx, rng=self._rng)


def box_frame_transform_np(boxes, pre_pose, cur_inv):
    """Host-side 7-dof box pose transform in float64, rounded to float32:
    the centre rotated and moved, the yaw through the heading vector
    (sin(yaw), cos(yaw), 0) (the numpy twin of
    ``ops/incremental.py box_frame_transform``)."""
    mm = cur_inv @ pre_pose
    out = boxes.copy()
    out[:, :3] = boxes[:, :3] @ mm[:3, :3].T + mm[:3, 3]
    yaw = boxes[:, 6]
    heading = np.stack([np.sin(yaw), np.cos(yaw), np.zeros_like(yaw)], -1)
    heading = heading @ mm[:3, :3].T
    out[:, 6] = np.arctan2(heading[:, 0], heading[:, 1])
    return out.astype(np.float32)


def _numpy(x) -> np.ndarray:
    """A prediction field as numpy: tensors (on any device) are copied to
    the host, bfloat16 as float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def run_sequential_eval(dataset, predict_fn, score_thr: float = 0.1,
                        feedback: bool = True):
    """FSD++'s sequential evaluation with seed feedback.

    Frames are visited in stored (sequence, time) order; frame t's
    detections above ``score_thr``, moved into frame t + 1's ego frame,
    replace frame t + 1's offline seeds, and a new sequence starts with
    none. ``predict_fn`` maps a collated one-sample ``TemporalBatch`` (CPU
    tensors) to the prediction dict (``boxes``, ``scores``, ``labels``,
    ``valid``; numpy arrays or tensors on any device). Only the previous
    frame's detections seed the next one (no seed ageing, as in JAX's);
    the dataset still supplies the multi-frame point history. Returns one
    dict per frame: valid ``boxes`` [N, 7], ``scores``, ``labels``,
    ``idx``."""
    live = {}  # seq -> (boxes in the previous ego frame, labels, scores, pose)
    results = []
    for idx in range(len(dataset)):
        sample = dataset[idx]
        seq, _ = dataset._seq_and_frame(idx)
        cur_pose = np.asarray(dataset.infos[idx].get("pose", np.eye(4)),
                              np.float64)
        if feedback:
            sb = np.zeros((dataset.max_seeds, 7), np.float32)
            sl = np.zeros(dataset.max_seeds, np.int32)
            ss = np.zeros(dataset.max_seeds, np.float32)
            sv = np.zeros(dataset.max_seeds, bool)
            if seq in live:
                pb, pl, psc, ppose = live[seq]
                if len(pb):
                    b = box_frame_transform_np(pb, ppose,
                                               np.linalg.inv(cur_pose))
                    m = min(len(b), dataset.max_seeds)
                    sb[:m], sl[:m], ss[:m], sv[:m] = (b[:m], pl[:m], psc[:m],
                                                      True)
            sample = dict(sample, seed_boxes=sb, seed_labels=sl,
                          seed_scores=ss, seed_valid=sv)
        out = predict_fn(collate_temporal([sample]))
        valid = _numpy(out["valid"][0])
        boxes = _numpy(out["boxes"][0])[valid][:, :7]
        scores = _numpy(out["scores"][0])[valid]
        labels = _numpy(out["labels"][0])[valid]
        results.append(dict(boxes=boxes, scores=scores, labels=labels,
                            idx=sample.get("idx", idx)))
        keep = scores > score_thr
        live[seq] = (boxes[keep], labels[keep], scores[keep], cur_pose)
    return results


_BATCH_KEYS = ("points", "valid", "frame_inds", "gt_boxes", "gt_labels",
               "gt_valid", "seed_boxes", "seed_labels", "seed_scores",
               "seed_valid")


def collate_temporal(samples):
    """Padded incremental samples stacked into a ``TemporalBatch`` of CPU
    tensors; the caller moves it to the card (``batch.to(device)``)."""
    from sst_tpu_torch.models.fsd.fsdpp import TemporalBatch

    return TemporalBatch(**{k: torch.from_numpy(np.stack([s[k] for s in
                                                           samples]))
                            for k in _BATCH_KEYS})
