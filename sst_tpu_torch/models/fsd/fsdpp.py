"""FSD++, the incremental multi-frame detector (counterpart of
``sst_tpu/models/fsd/fsdpp.py``): predict, loss and forward.

The network sees only (a) the *residual* points of the current frame,
those whose 0.4 m voxel no previous frame occupies, and (b) previous-frame
points inside the propagated seed boxes (last round's detections). The rest
of the multi-frame cloud, the static background seen before, is dropped
before the FSD two stage (``two_stage.py FSD``, ``fsd_mod``) runs. Dropping
is a mask; the survivors are then compacted, earliest index first, into a
``[B, residual_points_cap, C + 1]`` buffer (the extra channel is the frame
age ``-frame_inds * 0.1``), and the points past the cap are counted in
``num_residual_overflow``.

Randomness. In training the seeds are perturbed as JAX perturbs them from
its ``seeds`` rng: a uniform per seed drops it (``seed_drop_rate``),
uniforms pick seeds to copy into empty slots with a uniform xy shift
(``fp_rate``), and normal noise moves centre, size and yaw. Here the draws
come from a ``torch.Generator`` (``generator``) or are given (``draws``, a
:class:`SeedDraws`; the tests pass JAX's own). Without either, training
adds no noise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
from torch import nn

from sst_tpu_torch.core.boxes import points_in_boxes
from sst_tpu_torch.models import PointBatch, batch_to
from sst_tpu_torch.models.fsd.two_stage import FSD
from sst_tpu_torch.ops.ccl import topk_compact
from sst_tpu_torch.ops.fps import group_fps_mask
from sst_tpu_torch.ops.incremental import delta_points_mask
from sst_tpu_torch.ops.segment import INT_SENTINEL, unique_segments

SEED_CHUNK = 65536  # points per [points, seeds] containment block


@dataclass
class TemporalBatch:
    """Multi-frame input, pose-aligned to the current ego frame.

    points [B, P, C], valid [B, P], frame_inds [B, P] int32 (0 = the current
    frame, k > 0 = k frames ago); gt_boxes [B, G, 7+], gt_labels [B, G],
    gt_valid [B, G]; seed_boxes [B, S, 7], seed_labels [B, S], seed_scores
    [B, S], seed_valid [B, S]: the previous round's detections in the
    current frame. Fields hold numpy arrays or torch tensors; :meth:`to`
    makes tensors on a device."""

    points: Any
    valid: Any
    frame_inds: Any
    gt_boxes: Any
    gt_labels: Any
    gt_valid: Any
    seed_boxes: Any
    seed_labels: Any
    seed_scores: Any
    seed_valid: Any

    def to(self, device) -> "TemporalBatch":
        return batch_to(self, device)


class SeedDraws(NamedTuple):
    """The train-time seed noise, before scaling: ``drop`` [B, S] and
    ``fp`` [B, S] uniform in [0, 1), ``fp_shift`` [B, S, 2] uniform, and
    standard normals ``center`` [B, S, 3], ``dim`` [B, S, 3], ``yaw``
    [B, S, 1]. A draw the model's options do not read may be None."""

    drop: torch.Tensor | None
    fp: torch.Tensor | None
    fp_shift: torch.Tensor | None
    center: torch.Tensor | None
    dim: torch.Tensor | None
    yaw: torch.Tensor | None


class TwoStageFSDPP(nn.Module):
    """``num_point_features`` is the width of the raw point rows; the inner
    FSD sees one more, the frame age. ``fsd`` holds the two stage's
    settings (``single_stage``, ``roi_head``, ``rois_per_sample``).
    ``max_crop_points`` keeps the first K previous points of each seed box
    (by index), ``n_fps`` K furthest-point samples of each box instead (at
    most one of the two). ``residual_points_cap`` is the compacted buffer's
    rows (0: no compaction)."""

    def __init__(self, num_point_features: int = 5, fsd: dict | None = None,
                 inc_voxel_size: tuple = (0.4, 0.4, 0.4),
                 point_cloud_range: tuple = (-80.0, -80.0, -2.0, 80.0, 80.0,
                                             4.0),
                 extra_width: tuple = (0.5, 0.5, 0.5),
                 pre_score_thr: float = 0.3, center_noise: float = 0.0,
                 dim_noise: float = 0.0, yaw_noise: float = 0.0,
                 fp_rate: float | None = None,
                 seed_drop_rate: float | None = None,
                 max_crop_points: int | None = None,
                 n_fps: int | None = None, frame_id_scale: float = 0.1,
                 residual_points_cap: int = 0, dtype=torch.float32):
        super().__init__()
        self.inc_voxel_size = tuple(inc_voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.extra_width = tuple(extra_width)
        self.pre_score_thr = pre_score_thr
        self.center_noise = center_noise
        self.dim_noise = dim_noise
        self.yaw_noise = yaw_noise
        self.fp_rate = fp_rate
        self.seed_drop_rate = seed_drop_rate
        self.max_crop_points = max_crop_points
        self.n_fps = n_fps
        self.frame_id_scale = frame_id_scale
        self.residual_points_cap = residual_points_cap
        self.fsd_mod = FSD(num_point_features=num_point_features + 1,
                           dtype=dtype, **(fsd or {}))

    # ------------------------------------------------------------- seeds

    @property
    def _noisy(self) -> bool:
        return (self.center_noise > 0 or self.dim_noise > 0
                or self.yaw_noise > 0)

    @property
    def draws_noise(self) -> bool:
        """Whether a train-mode call draws seed noise (JAX asks for its
        ``seeds`` rng exactly then)."""
        return self._noisy or bool(self.fp_rate) or bool(self.seed_drop_rate)

    def draw_seed_noise(self, batch: TemporalBatch,
                        generator: torch.Generator) -> SeedDraws:
        """The draws a train-mode call reads, from ``generator`` (on the
        seeds' device)."""
        b, s = batch.seed_valid.shape
        kw = dict(generator=generator, device=batch.seed_boxes.device)

        def uniform(*shape):
            return torch.rand(shape, **kw)

        def normal(*shape):
            return torch.randn(shape, **kw) if self._noisy else None

        return SeedDraws(
            drop=uniform(b, s) if self.seed_drop_rate else None,
            fp=uniform(b, s) if self.fp_rate else None,
            fp_shift=uniform(b, s, 2) if self.fp_rate else None,
            center=normal(b, s, 3), dim=normal(b, s, 3), yaw=normal(b, s, 1))

    def _fp_insertion(self, boxes, labels, scores, valid, u_fp, u_shift):
        """Copy a random subset of the valid seeds (each with probability
        ``fp_rate``) into empty slots, in index order, shifted by U(-10, 10)
        m in x and y: simulated false positives for the RoI head to
        reject."""
        b, s = valid.shape
        cand = valid & (u_fp < self.fp_rate)
        shift = (u_shift - 0.5) * 20.0
        ones = torch.ones(s, device=valid.device)
        out = ([], [], [], [])
        for i in range(b):
            cidx, cok = topk_compact(ones, cand[i], s)
            eidx, eok = topk_compact(ones, ~valid[i], s)
            place = cok & eok
            dst = torch.where(place, eidx, s)
            moved = boxes[i][cidx]
            moved = torch.cat([moved[:, :2] + shift[i][cidx], moved[:, 2:]],
                              dim=-1)
            for lst, src, new in zip(out, (boxes[i], labels[i], scores[i],
                                           valid[i]),
                                     (moved, labels[i][cidx],
                                      scores[i][cidx], place)):
                buf = torch.cat([src, src[:1]])  # row s takes the drops
                buf[dst] = new
                lst.append(buf[:s])
        return tuple(torch.stack(lst) for lst in out)

    def preprocess_seeds(self, batch: TemporalBatch, train: bool,
                         draws: SeedDraws | None = None):
        """(boxes, boxes enlarged by class, valid): the seeds above
        ``pre_score_thr``; in train mode with ``draws``, dropped, copied and
        moved by them; each box then grown by its class's extra width in
        w, l and h about its centre."""
        boxes = batch.seed_boxes
        labels = batch.seed_labels
        scores = batch.seed_scores
        valid = batch.seed_valid & (scores > self.pre_score_thr)
        if train and draws is not None:
            if self.seed_drop_rate:
                valid = valid & (draws.drop > self.seed_drop_rate)
            if self.fp_rate:
                boxes, labels, scores, valid = self._fp_insertion(
                    boxes, labels, scores, valid, draws.fp, draws.fp_shift)
            if self._noisy:
                boxes = torch.cat([
                    boxes[..., :3] + draws.center * self.center_noise,
                    boxes[..., 3:6] + draws.dim * self.dim_noise,
                    boxes[..., 6:7] + draws.yaw * self.yaw_noise], dim=-1)
        ew = torch.tensor(self.extra_width, dtype=torch.float32,
                          device=boxes.device)
        grow = ew[torch.clamp(labels, 0, len(self.extra_width) - 1).long()]
        grow = grow[..., None].expand(*grow.shape, 3)
        enlarged = torch.cat([boxes[..., :2],
                              boxes[..., 2:3] - grow[..., :1] / 2,
                              boxes[..., 3:6] + grow, boxes[..., 6:7]],
                             dim=-1)
        return boxes, enlarged, valid

    # ------------------------------------------------------ point select

    @staticmethod
    def _seed_membership(xyz, seeds, seed_valid):
        """(in a valid seed box [P], the first such box's index [P]), from
        the [P, S] containment test taken ``SEED_CHUNK`` points at a
        time."""
        inside, first = [], []
        for start in range(0, xyz.shape[0], SEED_CHUNK):
            inb = points_in_boxes(xyz[start:start + SEED_CHUNK], seeds) \
                & seed_valid[None, :]
            inside.append(inb.any(1))
            first.append(torch.argmax(inb.to(torch.uint8), dim=1))
        return torch.cat(inside), torch.cat(first).to(torch.int32)

    def point_masks(self, batch: TemporalBatch, enlarged_seeds, seed_valid):
        """([B, P] residual, [B, P] crop): the current frame's valid points
        whose incremental voxel no valid previous point occupies, and the
        valid previous points inside a valid enlarged seed box (trimmed to
        ``max_crop_points`` per box by index, or to ``n_fps`` per box by
        furthest point sampling)."""
        residual, crop = [], []
        for i in range(batch.points.shape[0]):
            xyz = batch.points[i, :, :3]
            valid, finds = batch.valid[i], batch.frame_inds[i]
            cur = finds == 0
            prev = (finds > 0) & valid
            delta = delta_points_mask(xyz, valid & cur, xyz, prev,
                                      self.point_cloud_range,
                                      self.inc_voxel_size)
            in_seed, box_id = self._seed_membership(
                xyz, enlarged_seeds[i], seed_valid[i])
            c = prev & in_seed
            s = enlarged_seeds.shape[1]
            if self.max_crop_points:
                uu = unique_segments(torch.where(c, box_id, INT_SENTINEL), c,
                                     s)
                c = c & (uu.ranks < self.max_crop_points)
            elif self.n_fps:
                c = group_fps_mask(xyz, box_id, c, s, self.n_fps)
            residual.append(cur & valid & delta)
            crop.append(c)
        return torch.stack(residual), torch.stack(crop)

    def generate_point_mask(self, batch: TemporalBatch, enlarged_seeds,
                            seed_valid) -> torch.Tensor:
        """[B, P] keep = residual current points | seed-cropped previous
        points (:meth:`point_masks`)."""
        residual, crop = self.point_masks(batch, enlarged_seeds, seed_valid)
        return residual | crop

    def to_point_batch(self, batch: TemporalBatch, train: bool,
                       draws: SeedDraws | None = None,
                       diag: dict | None = None):
        """(the FSD input ``PointBatch``, the number of kept points past
        ``residual_points_cap``). The points gain the frame-age channel;
        with a cap, the kept points are compacted, earliest index first.
        ``diag``, if given, receives the per-batch counts: residual
        current points, seed-cropped previous points, kept points and the
        overflow."""
        _, enlarged, sv = self.preprocess_seeds(batch, train, draws)
        residual, crop = self.point_masks(batch, enlarged, sv)
        keep = residual | crop
        age = -batch.frame_inds.to(torch.float32) * self.frame_id_scale
        pts = torch.cat([batch.points, age[..., None]], dim=-1)
        overflow = torch.zeros((), device=pts.device)
        if self.residual_points_cap:
            cap = self.residual_points_cap
            p = pts.shape[1]
            overflow = torch.clamp(keep.sum(1) - cap, min=0).sum().to(
                torch.float32)
            order = -torch.arange(p, dtype=torch.float32, device=pts.device)
            rows, kept = [], []
            for i in range(pts.shape[0]):
                idx, ok = topk_compact(order, keep[i], cap)
                rows.append(pts[i][idx])
                kept.append(ok)
            pts, keep = torch.stack(rows), torch.stack(kept)
        if diag is not None:
            diag.update(num_residual_points=residual.sum(),
                        num_seed_cropped_points=crop.sum(),
                        num_input_points=keep.sum(),
                        num_residual_overflow=overflow)
        return PointBatch(points=pts, valid=keep, gt_boxes=batch.gt_boxes,
                          gt_labels=batch.gt_labels,
                          gt_valid=batch.gt_valid), overflow

    # ------------------------------------------------------------ wiring

    def _draws(self, batch, train, generator, draws):
        if not (train and self.draws_noise) or draws is not None:
            return draws
        if generator is None:
            return None
        return self.draw_seed_noise(batch, generator)

    def loss(self, batch: TemporalBatch, train: bool = True,
             thr_extra: float = 0.0,
             generator: torch.Generator | None = None,
             draws: SeedDraws | None = None) -> dict:
        """The two stage's training losses on the selected points, with
        ``num_input_points`` and ``num_residual_overflow``. ``generator``:
        the source of the seed noise (JAX's ``seeds`` rng) and of the RoI
        sampler's uniforms; ``draws`` gives the seed noise instead."""
        pb, overflow = self.to_point_batch(
            batch, train, self._draws(batch, train, generator, draws))
        losses = self.fsd_mod.loss(pb, train, thr_extra,
                                   generator=generator)
        losses["num_input_points"] = pb.valid.sum().to(torch.float32)
        losses["num_residual_overflow"] = overflow
        return losses

    @torch.inference_mode()
    def predict(self, batch: TemporalBatch, skip_rcnn: bool = False) -> dict:
        """Boxes for a batch (``FSD.predict`` on the selected points)."""
        pb, _ = self.to_point_batch(batch, train=False)
        return self.fsd_mod.predict(pb, skip_rcnn=skip_rcnn)

    def forward(self, batch: TemporalBatch, train: bool = False):
        pb, _ = self.to_point_batch(batch, train)
        return self.fsd_mod(pb, train)
