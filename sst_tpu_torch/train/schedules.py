"""Step-dependent training schedules (a copy of
``sst_tpu/train/schedules.py``, which the port cannot import).

  - :class:`FSDDetectionSchedule`: the reference's
    EnableFSDDetectionHookIter as a pure function of the step: a
    segmentation-only warm-up (``pretrain``), then detection with a linearly
    decaying extra fg-score threshold (``thr_extra``), both returned as
    keyword arguments of the model's ``loss``.
  - :class:`DisableAugmentationSchedule`: the reference's
    DisableAugmentationHook, a filter on a pipeline config list.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FSDDetectionSchedule:
    """Detection enabled at ``enable_after`` steps; the threshold buffer
    decays linearly from ``buffer_start`` to 0 between ``enable_after`` and
    ``delay_buffer_until``, in steps of ``quantize``."""

    enable_after: int = 4000
    buffer_start: float = 0.3
    delay_buffer_until: int = 8000
    quantize: float = 0.05

    def __call__(self, step: int) -> dict:
        if step < self.enable_after:
            return dict(pretrain=True, thr_extra=0.0)
        if step >= self.delay_buffer_until or self.buffer_start <= 0:
            return dict(pretrain=False, thr_extra=0.0)
        span = max(self.delay_buffer_until - self.enable_after, 1)
        frac = 1.0 - (step - self.enable_after) / span
        buf = self.buffer_start * frac
        if self.quantize > 0:
            buf = round(buf / self.quantize) * self.quantize
        return dict(pretrain=False, thr_extra=float(buf))


@dataclasses.dataclass
class DisableAugmentationSchedule:
    """From ``disable_after_step`` on, strip the named transform types from
    a pipeline config list."""

    disable_after_step: int
    disabled_types: tuple = ("ObjectSample", "RandomFlip3D",
                             "GlobalRotScaleTrans")

    def filter_pipeline(self, pipeline_cfgs: list, step: int) -> list:
        if step < self.disable_after_step:
            return list(pipeline_cfgs)
        return [c for c in pipeline_cfgs
                if c.get("type") not in self.disabled_types]

    def boundary_crossed(self, prev_step: int, step: int) -> bool:
        """True when the loader pipeline must be rebuilt (the reference
        restarts the dataloader)."""
        return prev_step < self.disable_after_step <= step
