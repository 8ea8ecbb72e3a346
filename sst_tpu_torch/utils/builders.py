"""Config → model assembly (the port's copy of ``sst_tpu/utils/builders.py``:
``_tuplify``, ``_convert_caps``, ``buckets_from_cfg`` and
``build_model_from_cfg``).

Only the detector types the port has are registered: ``FSD``,
``SingleStageFSD``, ``SingleStageFSDV2``, ``FSDV2``, ``DynamicVoxelNet``,
``TwoStageFSDPP`` and ``TrackletDetector``. Any other ``type`` of the JAX
registry raises ``NotImplementedError`` naming its ROADMAP queue item. The
JAX modules read the point width from their input; the port's take it at
construction, so the builder does too (``num_point_features``), and it
returns the model on ``device``.

The training half of a config (what the JAX package's ``tools/train.py``
reads): ``optimizer_from_cfg`` (``optimizer``) and ``schedule_from_cfg``
(``fsd_detection_schedule``). A model's own train settings (FSD's RoI
sampler, thresholds and loss weights, the UNet's ``remat``) sit in
``model`` and reach its modules through ``build_model_from_cfg``.
"""

from __future__ import annotations

import torch

from sst_tpu_torch.ops.window import BucketSpec
from sst_tpu_torch.utils.registry import MODELS

# detector types of the JAX registry not yet ported, by ROADMAP queue 1 item
UNPORTED_TYPES = {
    "PointPillars": "ROADMAP queue 1 item 10 (PointPillars)",
}

# the point width a type reads where the caller gives none: the CTRL
# tracklet rows carry a time lag after Waymo's five channels
_POINT_WIDTH = {"TrackletDetector": 6}

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}


def _register_ported() -> None:
    # imported here: the models import the ops that import this package
    from sst_tpu_torch.models import DynamicVoxelNet, SingleStageFSDV2
    from sst_tpu_torch.models.ctrl import TrackletDetector
    from sst_tpu_torch.models.fsd.fsdpp import TwoStageFSDPP
    from sst_tpu_torch.models.fsd.fsdv2 import FSDV2
    from sst_tpu_torch.models.fsd.single_stage import SingleStageFSD
    from sst_tpu_torch.models.fsd.two_stage import FSD

    for cls in (FSD, SingleStageFSD, SingleStageFSDV2, FSDV2,
                DynamicVoxelNet, TwoStageFSDPP, TrackletDetector):
        MODELS.register(cls)


def buckets_from_cfg(region_batching: list[dict]) -> tuple:
    """[{max_tokens, drop_range, max_windows}] → tuple[BucketSpec] (the
    reference's drop_info with static window caps)."""
    return tuple(BucketSpec(max_tokens=rb["max_tokens"],
                            drop_lower=rb["drop_range"][0],
                            drop_upper=rb["drop_range"][1],
                            max_windows=rb["max_windows"])
                 for rb in region_batching)


def _tuplify(x):
    """Config lists → tuples, as the JAX builder hands its modules."""
    if isinstance(x, (list, tuple)):
        return tuple(_tuplify(v) for v in x)
    if isinstance(x, dict):
        return {k: _tuplify(v) for k, v in x.items()}
    return x


def _convert_caps(kwargs: dict) -> dict:
    """``caps`` dicts in configs → the static caps dataclasses (also the
    single stage's of an ``FSD`` or ``FSDV2`` and the inner FSD's of a
    ``TwoStageFSDPP``)."""
    from sst_tpu_torch.models.fsd.fsdv2 import FSDV2Caps
    from sst_tpu_torch.models.fsd.single_stage import FSDCaps

    t = kwargs.get("type")
    cls_by_type = {"SingleStageFSD": FSDCaps, "SingleStageFSDV2": FSDV2Caps}
    if t in cls_by_type and isinstance(kwargs.get("caps"), dict):
        kwargs["caps"] = cls_by_type[t](**kwargs["caps"])

    def inner_caps(fsd: dict, caps_cls) -> dict:
        fsd = dict(fsd)
        if isinstance(fsd.get("single_stage"), dict):
            ss = dict(fsd["single_stage"])
            if isinstance(ss.get("caps"), dict):
                ss["caps"] = caps_cls(**ss["caps"])
            fsd["single_stage"] = ss
        return fsd

    if t in ("FSD", "FSDV2"):
        kwargs = inner_caps(kwargs, FSDCaps if t == "FSD" else FSDV2Caps)
    if t == "TwoStageFSDPP" and isinstance(kwargs.get("fsd"), dict):
        kwargs["fsd"] = inner_caps(kwargs["fsd"], FSDCaps)
    return kwargs


def build_model_from_cfg(cfg: dict, train: bool = True,
                         num_point_features: int | None = None,
                         device="cuda"):
    """Build a detector from a loaded config dict (``model``, ``capacity``,
    ``region_batching_{train,test}`` keys) on ``device``, the card by
    default (``flagship.on_device``: no fallback to the CPU).

    ``num_point_features`` is the width of a point row; None gives 5 for
    Waymo's x, y, z, intensity, elongation (as ``bench.py`` feeds FSD), and
    6 for a ``TrackletDetector`` (the tracklet dataset's five channels and
    the time lag). A ``model.dtype``
    string ('bfloat16' | 'float32') selects the compute dtype.
    ``capacity.max_points`` becomes ``model.max_points``, the point cap to
    pass to ``apis.prepare_batch`` (65,536 where the config gives none, as
    JAX's ``init_model``)."""
    from sst_tpu_torch.flagship import on_device

    _register_ported()
    kwargs = _convert_caps(_tuplify(dict(cfg["model"])))
    t = kwargs.get("type")
    if t in UNPORTED_TYPES:
        raise NotImplementedError(f"model type {t!r} is not ported yet: "
                                  f"{UNPORTED_TYPES[t]}")
    if isinstance(kwargs.get("dtype"), str):
        kwargs["dtype"] = _DTYPES[kwargs["dtype"]]
    cap = cfg.get("capacity", {})
    if t == "DynamicVoxelNet":
        if cap:
            kwargs.setdefault("max_voxels", cap.get("max_voxels", 65536))
            kwargs.setdefault("max_total_windows",
                              cap.get("max_total_windows", 16384))
        rb_key = "region_batching_train" if train else "region_batching_test"
        if rb_key in cfg:
            kwargs["buckets"] = buckets_from_cfg(cfg[rb_key])
    if num_point_features is None:
        num_point_features = _POINT_WIDTH.get(t, 5)
    model = MODELS.build(kwargs, num_point_features=num_point_features)
    return on_device(model, device, cap.get("max_points", 65536))


def optimizer_from_cfg(model: torch.nn.Module, cfg: dict,
                       total_steps: int):
    """The config's ``optimizer`` (base_lr, weight_decay, clip_norm; JAX's
    ``tools/train.py`` defaults where it gives none) over the model's
    parameters: ``train/state.py make_optimizer``, a ``total_steps``
    one-cycle."""
    from sst_tpu_torch.train.state import make_optimizer

    opt = cfg.get("optimizer", {})
    return make_optimizer(model.parameters(),
                          base_lr=opt.get("base_lr", 1e-5),
                          weight_decay=opt.get("weight_decay", 0.05),
                          total_steps=total_steps,
                          clip_norm=opt.get("clip_norm", 10.0))


def schedule_from_cfg(cfg: dict):
    """The config's ``fsd_detection_schedule`` as
    ``train/schedules.py FSDDetectionSchedule`` (its ``pretrain`` /
    ``thr_extra`` per step are the loss's keyword arguments), or None where
    the config has none."""
    from sst_tpu_torch.train.schedules import FSDDetectionSchedule

    if "fsd_detection_schedule" not in cfg:
        return None
    return FSDDetectionSchedule(**cfg["fsd_detection_schedule"])
