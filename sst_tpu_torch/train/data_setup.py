"""Train-time dataset selection (counterpart of
``sst_tpu/train/data_setup.py``): picks the dataset class and the matching
collate, so each detector family gets the batch its loss expects
(``PointBatch``, ``TemporalBatch`` or ``TrackletBatch``), all as CPU
tensors.

Kinds: ``synthetic``, ``waymo``, ``waymo_incremental`` (``data.dataset=
"waymo"`` with ``sequential=True``: FSD++'s multi-frame assembly,
``data/incremental_dataset.py``), ``waymo_tracklet``, ``nuscenes``
(``with_velocity``; ``cbgs`` wraps it in ``CBGSDataset``) and ``argo2``:
every kind of the JAX package.
"""

from __future__ import annotations

import functools

# dataset kinds of the JAX package not yet ported, by ROADMAP item
UNPORTED_KINDS: dict = {}


def default_train_pipeline(point_cloud_range, max_points):
    return [
        dict(type="RandomFlip3D"),
        dict(type="GlobalRotScaleTrans"),
        dict(type="PointsRangeFilter", point_cloud_range=point_cloud_range),
        dict(type="ObjectRangeFilter", point_cloud_range=point_cloud_range),
        dict(type="PointShuffle"),
        dict(type="PadToCap", max_points=max_points),
    ]


def _unported(kind: str):
    if kind in UNPORTED_KINDS:
        raise NotImplementedError(f"data.dataset {kind!r} is not ported "
                                  f"yet: {UNPORTED_KINDS[kind]}")
    raise ValueError(f"unknown data.dataset {kind!r}")


def _dataset_kwargs(data_cfg: dict, keys=("load_dim", "use_dim")) -> dict:
    return {k: data_cfg[k] for k in keys if k in data_cfg}


def build_train_dataset(cfg, model, synthetic: bool = False, seed: int = 0,
                        batch_size: int = 1):
    """Returns (dataset, collate_or_None, ds_kind, train_pipeline_cfg).

    collate None means the loader's default (``collate_to_batch``, a
    ``PointBatch``). ds_kind: 'synthetic' | 'waymo' | 'waymo_incremental' |
    'waymo_tracklet' | 'nuscenes' | 'argo2'.
    ``train_pipeline_cfg`` is the pipeline list in use, for the
    ``DisableAugmentationSchedule`` rebuild (None for the tracklet kind,
    whose samples run none)."""
    from sst_tpu_torch.data.datasets import SyntheticDataset, WaymoDataset
    from sst_tpu_torch.data.pipelines import build_pipeline

    data_cfg = cfg.get("data", {})
    cap = cfg.get("capacity", {})
    max_points = cap.get("max_points", 65536)
    ds_kind = "synthetic" if synthetic else data_cfg.get("dataset", "waymo")
    if ds_kind == "waymo" and data_cfg.get("sequential"):
        ds_kind = "waymo_incremental"
    # a tracklet sample runs no pipeline, and CTRL's model has no range
    train_pipeline_cfg = data_cfg.get("train_pipeline") or (
        None if ds_kind == "waymo_tracklet" else
        default_train_pipeline(model.point_cloud_range, max_points))

    collate = None
    if ds_kind == "synthetic":
        dataset = SyntheticDataset(
            num_samples=max(batch_size * 8, 64),
            num_points=min(max_points, 32768),
            pc_range=model.point_cloud_range,
            pipeline=build_pipeline([
                dict(type="PointsRangeFilter",
                     point_cloud_range=model.point_cloud_range),
                dict(type="PadToCap", max_points=max_points),
            ]),
        )
    elif ds_kind == "waymo_incremental":
        from sst_tpu_torch.data.incremental_dataset import (
            IncrementalWaymoDataset,
            collate_temporal,
        )

        dataset = IncrementalWaymoDataset(
            data_root=data_cfg["data_root"],
            info_path=data_cfg["info_path"],
            load_interval=data_cfg.get("load_interval", 1),
            seeds_path=data_cfg.get("seeds_path"),
            num_previous_frames=data_cfg.get("num_previous_frames", 6),
            max_points=max_points,
            max_seeds=cap.get("max_seeds", 256),
            max_gt=cap.get("max_gt", 128),
            **_dataset_kwargs(data_cfg),
        )
        collate = collate_temporal
    elif ds_kind == "waymo_tracklet":
        from sst_tpu_torch.data.tracklet_dataset import (
            WaymoTrackletDataset,
            collate_tracklets,
        )

        dataset = WaymoTrackletDataset(
            data_root=data_cfg["data_root"],
            tracklet_path=data_cfg["tracklet_path"],
            poses_path=data_cfg["poses_path"],
            frame_index_path=data_cfg["frame_index_path"],
            candidates_path=data_cfg.get("candidates_path"),
            max_points=max_points,
            max_frames=cap.get("max_frames", 200),
            seed=seed,
        )
        collate = functools.partial(collate_tracklets, device="cpu")
    elif ds_kind == "waymo":
        dataset = WaymoDataset(
            data_root=data_cfg["data_root"],
            info_path=data_cfg["info_path"],
            load_interval=data_cfg.get("load_interval", 1),
            pipeline=build_pipeline(train_pipeline_cfg),
            **_dataset_kwargs(data_cfg),
        )
    elif ds_kind == "nuscenes":
        from sst_tpu_torch.data.datasets import CBGSDataset, NuScenesDataset

        dataset = NuScenesDataset(
            data_root=data_cfg.get("data_root", "data/nuscenes"),
            info_path=data_cfg.get(
                "info_path", "data/nuscenes/nuscenes_infos_train.pkl"),
            load_interval=data_cfg.get("load_interval", 1),
            pipeline=build_pipeline(train_pipeline_cfg),
            **_dataset_kwargs(data_cfg,
                              ("load_dim", "use_dim", "with_velocity")),
        )
        if data_cfg.get("cbgs", False):
            dataset = CBGSDataset(dataset)
    elif ds_kind == "argo2":
        from sst_tpu_torch.data.datasets import Argo2Dataset

        dataset = Argo2Dataset(
            data_root=data_cfg.get("data_root", "data/argo2"),
            info_path=data_cfg.get(
                "info_path", "data/argo2/argo2_infos_train.pkl"),
            load_interval=data_cfg.get("load_interval", 1),
            pipeline=build_pipeline(train_pipeline_cfg),
            **_dataset_kwargs(data_cfg),
        )
    else:
        _unported(ds_kind)
    return dataset, collate, ds_kind, train_pipeline_cfg


def build_val_dataset(cfg, model, synthetic: bool = False,
                      num_samples: int = 32):
    """Validation dataset for in-train evaluation, ``PointBatch`` families
    only. Returns (dataset, class_names), or (None, None) where the
    configured kind has no in-train eval path or no ``val_info_path``."""
    from sst_tpu_torch.data.pipelines import build_pipeline

    data_cfg = cfg.get("data", {})
    cap = cfg.get("capacity", {})
    max_points = cap.get("max_points", 65536)
    pipeline = build_pipeline([
        dict(type="PointsRangeFilter",
             point_cloud_range=model.point_cloud_range),
        dict(type="PadToCap", max_points=max_points),
    ])
    ds_kind = "synthetic" if synthetic else data_cfg.get("dataset", "waymo")
    if ds_kind == "synthetic":
        from sst_tpu_torch.data.datasets import SyntheticDataset

        ds = SyntheticDataset(
            num_samples=num_samples, num_points=min(max_points, 32768),
            pc_range=model.point_cloud_range, pipeline=pipeline, seed=991)
        return ds, list(ds.CLASSES)
    if ds_kind not in ("waymo", "nuscenes", "argo2") \
            or "val_info_path" not in data_cfg:
        return None, None
    from sst_tpu_torch.data.datasets import (
        Argo2Dataset,
        NuScenesDataset,
        WaymoDataset,
    )

    cls = {"waymo": WaymoDataset, "nuscenes": NuScenesDataset,
           "argo2": Argo2Dataset}[ds_kind]
    ds = cls(data_root=data_cfg.get("data_root", ""),
             info_path=data_cfg["val_info_path"], pipeline=pipeline,
             test_mode=True)
    return ds, list(ds.classes)
