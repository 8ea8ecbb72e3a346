"""Evaluation CLI of the port (counterpart of the JAX package's
``tools/test.py``).

    python -m sst_tpu_torch.tools.test configs/sst/sst_waymoD5_3class.py \\
        work_dirs/sst/ckpt_1000 [--synthetic] [--eval ap3d]

The model is built from the config (``apis.init_model``: random weights
from seed 0 where no checkpoint is given) and answers every frame of the
synthetic or the configured validation set through its ``predict``;
``--eval`` scores the boxes (``ap3d`` / ``apbev``: ``eval_ap``; ``waymo``:
``waymo_eval``; ``dataset``: the configured dataset's own ``evaluate``,
NDS for ``nuscenes`` and CDS for ``argo2``, on the boxes with their
velocity columns) or the per-point classes of an FSD segmentor (``seg``:
``predict_seg`` and ``seg_eval``). The validation set is the config's
``data.dataset`` kind (``waymo``, ``nuscenes`` or ``argo2``) at
``data.val_info_path``, range-filtered and padded, as JAX's CLI reads it.

``--sequential`` runs FSD++ over the incremental dataset
(``data/incremental_dataset.py``) at ``data.val_info_path`` (else
``info_path``), frame after frame, each frame's detections above
``data.seed_score_thr`` (0.1) seeding the next (``run_sequential_eval``);
``--out`` writes the per-frame results, and ``--eval`` scores them
against each frame's first 128 gt boxes (``ap3d`` / ``apbev``:
``eval_ap``; ``waymo``: ``waymo_eval``, where JAX's sequential path takes
the BEV AP).
"""

from __future__ import annotations

import argparse
import json
import pickle
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate a detector of the port.")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-samples", type=int, default=16)
    p.add_argument("--eval", default="ap3d",
                   choices=["ap3d", "apbev", "waymo", "dataset", "seg",
                            "none"],
                   help="'seg' = per-point mIoU/acc protocol "
                        "(core/eval_seg.py) for FSD segmentors; gt labels "
                        "come from gt-box containment, as the seg loss's; "
                        "'dataset' = the dataset's own evaluate (NDS for "
                        "nuscenes, CDS for argo2)")
    p.add_argument("--matcher", default="greedy",
                   choices=["greedy", "hungarian"],
                   help="--eval waymo matching scheme")
    p.add_argument("--out", default=None, help="write predictions (pkl)")
    p.add_argument("--sequential", action="store_true",
                   help="FSD++ sequential mode: frames in time order, frame "
                        "t's detections seed frame t+1 (the incremental "
                        "Waymo dataset of the config's data section)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (raises without a card) or 'cpu'")
    return p.parse_args(argv)


def build_test_dataset(cfg, model, synthetic: bool, num_samples: int):
    """(dataset, class names): the synthetic scenes (seed 999) or the
    config's ``val_info_path``, range-filtered and padded to the point
    cap."""
    from sst_tpu_torch.data.datasets import (
        Argo2Dataset,
        NuScenesDataset,
        SyntheticDataset,
        WaymoDataset,
    )
    from sst_tpu_torch.data.pipelines import build_pipeline

    max_points = cfg.get("capacity", {}).get("max_points", 65536)
    data_cfg = cfg.get("data", {})
    pipeline = build_pipeline([
        dict(type="PointsRangeFilter",
             point_cloud_range=model.point_cloud_range),
        dict(type="PadToCap", max_points=max_points),
    ])
    if synthetic or data_cfg.get("dataset") == "synthetic":
        ds = SyntheticDataset(num_samples=num_samples,
                              num_points=min(max_points, 32768),
                              pc_range=model.point_cloud_range,
                              pipeline=pipeline, seed=999)
        return ds, list(ds.CLASSES)
    kind = data_cfg.get("dataset", "waymo")
    cls = {"nuscenes": NuScenesDataset, "argo2": Argo2Dataset}.get(
        kind, WaymoDataset)
    ds = cls(data_root=data_cfg["data_root"],
             info_path=data_cfg["val_info_path"], pipeline=pipeline,
             test_mode=True)
    return ds, list(ds.classes)


def run_seg_eval(model, loader, device, classes) -> dict:
    from sst_tpu_torch.core.eval_seg import seg_eval
    from sst_tpu_torch.tools.train import to_numpy

    gt_l, pred_l = [], []
    for batch in loader:
        batch = batch.to(device)
        out = model.predict_seg(batch)
        for i in range(batch.points.shape[0]):
            valid = to_numpy(out["valid"][i])
            gt_l.append(to_numpy(out["gt"][i])[valid])
            pred_l.append(to_numpy(out["pred"][i])[valid])
    return seg_eval(gt_l, pred_l, tuple(classes) + ("background",))


def run_predictions(model, loader, device,
                    results: list | None = None) -> tuple[list, list]:
    """Every frame's valid predictions and gt (boxes [:, :7]), as numpy.
    ``results``, where given, also takes each frame's valid predictions
    with every box column (velocity included) in the datasets' ``evaluate``
    layout (``boxes_3d``, ``scores_3d``, ``labels_3d``)."""
    from sst_tpu_torch.tools.train import frames_of, to_numpy

    preds, gts = [], []
    for batch in loader:
        batch = batch.to(device)
        out = model.predict(batch)
        p, g = frames_of(out, batch)
        preds += p
        gts += g
        for i, frame in enumerate(p if results is not None else ()):
            ok = to_numpy(out["valid"][i])
            results.append({"boxes_3d": to_numpy(out["boxes"][i])[ok],
                            "scores_3d": frame["scores"],
                            "labels_3d": frame["labels"]})
    return preds, gts


def run_sequential(args, cfg, model, device) -> dict:
    """``--sequential``: FSD++ over the config's incremental Waymo set, at
    the data section's caps (JAX's defaults: 262,144 points, 256 seeds, 128
    gt, 6 previous frames). Returns the metrics with ``frames``,
    ``detections``, ``predict_ms`` (per frame, the card synchronised) and
    ``seeded_frames`` (frames given fed-back seeds)."""
    import numpy as np
    import torch

    from sst_tpu_torch.data.incremental_dataset import (
        IncrementalWaymoDataset,
        run_sequential_eval,
    )

    if args.eval in ("seg", "dataset"):
        raise ValueError(f"--eval {args.eval} does not apply to --sequential")
    data_cfg = cfg.get("data", {})
    if "data_root" not in data_cfg:
        raise ValueError("--sequential reads a Waymo kitti-format set: the "
                         "config needs data.data_root and data.val_info_path "
                         "(or info_path)")
    dataset = IncrementalWaymoDataset(
        data_root=data_cfg["data_root"],
        info_path=data_cfg.get("val_info_path", data_cfg.get("info_path")),
        seeds_path=data_cfg.get("seeds_path"),
        num_previous_frames=data_cfg.get("num_previous_frames", 6),
        max_points=data_cfg.get("max_points", 262144),
        max_seeds=data_cfg.get("max_seeds", 256),
        max_gt=data_cfg.get("max_gt", 128),
        load_dim=data_cfg.get("load_dim", 6),
        use_dim=tuple(data_cfg.get("use_dim", (0, 1, 2, 3, 4))),
        test_mode=True,
    )
    cuda = device.type == "cuda"
    predict_ms, seeded = [], 0

    def predict(batch):
        nonlocal seeded
        seeded += bool(batch.seed_valid.any())
        t0 = time.perf_counter()
        out = model.predict(batch.to(device))
        if cuda:
            torch.cuda.synchronize(device)
        predict_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    results = run_sequential_eval(
        dataset, predict, score_thr=data_cfg.get("seed_score_thr", 0.1))
    print(f"sequential eval: {len(results)} frames", flush=True)
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
    res = {}
    if args.eval != "none":
        preds, gts = [], []
        for r in results:
            preds.append({k: r[k] for k in ("boxes", "scores", "labels")})
            s = dataset.get_sample(r["idx"])
            gts.append({"boxes": s.get("gt_boxes", np.zeros((0, 7)))[
                :dataset.max_gt, :7], "labels": s.get(
                    "gt_labels", np.zeros(0, np.int32))[:dataset.max_gt]})
        if args.eval == "waymo":
            from sst_tpu_torch.core.eval_waymo import waymo_eval

            res = waymo_eval(preds, gts, tuple(dataset.classes),
                             matcher=args.matcher, range_breakdowns=True)
        else:
            from sst_tpu_torch.core.evaluation import eval_ap

            mode = "3d" if args.eval == "ap3d" else "bev"
            res = {f"AP_{mode}": eval_ap(preds, gts, list(dataset.classes),
                                         mode=mode)}
        print(json.dumps(res))
    res["frames"] = len(results)
    res["detections"] = int(sum(len(r["scores"]) for r in results))
    res["predict_ms"] = predict_ms
    res["seeded_frames"] = seeded
    return res


def main(argv=None) -> dict:
    """Run the CLI; returns the metrics printed (empty for ``--eval
    none``) with the number of frames under ``frames``."""
    args = parse_args(argv)
    import torch

    from sst_tpu_torch.apis import init_model
    from sst_tpu_torch.core.evaluation import eval_ap
    from sst_tpu_torch.data.loader import DataLoader
    from sst_tpu_torch.utils.config import load_config

    model = init_model(args.config, args.checkpoint, device=args.device)
    device = torch.device(args.device)
    cfg = load_config(args.config)
    if args.sequential:
        return run_sequential(args, cfg, model, device)
    dataset, classes = build_test_dataset(cfg, model, args.synthetic,
                                          args.num_samples)
    if args.eval == "dataset" and not hasattr(dataset, "evaluate"):
        raise ValueError(
            f"--eval dataset: {type(dataset).__name__} has no evaluate of "
            f"its own; use --eval waymo, ap3d or apbev")
    loader = DataLoader(dataset, batch_size=1, shuffle=False, drop_last=False)

    if args.eval == "seg":
        res = run_seg_eval(model, loader, device, classes)
        print(json.dumps(res))
        return {**res, "frames": len(dataset)}

    results = []
    preds, gts = run_predictions(model, loader, device, results)
    print(f"ran inference on {len(preds)} samples", flush=True)
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(preds, f)
    res = {}
    if args.eval == "waymo":
        from sst_tpu_torch.core.eval_waymo import waymo_eval

        res = waymo_eval(preds, gts, tuple(classes), matcher=args.matcher,
                         range_breakdowns=True)
        print(json.dumps(res))
    elif args.eval == "dataset":
        res = dataset.evaluate(results)
        print(json.dumps(res))
    elif args.eval != "none":
        mode = "3d" if args.eval == "ap3d" else "bev"
        res = {f"AP_{mode}": eval_ap(preds, gts, classes, mode=mode)}
        print(json.dumps(res))
    res["frames"] = len(preds)
    res["detections"] = int(sum(len(p["scores"]) for p in preds))
    return res


if __name__ == "__main__":
    main()
