"""Dense-BEV vs sparse-UNet FSDv2 quality A/B (counterpart of the JAX
package's ``tools/ab_dense_vs_sparse.py``, with its flags and its output
keys, so that either ``ab_merge`` reads the other's file).

Both builds train on the same synthetic labelled scenes
(``flagship.synthetic_labeled_batch``: the gt boxes own their points, the
full capacity caps) and are scored on held-out scenes by the internal
Waymo protocol (``core/eval_waymo.py waymo_eval``, L1 / L2 mAP and mAPH).
The dense build runs the sorted segment reduce kernel; the sparse build
the sparse conv, input-gradient and dW kernels.

    python -m sst_tpu_torch.tools.ab_dense_vs_sparse --out ab.json
    python -m sst_tpu_torch.tools.ab_dense_vs_sparse --tiny --device cpu \\
        --steps 40 --out ab_tiny.json

Training: ``train/step.py train_step`` with ``make_optimizer(base_lr=--lr,
total_steps=--steps)`` under ``FSDDetectionSchedule(enable_after=--warmup,
buffer_start=0, delay_buffer_until=--warmup)``; the scenes in an order
drawn from ``RandomState(seed + 17)``, reshuffled each epoch; the weights
``flagship.init_weights`` from ``torch.Generator`` seed ``seed``.
``--ckpt-every`` saves the model, the optimizer and ``progress.json`` (the
step, the loss curve, the trajectory, the wall time and a fingerprint of
the run's settings) under ``--ckpt-dir``; ``--resume`` continues each
(build, seed) arm from its last save, the data order fast-forwarded, so a
resumed arm ends as an uninterrupted one does. ``--max-wall-s`` stops an
arm at the budget (the scene pools' build excluded) with a save.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch

AP_KEYS = ("Overall/L1 mAP", "Overall/L1 mAPH", "Overall/L2 mAP",
           "Overall/L2 mAPH")
TRAJ_KEYS = ("Overall/L1 mAP", "Overall/L1 mAPH", "Overall/L2 mAPH")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def predictions_to_frames(pred: dict, batch_size: int) -> list:
    """A ``predict`` output → per-frame eval dicts (valid rows with a
    positive score)."""
    boxes, scores, labels = (_np(pred[k]) for k in ("boxes", "scores",
                                                     "labels"))
    valid = _np(pred["valid"]) & (scores > 0)
    return [dict(boxes=boxes[i][m], scores=scores[i][m], labels=labels[i][m])
            for i, m in enumerate(valid[:batch_size])]


_POOLS = {}  # (scene_kw, n_train, n_val) -> (train, val), shared by the arms


def get_pools(scene_kw: dict, n_train: int, n_val: int,
              cache_dir: str | None = None):
    """(train, val) scene pools as numpy ``PointBatch``es: train scene s is
    ``synthetic_labeled_batch(seed=s)``, val scene v ``seed=10_000 + v``
    with its gt meta, the same scenes for every (build, seed) arm. Built
    once per process and kept in a pickle under ``cache_dir`` (the run's
    ``--ckpt-dir``; default the temporary directory), keyed by a hash of
    the settings."""
    from sst_tpu_torch.flagship import synthetic_labeled_batch

    kw_key = tuple(sorted(scene_kw.items()))
    key = (kw_key, n_train, n_val)
    if key in _POOLS:
        return _POOLS[key]
    t0 = time.time()
    h = hashlib.sha1(repr(key).encode()).hexdigest()[:16]
    cache_dir = cache_dir or tempfile.gettempdir()
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, f"sst_torch_ab_pool_{h}.pkl")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            _POOLS[key] = pickle.load(f)
        print(f"[pool] loaded {cache} ({time.time() - t0:.0f}s)", flush=True)
        return _POOLS[key]
    train = [synthetic_labeled_batch(seed=s, **scene_kw)[0]
             for s in range(n_train)]
    val = [synthetic_labeled_batch(seed=10_000 + v, **scene_kw)
           for v in range(n_val)]
    print(f"[pool] {n_train} train + {n_val} val scenes ready "
          f"({time.time() - t0:.0f}s)", flush=True)
    _POOLS[key] = (train, val)
    tmp = f"{cache}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(_POOLS[key], f)
    os.replace(tmp, cache)
    return _POOLS[key]


def run_build(name: str, model, scene_kw: dict, args, seed: int = 0) -> dict:
    """Train one (build, seed) arm and score it; returns its result dict
    (``ap``, ``loss_curve``, ``wall_s``, ``seed``, ``trajectory`` and,
    where the wall budget stopped it, ``stopped_early_at_step``)."""
    from sst_tpu_torch.core.eval_waymo import waymo_eval
    from sst_tpu_torch.flagship import init_weights
    from sst_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from sst_tpu_torch.train.schedules import FSDDetectionSchedule
    from sst_tpu_torch.train.state import make_optimizer
    from sst_tpu_torch.train.step import train_step

    pool, val_pool = get_pools(scene_kw, args.train_scenes, args.val_scenes,
                               args.ckpt_dir)
    device = next(model.parameters()).device
    # the wall budget starts after the pools: it bounds the arm's training
    t_start = time.time()
    init_weights(model, torch.Generator().manual_seed(seed))
    optimizer = make_optimizer(model.parameters(), base_lr=args.lr,
                               total_steps=args.steps)

    start_step, losses, trajectory, prior_wall = 0, [], [], 0.0
    ckpt_dir = prog_path = None
    fingerprint = {"build": name.split("@")[0], "seed": seed,
                   "steps": args.steps, "train_scenes": args.train_scenes,
                   "lr": args.lr, "num_points": args.num_points,
                   "warmup": args.warmup}
    if args.ckpt_every:
        ckpt_dir = os.path.join(args.ckpt_dir, name.replace("@", "_"))
        os.makedirs(ckpt_dir, exist_ok=True)
        prog_path = os.path.join(ckpt_dir, "progress.json")
    if args.resume and prog_path and os.path.exists(prog_path):
        with open(prog_path) as f:
            prog = json.load(f)
        if prog["fingerprint"] != fingerprint:
            raise SystemExit(
                f"[{name}] refusing to resume: checkpoint fingerprint "
                f"{prog['fingerprint']} != current {fingerprint} "
                f"(use a fresh --ckpt-dir)")
        load_checkpoint(os.path.join(ckpt_dir, f"step_{prog['step']}"),
                        model, optimizer)
        start_step = int(prog["step"])
        losses = prog["losses"]
        trajectory = [tuple(t) for t in prog["trajectory"]]
        prior_wall = float(prog["wall_s"])
        print(f"[{name}] resumed from step {start_step} "
              f"({prior_wall:.0f}s accumulated)", flush=True)

    def save_ckpt(step_done: int, extra: dict | None = None) -> None:
        if not ckpt_dir:
            return
        save_checkpoint(os.path.join(ckpt_dir, f"step_{step_done}"), model,
                        optimizer, step_done)
        prog = {"step": step_done, "losses": losses,
                "trajectory": trajectory, "fingerprint": fingerprint,
                "wall_s": prior_wall + (time.time() - t_start)}
        prog.update(extra or {})
        tmp = prog_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(prog, f)
        os.replace(tmp, prog_path)
        # the two newest saves stay
        steps_on_disk = sorted(
            int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and d.split("_")[1].isdigit())
        for s in steps_on_disk[:-2]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                          ignore_errors=True)
        print(f"[{name}] checkpointed step {step_done}", flush=True)

    def evaluate() -> dict:
        preds, gts = [], []
        for batch, meta in val_pool:
            preds.extend(predictions_to_frames(
                model.predict(batch.to(device)), scene_kw["batch_size"]))
            gts.extend(meta)
        return waymo_eval(preds, gts,
                          classes=("Car", "Pedestrian", "Cyclist"))

    # a seg-only warm-up, then detection (buffer_start 0: two modes)
    sched = FSDDetectionSchedule(enable_after=args.warmup, buffer_start=0.0,
                                 delay_buffer_until=args.warmup)
    loss_params = inspect.signature(model.loss).parameters
    shuffle_rng = np.random.RandomState(seed + 17)
    order = shuffle_rng.permutation(args.train_scenes)
    pos = 0
    # the data order fast-forwarded to the resume point, as the loop
    # consumes it, so a resumed arm sees an uninterrupted one's scenes
    for _ in range(start_step):
        if pos >= args.train_scenes:
            order = shuffle_rng.permutation(args.train_scenes)
            pos = 0
        pos += 1
    step = max(start_step - 1, 0)
    stopped_early = None
    for step in range(start_step, args.steps):
        kw = {k: v for k, v in sched(step).items() if k in loss_params}
        if "generator" in loss_params:  # the RoI sampler's draws
            kw["generator"] = torch.Generator(device=device).manual_seed(
                seed * 100_000 + step)
        if pos >= args.train_scenes:  # reshuffled each epoch
            order = shuffle_rng.permutation(args.train_scenes)
            pos = 0
        batch = pool[order[pos]].to(device)
        pos += 1
        metrics = train_step(model, optimizer, batch, loss_kwargs=kw)
        if step % 50 == 0 or step == args.steps - 1:
            lt = float(metrics["loss_total"])
            losses.append(round(lt, 3))
            print(f"[{name}] step {step}: loss={lt:.3f} "
                  f"({time.time() - t_start:.0f}s)", flush=True)
            if not np.isfinite(lt):
                raise FloatingPointError(f"{name} diverged at step {step}")
        if (args.eval_every and step > args.warmup
                and (step + 1) % args.eval_every == 0
                and step != args.steps - 1):
            ap_t = evaluate()
            trajectory.append((step + 1, {k: ap_t[k] for k in TRAJ_KEYS}))
            print(f"[{name}] step {step + 1}: "
                  f"L1 mAPH={ap_t['Overall/L1 mAPH']}", flush=True)
        if (args.ckpt_every and (step + 1) % args.ckpt_every == 0
                and step != args.steps - 1):
            save_ckpt(step + 1)
        if args.max_wall_s and time.time() - t_start > args.max_wall_s:
            stopped_early = step + 1
            print(f"[{name}] wall budget hit at step {step + 1}", flush=True)
            save_ckpt(step + 1, extra={"stopped_early_at_step": step + 1})
            break

    ap = evaluate()
    trajectory.append((step + 1, {k: ap[k] for k in TRAJ_KEYS}))
    if stopped_early is None and args.ckpt_every:
        save_ckpt(step + 1, extra={"completed": True})
    wall = prior_wall + (time.time() - t_start)
    print(f"[{name}] done in {wall:.0f}s  L2 mAPH={ap['Overall/L2 mAPH']}",
          flush=True)
    out = {"ap": ap, "loss_curve": losses, "wall_s": round(wall, 1),
           "seed": seed, "trajectory": trajectory}
    if stopped_early is not None:
        out["stopped_early_at_step"] = stopped_early
    return out


def _fsd_from_cfg(path: str, device):
    from sst_tpu_torch.utils.builders import build_model_from_cfg
    from sst_tpu_torch.utils.config import load_config

    return build_model_from_cfg(load_config(path), train=True, device=device)


def builders(args) -> tuple:
    """({build name: zero-argument constructor}, scene_kw) for ``args``."""
    from sst_tpu_torch import flagship as fl

    dev = args.device
    if args.tiny:
        return ({"dense": lambda: fl.tiny_fsdv2_dense(num_point_features=5,
                                                      device=dev),
                 "sparse": lambda: fl.tiny_fsdv2_flagship(
                     num_point_features=5, device=dev)},
                dict(batch_size=1, num_points=4096, num_extra_feats=2,
                     pcr_half=3.9, num_objects=6, size_scale=0.35))
    n = args.num_points
    dense_kw = {"z_groups": args.z_groups} if args.z_groups else {}
    return ({
        "dense": lambda: fl.fsdv2_waymo_dense(max_points=n, device=dev,
                                              **dense_kw),
        # the full-column z collapse, kept for the z-grouped build's delta
        "dense_z1": lambda: fl.fsdv2_waymo_dense(max_points=n, z_groups=1,
                                                 device=dev),
        "sparse": lambda: fl.fsdv2_waymo(max_points=n, backbone="sparse",
                                         device=dev),
        # "dense" is the bf16 default; dense_f32 isolates the dtype delta,
        # dense_bf16 names the default for older result files
        "dense_f32": lambda: fl.fsdv2_waymo_dense(
            max_points=n, dtype=torch.float32, device=dev, **dense_kw),
        "dense_bf16": lambda: fl.fsdv2_waymo_dense(
            max_points=n, dtype=torch.bfloat16, device=dev, **dense_kw),
        # FSD two stage: the same segmentor swap on the heaviest family
        "fsd_dense": lambda: _fsd_from_cfg(
            "configs/fsd/fsd_waymoD1_1x_dense.py", dev),
        "fsd_sparse": lambda: _fsd_from_cfg("configs/fsd/fsd_waymoD1_1x.py",
                                            dev),
    }, dict(batch_size=1, num_points=n, num_extra_feats=2, pcr_half=79.8,
            num_objects=48))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--warmup", type=int, default=150)
    p.add_argument("--train-scenes", type=int, default=64)
    p.add_argument("--val-scenes", type=int, default=24)
    p.add_argument("--num-points", type=int, default=196608)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--builds", default="dense,sparse")
    p.add_argument("--z-groups", type=int, default=0,
                   help="override dense build z_groups (0 = flagship default)")
    p.add_argument("--seeds", default="0",
                   help="comma list of init/shuffle seeds per build")
    p.add_argument("--eval-every", type=int, default=0,
                   help="held-out eval every N steps (mAPH trajectory)")
    p.add_argument("--max-wall-s", type=int, default=0,
                   help="per-invocation wall budget (pool build excluded); "
                        "an arm past it checkpoints and stops early; "
                        "relaunch with --resume to continue")
    p.add_argument("--ckpt-every", type=int, default=250,
                   help="checkpoint the model and optimizer every N steps "
                        "(0 disables)")
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "sst_ab_ckpt"))
    p.add_argument("--resume", action="store_true",
                   help="resume each (build, seed) arm from its latest "
                        "checkpoint under --ckpt-dir when one exists")
    p.add_argument("--tiny", action="store_true",
                   help="tiny grids (script smoke test)")
    p.add_argument("--out", default="AB_DENSE_SPARSE.json")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (raises without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    makers, scene_kw = builders(args)
    seeds = [int(s) for s in args.seeds.split(",")]
    results = {"args": vars(args), "scene_kw": dict(scene_kw)}
    for b in args.builds.split(","):
        runs = []
        for sd in seeds:
            tag = b if len(seeds) == 1 else f"{b}@s{sd}"
            runs.append(run_build(tag, makers[b](), scene_kw, args, seed=sd))
            # written after every arm: a crash keeps the finished ones
            results[b] = {
                "runs": runs,
                "ap": {k: round(float(np.mean([r["ap"][k] for r in runs])),
                                4) for k in AP_KEYS},
                "ap_std": {k: round(float(np.std([r["ap"][k] for r in runs])),
                                    4) for k in AP_KEYS},
            }
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    for dk, sk, label in (("dense", "sparse", "delta_dense_minus_sparse"),
                          ("dense", "dense_f32", "delta_bf16_minus_f32"),
                          ("fsd_dense", "fsd_sparse",
                           "delta_fsd_dense_minus_sparse")):
        if dk in results and sk in results:
            d, s = results[dk]["ap"], results[sk]["ap"]
            results[label] = {k: round(d[k] - s[k], 4) for k in AP_KEYS}
            print(f"{label}:", json.dumps(results[label]))
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", args.out)
    return results


if __name__ == "__main__":
    main()
