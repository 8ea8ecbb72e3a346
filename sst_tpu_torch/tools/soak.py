"""Train-at-scale soak on one card (counterpart of the JAX package's
``tools/soak.py``).

    python -m sst_tpu_torch.tools.soak --model sst --steps 300 \\
        --out work_dirs/soak.json [--scene-pool 16] [--device cuda]
    python -m sst_tpu_torch.tools.soak --config <config> --steps 20 ...

Runs ``--steps`` train steps of a full-width model on a pool of synthetic
labelled scenes, built as JAX's soak builds them, with random weights from
seed 0 and ``train/state.py make_optimizer(base_lr=1e-4, total_steps=
steps)``:
  - ``fsdv2``: ``flagship.fsdv2_waymo`` (the dense-BEV build at its bf16
    default) on ``synthetic_labeled_batch`` scenes (2 extra channels,
    within 79.8 m);
  - ``fsd_dense``: configs/fsd/fsd_waymoD1_1x_dense.py (train=True) on the
    same scenes;
  - ``sst``: ``flagship.sst_waymo(train_buckets=True)`` on
    ``synthetic_waymo_batch`` scenes (x, y, z);
  - ``--config``: any config's model (train=True) on
    ``synthetic_labeled_batch`` scenes within its range.
Step i's voxel shuffle and samplers draw from a generator seeded with
100 + i (JAX's ``PRNGKey(100 + i)``). Each step is timed by CUDA events.

The invariants, each a failure (exit code 1) where it breaks:
  - every loss is finite at every step;
  - every ``*overflow*`` / ``*dropped*`` counter is zero at every step;
  - in place of JAX's "no recompiles": from step 2 on, the launches of
    every kernel in a step (each wrapper's counter) and the step's peak
    device memory and the memory held after it equal step 2's.
It records the steady-state step time (mean and p90 over the second half
of the steps) and writes the log into the JSON file ``--out`` under the
model's name (other models' entries kept). With ``--device cpu`` the
kernels' plain twins run, the clock is the host's and memory is not
measured.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from sst_tpu_torch.ops import sorted_reduce as sr
from sst_tpu_torch.ops import sparse_conv_dw as sdw
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from sst_tpu_torch.ops import window_mha as wm

MODELS = ("fsdv2", "fsd_dense", "sst")
FSD_DENSE_CONFIG = "configs/fsd/fsd_waymoD1_1x_dense.py"


def _kernel_counts() -> dict:
    return {"sorted_reduce": sr.launches,
            "segment_offsets": sr.offsets_launches,
            "sparse_conv_gemm": scg.launches, "sparse_conv_dw": sdw.launches,
            "window_mha": wm.launches}


def build(model_name: str | None, config: str | None, num_points: int,
          device):
    """(model in train mode, scene maker seed -> PointBatch on the host)."""
    from sst_tpu_torch.flagship import (
        fsdv2_waymo,
        init_weights,
        sst_waymo,
        synthetic_labeled_batch,
        synthetic_waymo_batch,
    )

    def labeled(pcr_half):
        return lambda seed: synthetic_labeled_batch(
            1, num_points, seed=seed, num_extra_feats=2,
            pcr_half=pcr_half)[0]

    if config is not None or model_name == "fsd_dense":
        from sst_tpu_torch.utils.builders import build_model_from_cfg
        from sst_tpu_torch.utils.config import load_config

        cfg = load_config(config or FSD_DENSE_CONFIG)
        model = build_model_from_cfg(cfg, train=True, device=device)
        if config is None:
            mk = labeled(79.8)
        else:
            pcr = getattr(model, "point_cloud_range",
                          (-74.88, -74.88, -2, 74.88, 74.88, 4))
            mk = labeled(float(pcr[3]) - 0.2)
    elif model_name == "fsdv2":
        model = fsdv2_waymo(max_points=num_points, device=device)
        mk = labeled(79.8)
    elif model_name == "sst":
        model = sst_waymo(max_points=num_points, train_buckets=True,
                          num_point_features=3, device=device)

        def mk(seed):
            return synthetic_waymo_batch(1, num_points, seed=seed)
    else:
        raise ValueError(f"--model must be one of {MODELS}")
    init_weights(model, torch.Generator().manual_seed(0))
    return model.train(), mk


def soak(model_name: str | None, steps: int, num_points: int,
         scene_pool: int, device="cuda", config: str | None = None) -> dict:
    """Run the soak; returns its log (the invariants' verdicts under
    ``failures``, an empty list where all hold)."""
    from sst_tpu_torch.train.state import make_optimizer
    from sst_tpu_torch.train.step import train_step

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        from sst_tpu_torch.utils.timing import disable_tf32

        disable_tf32()
    model, mk = build(model_name, config, num_points, device)
    batches = [mk(s).to(device) for s in range(scene_pool)]
    opt = make_optimizer(model.parameters(), base_lr=1e-4,
                         total_steps=steps)
    takes_generator = "generator" in inspect.signature(model.loss).parameters
    log = {"model": config or model_name, "steps": steps,
           "num_points": num_points, "scene_pool": scene_pool,
           "device": str(device), "losses": [], "overflow_keys": {},
           "step_ms": [], "launches": [], "peak_bytes": [],
           "held_bytes": [], "failures": []}
    for i in range(steps):
        kw = {}
        if takes_generator:
            kw["generator"] = torch.Generator(device=device).manual_seed(
                100 + i)
        for mod in (sr, scg, sdw, wm):
            mod.reset_launch_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = train_step(model, opt, batches[i % scene_pool], kw)
            end.record()
            end.synchronize()
            log["step_ms"].append(start.elapsed_time(end))
            log["peak_bytes"].append(torch.cuda.max_memory_allocated(device))
            log["held_bytes"].append(torch.cuda.memory_allocated(device))
        else:
            t0 = time.perf_counter()
            metrics = train_step(model, opt, batches[i % scene_pool], kw)
            log["step_ms"].append((time.perf_counter() - t0) * 1e3)
        log["launches"].append(_kernel_counts())
        lt = float(metrics["loss_total"])
        log["losses"].append(lt)
        if not np.isfinite(lt):
            log["failures"].append(f"non-finite loss at step {i}")
        for k, v in metrics.items():
            if "overflow" in k or "dropped" in k:
                v = float(v)
                log["overflow_keys"][k] = log["overflow_keys"].get(k, 0.0) + v
                if v:
                    log["failures"].append(f"{k} = {v} at step {i}")
        print(f"step {i}: loss={lt:.4f} {log['step_ms'][-1]:.2f} ms",
              flush=True)
    for key in ("launches", "peak_bytes", "held_bytes"):
        seq = log[key]
        changed = [i for i in range(3, len(seq)) if seq[i] != seq[2]]
        if changed:
            log["failures"].append(
                f"{key} per step changed after step 2 at steps {changed}: "
                f"{seq[2]} then {seq[changed[0]]}")
    tail = log["step_ms"][len(log["step_ms"]) // 2:]
    log["steady_step_ms_mean"] = statistics.fmean(tail) if tail else None
    log["steady_step_ms_p90"] = (float(np.percentile(tail, 90)) if tail
                                 else None)
    log["ok"] = not log["failures"]
    return log


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="fsdv2", choices=MODELS)
    p.add_argument("--config", default=None,
                   help="soak this config's model instead of --model")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--num-points", type=int, default=196608)
    p.add_argument("--scene-pool", type=int, default=16)
    p.add_argument("--out", default="work_dirs/soak.json")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (raises without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    log = soak(args.model, args.steps, args.num_points, args.scene_pool,
               args.device, args.config)
    existing = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    existing[log["model"]] = log
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(existing, f, indent=1)
    for msg in log["failures"]:
        print(f"SOAK INVARIANT BROKEN: {msg}", flush=True)
    print(("SOAK OK" if log["ok"] else "SOAK FAILED"),
          f"steady step {log['steady_step_ms_mean']} ms -> {args.out}",
          flush=True)
    return log


if __name__ == "__main__":
    if not main()["ok"]:
        sys.exit(1)
