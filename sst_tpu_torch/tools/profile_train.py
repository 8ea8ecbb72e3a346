"""Where the time of a train step goes, on one CUDA card: FSDv2-Waymo's
dense-BEV or sparse build, or SST-Waymo.

    python -m sst_tpu_torch.tools.profile_train [--dtype float32]
    python -m sst_tpu_torch.tools.profile_train --backbone sparse \
        [--dtype bfloat16]
    python -m sst_tpu_torch.tools.profile_train --model sst

The models, frames and optimizer are those of ``chip_smoke.py`` phases 12
and 13 (phase 11 for ``--backbone sparse``, phase 25 at bf16): full
widths, TF32 off, ``fsdv2_waymo(backbone=...)`` at its build's default
dtype (bf16 compute for the dense build, float32 for the sparse one)
unless ``--dtype`` names one, ``sst_waymo``
in float32 with bf16 attention, random weights from seed 0,
batch 1, labelled synthetic Waymo-like frames of 196,608 points (seeds 0-3;
x, y, z + 2 extra channels within 79.8 m for ``fsdv2_waymo``, x, y, z
within 74.8 m for ``sst_waymo(train_buckets=True)`` with a seeded voxel
shuffle), AdamW (base_lr 1e-5, weight decay 0.05, clip 10); FSDv2 in the
detection schedule's step-0 mode. After 2 warm-up steps it traces 2
``train_step`` calls with ``torch.profiler`` and prints

  * the device's busy time (the union of its kernel and copy intervals),
    the wall time and the idle share (profiler on);
  * the kernels that take the most device time;
  * the operators that launch the most device time (self time, by the
    operator that launched each kernel).

The last line of standard output is a JSON object with these numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from sst_tpu_torch.flagship import (
    fsdv2_waymo,
    init_weights,
    sst_waymo,
    synthetic_labeled_batch,
)
from sst_tpu_torch.tools.profile_predict import device_busy
from sst_tpu_torch.train.schedules import FSDDetectionSchedule
from sst_tpu_torch.train.state import make_optimizer
from sst_tpu_torch.train.step import train_step
from sst_tpu_torch.utils.timing import card_name_and_power_limit, disable_tf32

WARMUP = 2
PROFILED = 2  # train steps traced by torch.profiler
TOP = 15


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("fsdv2", "sst"), default="fsdv2")
    ap.add_argument("--backbone", choices=("dense_bev", "sparse"),
                    default="dense_bev", help="FSDv2's build")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default=None, help="FSDv2's compute dtype (default: "
                    "the build's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_train: needs a CUDA card")
    card = card_name_and_power_limit()
    print(card, flush=True)
    disable_tf32()
    device = torch.device("cuda", 0)
    if args.model == "sst":
        model = sst_waymo(train_buckets=True, num_point_features=3)
        title = "sst_waymo(train_buckets=True)"
        frames = [synthetic_labeled_batch(1, 196608, seed=s,
                                          num_extra_feats=0,
                                          pcr_half=74.8)[0]
                  for s in range(4)]
        gen = torch.Generator(device=device).manual_seed(0)
        kw = dict(generator=gen)
    else:
        model = fsdv2_waymo(dtype=args.dtype and getattr(torch, args.dtype),
                            backbone=args.backbone)
        title = (f"fsdv2_waymo(backbone={args.backbone!r}) "
                 f"{model.segmentor_mod.vfe_mod.dtype}")
        frames = [synthetic_labeled_batch(1, 196608, seed=s,
                                          num_extra_feats=2,
                                          pcr_half=79.8)[0]
                  for s in range(4)]
        kw = FSDDetectionSchedule(enable_after=4000, buffer_start=0.3)(0)
    model = init_weights(model, torch.Generator().manual_seed(0)).train()
    batches = [f.to(device) for f in frames]
    opt = make_optimizer(model.parameters(), base_lr=1e-5, weight_decay=0.05,
                         clip_norm=10.0, total_steps=10000)
    for i in range(WARMUP):
        train_step(model, opt, batches[i % len(batches)], kw)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILED):
            train_step(model, opt, batches[(WARMUP + i) % len(batches)], kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, by_name = device_busy(prof)
    idle = 1.0 - busy / wall if busy > 0 else None
    print(f"{title} train_step, torch.profiler over {PROFILED} steps "
          f"({card}; TF32 off): device busy {busy:.3f} ms of {wall:.3f} ms "
          f"wall, idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'} "
          f"(profiler on)", flush=True)
    top = [(name[:100], ms) for name, ms in
           sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    print("kernels by device time:", flush=True)
    for name, ms in top:
        print(f"  {ms:9.3f} ms  {name}", flush=True)
    ops = []
    for ev in prof.key_averages():
        self_us = getattr(ev, "self_device_time_total", None)
        if self_us is None:
            self_us = ev.self_cuda_time_total
        if self_us > 0:
            ops.append((ev.key[:80], self_us / 1e3, ev.count))
    ops.sort(key=lambda r: -r[1])
    print("operators by the device time of their own kernels:", flush=True)
    for key, ms, count in ops[:TOP]:
        print(f"  {ms:9.3f} ms  {count:6d} calls  {key}", flush=True)
    print(json.dumps({
        "card": card, "model": title, "profiled_steps": PROFILED,
        "device_busy_ms": busy, "wall_ms": wall, "idle_share": idle,
        "top_kernels_ms": dict(top),
        "top_operators_ms": {k: ms for k, ms, _ in ops[:TOP]}}), flush=True)


if __name__ == "__main__":
    main()
