"""Where the time of FSDv2-Waymo or SST-Waymo predict goes, on one CUDA
card.

    python -m sst_tpu_torch.tools.profile_predict [--dtype float32]
    python -m sst_tpu_torch.tools.profile_predict --backbone sparse
    python -m sst_tpu_torch.tools.profile_predict --model sst \
        [--dtype bfloat16]

The models and frames are those of ``chip_smoke.py``: full widths, TF32
off, random weights from seed 0, batch 1, synthetic Waymo-like frames of
196,608 points (seeds 0-3; x, y, z + 2 extra channels within 79.8 m for
FSDv2, x, y, z within 74.8 m for SST, the frames the JAX bench feeds
each). ``--model fsdv2`` (default) builds ``fsdv2_waymo(backbone=...)``,
dense-BEV by default, at ``fsdv2_waymo``'s default dtype (bf16 compute for
the dense build, float32 for the sparse one) unless ``--dtype`` names one;
``--model sst`` builds ``sst_waymo(train_buckets=False)`` (float32 with
bf16 attention, or ``--dtype bfloat16``, ``bench.py bench_sst``'s build).
It prints

  * the median CUDA-event time of each stage of ``predict`` over 8 frames,
    from the call to each boundary marked by a hook on a module's forward:
    FSDv2: segmentor; virtual-voxel features (fg sampling, virtual VFE,
    multiscale fusion, mixer); head MLPs; box decode + NMS. SST: voxelize +
    VFE; window plan; SST blocks (and the BEV scatter); attached convs +
    FPN; head; box decode + NMS. Then the device-to-host copy of the
    result;
  * the median time of ``apis.inference_detector`` end to end (adds the
    host range filter, padding and host-to-device copy);
  * from ``torch.profiler`` over 2 predicts: the device's busy
    time (the union of its kernel and copy intervals), the wall time, the
    idle share (profiler on), and the kernels that take the most device time.

The last line of standard output is a JSON object with these numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict

import torch

from sst_tpu_torch.apis import (
    frame_to_numpy,
    inference_detector,
    prepare_batch,
)
from sst_tpu_torch.flagship import (
    fsdv2_waymo,
    init_weights,
    sst_waymo,
    synthetic_waymo_batch,
)
from sst_tpu_torch.utils.timing import (
    card_name_and_power_limit,
    disable_tf32,
    event_ms,
)

MAX_POINTS = 196608
FRAMES = 8  # timed frames for the stage table
PROFILED = 2  # predicts traced by torch.profiler


def stage_boundaries(model, name: str):
    """(stage name, module, "pre" | "post") for each stage that ends at a
    hook on a module's forward, in the order predict runs them; the stage
    after the last boundary ends with predict."""
    if name == "sst":
        bb = model.backbone_mod
        return [("voxelize + VFE", model.vfe_mod, "post"),
                ("window plan", bb, "pre"),
                ("SST blocks", bb.attached_conv_0, "pre"),
                ("attached convs + FPN", model.neck_mod, "post"),
                ("head", model.head_mod, "post")]
    return [("segmentor", model.segmentor_mod, "post"),
            ("virtual voxel features", model.head_mod, "pre"),
            ("head MLPs", model.head_mod, "post")]


def staged_predict(model, batch, boundaries):
    """``model.predict(batch)`` and the copy of its result to the host, with
    a CUDA event before predict, at each boundary, after predict and after
    the copy: the boundaries are module hooks, so what runs is predict
    itself.

    Returns (result as numpy for the frame, ms of each stage: one per
    boundary, then box decode + NMS, then the device-to-host copy)."""
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(len(boundaries) + 3)]
    hooks = []
    for i, (_, mod, kind) in enumerate(boundaries):
        def mark(*_, e=ev[i + 1]):
            e.record()
        hooks.append(mod.register_forward_pre_hook(mark) if kind == "pre"
                     else mod.register_forward_hook(mark))
    try:
        ev[0].record()
        res = model.predict(batch)
    finally:
        for h in hooks:
            h.remove()
    ev[-2].record()
    host = frame_to_numpy(res)
    ev[-1].record()
    ev[-1].synchronize()
    return host, [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]


def device_busy(prof):
    """(busy ms as the union of device intervals, {kernel name: ms})."""
    spans, by_name = [], defaultdict(float)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    busy_us, edge = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > edge:
            busy_us += end - max(start, edge)
            edge = end
    return busy_us / 1e3, by_name


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("fsdv2", "sst"), default="fsdv2")
    ap.add_argument("--backbone", choices=("dense_bev", "sparse"),
                    default="dense_bev", help="FSDv2's build")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default=None, help="the compute dtype (default: the "
                    "builder's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_predict: needs a CUDA card")
    card = card_name_and_power_limit()
    print(card, flush=True)
    disable_tf32()
    dtype = args.dtype and getattr(torch, args.dtype)
    if args.model == "sst":
        model = sst_waymo(train_buckets=False, num_point_features=3,
                          dtype=dtype or torch.float32)
        title = f"sst_waymo(train_buckets=False) {model.backbone_mod.dtype}"
        frames = [synthetic_waymo_batch(1, MAX_POINTS, seed=s).points[0]
                  for s in range(4)]
    else:
        model = fsdv2_waymo(dtype=dtype, backbone=args.backbone)
        title = (f"fsdv2_waymo(backbone={args.backbone!r}) "
                 f"{model.segmentor_mod.vfe_mod.dtype}")
        frames = [synthetic_waymo_batch(1, MAX_POINTS, seed=s,
                                        num_extra_feats=2,
                                        pcr_half=79.8).points[0]
                  for s in range(4)]
    model = init_weights(model, torch.Generator().manual_seed(0)).eval()
    batches = [prepare_batch(model, f, MAX_POINTS) for f in frames]
    boundaries = stage_boundaries(model, args.model)
    names = [b[0] for b in boundaries] + ["box decode + NMS",
                                          "device-to-host copy"]

    for batch in batches:  # warm-up
        staged_predict(model, batch, boundaries)

    per_stage = [[] for _ in names]
    for i in range(FRAMES):
        _, ms = staged_predict(model, batches[i % len(batches)], boundaries)
        for acc, t in zip(per_stage, ms):
            acc.append(t)
    stages = {name: statistics.median(t) for name, t in zip(names, per_stage)}
    totals = [sum(ms) for ms in zip(*per_stage)]
    e2e = statistics.median(
        event_ms(lambda f=frames[i % len(frames)]: inference_detector(
            model, f, MAX_POINTS)) for i in range(FRAMES))

    print(f"{title} predict stages, median of {FRAMES} frames (CUDA "
          f"events; {card}; TF32 off):", flush=True)
    for name, ms in stages.items():
        print(f"  {name:<24} {ms:9.3f} ms", flush=True)
    print(f"  {'total (no host I/O)':<24} {statistics.median(totals):9.3f} ms",
          flush=True)
    print(f"inference_detector end to end: {e2e:.3f} ms (median of "
          f"{FRAMES})", flush=True)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILED):
            model.predict(batches[i % len(batches)])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, by_name = device_busy(prof)
    if busy > 0:
        idle = 1.0 - busy / wall
        print(f"torch.profiler over {PROFILED} predicts: device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall, idle share {idle:.3f} "
              f"(profiler on)", flush=True)
    else:
        idle = None
        print("torch.profiler recorded no device time: busy and idle share "
              "not measured", flush=True)
    top = [(name[:100], ms) for name, ms in
           sorted(by_name.items(), key=lambda kv: -kv[1])[:12]]
    for name, ms in top:
        print(f"  {ms:9.3f} ms  {name}", flush=True)

    print(json.dumps({
        "card": card, "model": title, "frames": FRAMES,
        "stages_ms": stages,
        "total_ms": statistics.median(totals), "inference_detector_ms": e2e,
        "profiled_predicts": PROFILED, "device_busy_ms": busy,
        "wall_ms": wall, "idle_share": idle,
        "top_kernels_ms": dict(top)}), flush=True)


if __name__ == "__main__":
    main()
