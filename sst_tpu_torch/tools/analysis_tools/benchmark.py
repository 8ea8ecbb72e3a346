"""Predict latency and frames per second of a config on one card
(counterpart of the JAX package's ``tools/analysis_tools/benchmark.py``).

    python -m sst_tpu_torch.tools.analysis_tools.benchmark \\
        configs/sst/sst_waymoD5_3class_centerhead.py \\
        [--samples 50] [--warmup 5] [--num-points 196608] [--device cuda]

The kernels are checked against their twins first
(``utils/preflight.py preflight_kernels``; a failure ends the run). The
model is built from the config with random weights from seed 0 and fed one
``flagship.synthetic_waymo_batch`` frame (x, y, z and 2 extra channels
within the config's range less 0.2 m, JAX's ``pcr_half``), batch 1. After
one call and ``--warmup`` more, each of ``--samples`` predicts is timed
by CUDA events around ``model.predict`` (in place of JAX's slope method).
With ``--device cpu`` the model runs the kernels' plain twins, the
preflight is skipped (it needs a card) and the clock is the host's.

A line before the last gives the card's name and power limit, the
preflight's errors and the per-predict times; the last line of standard
output is JAX's JSON: ``config``, ``fps`` (1000 over the mean ms),
``p50_latency_ms`` (the median) and ``num_points``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--samples", type=int, default=50)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--num-points", type=int, default=196608)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (raises without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark; returns the last line's dict with the details
    (``predict_ms``, ``preflight``, ``card``) added."""
    args = parse_args(argv)
    import torch

    from sst_tpu_torch.flagship import init_weights, synthetic_waymo_batch
    from sst_tpu_torch.utils.builders import build_model_from_cfg
    from sst_tpu_torch.utils.config import load_config

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    details = {"card": None, "preflight": None}
    if cuda:
        from sst_tpu_torch.utils.preflight import preflight_kernels
        from sst_tpu_torch.utils.timing import (
            card_name_and_power_limit,
            disable_tf32,
        )

        details["card"] = card_name_and_power_limit()
        disable_tf32()
        details["preflight"] = preflight_kernels(device)
    cfg = load_config(args.config)
    model = init_weights(build_model_from_cfg(cfg, train=False,
                                              device=device),
                         torch.Generator().manual_seed(0)).eval()
    pcr = cfg["model"].get("point_cloud_range",
                           (-74.88, -74.88, -2, 74.88, 74.88, 4))
    batch = synthetic_waymo_batch(
        1, args.num_points, num_extra_feats=2,
        pcr_half=float(pcr[3]) - 0.2).to(device)

    def run():
        return model.predict(batch)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    for _ in range(1 + args.warmup):
        run()
    sync()
    times = []
    for _ in range(args.samples):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
    mean = statistics.fmean(times)
    result = {"config": args.config, "fps": 1e3 / mean,
              "p50_latency_ms": statistics.median(times),
              "num_points": args.num_points}
    details["predict_ms"] = times
    print(json.dumps(details), flush=True)
    print(json.dumps(result), flush=True)
    return dict(result, **details)


if __name__ == "__main__":
    main()
