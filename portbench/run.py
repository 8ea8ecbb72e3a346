"""Run one cell of the port's benchmark on the card this process finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names its configuration and traffic; the run sets up
(frames from the seed, the port's model, weights from the seed on the card,
the warm-up of the cell's own shapes), measures for ``--seconds``, frees
the port's state, holds a sample of what the timed path produced against
the plain reference, and prints one JSON line as its last line of standard
output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from spans and a device trace. The
numbers compared and their limits are the last lines of standard error and
the last key of the line."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def main(argv=None, spec_path=None, on_cpu: bool = False) -> int:
    """The run; ``spec_path`` and ``on_cpu`` serve the CPU tests (another
    benchmark file, tiny sizes, the port's plain twins)."""
    started = harness.process_start_epoch()
    args = parse(argv)
    if args.seed < 0:
        sys.exit("portbench: --seed must be non-negative")
    harness.set_cache_dirs()
    cell = harness.Cell(args.workload, spec_path or harness.ROOT
                        / "BENCHMARK.json")
    import torch

    if not on_cpu:
        if not torch.cuda.is_available():
            print("portbench: torch.cuda.is_available() is False; the "
                  "benchmark runs only on a CUDA card", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"portbench: the cell asks for {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cpu" if on_cpu else "cuda")

    from portbench import loops

    loop = loops.LOOPS[cell.traffic["loop"]]
    record = loop(cell, args.seed, args.seconds, bool(args.trace), device)
    # the reference's calibration of the weights is not the program's
    setup_s = record["t_window"] - started - record["reference_s"]

    checks = cell.config_module.check(cell.config, cell.traffic, record,
                                      args.seed, device)
    correct = all(v <= lim for v, lim in checks.values())
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds modules of JAX or the JAX "
              f"package: {found}", file=sys.stderr)
        return 4

    peaks = harness.json.loads((harness.HERE / "peaks.json").read_text())
    ctx = {"record": record, "cell": cell, "config": cell.config,
           "traffic": cell.traffic, "peaks": peaks, "setup_s": setup_s}
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = cell.metric_reader(m["name"]).read(ctx)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_rec = ({"platform": "cpu", "kind": "cpu", "count": 0} if on_cpu
                  else device_info(torch, cell.chips))
    device_rec["memory_peak_bytes"] = int(record["memory_peak_bytes"])
    if not on_cpu:
        device_rec["power_limit_w"] = harness.power_limit_w()
    breakdown = None
    if args.trace:
        prof = record.get("profile") or {}
        device_rec["busy_s"] = prof.get("busy_s", 0.0)
        device_rec["window_s"] = prof.get("window_s", 0.0)
        breakdown = prof.get("breakdown")
    phases = dict(record["setup_phases"])
    phases = {"start": record["t_window"] - started - sum(phases.values()),
              **phases}
    print(f"setup: {setup_s!r} s, leaving out the reference's "
          f"{record['reference_s']!r} s of weight calibration; by phase "
          f"(s): {phases!r}", file=sys.stderr)
    if args.trace:
        print(f"peaks: {peaks['bf16_flops']!r} FLOP/s bf16, "
              f"{peaks['hbm_bytes']!r} B/s memory; the card's power limit "
              f"{device_rec.get('power_limit_w')!r} W", file=sys.stderr)
    lines = [f"check {k}: {v!r} (limit {lim!r})"
             for k, (v, lim) in checks.items()]
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(
        correct, record["requests"], record["failed"], metrics, device_rec,
        {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
        breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
