"""Training-log analysis (counterpart of the JAX package's
``tools/analysis_tools/analyze_logs.py``, after the reference's plot_curve /
cal_train_time over mmcv json logs), on the train CLI's
``train_log.jsonl``.

Usage:
  # training-speed stats
  python -m sst_tpu_torch.tools.analysis_tools.analyze_logs cal_train_time \\
      work_dirs/run/train_log.jsonl

  # loss curves (a PNG where matplotlib imports, else an ASCII sparkline)
  python -m sst_tpu_torch.tools.analysis_tools.analyze_logs plot_curve \\
      work_dirs/run/train_log.jsonl --keys loss_total loss_sem_seg \\
      --out curves.png
"""

from __future__ import annotations

import argparse
import json


def load(path: str) -> list[dict]:
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    return recs


def cal_train_time(recs: list[dict]) -> None:
    if len(recs) < 2:
        print("need >= 2 log records")
        return
    spans = []
    for a, b in zip(recs[:-1], recs[1:]):
        ds = b["step"] - a["step"]
        if ds > 0 and "wall" in a and "wall" in b:
            spans.append((b["wall"] - a["wall"]) / ds)
    spans = sorted(spans)
    if not spans:
        print("no wall-time spans found")
        return
    import statistics

    # skip the first span (contains compile time)
    tail = spans[1:] or spans
    print(f"records: {len(recs)}  steps: {recs[0]['step']}..{recs[-1]['step']}")
    print(f"per-step time: mean {statistics.mean(tail):.3f}s  "
          f"median {statistics.median(tail):.3f}s  "
          f"fastest {tail[0]:.3f}s  slowest {tail[-1]:.3f}s")


def _ascii_plot(xs, ys, key, width=72, height=12):
    lo, hi = min(ys), max(ys)
    span = (hi - lo) or 1.0
    rows = [[" "] * width for _ in range(height)]
    for x, y in zip(xs, ys):
        c = int((x - xs[0]) / max(xs[-1] - xs[0], 1) * (width - 1))
        r = int((1 - (y - lo) / span) * (height - 1))
        rows[r][c] = "*"
    print(f"{key}  [{lo:.4g} .. {hi:.4g}]  steps {xs[0]}..{xs[-1]}")
    for r in rows:
        print("".join(r))


def plot_curve(recs: list[dict], keys: list[str], out: str | None) -> None:
    series = {}
    for k in keys:
        pts = [(r["step"], r[k]) for r in recs if k in r]
        if not pts:
            print(f"key {k!r} not found in log")
            continue
        series[k] = pts
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for k, pts in series.items():
            xs, ys = zip(*pts)
            plt.plot(xs, ys, label=k)
        plt.xlabel("step")
        plt.legend()
        plt.grid(alpha=0.3)
        out = out or "curves.png"
        plt.savefig(out, dpi=120, bbox_inches="tight")
        print(f"wrote {out}")
    except ImportError:
        for k, pts in series.items():
            xs, ys = zip(*pts)
            _ascii_plot(list(xs), list(ys), k)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("task", choices=("cal_train_time", "plot_curve"))
    p.add_argument("jsonl")
    p.add_argument("--keys", nargs="+", default=["loss_total"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    recs = load(args.jsonl)
    if args.task == "cal_train_time":
        cal_train_time(recs)
    else:
        plot_curve(recs, args.keys, args.out)


if __name__ == "__main__":
    main()
