"""Merge A/B result files and take matched-step quality deltas
(counterpart of the JAX package's ``tools/ab_merge.py``; it reads the
files of either package's ``ab_dense_vs_sparse`` and writes the same keys).

``ab_dense_vs_sparse`` writes one JSON per invocation, often one build per
file. For every ``--pair a:b`` this averages each arm's trajectory over its
seeds per step, intersects the two arms' evaluated steps, and emits
``matched_step_delta_a_minus_b`` per metric at every common step.

    python -m sst_tpu_torch.tools.ab_merge --out merged.json \\
        --pair dense:sparse --pair dense:dense_f32 a.json b.json c.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np

TRAJ_KEYS = ("Overall/L1 mAP", "Overall/L1 mAPH", "Overall/L2 mAPH")
AP_KEYS = ("Overall/L1 mAP", "Overall/L1 mAPH",
           "Overall/L2 mAP", "Overall/L2 mAPH")


def mean_trajectory(build: dict) -> dict:
    """{step: {"n_seeds", metric: mean over seeds}}."""
    per_step = {}
    for run in build["runs"]:
        for step, metrics in run["trajectory"]:
            per_step.setdefault(int(step), []).append(metrics)
    return {step: {"n_seeds": len(ms),
                   **{k: round(float(np.mean([m[k] for m in ms])), 4)
                      for k in TRAJ_KEYS if all(k in m for m in ms)}}
            for step, ms in sorted(per_step.items())}


def merge(inputs, pairs) -> dict:
    builds = {}
    merged = {"sources": {}}
    for path in inputs:
        with open(path) as f:
            d = json.load(f)
        merged["sources"][path] = d.get("args", {})
        for k, v in d.items():
            if isinstance(v, dict) and "runs" in v:
                if k in builds:  # one build in two files: the seeds pooled
                    seen = {r["seed"] for r in builds[k]["runs"]}
                    builds[k]["runs"] += [r for r in v["runs"]
                                          if r["seed"] not in seen]
                else:
                    builds[k] = {"runs": list(v["runs"])}

    for name, b in builds.items():
        runs = b["runs"]
        b["seeds"] = sorted(r["seed"] for r in runs)
        b["final_step"] = max(s for r in runs for s, _ in r["trajectory"])
        b["ap"] = {k: round(float(np.mean([r["ap"][k] for r in runs])), 4)
                   for k in AP_KEYS}
        b["ap_std"] = {k: round(float(np.std([r["ap"][k] for r in runs])), 4)
                       for k in AP_KEYS}
        b["trajectory_mean"] = mean_trajectory(b)
        merged[name] = b

    for pair in pairs:
        a, bname = pair.split(":")
        if a not in builds or bname not in builds:
            merged[f"matched_step_delta_{a}_minus_{bname}"] = None
            continue
        ta = merged[a]["trajectory_mean"]
        tb = merged[bname]["trajectory_mean"]
        common = sorted(set(ta) & set(tb))
        merged[f"matched_step_delta_{a}_minus_{bname}"] = {
            str(s): {k: round(ta[s][k] - tb[s][k], 4)
                     for k in TRAJ_KEYS if k in ta[s] and k in tb[s]}
            for s in common
        } or None
        merged[f"matched_steps_{a}_vs_{bname}"] = common
    return merged


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("inputs", nargs="+")
    p.add_argument("--pair", action="append", default=[],
                   help="a:b -> emit matched_step_delta_a_minus_b")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    merged = merge(args.inputs, args.pair)
    with open(args.out, "w") as f:
        json.dump(merged, f, indent=1)
    print("wrote", args.out)
    for k, v in merged.items():
        if k.startswith("matched_step_delta"):
            print(k, json.dumps(v))
    return merged


if __name__ == "__main__":
    main()
