"""The two readings that each compared number's limit is set from, on the
card, at a cell's own sizes, for many seeds in one process:

  * the lower reading: the port's timed path (the cell's loop code) held
    against the plain reference;
  * the upper reading: the control, the reference itself computed with
    fp8 products (``ref/precision.py``), in the port's place.

    python3 portbench/readings.py --workload <cell> --seeds 100 112

prints one JSON line per seed and per side. The benchmark's own runs do not
run this."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs=2, required=True,
                    help="first and one past the last seed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell(args.workload)
    device = torch.device(args.device)
    for seed in range(*args.seeds):
        for side, nums in cell.config_module.readings(cell, seed, device):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
