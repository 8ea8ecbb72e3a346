"""Several Waymo Objects bins merged into one, frame by frame (e.g. CTRL's
per-class outputs; counterpart of the JAX package's
``tools/ctrl/merge_bins.py``).

    python -m sst_tpu_torch.tools.ctrl.merge_bins --bins a.bin b.bin \\
        --out merged.bin
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bins", nargs="+", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if os.path.exists(args.out):
        raise FileExistsError(f"{args.out} already exists")

    from sst_tpu_torch.core.waymo_bin import read_bin_as_frames, write_waymo_bin

    merged: dict = {}
    for path in args.bins:
        for (cx, ts), fr in read_bin_as_frames(path).items():
            if (cx, ts) in merged:
                m = merged[(cx, ts)]
                m["boxes"] = np.concatenate([m["boxes"], fr["boxes"]])
                m["scores"] = np.concatenate([m["scores"], fr["scores"]])
                m["labels"] = np.concatenate([m["labels"], fr["labels"]])
                m["obj_ids"] = m["obj_ids"] + fr["obj_ids"]
            else:
                merged[(cx, ts)] = dict(fr)

    frames = [
        dict(boxes=fr["boxes"], scores=fr["scores"], labels=fr["labels"],
             obj_ids=fr["obj_ids"], context_name=cx, timestamp_micros=ts)
        for (cx, ts), fr in merged.items()
    ]
    write_waymo_bin(args.out, frames)
    n = sum(len(f["boxes"]) for f in frames)
    print(f"merged {len(args.bins)} bins: {n} objects -> {args.out}")


if __name__ == "__main__":
    main()
