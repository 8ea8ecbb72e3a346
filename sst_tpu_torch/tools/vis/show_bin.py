"""Render a Waymo Objects bin as BEV PNGs (counterpart of the JAX
package's ``tools/vis/show_bin.py``, after the reference's).

Decodes prediction (and optionally gt) bins with ``core/waymo_bin.py``
and draws every Nth frame; the reference's interactive Visualizer2D
becomes headless matplotlib output (matplotlib is needed). Point clouds
are optional: where an idx2timestamp map and a kitti-format velodyne
directory are at hand the cloud is drawn underneath, otherwise the frames
hold boxes alone.

Usage:
  python -m sst_tpu_torch.tools.vis.show_bin --bin-path preds.bin \\
      [--gt-bin-path gt.bin] [--save-folder vis_out] [--interval 198] \\
      [--data-root data/waymo/kitti_format]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def _load_points(data_root, idx2ts, ts, split):
    if not (data_root and idx2ts):
        return None
    idx = idx2ts.get(ts)
    if idx is None:
        return None
    prefix = "training" if split == "training" else "testing"
    path = os.path.join(data_root, prefix, "velodyne", f"{idx}.bin")
    if not os.path.exists(path):
        return None
    return np.fromfile(path, np.float32).reshape(-1, 6)[:, :3]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bin-path", required=True)
    p.add_argument("--gt-bin-path", default="")
    p.add_argument("--save-folder", default="")
    p.add_argument("--suffix", default="")
    p.add_argument("--split", default="training")
    p.add_argument("--interval", type=int, default=198)
    p.add_argument("--no-gt", action="store_true")
    p.add_argument("--data-root", default="",
                   help="kitti_format root holding velodyne/ + idx2timestamp.pkl")
    args = p.parse_args(argv)

    from sst_tpu_torch.core.waymo_bin import read_bin_as_frames
    from sst_tpu_torch.utils.visualizer import show_bev

    bin_path = os.path.abspath(args.bin_path)
    save_folder = args.save_folder or os.path.join(
        os.path.dirname(bin_path), "vis_folder")
    os.makedirs(save_folder, exist_ok=True)

    preds = read_bin_as_frames(bin_path)
    gts = None
    if args.gt_bin_path and not args.no_gt:
        gts = read_bin_as_frames(args.gt_bin_path)

    idx2ts = None
    if args.data_root:
        m = os.path.join(args.data_root, "idx2timestamp.pkl")
        if os.path.exists(m):
            with open(m, "rb") as f:
                ts2idx = pickle.load(f)
            # file maps idx->timestamp in the converter's output; invert
            first = next(iter(ts2idx.items()), None)
            if first and isinstance(first[1], (int, np.integer)):
                idx2ts = {v: k for k, v in ts2idx.items()}
            else:
                idx2ts = ts2idx

    keys = sorted((gts or preds).keys())
    written = 0
    for i, key in enumerate(keys):
        if i % args.interval:
            continue
        if key not in preds:
            continue
        pred = preds[key]
        gt = gts.get(key) if gts else None
        ts = key[1]
        pts = _load_points(args.data_root, idx2ts, ts, args.split)
        suffix = f"_{args.suffix}" if args.suffix else ""
        show_bev(
            points=pts,
            gt_boxes=gt["boxes"] if gt is not None else None,
            pred_boxes=pred["boxes"], pred_scores=pred["scores"],
            out_file=os.path.join(save_folder, f"{ts}{suffix}.png"),
        )
        written += 1
    print(f"wrote {written} frames to {save_folder}")
    return written


if __name__ == "__main__":
    main()
