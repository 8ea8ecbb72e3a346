"""BEV PNGs (and meshlab OBJ dumps) of a dataset's samples (counterpart of
the JAX package's ``tools/misc/browse_dataset.py``, after the reference's,
whose open3d window becomes headless files).

    python -m sst_tpu_torch.tools.misc.browse_dataset CONFIG \\
        --output-dir work_dirs/browse [--synthetic] [--num 10] [--objs]

The dataset set-up reads the model's point-cloud range, so the model is
built from the config on the ``meta`` device: shapes only, no storage and
no card. The PNGs need matplotlib.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Browse a dataset as BEV PNGs")
    p.add_argument("config")
    p.add_argument("--output-dir", default="work_dirs/browse")
    p.add_argument("--num", type=int, default=10)
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (no real data needed)")
    p.add_argument("--objs", action="store_true",
                   help="also write meshlab OBJ dumps per sample")
    args = p.parse_args(argv)

    from sst_tpu_torch.train.data_setup import build_train_dataset
    from sst_tpu_torch.utils.builders import build_model_from_cfg
    from sst_tpu_torch.utils.config import load_config
    from sst_tpu_torch.utils.visualizer import show_bev, show_result

    cfg = load_config(args.config)
    model = build_model_from_cfg(cfg, train=False, device="meta")
    dataset, _, kind, _ = build_train_dataset(cfg, model,
                                              synthetic=args.synthetic)
    os.makedirs(args.output_dir, exist_ok=True)
    n = min(args.num, len(dataset))
    for i in range(n):
        s = dataset[i]
        pts = np.asarray(s["points"])
        valid = np.asarray(s.get("points_valid", np.ones(len(pts), bool)))
        gt = np.asarray(s.get("gt_boxes", np.zeros((0, 7))))
        gtv = np.asarray(s.get("gt_valid", np.ones(len(gt), bool)))
        show_bev(pts[valid], gt_boxes=gt[gtv],
                 out_file=os.path.join(args.output_dir, f"sample_{i:04d}.png"))
        if args.objs:
            show_result(pts[valid], gt[gtv], None, args.output_dir,
                        f"sample_{i:04d}")
    print(f"wrote {n} {kind} samples to {args.output_dir}")
    return n


if __name__ == "__main__":
    main()
