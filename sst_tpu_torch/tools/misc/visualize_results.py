"""BEV PNGs and meshlab OBJ dumps of a results pickle from ``tools.test
--out`` (counterpart of the JAX package's
``tools/misc/visualize_results.py``, after the reference's, whose
``dataset.show()`` becomes headless files).

    python -m sst_tpu_torch.tools.misc.visualize_results CONFIG \\
        --result preds.pkl --show-dir work_dirs/vis [--synthetic] \\
        [--score-thr 0.3] [--no-png]

The dataset set-up reads the model's point-cloud range, so the model is
built from the config on the ``meta`` device: shapes only, no storage and
no card. The PNGs need matplotlib; ``--no-png`` writes the OBJ dumps alone.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="visualize detection results")
    p.add_argument("config")
    p.add_argument("--result", required=True, help="results pkl from test.py")
    p.add_argument("--show-dir", required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--no-png", action="store_true",
                   help="OBJ dumps only (no matplotlib needed)")
    args = p.parse_args(argv)
    if not args.result.endswith((".pkl", ".pickle")):
        raise ValueError("The results file must be a pkl file.")

    from sst_tpu_torch.train.data_setup import build_train_dataset
    from sst_tpu_torch.utils.builders import build_model_from_cfg
    from sst_tpu_torch.utils.config import load_config
    from sst_tpu_torch.utils.visualizer import show_result

    cfg = load_config(args.config)
    model = build_model_from_cfg(cfg, train=False, device="meta")
    dataset, _, _, _ = build_train_dataset(cfg, model,
                                           synthetic=args.synthetic)
    with open(args.result, "rb") as f:
        results = pickle.load(f)
    os.makedirs(args.show_dir, exist_ok=True)
    for i, res in enumerate(results):
        if i >= len(dataset):
            break
        s = dataset[i]
        pts = np.asarray(s["points"])
        valid = np.asarray(s.get("points_valid", np.ones(len(pts), bool)))
        gt = np.asarray(s.get("gt_boxes", np.zeros((0, 7))))
        gtv = np.asarray(s.get("gt_valid", np.ones(len(gt), bool)))
        gt = gt[gtv][:, :7] if len(gt) else gt.reshape(0, 7)
        boxes = np.asarray(res["boxes"])
        keep = np.asarray(res.get("valid", np.ones(len(boxes), bool)))
        keep = keep & (np.asarray(res.get("scores", np.ones(len(boxes)))) >=
                       args.score_thr)
        show_result(pts[valid], gt, boxes[keep][:, :7], args.show_dir,
                    f"frame_{i:04d}", show=not args.no_png)
    n = min(len(results), len(dataset))
    print(f"wrote {n} frames to {args.show_dir}")
    return n


if __name__ == "__main__":
    main()
