"""Score a prediction feather against a gathered gt feather with the
port's AV2 protocol (``core/eval_argo2.py``; counterpart of the JAX
package's ``tools/argo/eval_feather.py``, after the reference's, which calls
av2.evaluation.detection). Needs pandas and pyarrow.

Usage:
  python -m sst_tpu_torch.tools.argo.eval_feather --pred preds.feather \\
      --gt val_anno.feather
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from sst_tpu_torch.core.eval_argo2 import argo2_eval
from sst_tpu_torch.tools.argo.argo2_converter import LABEL_ATTR, quat_to_yaw


def feather_to_frames(path, scored: bool):
    import pyarrow.feather as feather

    df = feather.read_table(path).to_pandas()
    frames = {}
    for (log, ts), fa in df.groupby(["log_id", "timestamp_ns"]):
        cub = fa.loc[:, list(LABEL_ATTR)].to_numpy(np.float64)
        yaw = quat_to_yaw(cub[:, 6], cub[:, 7], cub[:, 8], cub[:, 9])
        yaw = -yaw - 0.5 * np.pi
        boxes = np.concatenate(
            [cub[:, :2], (cub[:, 2] - cub[:, 5] / 2)[:, None],
             cub[:, [4, 3, 5]], ((yaw + np.pi) % (2 * np.pi) - np.pi)[:, None]],
            axis=1).astype(np.float32)
        fr = dict(
            boxes=boxes,
            labels=np.asarray([c.lower().capitalize()
                               for c in fa["category"]], "<U32"),
        )
        if scored:
            fr["scores"] = fa["score"].to_numpy(np.float32)
        elif "num_interior_pts" in fa:
            fr["num_points"] = fa["num_interior_pts"].to_numpy(np.int32)
        frames[(log, int(ts))] = fr
    return frames


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pred", required=True)
    p.add_argument("--gt", required=True)
    args = p.parse_args(argv)

    preds_by = feather_to_frames(args.pred, scored=True)
    gts_by = feather_to_frames(args.gt, scored=False)
    classes = sorted({str(n) for fr in gts_by.values() for n in fr["labels"]})
    keys = sorted(gts_by)
    empty = dict(boxes=np.zeros((0, 7), np.float32),
                 scores=np.zeros(0, np.float32),
                 labels=np.zeros(0, "<U32"))
    preds, gts = [], []
    for k in keys:
        pr = preds_by.get(k, empty)
        gt = gts_by[k]
        name2id = {n: i for i, n in enumerate(classes)}
        preds.append(dict(boxes=pr["boxes"], scores=pr.get(
            "scores", np.zeros(len(pr["boxes"]), np.float32)),
            labels=np.asarray([name2id.get(str(n), -1)
                               for n in pr["labels"]], np.int32)))
        gts.append(dict(boxes=gt["boxes"],
                        labels=np.asarray([name2id.get(str(n), -1)
                                           for n in gt["labels"]], np.int32),
                        num_points=gt.get("num_points")))
    res = argo2_eval(preds, gts, classes)
    print(json.dumps(res, indent=1, default=float))
    return res


if __name__ == "__main__":
    main()
