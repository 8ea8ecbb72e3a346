"""Concatenate every val segment's annotations.feather into one gt feather
for the CDS evaluator (counterpart of the JAX package's
``tools/argo/gather_argo2_anno_feather.py``). Needs pandas and pyarrow.

Usage:
  python -m sst_tpu_torch.tools.argo.gather_argo2_anno_feather \\
      --root <av2>/sensor --out val_anno.feather [--split val]
"""

from __future__ import annotations

import argparse
import glob
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--split", default="val")
    args = p.parse_args(argv)

    import pandas as pd
    import pyarrow.feather as feather

    seg_paths = sorted(glob.glob(os.path.join(args.root, args.split, "*")))
    parts = []
    for seg in seg_paths:
        path = os.path.join(seg, "annotations.feather")
        if not os.path.exists(path):
            continue
        df = feather.read_table(path).to_pandas()
        df["log_id"] = os.path.basename(seg)
        parts.append(df)
    gts = pd.concat(parts).reset_index(drop=True)
    feather.write_feather(gts, args.out)
    print(f"gathered {len(gts)} annotations from {len(parts)} segments "
          f"-> {args.out}")
    return len(gts)


if __name__ == "__main__":
    main()
