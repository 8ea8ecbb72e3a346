"""A Waymo info pkl cut at sequence boundaries into shards for parallel
sequential evaluation, each shard holding whole sequences (counterpart of
the JAX package's ``tools/fsdpp/create_segment_break.py``). Frame ids
follow ``image_idx = seq * 1000 + frame``, so a sequence starts where
``image_idx % 1000 == 0``. Prints the breaks as JSON; ``--out`` pickles
them.

    python -m sst_tpu_torch.tools.fsdpp.create_segment_break \\
        --info data/waymo/kitti_format/waymo_infos_val.pkl --num-shards 8
"""

from __future__ import annotations

import argparse
import json
import pickle


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--info", required=True)
    ap.add_argument("--num-shards", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    with open(args.info, "rb") as f:
        infos = pickle.load(f)

    starts = [i for i, info in enumerate(infos)
              if info["image"]["image_idx"] % 1000 == 0]
    if not starts or starts[0] != 0:
        raise ValueError("the infos must begin at a sequence start")
    per = max(1, -(-len(starts) // args.num_shards))
    breaks = [starts[s] for s in range(0, len(starts), per)]
    breaks.append(len(infos))

    out = dict(num_frames=len(infos), num_sequences=len(starts),
               breaks=breaks)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(breaks, f)
    return out


if __name__ == "__main__":
    main()
