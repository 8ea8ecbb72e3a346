"""CTRL offline step 1: a tracker's Objects bin → tracklets (counterpart
of the JAX package's ``tools/ctrl/generate_track_input.py``).

The bin's objects (with ids) are grouped into ``LiDARTracklet``s, moved
into the world frame by each frame's ego pose, and pickled as a list of
the port's class (``data/tracklet_dataset.py`` reads them).

    python -m sst_tpu_torch.tools.ctrl.generate_track_input \\
        --bin track_results.bin --poses poses_by_context.pkl \\
        --out tracklets.pkl [--min-len 2] [--type 1]
"""

from __future__ import annotations

import argparse
import pickle


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bin", required=True)
    ap.add_argument("--poses", default=None,
                    help="pkl: {context_name: {timestamp: 4x4 pose}}")
    ap.add_argument("--out", required=True)
    ap.add_argument("--min-len", type=int, default=2)
    ap.add_argument("--type", type=int, default=None,
                    help="keep only this WOD type (1 veh / 2 ped / 4 cyc)")
    args = ap.parse_args(argv)

    from sst_tpu_torch.core.tracklet import LiDARTracklet

    trks = LiDARTracklet.from_waymo_bin(args.bin, min_len=args.min_len)
    if args.type is not None:
        trks = [t for t in trks if t.type_id == args.type]
    if args.poses:
        with open(args.poses, "rb") as f:
            poses = pickle.load(f)
        trks = [t.to_world(poses[t.context_name]) for t in trks
                if t.context_name in poses]
    with open(args.out, "wb") as f:
        pickle.dump(trks, f)
    print(f"wrote {len(trks)} tracklets to {args.out}")


if __name__ == "__main__":
    main()
