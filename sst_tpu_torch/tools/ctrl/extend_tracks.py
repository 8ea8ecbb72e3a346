"""Track extension (counterpart of the JAX package's
``tools/ctrl/extend_tracks.py``): each track extrapolated backward (or,
for long tracks with ``--extend-all``, to every frame of its sequence) at
constant velocity in the world frame, the added boxes' scores decayed
geometrically; recovers the early frames a tracker misses before CTRL
refines them (``LiDARTracklet.extend`` / ``extend_all``).

    python -m sst_tpu_torch.tools.ctrl.extend_tracks --bin tracks.bin \\
        --kitti-root data/waymo/kitti_format \\
        [--extend-length 10 --min-length 5 --score-multiplier 0.9 \\
         --velo-window 10 --extend-all --min-length-extend-all 40]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bin", required=True)
    p.add_argument("--kitti-root", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--extend-length", type=int, default=10)
    p.add_argument("--min-length", type=int, default=5)
    p.add_argument("--score-multiplier", type=float, default=0.9)
    p.add_argument("--velo-window", type=int, default=10)
    p.add_argument("--extend-all", action="store_true")
    p.add_argument("--min-length-extend-all", type=int, default=40)
    args = p.parse_args(argv)

    from sst_tpu_torch.core.tracklet import tracklets_to_bin
    from sst_tpu_torch.tools.ctrl.utils import (
        generate_tracklets,
        load_pose_maps,
    )

    ts2pose, context2ts = load_pose_maps(args.kitti_root)
    tracklets = generate_tracklets(args.bin)
    print(f"{len(tracklets)} tracks loaded")

    out = []
    n_added = 0
    for trk in tracklets:
        world = trk.to_world(ts2pose)
        full_ts = context2ts[trk.context_name]
        before = len(world)
        if args.extend_all and len(world) > args.min_length_extend_all:
            world = world.extend_all(
                full_ts, args.min_length_extend_all,
                args.score_multiplier, args.velo_window,
            )
        else:
            world = world.extend(
                args.extend_length, "backward", full_ts, args.min_length,
                args.score_multiplier, args.velo_window,
            )
        n_added += len(world) - before
        out.append(world.to_ego(ts2pose))

    save = args.out or args.bin.replace(".bin", "_extended.bin")
    tracklets_to_bin(out, save)
    print(f"extended {len(out)} tracks by {n_added} boxes -> {save}")


if __name__ == "__main__":
    main()
