"""The one generator of the benchmark's traffic: a pool of synthetic
Waymo-like lidar sweeps made from ``--seed``, as a traffic file's
parameters ask.

The frame functions are frozen copies of the port's
``flagship.synthetic_waymo_batch`` and ``flagship.synthetic_labeled_batch``
(one frame each, numpy only), so a later change to the port's generators
moves no cell's inputs. A traffic file (``portbench/traffic/<name>.json``)
names its ``frames`` kind and the pool's parameters:

  frames        "sweep" (points only) or "labelled_sweep" (gt boxes own
                their points)
  pool          frames in the pool
  points_min, points_max
                returns per frame: the pool holds ``pool`` sizes evenly
                spaced over [points_min, points_max], in an order drawn
                from the seed, so every seed gives the same work
  extra_feats   channels after x, y, z (uniform in [0, 1))
  half_range    the frame's half extent in x and y, in metres
  num_objects   boxes per labelled frame
"""

from __future__ import annotations

import numpy as np

# (l_lo, l_hi, w_lo, w_hi, h_lo, h_hi): the Waymo anchors' size priors
CLASS_SIZE_PRIORS = (
    (3.8, 5.5, 1.7, 2.2, 1.5, 2.0),   # Vehicle
    (0.6, 1.0, 0.6, 1.0, 1.6, 1.9),   # Pedestrian
    (1.6, 2.0, 0.6, 0.9, 1.5, 1.9),   # Cyclist
)


def frame_seed(seed: int, index: int) -> int:
    """A 32-bit numpy seed for frame ``index`` of run seed ``seed`` (any
    non-negative integer, also past 32 bits)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def pool_sizes(traffic: dict, seed: int) -> list[int]:
    """The returns of each pool frame: the same evenly spaced sizes for
    every seed, in an order drawn from the seed."""
    sizes = np.linspace(traffic["points_min"], traffic["points_max"],
                        traffic["pool"]).round().astype(np.int64)
    order = np.random.RandomState(frame_seed(seed, 2**20)).permutation(
        traffic["pool"])
    return [int(s) for s in sizes[order]]


def sweep(num_points: int, seed: int, num_extra_feats: int,
          pcr_half: float) -> dict:
    """One Waymo-like sweep: ground rings with a radial density falloff
    and clustered vertical structures (``synthetic_waymo_batch`` at batch
    1). Returns points [N, 3 + extra] float32, and 64 random boxes."""
    rng = np.random.RandomState(seed)
    batch_size, p = 1, num_points
    n_beams = 64
    beam = rng.randint(0, n_beams, (batch_size, p))
    elev = -np.radians(1.0 + 17.0 * (beam + 0.5) / n_beams)
    ring_r = np.clip(2.1 / np.tan(-elev), 0.0, 78.0)
    az = rng.uniform(-np.pi, np.pi, (batch_size, p))
    rr = ring_r * (1 + rng.randn(batch_size, p) * 0.01)
    x = (rr * np.cos(az)).astype(np.float32)
    y = (rr * np.sin(az)).astype(np.float32)
    z_ground = (rng.randn(batch_size, p) * 0.05 - 0.8).astype(np.float32)
    is_ground = rng.rand(batch_size, p) < 0.7
    n_struct = 1024
    cx = rng.uniform(-pcr_half, pcr_half, (batch_size, n_struct))
    cy = rng.uniform(-pcr_half, pcr_half, (batch_size, n_struct))
    which = rng.randint(0, n_struct, (batch_size, p))
    xs = np.take_along_axis(cx, which, 1) + rng.randn(batch_size, p) * 0.6
    ys = np.take_along_axis(cy, which, 1) + rng.randn(batch_size, p) * 0.6
    z_struct = rng.uniform(-1.0, 3.0, (batch_size, p)).astype(np.float32)
    x = np.where(is_ground, x, xs.astype(np.float32))
    y = np.where(is_ground, y, ys.astype(np.float32))
    z = np.where(is_ground, z_ground, z_struct).astype(np.float32)
    pts = np.stack([x, y, z], -1)
    if num_extra_feats:
        pts = np.concatenate(
            [pts, rng.rand(batch_size, p, num_extra_feats).astype(np.float32)],
            -1)
    g = 64
    boxes = np.concatenate([
        rng.uniform(-70, 70, (batch_size, g, 2)),
        np.full((batch_size, g, 1), -0.1),
        rng.uniform(0.8, 5.0, (batch_size, g, 3)),
        rng.uniform(-np.pi, np.pi, (batch_size, g, 1)),
    ], -1).astype(np.float32)
    labels = rng.randint(0, 3, (batch_size, g)).astype(np.int32)
    return {"points": pts[0], "gt_boxes": boxes[0], "gt_labels": labels[0],
            "gt_valid": np.ones(g, bool)}


def labelled_sweep(num_points: int, seed: int, num_extra_feats: int,
                   pcr_half: float, num_objects: int) -> dict:
    """A sweep whose gt boxes own their points
    (``synthetic_labeled_batch`` at batch 1): ``num_objects`` boxes with
    the class size priors on a coarse grid each replace a range-scaled
    number of background points by points inside the box, 80% of them on
    its faces; a box with no point budget left is dropped (zeroed,
    ``gt_valid`` False)."""
    base = sweep(num_points, seed, num_extra_feats, pcr_half)
    rng = np.random.RandomState((seed + 70000) % 2**32)
    pts = base["points"].copy()
    g = num_objects
    boxes = np.zeros((g, 7), np.float32)
    labels = rng.randint(0, 3, (1, g)).astype(np.int32)[0]
    gvalid = np.ones(g, bool)
    cells = rng.choice((2 * 24) ** 2, size=g, replace=False)
    cx = (cells % 48 - 24 + rng.uniform(0.25, 0.75, g)) * (pcr_half / 24.4)
    cy = (cells // 48 - 24 + rng.uniform(0.25, 0.75, g)) * (pcr_half / 24.4)
    cursor = 0
    for j in range(g):
        lo_hi = CLASS_SIZE_PRIORS[labels[j]]
        length = rng.uniform(lo_hi[0], lo_hi[1])
        width = rng.uniform(lo_hi[2], lo_hi[3])
        height = rng.uniform(lo_hi[4], lo_hi[5])
        yaw = rng.uniform(-np.pi, np.pi)
        zb = -0.9
        boxes[j] = (cx[j], cy[j], zb, width, length, height, yaw)
        r = float(np.hypot(cx[j], cy[j]))
        budget = 9000.0 * num_points / 196608
        n = int(np.clip(budget * np.sqrt(length * width) / max(r, 5.0), 8,
                        1500))
        n = min(n, num_points - cursor)
        if n <= 0:
            boxes[j, :] = 0
            gvalid[j] = False
            continue
        local = np.stack([
            rng.uniform(-length / 2, length / 2, n),
            rng.uniform(-width / 2, width / 2, n),
            rng.uniform(0, height, n)], -1).astype(np.float32)
        surf = rng.rand(n) < 0.8
        ax = rng.randint(0, 2, n)
        local[surf & (ax == 0), 0] = np.sign(
            local[surf & (ax == 0), 0]) * length / 2
        local[surf & (ax == 1), 1] = np.sign(
            local[surf & (ax == 1), 1]) * width / 2
        c, s = np.cos(yaw), np.sin(yaw)
        sl = slice(cursor, cursor + n)
        pts[sl, 0] = local[:, 0] * c - local[:, 1] * s + cx[j]
        pts[sl, 1] = local[:, 0] * s + local[:, 1] * c + cy[j]
        pts[sl, 2] = local[:, 2] + zb
        cursor += n
    pts = pts[rng.permutation(num_points)]
    return {"points": pts, "gt_boxes": boxes, "gt_labels": labels,
            "gt_valid": gvalid}


def make_pool(traffic: dict, seed: int) -> list[dict]:
    """The traffic's pool of frames for ``seed``, as numpy arrays."""
    out = []
    for i, n in enumerate(pool_sizes(traffic, seed)):
        s = frame_seed(seed, i)
        if traffic["frames"] == "sweep":
            out.append(sweep(n, s, traffic["extra_feats"],
                             traffic["half_range"]))
        elif traffic["frames"] == "labelled_sweep":
            out.append(labelled_sweep(n, s, traffic["extra_feats"],
                                      traffic["half_range"],
                                      traffic["num_objects"]))
        else:
            raise ValueError(f"unknown frames kind {traffic['frames']!r}")
    return out
