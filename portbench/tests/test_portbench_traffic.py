"""The traffic generator repeats bit for bit for a seed, differs across
seeds, and gives every seed the same work."""

import json

import numpy as np
import pytest

from portbench import harness
from portbench.traffic import generator

TINY = {"frames": "labelled_sweep", "pool": 4, "batch": 1,
        "points_min": 1500, "points_max": 2048, "extra_feats": 2,
        "half_range": 6.3, "num_objects": 6}


@pytest.mark.parametrize("frames", ["sweep", "labelled_sweep"])
def test_pool_repeats_for_a_seed_and_differs_across_seeds(frames):
    t = dict(TINY, frames=frames)
    a = generator.make_pool(t, 2**31 + 5)
    b = generator.make_pool(t, 2**31 + 5)
    c = generator.make_pool(t, 2**31 + 6)
    for fa, fb in zip(a, b):
        for k in fa:
            assert fa[k].tobytes() == fb[k].tobytes()
    assert any(fa["points"].shape != fc["points"].shape
               or not np.array_equal(fa["points"], fc["points"])
               for fa, fc in zip(a, c))


def test_every_seed_gets_the_same_sizes_in_another_order():
    t = dict(TINY, pool=16, points_min=150000, points_max=196608)
    s1, s2 = generator.pool_sizes(t, 1), generator.pool_sizes(t, 2)
    assert sorted(s1) == sorted(s2)
    assert s1 != s2
    assert min(s1) == 150000 and max(s1) == 196608


def test_the_cells_traffic_files_name_a_loop_and_frames():
    for name in ("predict_b4", "train_b1"):
        t = json.loads((harness.HERE / "traffic" / f"{name}.json")
                       .read_text())
        assert t["loop"] in ("predict", "train")
        assert t["frames"] in ("sweep", "labelled_sweep")


def test_labelled_boxes_own_their_points():
    f = generator.make_pool(TINY, 3)[0]
    assert f["gt_valid"].any()
    inside = 0
    for box in f["gt_boxes"][f["gt_valid"]]:
        d = f["points"][:, :2] - box[:2]
        inside += int((np.hypot(d[:, 0], d[:, 1]) < max(box[3:5])).sum())
    assert inside >= 8 * int(f["gt_valid"].sum())
