"""The port's data converters and ``create_data`` against the JAX
package's tools, on seeded raw data: every output file byte for byte and
every info pickle field by field. No model runs; both sides are numpy.

- ``Waymo2KITTI`` on two segments of ``data/format_writers.py
  write_waymo_tfrecords``: a TOP lidar with its beam list, two returns and
  per-pixel poses, and two short-range lidars on the min / max
  inclination path with their own extrinsics (one turned by 90 degrees),
  labels with no points (dropped) and a sign (never emitted). The port's
  tfrecord writer (numpy CRC-32C) writes JAX's writer's bytes.
- ``create_data gt_db`` on the converted set and ``create_data kitti`` on
  a raw KITTI layout: the dbinfos and every object ``.bin`` equal JAX's.
- ``create_nuscenes_infos`` on JAX's own table set
  (``tests/test_nuscenes_converter.py _write_tables``) and on
  ``write_nuscenes_tables`` (10-sweep chains, an annotation with a NaN
  velocity): the info pkls equal JAX's.
- The converter CLIs in a process that cannot import ``jax``, ``flax`` or
  ``sst_tpu``.
"""

from __future__ import annotations

import glob
import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from sst_tpu_torch.data import format_writers as fw
from test_torch_waymo_bin import ROOT
from torch_threads import torch_threads_per_worker  # noqa: F401


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def same(a, b, path="obj"):
    """Nested dicts, lists and arrays equal exactly (dtypes too; NaN equal
    to NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and (a == b or a != a and b != b), path


def same_files(dir_a, dir_b, pattern):
    names = sorted(os.path.relpath(p, dir_a)
                   for p in glob.glob(os.path.join(dir_a, pattern)))
    assert names and names == sorted(
        os.path.relpath(p, dir_b)
        for p in glob.glob(os.path.join(dir_b, pattern)))
    for n in names:
        with open(os.path.join(dir_a, n), "rb") as fa, \
                open(os.path.join(dir_b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return len(names)


@pytest.fixture(scope="module")
def waymo_world(tmp_path_factory):
    """Two raw segments of two frames, converted by JAX's tool and by the
    port's."""
    from sst_tpu_torch.tools.data_converter import waymo_converter as tw
    from tools.data_converter import waymo_converter as jw

    root = str(tmp_path_factory.mktemp("waymo_raw"))
    raw = os.path.join(root, "raw")
    paths = fw.write_waymo_tfrecords(
        raw, seed=5, segments=2, frames=2, points=1500, boxes=8,
        top_shape=(16, 96), side_shape=(10, 40), sides=2, no_label_zone=16)
    out = {}
    for tag, mod in (("jax", jw), ("port", tw)):
        save = os.path.join(root, tag)
        mod.Waymo2KITTI(raw, save, prefix=0, split="train").convert()
        out[tag] = save
    return dict(root=root, raw=raw, paths=paths, **out)


def test_waymo_converter_equals_jax(waymo_world):
    from sst_tpu.data import waymo_proto as jwp
    from sst_tpu_torch.data import waymo_proto as twp

    j, t = waymo_world["jax"], waymo_world["port"]
    n = sum(same_files(j, t, f"{sub}/*") for sub in
            ("velodyne", "pose", "calib", "label_all"))
    assert n == 4 * 4
    same_files(j, t, "gt.bin")
    for name in ("waymo_infos_train.pkl", "idx2timestamp.pkl",
                 "idx2contextname.pkl"):
        same(_load(os.path.join(t, name)), _load(os.path.join(j, name)),
             name)
    infos = _load(os.path.join(t, "waymo_infos_train.pkl"))
    frame = twp.parse_frame(next(twp.read_tfrecord(waymo_world["paths"][0])))
    # the lidars, the min / max path and the labels the world holds
    assert sorted(frame["lasers"]) == [1, 2, 3]
    assert len(frame["laser_calibrations"][2]["beam_inclinations"]) == 0
    assert frame["lasers"][1][0]["pose"].shape == (16, 96, 6)
    kept = [o for o in frame["laser_labels"]
            if o["type"] != 3 and o["num_lidar_points_in_box"] > 0]
    assert 0 < len(kept) < len(frame["laser_labels"]) - 1
    assert len(infos[0]["annos"]["name"]) == len(kept)
    pc = np.fromfile(os.path.join(t, "velodyne", "0000000.bin"),
                     np.float32).reshape(-1, 6)
    assert len(pc) == 1500
    # the port's tfrecord writer frames records as JAX's (one record above
    # the CRC's many-lane size)
    recs = [np.random.RandomState(0).bytes(300_000), b"", b"short"]
    for tag, mod in (("jax", jwp), ("port", twp)):
        mod.write_tfrecord(os.path.join(waymo_world["root"], f"{tag}.rec"),
                           recs)
    with open(os.path.join(waymo_world["root"], "jax.rec"), "rb") as a, \
            open(os.path.join(waymo_world["root"], "port.rec"), "rb") as b:
        assert a.read() == b.read()


def _kitti_raw(root):
    """A raw KITTI layout: two frames' label_2 and calib text (one label a
    DontCare) and the split file."""
    rng = np.random.RandomState(3)
    for sub in ("ImageSets", "training/calib", "training/label_2"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    ids = ["000000", "000007"]
    with open(os.path.join(root, "ImageSets", "train.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    for sid in ids:
        with open(os.path.join(root, "training/calib", f"{sid}.txt"),
                  "w") as f:
            for k, n in (("P0", 12), ("P1", 12), ("P2", 12), ("P3", 12),
                         ("R0_rect", 9), ("Tr_velo_to_cam", 12),
                         ("Tr_imu_to_velo", 12)):
                f.write(f"{k}: " + " ".join(
                    f"{v:.12e}" for v in rng.randn(n)) + "\n")
        rows = []
        for name in ("Car", "Pedestrian", "DontCare", "Cyclist"):
            v = rng.uniform(0, 50, 15)
            rows.append(f"{name} {v[0] / 50:.2f} {int(v[1]) % 3} "
                        + " ".join(f"{x:.2f}" for x in v[3:15]))
        with open(os.path.join(root, "training/label_2", f"{sid}.txt"),
                  "w") as f:
            f.write("\n".join(rows) + "\n")


def test_create_data_gt_db_and_kitti_equal_jax(waymo_world, tmp_path,
                                               monkeypatch):
    from sst_tpu_torch.tools import create_data as tcd
    from tools import create_data as jcd

    save = waymo_world["port"]
    dbs = {}
    for tag, mod in (("jax", jcd), ("port", tcd)):
        out = str(tmp_path / tag)
        mod.create_gt_database(SimpleNamespace(
            dataset="WaymoDataset", data_root=save,
            info_path=os.path.join(save, "waymo_infos_train.pkl"),
            out_dir=out, min_points=5))
        dbs[tag] = _load(os.path.join(out, "waymodataset_dbinfos_train.pkl"))
    same(dbs["port"], dbs["jax"], "dbinfos")
    assert sum(len(v) for v in dbs["port"].values()) >= 4
    same_files(str(tmp_path / "jax"), str(tmp_path / "port"),
               "waymodataset_gt_database/*.bin")
    # the port's sampler draws from the database it wrote
    from sst_tpu_torch.data.dbsampler import DataBaseSampler

    sampler = DataBaseSampler(
        str(tmp_path / "port" / "waymodataset_dbinfos_train.pkl"),
        str(tmp_path / "port"), sample_groups=dict(Car=4, Pedestrian=4,
                                                   Cyclist=4))
    got = sampler.sample_all(np.zeros((0, 7), np.float32), [])
    assert got is not None and len(got["points"])

    raw = str(tmp_path / "kitti_raw")
    _kitti_raw(raw)
    for tag, mod in (("jax", jcd), ("port", tcd)):
        mod.create_kitti_infos(SimpleNamespace(
            data_root=raw, out_dir=str(tmp_path / f"kitti_{tag}"),
            split="train"))
    same(_load(str(tmp_path / "kitti_port" / "kitti_infos_train.pkl")),
         _load(str(tmp_path / "kitti_jax" / "kitti_infos_train.pkl")),
         "kitti")


@pytest.mark.parametrize("tables", ["jax_test", "writer"])
def test_nuscenes_infos_equal_jax(tables, tmp_path):
    from sst_tpu_torch.tools.data_converter import nuscenes_converter as tn
    from test_nuscenes_converter import _write_tables
    from tools.data_converter import nuscenes_converter as jn

    root = str(tmp_path / "nusc")
    if tables == "jax_test":
        _write_tables(root)
        kw = dict(version="v1.0-trainval", max_sweeps=10, val_ratio=0.5)
    else:
        w = fw.write_nuscenes_tables(root, seed=4, scenes=2, keyframes=3,
                                     points=64, objects=12)
        kw = dict(version=w["version"], max_sweeps=10,
                  val_scene_names=w["val_scenes"])
    for tag, mod in (("jax", jn), ("port", tn)):
        mod.create_nuscenes_infos(root, info_prefix=tag,
                                  out_dir=str(tmp_path), **kw)
    n_nan = 0
    for split in ("train", "val"):
        got = _load(str(tmp_path / f"port_infos_{split}.pkl"))
        same(got, _load(str(tmp_path / f"jax_infos_{split}.pkl")), split)
        n_nan += sum(int(np.isnan(i["gt_velocity"]).any(1).sum())
                     for i in got["infos"])
    if tables == "writer":
        infos = _load(str(tmp_path / "port_infos_train.pkl"))["infos"]
        assert [len(i["sweeps"]) for i in infos] == [10, 10, 10]
        assert n_nan == 2  # one isolated annotation per scene


_BLOCKED_RUN = r"""
import sys


class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "sst_tpu"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, _Blocked())
from sst_tpu_torch.tools import create_data

raw, save, nusc = sys.argv[1:4]
conv = create_data.main(["waymo", "--load-dir", raw, "--save-dir", save])
create_data.main(["gt_db", "--data-root", save, "--info-path",
                  save + "/waymo_infos_train.pkl", "--out-dir", save])
paths = create_data.main(["nuscenes", "--root-path", nusc, "--version",
                          "v1.0-trainval", "--val-ratio", "0.5"])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "sst_tpu"))
print(repr((loaded, len(conv.infos), len(paths))))
"""


def test_converter_clis_run_without_jax(waymo_world, tmp_path):
    from test_nuscenes_converter import _write_tables

    nusc = str(tmp_path / "nusc")
    _write_tables(nusc)
    save = str(tmp_path / "save")
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, waymo_world["raw"], save, nusc],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded, frames, n_paths = eval(res.stdout.strip().splitlines()[-1])
    assert loaded == [] and frames == 4 and n_paths == 2
    same_files(waymo_world["jax"], save, "velodyne/*")
    assert os.path.exists(os.path.join(save, "waymodataset_dbinfos_train.pkl"))
