"""The port's Waymo codecs against the JAX package's, on seeded data, no
model: the Objects-bin writer (``core/waymo_bin.py``) gives the same bytes
(an empty frame, yaws at and near +-pi, every class name, object ids), each
package reads the other's bins and tfrecords (``data/waymo_proto.py``),
``tools/create_submission.py`` packs the same bytes, and
``WaymoDataset.format_results`` / ``evaluate`` and the tracklet bin I/O
(``LiDARTracklet.from_waymo_bin``, ``tracklets_to_bin``) equal JAX's. The
floats a bin holds are float32 scores and doubles: every comparison is
exact, except boxes read back as float32 rows (``waymo_box_to_lidar``),
equal to the written rows within 1e-5 m (2e-6 rad)."""

from __future__ import annotations

import importlib.util
import math
import os
import sys

import numpy as np
import pytest

from sst_tpu.core import tracklet as jtrk
from sst_tpu.core import waymo_bin as jwb
from sst_tpu.data import datasets as jds
from sst_tpu.data import waymo_proto as jwp
from sst_tpu_torch.core import tracklet as ttrk
from sst_tpu_torch.core import waymo_bin as twb
from sst_tpu_torch.data import datasets as tds
from sst_tpu_torch.data import format_writers as fw
from sst_tpu_torch.data import waymo_proto as twp
from sst_tpu_torch.tools import create_submission as tsub
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("Car", "Pedestrian", "Cyclist", "Sign", "Unknown")


def load_jax_script(rel: str, monkeypatch):
    """The JAX package's script at ``rel`` (under the repository root),
    imported by file path; its directory goes first on ``sys.path`` for
    the test's duration (``tools/ctrl`` scripts import ``utils``, which
    leaves ``sys.modules`` again after the import)."""
    path = os.path.join(ROOT, rel)
    monkeypatch.syspath_prepend(os.path.dirname(path))
    had_utils = "utils" in sys.modules
    name = "_jax_" + rel[:-3].replace("/", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not had_utils:
        sys.modules.pop("utils", None)
    return mod


def run_jax_script(mod, argv, monkeypatch):
    """``mod.main()`` with ``sys.argv`` set to ``argv`` (JAX's scripts read
    it)."""
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    return mod.main()


def seeded_frames(seed: int = 0, n_frames: int = 4) -> list[dict]:
    """Detection frames over every class name, with an empty frame, yaws at
    and near +-pi, one frame carrying object ids."""
    rng = np.random.RandomState(seed)
    frames = []
    for f in range(n_frames):
        n = 0 if f == 1 else int(rng.randint(3, 9))
        boxes = np.concatenate([
            rng.uniform(-70, 70, (n, 2)), rng.uniform(-2, 1, (n, 1)),
            rng.uniform(0.5, 5, (n, 3)), rng.uniform(-math.pi, math.pi,
                                                     (n, 1))], 1)
        if n:
            boxes[:4, 6] = [math.pi, -math.pi, math.pi - 1e-7,
                            -math.pi + 1e-7][:min(n, 4)]
        frames.append(dict(
            boxes=boxes.astype(np.float32),
            scores=rng.rand(n).astype(np.float32),
            labels=np.arange(n) % len(CLASSES),
            context_name=f"ctx-{seed}-{f // 2}",
            timestamp_micros=1_510_000_000_000_000 + f * 100_000,
            **({"obj_ids": [f"id{i}" if i % 3 else "" for i in range(n)]}
               if f == 2 else {})))
    return frames


def test_bin_bytes_equal_jax(tmp_path):
    frames = seeded_frames()
    for names in (CLASSES, ("Car", "Pedestrian", "Cyclist")):
        fr = [dict(f, labels=np.asarray(f["labels"]) % len(names))
              for f in frames]
        a = twb.write_waymo_bin(str(tmp_path / "port.bin"), fr, names)
        b = jwb.write_waymo_bin(str(tmp_path / "jax.bin"), fr, names)
        assert open(a, "rb").read() == open(b, "rb").read()
    for i in range(3):
        args = (frames[0]["boxes"][i], 0.5, CLASSES[i], "c", 7, "x")
        assert twb.encode_object(*args) == jwb.encode_object(*args)
    for yaw in (math.pi, -math.pi, 0.0, 3.0, -1e-9):
        assert twb.lidar_to_waymo_heading(yaw) == \
            jwb.lidar_to_waymo_heading(yaw)


def _same_objects(a: list, b: list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if k == "box":
                assert x[k] == y[k]
            else:
                assert x[k] == y[k], k


def _same_frames(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        for f in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(a[k][f], b[k][f], err_msg=str(k))
        assert a[k]["obj_ids"] == b[k]["obj_ids"]


def test_each_package_reads_the_others_bin(tmp_path):
    frames = seeded_frames(1)
    port = twb.write_waymo_bin(str(tmp_path / "port.bin"), frames, CLASSES)
    jax = jwb.write_waymo_bin(str(tmp_path / "jax.bin"), frames, CLASSES)
    _same_objects(twb.read_waymo_bin(jax), jwb.read_waymo_bin(port))
    _same_frames(twb.read_bin_as_frames(jax), jwb.read_bin_as_frames(port))
    # the rows read back: the written float32 rows, the 3 detection
    # classes kept (Sign and Unknown dropped), the empty frame absent
    got = twb.read_bin_as_frames(port)
    for f in frames:
        keep = np.asarray(f["labels"]) < 3
        key = (f["context_name"], f["timestamp_micros"])
        if not keep.any():
            assert key not in got
            continue
        rows = got[key]["boxes"]
        np.testing.assert_allclose(rows[:, :6], f["boxes"][keep, :6],
                                   atol=1e-5)
        d = (rows[:, 6] - f["boxes"][keep, 6] + np.pi) % (2 * np.pi) - np.pi
        assert np.abs(d).max() < 2e-6
        np.testing.assert_array_equal(got[key]["scores"],
                                      f["scores"][keep])
    for o in twb.read_waymo_bin(port):
        assert twb.waymo_box_to_lidar(o["box"]).tobytes() == \
            jwb.waymo_box_to_lidar(o["box"]).tobytes()


def _frame_records(seed: int) -> list[bytes]:
    rng = np.random.RandomState(seed)
    records = []
    for f in range(3):
        labels = [twp.enc_label(rng.uniform(-9, 9, 7), int(t), f"o{k}",
                                int(rng.randint(0, 99)), difficulty=k % 3,
                                speed=tuple(rng.randn(2)))
                  for k, t in enumerate((1, 2, 4, 3)[: f + 2])]
        calib = twp.enc_laser_calibration(
            1, np.eye(4), rng.uniform(-0.3, 0.1, 4), -0.3, 0.1)
        laser = twp.enc_varint(1, 1) + twp.enc_bytes(2, twp.enc_range_image(
            rng.rand(2, 3, 4), rng.rand(2, 3, 6)))
        pose = np.eye(4)
        pose[:3, 3] = rng.randn(3)
        records.append(twp.enc_frame(f"ctx{seed}", 1000 + f, pose,
                                     twp.enc_bytes(3, calib), [laser],
                                     labels))
    return records


def _same_parsed(a, b, path="frame"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same_parsed(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_parsed(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_tfrecords_read_both_ways(tmp_path):
    """The encoders and the masked-crc32c writer give JAX's bytes; each
    parser reads the other package's file to the same frames."""
    records = _frame_records(2)
    assert twp.enc_label((1, 2, 3, 4, 5, 6, 7), 1, "a", 3) == \
        jwp.enc_label((1, 2, 3, 4, 5, 6, 7), 1, "a", 3)
    tp, jp = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    twp.write_tfrecord(tp, records)
    jwp.write_tfrecord(jp, records)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    got_t = [twp.parse_frame(r) for r in twp.read_tfrecord(jp)]
    got_j = [jwp.parse_frame(r) for r in jwp.read_tfrecord(tp)]
    assert len(got_t) == len(got_j) == 3
    _same_parsed(got_t, got_j)
    assert got_t[2]["laser_labels"][3]["type"] == 3
    assert got_t[0]["lasers"][1][0]["range_image"].shape == (2, 3, 4)


def test_create_submission_bytes_equal_jax(tmp_path, monkeypatch):
    frames = seeded_frames(3)
    bins = [twb.write_waymo_bin(str(tmp_path / f"p{i}.bin"), frames[i::2],
                                CLASSES) for i in range(2)]
    meta = tmp_path / "sub.txt"
    meta.write_text("# submission\nunique_method_name: fsd-port\n"
                    "authors: A. Author\nauthors: B. Author\n"
                    "affiliation: Lab\naccount_name: a@b.c\n"
                    "num_past_frames: 6\nlatency_second: 0.12\n"
                    "sensor_type: LIDAR_ALL\n")
    jsub = load_jax_script("tools/create_submission.py", monkeypatch)
    argv = ["--input-filenames", *bins, "--submission-filename", str(meta),
            "--num-shards", "3", "--output-filename"]
    paths = tsub.main(argv + [str(tmp_path / "port" / "sub")])
    run_jax_script(jsub, argv + [str(tmp_path / "jax" / "sub")],
                   monkeypatch)
    objects = []
    for s, path in enumerate(paths):
        blob = open(path, "rb").read()
        assert blob == open(tmp_path / "jax" / f"sub{s}", "rb").read()
        fields = twb._parse_fields(blob)
        assert [v for f, _, v in fields if f == 3] == [b"A. Author",
                                                       b"B. Author"]
        assert [v for f, _, v in fields if f == 9] == [6]
        (inner,) = [v for f, _, v in fields if f == 11]
        objects += [v for f, w, v in twb._parse_fields(inner)
                    if f == 1 and w == 2]
    payloads = [p for b in bins for p in tsub.read_objects_payload(b)]
    assert sorted(objects) == sorted(payloads)
    assert len(payloads) == sum(len(f["scores"]) for f in frames)


@pytest.fixture(scope="module")
def waymo_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo"))
    return fw.write_waymo_set(root, seed=5, train_sequences=1,
                              val_sequences=2, frames=3, points=512,
                              boxes=6, half=20.0)


def _results(ds, seed):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(len(ds)):
        g = ds.get_sample(i)["gt_boxes"].astype(np.float32)
        keep = rng.rand(len(g)) > 0.3
        b = g[keep] + rng.normal(0, 0.2, (int(keep.sum()), 7)).astype(
            np.float32)
        out.append(dict(boxes_3d=b, scores_3d=rng.rand(len(b)).astype(
            np.float32), labels_3d=rng.randint(0, 3, len(b))))
    out[-1] = dict(boxes_3d=np.zeros((0, 7), np.float32),
                   scores_3d=np.zeros(0, np.float32),
                   labels_3d=np.zeros(0, np.int64))
    return out


def test_waymo_dataset_format_results_and_evaluate(waymo_set, tmp_path):
    """``format_results`` writes JAX's bytes under the converter's maps;
    ``evaluate`` (no metric binary here: the internal protocol, with the
    infos' point counts and difficulties, and its range breakdowns) gives
    JAX's metrics, and with a prefix it writes the bin as JAX's."""
    root, info = waymo_set["root"], waymo_set["validation"]
    t = tds.WaymoDataset(data_root=root, info_path=info)
    j = jds.WaymoDataset(data_root=root, info_path=info)
    res = _results(t, 7)
    a = t.format_results(res, str(tmp_path / "port"))
    b = j.format_results(res, str(tmp_path / "jax.bin"))
    assert a.endswith("port.bin")
    assert open(a, "rb").read() == open(b, "rb").read()
    frames = twb.read_bin_as_frames(a)
    assert len(frames) == len(t) - 1  # the empty last frame writes nothing
    for metric in ("fast", "waymo"):
        got = t.evaluate(res, metric=metric,
                         pklfile_prefix=str(tmp_path / f"t_{metric}"))
        want = j.evaluate(res, metric=metric,
                          pklfile_prefix=str(tmp_path / f"j_{metric}"))
        assert got.pop("bin").endswith(f"t_{metric}.bin")
        want.pop("bin")
        assert got == want
        assert 0.0 < got["Overall/L2 mAP"] <= 100.0  # percent


def test_tracklet_bin_io_equal_jax(tmp_path):
    """Tracks of a tracker-style bin: ``from_waymo_bin`` groups them as
    JAX's, ``to_frames`` / ``tracklets_to_bin`` write JAX's bytes."""
    frames = seeded_frames(4, 6)
    for k, f in enumerate(frames):
        f["obj_ids"] = [f"t{(i + k) % 3}" for i in range(len(f["scores"]))]
        f["context_name"] = "ctx-trk"
        f["labels"] = f["labels"] % 3
    path = twb.write_waymo_bin(str(tmp_path / "trk.bin"), frames)
    t = ttrk.LiDARTracklet.from_waymo_bin(path, min_len=2)
    j = jtrk.LiDARTracklet.from_waymo_bin(path, min_len=2)
    assert [(x.context_name, x.obj_id, x.type_id, x.timestamps)
            for x in t] == [(x.context_name, x.obj_id, x.type_id,
                             x.timestamps) for x in j]
    for x, y in zip(t, j):
        assert x.boxes.tobytes() == y.boxes.tobytes()
        assert x.scores.tobytes() == y.scores.tobytes()
    a = ttrk.tracklets_to_bin(t, str(tmp_path / "port.bin"))
    b = jtrk.tracklets_to_bin(j, str(tmp_path / "jax.bin"))
    assert open(a, "rb").read() == open(b, "rb").read()
