"""The port's Argoverse 2 tools against the JAX package's on seeded
feathers: ``argo2_converter`` (infos, ``ts2idx`` and every point bin),
``gather_argo2_anno_feather`` (the gathered table), ``eval_feather`` (the
CDS printout) and ``create_roi_mask`` (every mask file, with one worker and
with a pool of two). The tools read and write feathers through pandas and
pyarrow; without them this file skips."""

from __future__ import annotations

import contextlib
import io
import os
import pickle

import numpy as np
import pytest

pytest.importorskip("pandas", reason="the Argo2 tools read feathers "
                                     "through pandas")
pytest.importorskip("pyarrow", reason="the Argo2 tools read feathers "
                                      "through pyarrow")

from test_torch_data_converters import same, same_files  # noqa: E402
from test_torch_waymo_bin import load_jax_script, run_jax_script  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_converter_gather_and_eval_equal_jax(tmp_path, monkeypatch):
    import pyarrow.feather as feather

    from sst_tpu_torch.tools.argo import (
        argo2_converter,
        eval_feather,
        gather_argo2_anno_feather,
    )
    from test_argo_tools import make_av2

    make_av2(tmp_path, split="val", n_seg=2, n_frames=3)
    make_av2(tmp_path, split="test", n_seg=1, n_frames=2)
    outs = {}
    for tag, tmod in (("jax", None), ("port", argo2_converter)):
        out = tmp_path / f"conv_{tag}"
        out.mkdir()
        argv = ["--root", str(tmp_path), "--out", str(out), "--splits",
                "val", "test"]
        if tmod is None:
            run_jax_script(load_jax_script("tools/argo/argo2_converter.py",
                                           monkeypatch), argv, monkeypatch)
        else:
            tmod.main(argv)
        outs[tag] = str(out)
    for name in ("argo2_infos_val.pkl", "argo2_infos_test.pkl",
                 "ts2idx.pkl"):
        same(_load(os.path.join(outs["port"], name)),
             _load(os.path.join(outs["jax"], name)), name)
    assert same_files(outs["jax"], outs["port"], "*/velodyne/*.bin") == 8

    gts = {}
    for tag in ("jax", "port"):
        argv = ["--root", str(tmp_path), "--out",
                str(tmp_path / f"gt_{tag}.feather")]
        if tag == "jax":
            run_jax_script(load_jax_script(
                "tools/argo/gather_argo2_anno_feather.py", monkeypatch),
                argv, monkeypatch)
        else:
            gather_argo2_anno_feather.main(argv)
        gts[tag] = feather.read_table(argv[-1]).to_pandas()
    assert gts["port"].equals(gts["jax"]) and len(gts["port"]) == 6

    preds = gts["port"].copy()
    rng = np.random.RandomState(0)
    preds["tx_m"] += rng.normal(0, 0.3, len(preds))
    preds["score"] = rng.uniform(0.3, 1.0, len(preds))
    pred_path = str(tmp_path / "preds.feather")
    feather.write_feather(preds, pred_path)
    argv = ["--pred", pred_path, "--gt", str(tmp_path / "gt_port.feather")]
    jout = _stdout(run_jax_script, load_jax_script(
        "tools/argo/eval_feather.py", monkeypatch), argv, monkeypatch)
    tout = _stdout(eval_feather.main, argv)
    assert tout == jout and "Regular_vehicle" in tout


def test_create_roi_mask_equals_jax(tmp_path, monkeypatch):
    from sst_tpu_torch.tools.argo import create_roi_mask
    from test_av2_map import LOG_ID, TS, _write_fixture_log

    argo2_root = tmp_path / "argo2"
    split_dir = argo2_root / "argo2_format" / "sensor" / "val"
    os.makedirs(split_dir, exist_ok=True)
    _write_fixture_log(str(split_dir), yaw_deg=20.0,
                       t_xyz=(110.0, 205.0, 0.0))
    velo = argo2_root / "kitti_format" / "training" / "velodyne"
    os.makedirs(velo, exist_ok=True)
    rng = np.random.RandomState(1)
    infos = []
    for i in range(3):
        pts = np.concatenate([rng.uniform(-20, 20, (400, 2)),
                              rng.uniform(-1, 4, (400, 1)),
                              rng.rand(400, 1)], 1).astype(np.float32)
        pts.tofile(velo / f"00000{i}.bin")
        infos.append({"uuid": f"{LOG_ID}/{TS}", "sample_idx": f"00000{i}",
                      "point_cloud": {"velodyne_path":
                                      f"training/velodyne/00000{i}.bin"}})
    infos_path = str(argo2_root / "infos_val.pkl")
    with open(infos_path, "wb") as f:
        pickle.dump(infos, f)
    mask_dir = argo2_root / "kitti_format" / "training" / "mask"
    masks = {}
    for tag, procs in (("jax", "1"), ("port", "1"), ("port_pool", "2")):
        argv = ["--argo2-root", str(argo2_root), "--infos", infos_path,
                "--split", "val", "--num-process", procs]
        if tag == "jax":
            run_jax_script(load_jax_script("tools/argo/create_roi_mask.py",
                                           monkeypatch), argv, monkeypatch)
        else:
            create_roi_mask.main(argv)
        masks[tag] = {p: (mask_dir / p).read_bytes()
                      for p in sorted(os.listdir(mask_dir))}
        for p in os.listdir(mask_dir):
            os.remove(mask_dir / p)
    assert masks["port"] == masks["jax"] == masks["port_pool"]
    m = np.frombuffer(masks["port"]["000000.bin"], bool).reshape(-1, 3)
    assert len(m) == 400 and 0 < m[:, 0].sum() < 400
