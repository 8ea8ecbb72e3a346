"""The port's dense-vs-sparse quality A/B tools
(``sst_tpu_torch/tools/ab_dense_vs_sparse.py``, ``ab_merge.py``) against
the JAX package's (``tools/ab_dense_vs_sparse.py``, ``tools/ab_merge.py``,
imported by file path), on the CPU.

- The scene pools: the same train and val scenes, bit for bit (JAX's pool
  cache redirected into the test's directory).
- ``predictions_to_frames`` and ``waymo_eval`` on the same seeded
  predictions: the same frames and the same numbers.
- ``ab_merge`` on JAX-written result files (the repository's r05 files)
  and on a port-written one: the same merged JSON from either package's
  merge.
- A ``--tiny --steps 4`` run of the port (both builds) writes JAX's keys.
- Two steps, a crash, and ``--resume`` for two more end bit for bit where
  an uninterrupted four-step run ends: the same weights, optimizer state,
  losses and scores.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from sst_tpu_torch.tools import ab_dense_vs_sparse as ab
from sst_tpu_torch.tools import ab_merge
from sst_tpu_torch.train import step as tstep
from sst_tpu_torch.train.checkpoint import read_checkpoint
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SCENES = dict(batch_size=1, num_points=4096, num_extra_feats=2,
                   pcr_half=3.9, num_objects=6, size_scale=0.35)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_argv(tmp_path, *extra):
    return ["--tiny", "--device", "cpu", "--train-scenes", "3",
            "--val-scenes", "2", "--ckpt-dir", str(tmp_path / "ckpt"),
            *extra]


def test_scene_pools_equal_jax(tmp_path, monkeypatch):
    jab = _jax_tool("ab_dense_vs_sparse")
    real_open = open

    def redirect(path, *a, **k):  # JAX's pool cache, into tmp_path
        return real_open(tmp_path / os.path.basename(path), *a, **k)

    monkeypatch.setattr(jab, "open", redirect, raising=False)
    monkeypatch.setattr(jab.os.path, "exists", lambda p: False)
    jtrain, jval = jab.get_pools(TINY_SCENES, 3, 2)
    train, val = ab.get_pools(TINY_SCENES, 3, 2, str(tmp_path / "port"))
    fields = ("points", "valid", "gt_boxes", "gt_labels", "gt_valid")
    for got, ref in zip(train + [b for b, _ in val],
                        jtrain + [b for b, _ in jval]):
        for f in fields:
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(ref, f)))
    for (_, gm), (_, jm) in zip(val, jval):
        for g, j in zip(gm, jm):
            assert sorted(g) == sorted(j)
            for k in g:
                np.testing.assert_array_equal(g[k], j[k])
    # the pools are kept per process and in the cache directory
    assert ab.get_pools(TINY_SCENES, 3, 2)[0] is train
    assert any(n.startswith("sst_torch_ab_pool_")
               for n in os.listdir(tmp_path / "port"))


def test_frames_and_waymo_eval_match_jax(tmp_path):
    from sst_tpu.core.eval_waymo import waymo_eval as jwaymo
    from sst_tpu_torch.core.eval_waymo import waymo_eval

    jab = _jax_tool("ab_dense_vs_sparse")
    rng = np.random.RandomState(0)
    _, val = ab.get_pools(TINY_SCENES, 3, 2, str(tmp_path))
    gts = [m for _, meta in val for m in meta]
    preds = []
    for m in gts:
        k = 12
        boxes = np.zeros((1, k, 7), np.float32)
        n = min(len(m["boxes"]), 8)
        boxes[0, :n] = m["boxes"][:n] + rng.randn(n, 7).astype(
            np.float32) * 0.05
        boxes[0, n:] = rng.randn(k - n, 7).astype(np.float32)
        boxes[0, n:, 3:6] = np.abs(boxes[0, n:, 3:6]) + 0.5
        scores = rng.rand(1, k).astype(np.float32)
        scores[0, -2:] = 0.0  # kept out by the positive-score rule
        labels = np.concatenate([m["labels"][:n], rng.randint(
            0, 3, k - n)]).astype(np.int32)[None]
        valid = np.ones((1, k), bool)
        valid[0, -3] = False
        preds.append(dict(boxes=boxes, scores=scores, labels=labels,
                          valid=valid))
    jframes, frames = [], []
    for p in preds:
        jframes += jab.predictions_to_frames(p, 1)
        frames += ab.predictions_to_frames(
            {k: torch.from_numpy(v) for k, v in p.items()}, 1)
    for f, j in zip(frames, jframes):
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(f[k], j[k])
        assert len(f["boxes"]) == 9
    ref = jwaymo(jframes, gts, classes=("Car", "Pedestrian", "Cyclist"))
    got = waymo_eval(frames, gts, classes=("Car", "Pedestrian", "Cyclist"))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert ref["Overall/L1 mAP"] > 0


def _merge_both(tmp_path, monkeypatch, inputs, pairs):
    jmerge = _jax_tool("ab_merge")
    argv = [*inputs] + [a for p in pairs for a in ("--pair", p)]
    jout = tmp_path / "jax_merged.json"
    monkeypatch.setattr(sys, "argv", ["ab_merge", *argv, "--out",
                                      str(jout)])
    jmerge.main()
    out = tmp_path / "port_merged.json"
    ab_merge.main([*argv, "--out", str(out)])
    with open(jout) as f, open(out) as g:
        return json.load(g), json.load(f)


def test_ab_merge_matches_jax_on_jax_files(tmp_path, monkeypatch):
    """The repository's JAX-written r05 arms (one build per file, one arm
    stopped early) and its r04 dense arm, merged by both packages."""
    inputs = [os.path.join(ROOT, f) for f in (
        "AB_DENSE_r04.json", "AB_SPARSE_r05.json")]
    got, ref = _merge_both(tmp_path, monkeypatch, inputs,
                           ["dense:sparse", "dense:dense_f32"])
    assert got == ref
    assert ref["matched_step_delta_dense_minus_dense_f32"] is None
    assert ref["matched_steps_dense_vs_sparse"]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ab")
    out = tmp / "ab.json"
    res = ab.main(_tiny_argv(tmp, "--steps", "4", "--ckpt-every", "2",
                             "--out", str(out)))
    return tmp, out, res


def test_tiny_run_writes_jax_keys(tiny_run, tmp_path, monkeypatch):
    """Both builds train and score; the file has the JAX tool's keys at
    every level (its args are a superset: ``--device``), and either
    package's ``ab_merge`` reads it to the same result."""
    tmp, out, res = tiny_run
    with open(out) as f:
        port = json.load(f)
    with open(os.path.join(ROOT, "AB_SPARSE_r05.json")) as f:
        jax_file = json.load(f)
    assert sorted(port) == ["args", "delta_dense_minus_sparse", "dense",
                            "scene_kw", "sparse"]
    assert set(jax_file["args"]) <= set(port["args"])
    assert set(port["args"]) - set(jax_file["args"]) == {"device"}
    # the JAX tool's --tiny scenes
    assert port["scene_kw"] == TINY_SCENES
    for b in ("dense", "sparse"):
        assert sorted(port[b]) == sorted(jax_file["sparse"])
        run = port[b]["runs"][0]
        ref_run = {k for k in jax_file["sparse"]["runs"][0]
                   if k != "stopped_early_at_step"}
        assert set(run) == ref_run
        assert sorted(run["ap"]) == sorted(jax_file["sparse"]["runs"][0]["ap"])
        assert len(run["loss_curve"]) == 2
        assert all(np.isfinite(run["loss_curve"]))
        assert run["trajectory"][-1][0] == 4
    got, ref = _merge_both(tmp_path, monkeypatch, [str(out)],
                           ["dense:sparse"])
    assert got == ref
    assert ref["matched_steps_dense_vs_sparse"] == [4]


def test_resume_equals_an_uninterrupted_run(tiny_run, tmp_path, monkeypatch):
    """The sparse arm: steps 0-1, a crash in step 2 (the checkpoint of
    step 2 on disk), then ``--resume`` through step 3: the final
    checkpoint (weights, running statistics, AdamW's moments and count)
    and the result equal the uninterrupted run's bit for bit."""
    ref_dir, _, ref_res = tiny_run
    argv = _tiny_argv(tmp_path, "--steps", "4", "--ckpt-every", "2",
                      "--builds", "sparse", "--out",
                      str(tmp_path / "ab.json"))
    real_step, calls = tstep.train_step, []

    def crash_in_step_2(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("simulated crash")
        return real_step(*a, **k)

    monkeypatch.setattr(tstep, "train_step", crash_in_step_2)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ab.main(argv)
    monkeypatch.setattr(tstep, "train_step", real_step)
    with open(tmp_path / "ckpt" / "sparse" / "progress.json") as f:
        assert json.load(f)["step"] == 2
    res = ab.main(argv + ["--resume"])
    got = read_checkpoint(str(tmp_path / "ckpt" / "sparse" / "step_4"))
    ref = read_checkpoint(str(ref_dir / "ckpt" / "sparse" / "step_4"))
    assert got["step"] == ref["step"] == 4
    for k, x in ref["model"].items():
        assert torch.equal(got["model"][k], x), k
    assert got["optimizer"]["count"] == ref["optimizer"]["count"] == 4
    for pid, st in ref["optimizer"]["adamw"]["state"].items():
        for k, x in st.items():
            assert torch.equal(got["optimizer"]["adamw"]["state"][pid][k],
                               x), (pid, k)
    run, ref_run = res["sparse"]["runs"][0], ref_res["sparse"]["runs"][0]
    for k in ("ap", "loss_curve", "trajectory", "seed"):
        assert run[k] == ref_run[k], k
