"""The port's misc, analysis and visualisation tools against the JAX
package's, on the same seeded inputs. JAX's scripts are imported by file
path and their ``main`` runs in this process with ``sys.argv`` set; the
port's take ``argv``. No JAX model is traced or compiled.

- ``fuse_state_dict`` against ``fuse_variables`` carried through
  ``convert.py``: a stack of flax ``ConvNormAct``s and a ``SECONDFPN``
  with 1x1 and stride-2 / stride-4 transposed deblocks, every tensor
  within 1 ulp; the fused port modules' outputs against the unfused ones
  within 1e-5; the CLI over a checkpoint keeps its optimizer state and
  step.
- ``graft`` against JAX's on the same tensors, bit for bit, from a
  detector's segmentor and from a bare one; the CLI writes ``<dst>_init``.
- The visualizer's OBJ files byte for byte and its PNG's decoded pixels,
  from numpy arrays and from tensors.
- ``print_config``, ``analyze_logs``, ``eval_nus_json`` and
  ``calibrate_synthetic`` (2 scenes) print or write JAX's output.
- ``browse_dataset``, ``visualize_results`` and ``show_bin`` write JAX's
  files (the first two build their model on the ``meta`` device).
- ``dist_train.sh`` forwards the device count to the train CLI, which
  refuses a run of another size.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import pickle
import subprocess

import numpy as np
import pytest
import torch

from test_torch_waymo_bin import ROOT, load_jax_script, run_jax_script
from torch_threads import torch_threads_per_worker  # noqa: F401

CFG = os.path.join(ROOT, "configs/sst/sst_tiny_synthetic.py")


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue(), out


def _ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest gap between ``a`` and ``b`` in float32 ulps of the
    larger magnitude."""
    a, b = a.double(), b.double()
    ulp = torch.from_numpy(np.spacing(np.maximum(
        np.abs(a.numpy()), np.abs(b.numpy())).astype(np.float32))).double()
    return float(((a - b).abs() / ulp).max())


def _png_pixels(path):
    import matplotlib.image as mpimg

    return mpimg.imread(path)


def _same_dirs(a, b, pattern):
    names = sorted(os.path.relpath(p, a)
                   for p in glob.glob(os.path.join(a, pattern),
                                      recursive=True) if os.path.isfile(p))
    assert names and names == sorted(
        os.path.relpath(p, b) for p in glob.glob(os.path.join(b, pattern),
                                                 recursive=True)
        if os.path.isfile(p))
    for n in names:
        if n.endswith(".png"):
            np.testing.assert_array_equal(_png_pixels(os.path.join(a, n)),
                                          _png_pixels(os.path.join(b, n)))
        else:
            with open(os.path.join(a, n), "rb") as fa, \
                    open(os.path.join(b, n), "rb") as fb:
                assert fa.read() == fb.read(), n
    return names


def _flax_fuse_world():
    """Flax modules of ``ConvNormAct``s and a ``SECONDFPN`` with seeded
    parameters and running statistics far from identity; their port
    twins; the seeded inputs (NHWC for flax)."""
    import flax.linen as nn
    import jax

    from sst_tpu.models.layers import ConvNormAct as JConvNormAct
    from sst_tpu.models.second import SECONDFPN as JFPN
    from sst_tpu_torch.models.layers import ConvNormAct
    from sst_tpu_torch.models.second import SECONDFPN

    class JStack(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            x = JConvNormAct(8, 3)(x, train)
            x = JConvNormAct(6, 1)(x, train)
            return JConvNormAct(4, 3, stride=2)(x, train)

    class Stack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ConvNormAct_0 = ConvNormAct(3, 8, 3)
            self.ConvNormAct_1 = ConvNormAct(8, 6, 1)
            self.ConvNormAct_2 = ConvNormAct(6, 4, 3, stride=2)

        def forward(self, x):
            for i in range(3):
                x = getattr(self, f"ConvNormAct_{i}")(x)
            return x

    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    feats = [rng.randn(2, 8 // s, 8 // s, c).astype(np.float32)
             for s, c in ((1, 5), (2, 6), (4, 7))]
    worlds = []
    for jmod, tmod, inp in (
            (JStack(), Stack(), x),
            (JFPN(out_channels=(4, 3, 5), upsample_strides=(1, 2, 4)),
             SECONDFPN((5, 6, 7), out_channels=(4, 3, 5),
                       upsample_strides=(1, 2, 4)), feats)):
        v = jax.tree_util.tree_map(
            np.asarray, jmod.init(jax.random.PRNGKey(0), inp))

        def seeded(path, leaf):
            name = jax.tree_util.keystr(path)
            if "var" in name:
                return rng.uniform(0.2, 3.0, leaf.shape).astype(np.float32)
            if "scale" in name:
                return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
            return rng.randn(*leaf.shape).astype(np.float32) * 0.5

        v = jax.tree_util.tree_map_with_path(seeded, v)
        worlds.append((v, tmod.eval(), inp))
    return worlds


def test_fuse_state_dict_equals_jax(tmp_path):
    from sst_tpu_torch.convert import load_flax_variables
    from sst_tpu_torch.tools.misc import fuse_conv_bn as tfuse
    from sst_tpu_torch.train.checkpoint import read_checkpoint, \
        save_checkpoint
    from tools.misc.fuse_conv_bn import fuse_variables

    for variables, tmod, inp in _flax_fuse_world():
        load_flax_variables(tmod, variables)
        unfused = {k: v.clone() for k, v in tmod.state_dict().items()}
        t_in = ([torch.from_numpy(f).permute(0, 3, 1, 2) for f in inp]
                if isinstance(inp, list)
                else torch.from_numpy(inp).permute(0, 3, 1, 2))
        with torch.no_grad():
            ref = tmod(t_in)
        got = tfuse.fuse_state_dict(unfused)
        load_flax_variables(tmod, fuse_variables(variables))
        want = tmod.state_dict()
        assert got.keys() == want.keys()
        assert len(tfuse.fused_pairs(unfused)) == 3
        for k in want:
            assert _ulps(got[k], want[k]) <= 1.0, k
        tmod.load_state_dict(got)
        with torch.no_grad():
            fused = tmod(t_in)
        torch.testing.assert_close(fused, ref, rtol=1e-5, atol=1e-5)
    # the CLI: the optimizer state and the step carried over unchanged
    tmod.load_state_dict(unfused)
    opt = torch.optim.AdamW(tmod.parameters())
    tmod(t_in).sum().backward()
    opt.step()
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), tmod,
                           type("O", (), {"adamw": opt, "count": 7})(), 7)
    out = tfuse.main([CFG, ckpt, str(tmp_path / "fused")])
    a, b = read_checkpoint(ckpt), read_checkpoint(out)
    assert b["step"] == 7 and b["optimizer"]["count"] == 7
    assert torch.equal(b["optimizer"]["adamw"]["state"][0]["exp_avg"],
                       a["optimizer"]["adamw"]["state"][0]["exp_avg"])
    for k, v in tfuse.fuse_state_dict(a["model"]).items():
        assert torch.equal(b["model"][k], v), k


def _nested(flat: dict, sep: str = ".") -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        *scopes, leaf = k.split(sep)
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = v
    return out


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_graft_equals_jax(tmp_path):
    from sst_tpu_torch.tools.model_converters import \
        fsd_pretrain_converter as tgraft
    from sst_tpu_torch.train.checkpoint import read_checkpoint, \
        write_checkpoint
    from tools.model_converters.fsd_pretrain_converter import graft

    rng = np.random.RandomState(1)
    names = ("segmentor_mod.vfe.w", "segmentor_mod.unet.enc_0.w",
             "segmentor_mod.head_mod.b", "roi.w", "rpn_head.b")

    def state(seed):
        r = np.random.RandomState(seed)
        return {k: r.randn(3, 2).astype(np.float32) for k in names}

    src, dst = state(1), state(2)
    want = _flat(graft(_nested(src, "."), _nested(dst, "."), "segmentor_mod",
                       "segmentor_mod"))
    t = {k: torch.from_numpy(v) for k, v in src.items()}
    got = tgraft.graft(t, {k: torch.from_numpy(v) for k, v in dst.items()},
                       "segmentor_mod", "segmentor_mod")
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k
    # a bare segmentor (no prefix) into the two-stage layout, by the CLI
    bare = {k[len("segmentor_mod."):]: torch.from_numpy(v)
            for k, v in src.items() if k.startswith("segmentor_mod.")}
    two = {f"rpn.{k}" if k.startswith("segmentor_mod") else k:
           torch.from_numpy(v) for k, v in dst.items()}
    s_ck = write_checkpoint(str(tmp_path / "seg"), {"model": bare, "step": 5})
    d_ck = write_checkpoint(str(tmp_path / "det"), {"model": two, "step": 0,
                                                    "optimizer": {"count": 0}})
    out = tgraft.main(["--src", s_ck, "--dst", d_ck])
    assert out == d_ck + "_init"
    res = read_checkpoint(out)
    for k, v in res["model"].items():
        ref = bare[k[len("rpn.segmentor_mod."):]] if k.startswith(
            "rpn.segmentor_mod.") else two[k]
        assert torch.equal(v, ref), k
    assert res["optimizer"] == {"count": 0} and res["step"] == 0
    with pytest.raises(ValueError, match="does not fit"):
        tgraft.graft({"a.w": torch.zeros(2)}, {"a.w": torch.zeros(3)}, "a",
                     "a")


def test_visualizer_files_equal_jax(tmp_path):
    from sst_tpu.utils import visualizer as jvis
    from sst_tpu_torch.utils import visualizer as tvis

    rng = np.random.RandomState(2)
    pts = rng.uniform(-30, 30, (500, 6)).astype(np.float32)
    gt = np.concatenate([rng.uniform(-20, 20, (4, 3)),
                         rng.uniform(1, 4, (4, 3)),
                         rng.uniform(-3, 3, (4, 1))], 1).astype(np.float32)
    pred = gt + rng.normal(0, 0.2, gt.shape).astype(np.float32)
    scores = rng.rand(4).astype(np.float32)
    for tag, mod, conv in (("jax", jvis, np.asarray),
                           ("port", tvis, torch.from_numpy)):
        d = tmp_path / tag
        mod.show_result(conv(pts[:, :3]), conv(gt), conv(pred), str(d),
                        "frame", show=True)
        mod.write_points_obj(conv(pts), str(d / "colored.obj"))
        mod.show_bev(conv(pts), conv(gt), conv(pred), conv(scores),
                     out_file=str(d / "bev.png"), pc_range=40.0)
    names = _same_dirs(str(tmp_path / "jax"), str(tmp_path / "port"), "**")
    assert len(names) == 6


def _write_log(path):
    rng = np.random.RandomState(5)
    with open(path, "w") as f:
        for i in range(1, 9):
            f.write(json.dumps({"step": i * 10, "wall": i * 3.2 + rng.rand(),
                                "loss_total": 5.0 / i,
                                "loss_sem_seg": 1.0 / i}) + "\n")


def _nus_world(tmp_path):
    """tests/test_misc_tools.py's eval_nus_json world: one sample, the ego
    turned and moved, its gt as global-frame submission entries."""
    yaw_e = np.pi / 6
    q_eg = [np.cos(yaw_e / 2), 0, 0, np.sin(yaw_e / 2)]
    t_eg = [100.0, -50.0, 1.0]
    gt = np.array([[5.0, 2.0, -1.0, 2.0, 4.0, 1.6, 0.4],
                   [-3.0, 7.0, -0.8, 0.7, 0.8, 1.7, -1.2]], np.float32)
    names = ["car", "pedestrian"]
    info = dict(token="tok0", gt_boxes=gt, gt_names=names,
                gt_velocity=np.zeros((2, 2), np.float32),
                lidar2ego_rotation=[1.0, 0, 0, 0],
                lidar2ego_translation=[0.0, 0.0, 0.0],
                ego2global_rotation=q_eg, ego2global_translation=t_eg)
    info_path = str(tmp_path / "infos.pkl")
    with open(info_path, "wb") as f:
        pickle.dump([info], f)
    R = np.array([[np.cos(yaw_e), -np.sin(yaw_e), 0],
                  [np.sin(yaw_e), np.cos(yaw_e), 0], [0, 0, 1]])
    entries = []
    for row, name in zip(gt, names):
        ctr = row[:3].copy()
        ctr[2] += row[5] / 2
        g = R @ ctr + np.asarray(t_eg)
        gyaw = row[6] + yaw_e + 0.05
        entries.append(dict(
            translation=g.tolist(), size=row[3:6].tolist(),
            rotation=[float(np.cos(gyaw / 2)), 0.0, 0.0,
                      float(np.sin(gyaw / 2))],
            velocity=[0.3, 0.0], detection_name=name, detection_score=0.9))
    res_path = str(tmp_path / "results_nusc.json")
    with open(res_path, "w") as f:
        json.dump({"results": {"tok0": entries}, "meta": {}}, f)
    return res_path, info_path


def test_text_tools_equal_jax(tmp_path, monkeypatch):
    import matplotlib.pyplot as plt

    from sst_tpu_torch.tools.analysis_tools import (
        analyze_logs,
        calibrate_synthetic,
        eval_nus_json,
    )
    from sst_tpu_torch.tools.misc import print_config

    log = str(tmp_path / "train_log.jsonl")
    _write_log(log)
    res_path, info_path = _nus_world(tmp_path)
    runs = (
        ("tools/misc/print_config.py", print_config,
         lambda tag: [CFG, "--cfg-options", "data.samples_per_device=2",
                      "model.head.num_classes=[3]"]),
        ("tools/analysis_tools/analyze_logs.py", analyze_logs,
         lambda tag: ["cal_train_time", log]),
        ("tools/analysis_tools/analyze_logs.py", analyze_logs,
         lambda tag: ["plot_curve", log, "--keys", "loss_total",
                      "loss_sem_seg", "--out", str(tmp_path / f"{tag}.png")]),
        ("tools/analysis_tools/eval_nus_json.py", eval_nus_json,
         lambda tag: [res_path, "--info-path", info_path]),
        ("tools/analysis_tools/calibrate_synthetic.py", calibrate_synthetic,
         lambda tag: ["--val-scenes", "2", "--out",
                      str(tmp_path / f"cal_{tag}.json")]),
    )
    for script, tmod, argv in runs:
        jmod = load_jax_script(script, monkeypatch)
        plt.close("all")
        jout, _ = _stdout(run_jax_script, jmod, argv("TAGJ"), monkeypatch)
        plt.close("all")
        tout, _ = _stdout(tmod.main, argv("TAGP"))
        assert tout == jout.replace("TAGJ", "TAGP"), script
    np.testing.assert_array_equal(_png_pixels(str(tmp_path / "TAGJ.png")),
                                  _png_pixels(str(tmp_path / "TAGP.png")))
    with open(tmp_path / "cal_TAGJ.json") as a, \
            open(tmp_path / "cal_TAGP.json") as b:
        assert json.load(a) == json.load(b)
    out = eval_nus_json.main([res_path, "--info-path", info_path])
    assert out["car_AP_dist_0.5"] > 0.99 and 0.0 < out["mAOE"] < 0.1


def test_browse_visualize_show_bin_write_jax_files(tmp_path, monkeypatch):
    from sst_tpu_torch.core.waymo_bin import write_waymo_bin
    from sst_tpu_torch.tools.misc import browse_dataset, visualize_results
    from sst_tpu_torch.tools.vis import show_bin

    res = [dict(boxes=np.array([[1, 2, 0.5, 4, 2, 1.5, 0.1]], np.float32),
                scores=np.array([0.9], np.float32), labels=np.array([0]),
                valid=np.array([True])),
           dict(boxes=np.array([[-5, 2, 0.5, 1, 1, 1.5, 1.1],
                                [3, -7, 0.4, 2, 4, 1.5, -0.3]], np.float32),
                scores=np.array([0.2, 0.8], np.float32),
                labels=np.array([1, 0]), valid=np.array([True, True]))]
    pkl = str(tmp_path / "preds.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(res, f)
    binp = str(tmp_path / "preds.bin")
    write_waymo_bin(binp, [dict(
        context_name="ctx", timestamp_micros=1234 + i, **{
            k: r[k] for k in ("boxes", "scores", "labels")})
        for i, r in enumerate(res)])
    runs = (
        ("tools/misc/browse_dataset.py", browse_dataset,
         lambda tag: [CFG, "--synthetic", "--num", "2", "--objs",
                      "--output-dir", str(tmp_path / tag / "browse")]),
        ("tools/misc/visualize_results.py", visualize_results,
         lambda tag: [CFG, "--synthetic", "--result", pkl, "--show-dir",
                      str(tmp_path / tag / "vis")]),
        ("tools/vis/show_bin.py", show_bin,
         lambda tag: ["--bin-path", binp, "--no-gt", "--interval", "1",
                      "--save-folder", str(tmp_path / tag / "bin")]),
    )
    for script, tmod, argv in runs:
        jmod = load_jax_script(script, monkeypatch)
        run_jax_script(jmod, argv("jax"), monkeypatch)
        tmod.main(argv("port"))
    names = _same_dirs(str(tmp_path / "jax"), str(tmp_path / "port"), "**")
    assert "browse/sample_0001/sample_0001_points.obj" in names
    assert "vis/frame_0001/frame_0001_pred.obj" in names
    assert "bin/1235.png" in names


def test_dist_train_wrapper_checks_the_device_count(tmp_path):
    """``dist_train.sh CFG 1`` starts one process and forwards
    ``--expect-devices 1``; a later ``--expect-devices`` that the run does
    not have makes the CLI refuse before any step. With one node and no
    ``MASTER_PORT`` the wrapper runs torchrun ``--standalone``, whose
    rendezvous binds a free port, so runs side by side never collide."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("NNODES", "NODE_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        ["bash", "sst_tpu_torch/tools/dist_train.sh", CFG, "1", "--synthetic",
         "--device", "cpu", "--max-steps", "1", "--work-dir",
         str(tmp_path / "wd"), "--expect-devices", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "--expect-devices 3 but the run has 1 process(es)" in (
        r.stdout + r.stderr)
    assert not os.path.exists(tmp_path / "wd" / "train_log.jsonl")
