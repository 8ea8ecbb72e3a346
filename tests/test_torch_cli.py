"""The port's train and test CLIs and what lies beneath them, on the CPU:
``predict_seg`` against JAX's, checkpoints bit for bit, ``apis.init_model``,
the two CLIs end to end on ``configs/sst/sst_tiny_synthetic.py``, the test
CLI's evaluation loop against JAX's ``tools/test.py`` loop, and the import
guard (no ``jax``, ``flax`` or ``sst_tpu`` in a process that runs the
CLIs).

The slice as a whole: the config's SST with the variables of JAX's init
(random running statistics, JAX's fused attention in interpret mode as in
``test_torch_sst.py``) answers four synthetic frames in both packages. The
detections agree within the SST slice's tolerances (scores 1e-3, boxes
1e-2: the attention's bf16 roundings), so the ground truth of each class is
made from JAX's detections: the ones above a score cut with a margin of
at least twice the score tolerance become gt boxes (plus a far-off missed
box per frame), the rest are false positives. Every true positive then
ranks above every false positive in both packages, and the AP of each class
is a fixed function of the matches: the two loops' APs must agree within
1e-6.
"""

import copy
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu.core.evaluation import eval_ap as jeval_ap
from sst_tpu.data.datasets import SyntheticDataset as JSynthetic
from sst_tpu.data.pipelines import build_pipeline as jbuild
from sst_tpu.utils.builders import build_model_from_cfg as jbuild_model
from sst_tpu.utils.config import load_config as jload
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.apis import init_model
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.core.evaluation import eval_ap
from sst_tpu_torch.data.loader import DataLoader
from sst_tpu_torch.tools import test as test_cli
from sst_tpu_torch.tools import train as train_cli
from sst_tpu_torch.train.checkpoint import (
    load_checkpoint,
    read_checkpoint,
    save_checkpoint,
)
from sst_tpu_torch.train.state import make_optimizer
from sst_tpu_torch.train.step import train_step
from sst_tpu_torch.utils.builders import build_model_from_cfg
from sst_tpu_torch.utils.config import load_config
from test_torch_ctrl import seeded_port_variables
from test_torch_sst import SCORE_TOL, _numpy_vars
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(ROOT, "configs/sst/sst_tiny_synthetic.py")


def _cfg_with_fused_attention(load):
    cfg = load(TINY_CFG)
    cfg["model"]["backbone"]["use_pallas"] = True
    return cfg


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's two references: ``predict_seg`` of ``tiny_fsd`` on seeded
    variables, and the config's SST ``predict`` (fused attention in
    interpret mode, set while it traces) on the variables of its init, over
    the test CLI's first four synthetic frames. The init and both
    references are traced in turn and compiled together in threads."""
    from sst_tpu.data.datasets import collate_to_batch

    fsd_v = seeded_port_variables(tflag.tiny_fsd(device="cpu"), seed=1)
    jfsd = jflag.tiny_fsd()
    fsd_batch = jflag.fsd_batch(np.random.RandomState(2), p=512)
    cfg = _cfg_with_fused_attention(jload)
    jsst = jbuild_model(cfg, train=False)
    max_points = cfg["capacity"]["max_points"]
    ds = JSynthetic(num_samples=4, num_points=min(max_points, 32768),
                    pc_range=jsst.point_cloud_range, seed=999,
                    pipeline=jbuild([
                        dict(type="PointsRangeFilter",
                             point_cloud_range=jsst.point_cloud_range),
                        dict(type="PadToCap", max_points=max_points)]))
    frames = [collate_to_batch([ds[i]]) for i in range(4)]

    def init(b):
        return jsst.init({"params": jax.random.PRNGKey(0),
                          "shuffle": jax.random.PRNGKey(1)}, b, train=False)

    lowered = [
        jax.jit(lambda v, b: jfsd.apply(v, b, method=jfsd.predict_seg))
        .lower(fsd_v, fsd_batch),
        jax.jit(init).lower(frames[0])]
    mp = pytest.MonkeyPatch()
    mp.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    try:
        lowered.append(jax.jit(lambda v, b: jsst.apply(
            v, b, method=jsst.predict)).lower(
                jax.eval_shape(init, frames[0]), frames[0]))
    finally:
        mp.undo()
    with ThreadPoolExecutor(3) as pool:
        seg_c, init_c, det_c = pool.map(lambda low: low.compile(), lowered)
    seg_out = jax.tree_util.tree_map(np.asarray, seg_c(fsd_v, fsd_batch))
    sst_v = _numpy_vars(init_c(frames[0]))
    dets = [jax.tree_util.tree_map(np.asarray, det_c(sst_v, f))
            for f in frames]
    return dict(fsd_v=fsd_v, fsd_batch=fsd_batch, seg_out=seg_out,
                sst_v=sst_v, dets=dets, frames=frames)


def test_predict_seg_matches_jax(jax_refs):
    """``predict_seg`` of ``tiny_fsd``: per-point classes, box-derived gt
    labels and validity equal to JAX's, point for point."""
    r = jax_refs
    tm = load_flax_variables(tflag.tiny_fsd(device="cpu"), r["fsd_v"]).eval()
    b = r["fsd_batch"]
    out = tm.predict_seg(tflag.PointBatch(
        **{k: np.array(getattr(b, k)) for k in
           ("points", "valid", "gt_boxes", "gt_labels", "gt_valid")}
    ).to("cpu"))
    for k in ("pred", "gt", "valid"):
        got, ref = out[k].numpy(), r["seg_out"][k]
        assert got.dtype == ref.dtype and np.array_equal(got, ref), k
    ref = r["seg_out"]
    assert (ref["gt"][ref["valid"]] < 3).any()  # points inside gt boxes
    fg = ref["pred"][ref["valid"]] < 3
    assert 0 < fg.sum() < fg.size  # both decisions taken


def _trained_tiny_sst(dtype):
    """``tiny_sst`` after two train steps (non-zero AdamW moments, moved
    running statistics) with its optimizer."""
    model = tflag.init_weights(tflag.tiny_sst(dtype=dtype, device="cpu"),
                               torch.Generator().manual_seed(4)).train()
    opt = make_optimizer(model.parameters(), base_lr=1e-3, total_steps=10)
    batch = tflag.tiny_batch().to("cpu")
    for s in range(2):
        train_step(model, opt, batch,
                   {"generator": torch.Generator().manual_seed(s)})
    return model, opt, batch


def _same_state(a, b, path="state"):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _same_state(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_state(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.bfloat16 else b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_bit_for_bit(tmp_path, dtype):
    """Parameters (float32 at either compute dtype), running statistics,
    AdamW moments and steps, ``count`` and ``step`` come back bit for bit
    into a fresh model and optimizer; a second save over the first
    replaces it; the restored model predicts exactly as the one that
    saved it."""
    model, opt, batch = _trained_tiny_sst(dtype)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    path = save_checkpoint(tmp_path / "ckpt_2", model, opt, step=2)
    save_checkpoint(path, model, opt, step=2)  # replaces, as orbax's force
    assert sorted(os.listdir(tmp_path)) == ["ckpt_2"]
    fresh = tflag.tiny_sst(dtype=dtype, device="cpu")
    fresh_opt = make_optimizer(fresh.parameters(), base_lr=1e-3,
                               total_steps=10)
    assert load_checkpoint(path, fresh, fresh_opt) == 2
    _same_state(fresh.state_dict(), model.state_dict())
    _same_state(fresh_opt.adamw.state_dict(), opt.adamw.state_dict())
    assert fresh_opt.count == opt.count == 2
    raw = read_checkpoint(path)
    assert raw["step"] == 2 and raw["optimizer"]["count"] == 2
    assert len(raw["optimizer"]["adamw"]["state"]) == len(opt.params)
    with torch.inference_mode():
        ref = model.eval().predict(batch)
        got = fresh.eval().predict(batch)
    _same_state(got, ref)
    assert ref["valid"].any()


def test_init_model_predicts_as_the_saved_module(tmp_path):
    """``init_model(config, ckpt, device="cpu")`` gives the saved module's
    predictions bit for bit; without a checkpoint its weights come from the
    seed."""
    src = init_model(TINY_CFG, seed=3, device="cpu")
    assert not src.training
    other = init_model(TINY_CFG, seed=4, device="cpu")
    assert not torch.equal(next(src.parameters()),
                           next(other.parameters()))
    save_checkpoint(tmp_path / "ckpt_0", src, step=0)
    got = init_model(TINY_CFG, str(tmp_path / "ckpt_0"), device="cpu")
    b = tflag.synthetic_waymo_batch(1, 2048, num_extra_feats=2,
                                    pcr_half=6.2).to("cpu")
    _same_state(got.predict(b), src.predict(b))
    if not torch.cuda.is_available():  # the card by default, no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            init_model(TINY_CFG)


def _jax_log_keys() -> set:
    """The keys of JAX's ``train_log.jsonl`` step lines for the tiny
    config: its model's loss keys (traced by ``jax.eval_shape``, nothing
    compiled) and the CLI's own."""
    cfg = jload(TINY_CFG)
    jm = jbuild_model(cfg, train=True)
    b = jflag.tiny_batch(batch_size=2, num_points=256)
    v = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1)},
        b, train=False))
    out = jax.eval_shape(lambda v: jm.apply(
        v, b, True, method=jm.loss, rngs={"shuffle": jax.random.PRNGKey(2)},
        mutable=["batch_stats"])[0], v)
    return set(out) | {"loss_total", "grad_norm", "step", "wall"}


def test_train_and_test_clis_end_to_end(tmp_path, capsys, monkeypatch):
    """2 steps with in-train eval, a resume from ``ckpt_2`` to step 4 (the
    restored state equals the saved one bit for bit), then the test CLI on
    ``ckpt_4`` with ``--eval ap3d`` and ``--eval waymo``: finite losses,
    JAX's JSON keys, JAX's printed lines. TensorBoard is absent, as on the
    card's machine (``tests/test_torch_tools.py`` covers its writer)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    wd = str(tmp_path / "wd")
    common = [TINY_CFG, "--synthetic", "--device", "cpu", "--work-dir", wd,
              "--log-interval", "1", "--ckpt-interval", "2"]
    first = train_cli.main(common + ["--max-steps", "2", "--eval-interval",
                                     "2", "--eval-samples", "2"])
    out = capsys.readouterr().out
    assert "step 1/2 loss=" in out and "eval @ 2: {'val/Car'" in out
    assert first["steps"] == 2 and first["checkpoints"] == [
        os.path.join(wd, "ckpt_2")]
    second = train_cli.main(common + ["--max-steps", "4", "--resume-from",
                                      os.path.join(wd, "ckpt_2")])
    assert second["start_step"] == 2 and second["steps"] == 2
    assert "saved " + os.path.join(wd, "ckpt_4") in capsys.readouterr().out
    recs = [json.loads(line) for line in open(os.path.join(wd,
                                                           "train_log.jsonl"))]
    steps = [r for r in recs if "loss_total" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    keys = _jax_log_keys()
    for r in steps:
        assert set(r) == keys
        assert all(np.isfinite(v) for v in r.values())
    val = [r for r in recs if "val/mAP" in r]
    assert len(val) == 1 and set(val[0]) == {
        "val/Car", "val/Pedestrian", "val/Cyclist", "val/mAP", "step"}
    # the restored state: ckpt_2 into a fresh model and optimizer
    cfg = load_config(TINY_CFG)
    model = build_model_from_cfg(cfg, device="cpu")
    opt = make_optimizer(model.parameters(), total_steps=4)
    assert load_checkpoint(os.path.join(wd, "ckpt_2"), model, opt) == 2
    raw = read_checkpoint(os.path.join(wd, "ckpt_2"))
    _same_state(model.state_dict(), raw["model"])
    _same_state(opt.adamw.state_dict(), raw["optimizer"]["adamw"])
    assert opt.count == 2
    four = read_checkpoint(os.path.join(wd, "ckpt_4"))
    assert four["step"] == 4 and four["optimizer"]["count"] == 4

    ckpt4 = os.path.join(wd, "ckpt_4")
    res = test_cli.main([TINY_CFG, ckpt4, "--synthetic", "--device", "cpu",
                         "--num-samples", "2", "--eval", "ap3d",
                         "--out", str(tmp_path / "preds.pkl")])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0] == "ran inference on 2 samples"
    assert set(json.loads(printed[-1])["AP_3d"]) == {
        "Car", "Pedestrian", "Cyclist", "mAP"}
    assert res["frames"] == 2 and os.path.exists(tmp_path / "preds.pkl")
    res = test_cli.main([TINY_CFG, ckpt4, "--synthetic", "--device", "cpu",
                         "--num-samples", "2", "--eval", "waymo"])
    assert "Overall/L2 mAPH" in json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    # --sequential reads a Waymo set the synthetic config does not name
    with pytest.raises(ValueError, match="data_root"):
        test_cli.main([TINY_CFG, "--sequential", "--device", "cpu"])


def test_test_cli_loop_matches_jax(jax_refs):
    """The slice as a whole (module docstring): the port's test-CLI loop
    (``tools/test.py`` dataset, loader, ``run_predictions``) with JAX's
    init variables, and ``eval_ap`` in 3D and BEV, against JAX's
    ``tools/test.py`` loop rebuilt here, within 1e-6."""
    r = jax_refs
    cfg = _cfg_with_fused_attention(load_config)
    model = load_flax_variables(build_model_from_cfg(cfg, train=False,
                                                     device="cpu"),
                                r["sst_v"]).eval()
    jpreds = []
    for out in r["dets"]:
        ok = out["valid"][0]
        jpreds.append({"boxes": out["boxes"][0][ok][:, :7],
                       "scores": out["scores"][0][ok],
                       "labels": out["labels"][0][ok]})
    # gt from JAX's detections: per class, those above a score cut with a
    # margin of 2 * SCORE_TOL on both sides of it (and above the max_num
    # cut's near ties), plus one far-off missed box per frame
    gts = [{"boxes": [np.array([[5.0, 5.0, -1.0, 1.0, 1.0, 1.0, 0.0]],
                               np.float32)],
            "labels": [np.array([i % 3])]} for i in range(len(jpreds))]
    n_tp = 0
    for c in range(3):
        s = np.sort(np.concatenate([p["scores"][p["labels"] == c]
                                    for p in jpreds]))[::-1]
        lowest = min(p["scores"].min() for p in jpreds)
        gaps = [k for k in range(1, len(s))
                if s[k - 1] - s[k] > 2 * SCORE_TOL
                and s[k] - lowest > 2 * SCORE_TOL]
        assert gaps, f"no score cut with a margin for class {c}"
        cut = s[gaps[len(gaps) // 2] - 1]
        for i, p in enumerate(jpreds):
            m = (p["labels"] == c) & (p["scores"] >= cut)
            gts[i]["boxes"].append(p["boxes"][m])
            gts[i]["labels"].append(np.full(m.sum(), c))
            n_tp += m.sum()
    gts = [{k: np.concatenate(v) for k, v in g.items()} for g in gts]
    assert n_tp >= 6

    dataset, classes = test_cli.build_test_dataset(cfg, model, True, 4)

    class WithGT:
        def __len__(self):
            return len(dataset)

        def __getitem__(self, i):
            s = dataset[i]
            g = gts[i]
            n = len(g["labels"])
            s["gt_boxes"] = np.zeros_like(s["gt_boxes"])
            s["gt_boxes"][:n] = g["boxes"]
            s["gt_labels"] = np.zeros_like(s["gt_labels"])
            s["gt_labels"][:n] = g["labels"]
            s["gt_valid"] = np.arange(len(s["gt_valid"])) < n
            return s

    loader = DataLoader(WithGT(), batch_size=1, shuffle=False,
                        drop_last=False, num_workers=1)
    preds, tgts = test_cli.run_predictions(model, loader, "cpu")
    assert len(preds) == 4
    for got_frame, jb in zip(loader, r["frames"]):  # the same points
        assert np.array_equal(got_frame.points.numpy(),
                              np.asarray(jb.points))
    for g, ref in zip(tgts, gts):
        assert np.array_equal(g["boxes"], ref["boxes"])
    for mode in ("3d", "bev"):
        ref = jeval_ap(copy.deepcopy(jpreds), gts, classes, mode=mode)
        got = eval_ap(preds, tgts, classes, mode=mode)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-6, (mode, k, got[k], ref[k])
        assert 0 < ref["mAP"] < 1


_GUARD = r"""
import runpy
import sys


class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "sst_tpu"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, _Blocked())
sys.modules["torch.utils.tensorboard"] = None  # absent on the card's machine
cfg, wd = sys.argv[1:3]
sys.argv = ["train", "--help"]
try:
    runpy.run_module("sst_tpu_torch.tools.train", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    assert e.code in (0, None), e.code
from sst_tpu_torch.tools import test, train

train.main([cfg, "--synthetic", "--device", "cpu", "--max-steps", "2",
            "--work-dir", wd])
test.main([cfg, wd + "/ckpt_2", "--synthetic", "--device", "cpu",
           "--num-samples", "1", "--eval", "none"])
import importlib

for name in ("core.eval_nuscenes", "core.eval_argo2", "core.av2_map",
             "core.eval_kitti", "core.eval_lyft", "core.frames",
             "data.dbsampler", "data.format_writers", "data.datasets",
             "data.pipelines", "train.data_setup"):
    importlib.import_module("sst_tpu_torch." + name)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sst_tpu")))
"""


def test_clis_import_nothing_of_jax(tmp_path):
    """In a process where ``jax``, ``flax`` and ``sst_tpu`` cannot be
    imported (nor TensorBoard, as on the card's machine),
    ``python -m sst_tpu_torch.tools.train --help`` prints the
    torchrun note, a two-step ``--device cpu`` run and the test CLI on
    its checkpoint complete, and the nuScenes / Argo2 / KITTI / Lyft data
    and evaluation modules import; no such module enters
    ``sys.modules``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _GUARD, TINY_CFG,
                          str(tmp_path / "wd")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    assert "torchrun" in res.stdout and "step 1/2 loss=" in res.stdout
    assert os.path.isdir(tmp_path / "wd" / "ckpt_2")
