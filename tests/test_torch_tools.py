"""The port's preflight, benchmark and soak tools, the phase timer and the
train CLI's TensorBoard scalars, on the CPU (no JAX model).

- ``utils/preflight.py preflight_kernels`` refuses a CPU device: the
  kernels run only on a card. Its checks, run on CPU tensors (each kernel
  wrapper then takes its twin), meet their tolerances with no error.
- ``tools/analysis_tools/benchmark.py`` on configs/sst/sst_tiny_synthetic.py
  with ``--device cpu``: JAX's last-line keys, positive fps and latency,
  the preflight skipped.
- ``tools/soak.py`` on that config: every invariant holds over 4 steps at
  300 points (within the config's caps), and at 2,048 points the
  overflow and dropped counters break it.
- ``utils/timer.py Timer``: running averages per name, the print interval.
- The train CLI writes its scalars under ``work_dir/tb``.
"""

from __future__ import annotations

import glob
import json
import os
import sys

import pytest
import torch
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/sst/sst_tiny_synthetic.py")


def test_preflight_refuses_the_cpu():
    from sst_tpu_torch.utils.preflight import preflight_kernels

    with pytest.raises(RuntimeError, match="CUDA card"):
        preflight_kernels("cpu")


def test_preflight_checks_run_on_the_twins():
    from sst_tpu_torch.utils import preflight as pf

    assert pf.check_window_mha("cpu") == 0.0
    assert pf.check_sorted_reduce("cpu") == 0.0


def test_benchmark_tool_on_the_cpu(capsys):
    from sst_tpu_torch.tools.analysis_tools import benchmark

    res = benchmark.main([TINY, "--samples", "3", "--warmup", "1",
                          "--num-points", "2048", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(last) == ["config", "fps", "num_points", "p50_latency_ms"]
    assert last["num_points"] == 2048 and last["fps"] > 0
    assert last["p50_latency_ms"] > 0
    assert res["preflight"] is None and len(res["predict_ms"]) == 3


def test_soak_holds_its_invariants_on_the_cpu(tmp_path):
    from sst_tpu_torch.tools import soak

    out = tmp_path / "soak.json"
    log = soak.main(["--config", TINY, "--steps", "4", "--num-points", "300",
                     "--scene-pool", "2", "--device", "cpu", "--out",
                     str(out)])
    assert log["ok"] and not log["failures"]
    assert len(log["losses"]) == 4 and log["steady_step_ms_mean"] > 0
    assert all(c == log["launches"][2] for c in log["launches"])
    assert set(log["overflow_keys"]) == {"num_voxel_overflow_points",
                                         "num_window_dropped_voxels"}
    saved = json.loads(out.read_text())
    assert saved[TINY]["ok"]


def test_soak_fails_on_dropped_voxels(tmp_path, capsys):
    """2,048 points fill more than the tiny config's 512 voxels: the
    overflow counter is non-zero, the soak fails (the module's
    ``__main__`` then exits 1) and says why."""
    from sst_tpu_torch.tools import soak

    log = soak.main(["--config", TINY, "--steps", "2", "--num-points",
                     "2048", "--scene-pool", "1", "--device", "cpu",
                     "--out", str(tmp_path / "soak.json")])
    out = capsys.readouterr().out
    assert not log["ok"] and "SOAK FAILED" in out
    assert any("num_voxel_overflow_points" in f for f in log["failures"])


def test_timer_averages_and_prints(capsys):
    from sst_tpu_torch.utils.timer import Timer

    timer = Timer(print_interval=2)
    for _ in range(4):
        with timer("a", torch.zeros(3)):
            pass
    with timer("b") as holder:
        holder["out"] = {"x": torch.ones(2)}
    summary = timer.summary()
    assert set(summary) == {"a", "b"} and timer.counts["a"] == 4
    assert capsys.readouterr().out.count("[timer] a: avg") == 2
    with Timer(enabled=False)("c"):
        pass


def test_train_cli_writes_tensorboard_scalars(tmp_path):
    pytest.importorskip("tensorboard")
    from sst_tpu_torch.tools import train

    wd = tmp_path / "wd"
    train.main([TINY, "--synthetic", "--device", "cpu", "--max-steps", "2",
                "--log-interval", "1", "--work-dir", str(wd)])
    events = glob.glob(str(wd / "tb" / "events.out.tfevents.*"))
    assert len(events) == 1 and os.path.getsize(events[0]) > 0
    lines = (wd / "train_log.jsonl").read_text().splitlines()
    assert len(lines) == 2


def test_tensorboard_writer_off_where_it_does_not_import(monkeypatch,
                                                         capsys, tmp_path):
    """Where ``tensorboard`` does not import (the card's machine), the CLI
    says the writer is off and writes only ``train_log.jsonl``."""
    from sst_tpu_torch.tools import train

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert train.open_tensorboard(str(tmp_path)) is None
    assert "tensorboard writer disabled" in capsys.readouterr().out
    train.write_scalars(None, {"loss": 1.0}, 1)  # a no-op
    assert not (tmp_path / "tb").exists()
