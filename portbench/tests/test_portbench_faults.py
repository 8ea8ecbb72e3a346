"""A run whose timed path is broken underneath comes out not correct, for
each fault a cell can have, and so does the control: the plain reference
computed with fp8 products in the port's place. The run skips its look for
a card and drives the rest on the CPU at tiny sizes (``data/``)."""

import json

import pytest

from portbench import harness, run


def _run(spec, workload, capsys, seed=4100000123):
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0.5", "--trace", "0"], spec_path=spec,
                  on_cpu=True)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_runs_are_correct(on_cpu, capsys):
    for workload in ("fsdv2_tiny.predict", "sst_tiny.train"):
        line = _run(on_cpu, workload, capsys)
        assert line["correct"], line["checks"]
        assert list(line)[-1] == "checks"


def _predict_with(monkeypatch, edit):
    from sst_tpu_torch.models.fsd.fsdv2 import SingleStageFSDV2

    inner = SingleStageFSDV2.predict

    def predict(self, batch):
        return edit({k: v.clone() for k, v in inner(self, batch).items()})

    monkeypatch.setattr(SingleStageFSDV2, "predict", predict)


def test_half_the_batch_left_out(on_cpu, capsys, monkeypatch):
    def drop(res):
        half = res["valid"].shape[0] // 2
        res["valid"][:half] = False
        return res

    _predict_with(monkeypatch, drop)
    assert not _run(on_cpu, "fsdv2_tiny.predict", capsys)["correct"]


def test_an_answer_altered_where_it_is_produced(on_cpu, capsys,
                                                monkeypatch):
    def shift(res):
        res["boxes"][..., 0] += 2.0
        return res

    _predict_with(monkeypatch, shift)
    assert not _run(on_cpu, "fsdv2_tiny.predict", capsys)["correct"]


@pytest.mark.parametrize("nms_thr", [1.5, 0.5], ids=["no_suppression",
                                                    "threshold_doubled"])
def test_an_nms_that_suppresses_too_little(on_cpu, capsys, monkeypatch,
                                           nms_thr):
    """The port's NMS run with no suppression (no IoU passes 1.5), or
    at twice the configuration's threshold."""
    from sst_tpu_torch.models.fsd.fsdv2 import SingleStageFSDV2

    inner = SingleStageFSDV2.predict

    def predict(self, batch):
        saved = self.test_cfg
        self.test_cfg = dict(saved, nms_thr=nms_thr)
        try:
            return inner(self, batch)
        finally:
            self.test_cfg = saved

    monkeypatch.setattr(SingleStageFSDV2, "predict", predict)
    line = _run(on_cpu, "fsdv2_tiny.predict", capsys)
    assert not line["correct"], line["checks"]


def test_a_step_that_leaves_the_state_unchanged(on_cpu, capsys,
                                                 monkeypatch):
    from sst_tpu_torch.train.state import ClippedAdamW

    def step(self, reduce_grads=None):
        return self.params[0].new_zeros(())

    monkeypatch.setattr(ClippedAdamW, "step", step)
    assert not _run(on_cpu, "sst_tiny.train", capsys)["correct"]


def test_a_loss_altered_where_it_is_produced(on_cpu, capsys, monkeypatch):
    from sst_tpu_torch.models import DynamicVoxelNet

    inner = DynamicVoxelNet.loss

    def loss(self, *a, **k):
        return {n: v * 1.5 if n.startswith("loss") else v
                for n, v in inner(self, *a, **k).items()}

    monkeypatch.setattr(DynamicVoxelNet, "loss", loss)
    assert not _run(on_cpu, "sst_tiny.train", capsys)["correct"]


@pytest.mark.parametrize("workload", ["fsdv2_tiny.predict", "sst_tiny.train"])
def test_the_control_is_not_correct(on_cpu, capsys, monkeypatch, workload):
    """The reference with fp8 products and maps, built from the cell's
    sizes, put in the port's place: its run fails a compared number."""
    from portbench.ref.precision import lower_precision

    cell = harness.Cell(workload, on_cpu)
    cfgm = cell.config_module

    def build(cfg, traffic, device):
        ref = cfgm.build_reference(cfg, traffic, device)
        ref.max_points = cfg["max_points"]
        for name in ("predict", "loss"):
            inner = getattr(ref, name)

            def wrapped(*a, _inner=inner, **k):
                with lower_precision():
                    return _inner(*a, **k)

            setattr(ref, name, wrapped)
        return ref

    monkeypatch.setattr(harness, "load_module", _patched_loader(
        harness.load_module, cfgm, build))
    line = _run(on_cpu, workload, capsys)
    assert not line["correct"], line["checks"]


def _patched_loader(load, cfgm, build):
    def loader(path, name):
        mod = load(path, name)
        if getattr(mod, "__file__", None) == cfgm.__file__:
            mod.build = build
        return mod
    return loader
