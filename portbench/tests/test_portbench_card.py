"""On the card, at the cells' own sizes: each cell's run is correct, and
each cell's control (the reference with fp8 products and maps in the
port's place) and each fault that ``readings`` plants fail a compared
number on three seeds while the port passes them all. Skipped without a
card; on the card: ``python -m pytest -m cuda portbench/tests``."""

import json

import pytest

from portbench import harness, run

CELLS = ["fsdv2_dense_bf16.predict_b4", "sst_bf16.train_b1"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct(card, capsys, workload):
    rc = run.main(["--workload", workload, "--seed", "3900000011",
                   "--seconds", "5", "--trace", "0"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_and_the_port_passes(card, workload):
    cell = harness.Cell(workload)
    limits = cell.config_module.LIMITS
    for seed in (3900000021, 3900000022, 3900000023):
        sides = dict(cell.config_module.readings(cell, seed, card))
        assert all(sides["program"][k] <= lim for k, lim in limits.items())
        for side, nums in sides.items():
            if side != "program":
                assert any(nums[k] > lim for k, lim in limits.items()), \
                    (side, nums)
