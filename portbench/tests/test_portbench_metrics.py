"""The metric arithmetic: a rate over the whole window, a p95 over all
requests, the idle share from the union of device intervals, and the
readers over a recorded run."""

import json
import math

import pytest

from portbench import harness


def test_rate_is_all_work_over_all_time():
    assert harness.rate(120, 40.0) == 3.0


def test_p95_is_nearest_rank_over_all_requests():
    xs = list(range(1, 201))  # 200 requests
    assert harness.percentile(xs, 95) == 190
    assert harness.percentile([5.0], 95) == 5.0
    assert harness.percentile([3, 1, 2, 4], 50) == 2


def test_union_and_idle_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert harness.union_seconds(iv) == 4
    assert harness.idle_gaps(iv, 0, 8) == [(3, 5), (6, 8)]



def test_readers_over_a_record(on_cpu):
    cell = harness.Cell("fsdv2_tiny.predict", on_cpu)
    peaks = json.loads((harness.HERE / "peaks.json").read_text())
    record = {"frames": 40, "window_s": 10.0, "latencies_s":
              [0.1] * 19 + [0.5], "spans": {
                  "segmentor": {"total_ms": 30.0, "count": 3},
                  "extract_feat": {"total_ms": 9.0, "count": 3},
                  "get_bboxes": {"total_ms": 60.0, "count": 3}},
              "profile": {"busy_s": 0.25, "window_s": 1.0,
                          "ranges_ms": {"conv": 2.0}, "kernels_ms": {}},
              "profiled_requests": [[0, 1]]}
    ctx = {"record": record, "cell": cell, "config": cell.config,
           "traffic": cell.traffic, "peaks": peaks, "setup_s": 7.5}

    def read(name):
        return cell.metric_reader(name).read(ctx)

    assert read("predict_frames_per_s") == 4.0
    assert read("predict_p95_ms") == pytest.approx(100.0)
    assert read("setup_s") == 7.5
    assert read("segmentor_ms.predict") == 10.0
    assert read("virtual_voxel_ms.predict") == 3.0
    assert read("decode_nms_ms.predict") == 20.0
    assert read("device_idle.predict") == 75.0
    m = cell.config_module
    bound = m.conv_bound_s(m.conv_list(cell.config), peaks)
    assert read("conv_roofline.predict") == pytest.approx(
        100.0 * bound * 2 * 1e3 / 2.0)
    record["profile"]["ranges_ms"] = {}
    assert read("conv_roofline.predict") is None  # nothing to read: silent
    record["profile"] = None
    assert read("device_idle.predict") is None


def test_every_metric_of_the_benchmark_has_a_reader():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists(), \
            m["name"]
    assert not math.isnan(harness.rate(1, 1))
