"""The operation and byte counts equal hand sums at small shapes."""

import json

import numpy as np
import pytest

from portbench import harness

PEAKS = {"bf16_flops": 1e12, "hbm_bytes": 1e9}


def _module(name):
    return harness.load_module(harness.HERE / "configs" / f"{name}.py",
                               f"portbench_test_{name}")


def test_unet_convs_by_hand():
    m = _module("fsdv2_dense_bf16")
    got = m._unet(10, [[8, 8], [16]], [8], 6, 32)
    assert got == [(10, 8, 3, 1, 32, 32), (8, 8, 3, 1, 32, 32),
                   (8, 16, 3, 2, 16, 16),
                   (16, 8, 3, 1, 32, 32), (8, 8, 1, 1, 32, 32),
                   (8, 8, 3, 1, 32, 32), (8, 6, 3, 1, 32, 32)]
    assert m.conv_flops([(10, 8, 3, 1, 32, 32)]) == 2 * 9 * 10 * 8 * 32 * 32
    # a 1x1 conv at this size is bound by bytes, a 3x3 one by operations
    one = (8, 8, 1, 1, 32, 32)
    assert m.conv_bound_s([one], PEAKS) == pytest.approx(
        2 * (8 * 1024 + 64 + 8 * 1024) / 1e9)
    s2 = (8, 16, 3, 2, 16, 16)
    assert m.conv_bound_s([s2], PEAKS) == pytest.approx(max(
        2 * 9 * 8 * 16 * 256 / 1e12,
        2 * (8 * 256 * 4 + 9 * 8 * 16 + 16 * 256) / 1e9))


def test_flagship_conv_count_at_its_widths():
    m = _module("fsdv2_dense_bf16")
    cfg = json.loads((harness.HERE / "configs" / "fsdv2_dense_bf16.json")
                     .read_text())
    convs = m.conv_list(cfg)
    assert len(convs) == 18 + 8  # segmentor UNet, mixer UNet
    assert convs[0] == (100, 64, 3, 1, 640, 640)  # 4 bands x (24 + 1)
    assert convs[18] == (384, 128, 3, 1, 320, 320)  # 12 slices x 32
    assert m.conv_flops(convs) == pytest.approx(969.9328e9)


def test_attention_and_forward_counts_by_hand():
    m = _module("sst_bf16")
    cfg = json.loads((harness.HERE / "configs" / "sst_bf16.json")
                     .read_text())
    counts = {"points": 1000, "voxels": 100,
              "fills": [[np.array([2.0, 3.0])], [np.array([4.0])]]}
    flops, byts = m.attention_work(cfg, counts)
    c, blocks = 128, 6
    assert flops == blocks * 4 * c * (4 + 9 + 16)
    assert byts == blocks * 4 * c * 2 * (2 + 3 + 4)
    fwd = m.forward_flops(cfg, counts)
    vfe = 2 * 1000 * (11 * 64 + 128 * 128)  # 5 features + 6 offsets
    sst = 6 * 2 * 2 * (128 * 256 + 128 * 128 * 2 + 128 * 256 * 2) * 100
    convs = 3 * 2 * 9 * 128 * 128 * 468 * 468
    fpn = 2 * 128 * 384 * 468 * 468
    head = 2 * 384 * 6 * (3 + 7 + 2) * 468 * 468
    assert fwd == pytest.approx(vfe + sst + flops + convs + fpn + head)


def test_mha_bound_counts_forward_and_recompute():
    m = _module("sst_bf16")
    cfg = json.loads((harness.HERE / "configs" / "sst_bf16.json")
                     .read_text())
    counts = {"points": 1, "voxels": 1,
              "fills": [[np.array([10.0])], [np.array([10.0])]]}
    record = {"_counts": [counts], "profiled_requests": [[0], [0]]}
    flops, byts = m.attention_work(cfg, counts)
    one = max(flops / PEAKS["bf16_flops"], byts / PEAKS["hbm_bytes"])
    assert m.mha_bound_s(cfg, record, PEAKS) == pytest.approx(2 * 2 * one)
