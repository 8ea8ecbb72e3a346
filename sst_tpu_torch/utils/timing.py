"""Timing on the card with CUDA events, and the card's identity.

Used by ``chip_smoke.py`` and ``sst_tpu_torch/tools/profile_predict.py``;
every number they keep stands beside :func:`card_name_and_power_limit`.
"""

from __future__ import annotations

import statistics
import subprocess

import torch


def event_ms(fn) -> float:
    """CUDA-event time of one ``fn()`` on the current stream, in ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    return statistics.median(event_ms(fn) for _ in range(reps))


def card_name_and_power_limit() -> str:
    """The first card's line of
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def disable_tf32() -> None:
    """Full float32 for cuDNN convolutions and matmuls (both default to TF32
    on Hopper), so timings and comparisons are of the f32 model."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
