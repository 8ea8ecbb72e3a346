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


# ~0.25 ms of GPU clock: longer than a kernel wrapper's host time
QUEUE_CYCLES = 500_000


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms, after ``warmup`` calls. Each
    timed call is queued behind a ``torch.cuda._sleep``, so its kernels are
    already enqueued when its start event runs: the host's launch time
    (Python, checks, ctypes) stays out of a short kernel's time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(QUEUE_CYCLES)
        times.append(event_ms(fn))
    return statistics.median(times)


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
