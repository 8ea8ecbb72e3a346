"""Named phase timers (counterpart of ``sst_tpu/utils/timer.py``'s
``Timer``, the reference's TorchTimer): a context manager per phase name,
running averages, and a print every ``print_interval`` hits of a name.

    timer = Timer()
    with timer("predict", out) as h:   # or set h["out"] inside the block
        out = model.predict(batch)

A phase ends when the work it queued on the card has run: where the
tracked output (``out``, or ``h["out"]``) holds a tensor on a CUDA
device, that device is synchronised before the clock is read; where it
holds none, every card of the process is. On the CPU nothing waits. JAX's
``trace()`` (an xplane profile) has no counterpart: ``torch.profiler``
serves there (``tools/profile_predict.py``).
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in a nest of dicts, lists, tuples
    and dataclass-like objects."""
    found = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                found.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dict__"):
            for v in vars(x).values():
                walk(v)

    walk(out)
    return found


class Timer:
    """``with timer(name, out): ...``: wall time per phase name, averaged;
    the average is printed every ``print_interval`` hits of a name."""

    def __init__(self, print_interval: int = 20, enabled: bool = True):
        self.print_interval = print_interval
        self.enabled = enabled
        self.sums = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    @staticmethod
    def _drain(out) -> None:
        devices = _cuda_devices(out) if out is not None else set()
        if devices:
            for d in devices:
                torch.cuda.synchronize(d)
        elif torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def __call__(self, name: str, out=None):
        if not self.enabled:
            yield {}
            return
        holder = {}
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            self._drain(holder.get("out", out))
            self.sums[name] += time.perf_counter() - t0
            self.counts[name] += 1
            if self.counts[name] % self.print_interval == 0:
                avg = self.sums[name] / self.counts[name]
                print(f"[timer] {name}: avg {avg * 1e3:.2f} ms "
                      f"over {self.counts[name]} calls", flush=True)

    def summary(self) -> dict:
        """{name: mean seconds per hit}."""
        return {k: self.sums[k] / max(self.counts[k], 1) for k in self.sums}
