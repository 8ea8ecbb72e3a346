"""Fixtures of the benchmark's CPU tests: the run's CUDA calls replaced
where a test drives a whole run on the CPU at tiny sizes, and the card
looked for inside a fixture (never at import)."""

import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

DATA = Path(__file__).resolve().parent / "data"
SPEC = DATA / "BENCHMARK.json"


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU: host time."""

    def __init__(self, **_):
        self.t = None

    def record(self, *_):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3

    def synchronize(self):
        pass


@pytest.fixture
def on_cpu(monkeypatch):
    """A run's CUDA calls made harmless on the CPU, and few threads."""
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield SPEC
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
