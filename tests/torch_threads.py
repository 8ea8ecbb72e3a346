"""One share of the cores for torch in each pytest-xdist worker.

Under ``pytest -n N`` each worker is a process whose torch takes every core
for its intra-op threads, so N workers run N times as many threads as there
are cores and spin on each other: a CPU test of the port that took 14 s in
each of six concurrent processes at one thread took 194 s at torch's
default. The port's test modules import the autouse fixture below, which
gives torch the worker's share of the cores for the module and puts the old
count back after it. Outside xdist it changes nothing.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers <= 1:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, before // workers))
    try:
        yield
    finally:
        torch.set_num_threads(before)
