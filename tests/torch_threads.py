"""PyTorch's CPU threads in the port's tests.

Under pytest-xdist each worker process would run PyTorch's OpenMP pool
at the machine's width, so that workers x threads oversubscribe the
cores, and the pools' spin-waiting threads then slow the many small ops
of a decode or a CLI run by an order of magnitude (four of the port's
test files under 6 workers on an 8-core CPU: 528 s at PyTorch's default
of 8 threads, 83 s at 1). The port's test modules import the autouse
fixture below, which gives each test the worker's share of the cores
and puts PyTorch's own setting back after it. A run without xdist keeps
every core."""

import os

import pytest
import torch


def share() -> int:
    """The cores of one test process: all of them, or under pytest-xdist
    (PYTEST_XDIST_WORKER_COUNT) an equal share, at least one."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(1, workers))


@pytest.fixture(autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(share())
    yield
    torch.set_num_threads(before)
