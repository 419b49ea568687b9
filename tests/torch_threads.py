"""One PyTorch intra-op thread for a test module of the port's CPU tests.

The tier-1 suite runs six pytest-xdist workers, and PyTorch starts one
OpenMP thread per core in each: the workers then oversubscribe the cores so
far that a 240x320 force forward takes ~16 s instead of ~0.1 s (six such
processes at once on 8 cores, against one thread each).  A test module
imports ``single_torch_thread``; the count is restored when the module
ends, so the other modules a worker runs keep theirs.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
