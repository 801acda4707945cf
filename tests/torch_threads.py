"""A pytest fixture for the port's CPU tests. Under pytest-xdist every
worker runs torch with its default of one intra-op thread per core, so
the workers together oversubscribe the CPU, and OpenMP's waiting threads
then slow a small training step by one to two orders of magnitude (six
workers on eight cores: test_training_reduces_loss took 312.8 s against
7.6 s in a run of its own). Importing ``share_the_cores`` into a test
module gives its worker an equal share of the cores while the module
runs; a run without workers keeps them all.
"""
import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def share_the_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    share = max(1, len(os.sched_getaffinity(0)) // workers)
    torch.set_num_threads(min(before, share))
    yield
    torch.set_num_threads(before)
