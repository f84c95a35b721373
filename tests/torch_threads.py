"""Torch's intra-op threads for the port's CPU tests under pytest-xdist.

Every xdist worker imports every test module while collecting, and torch
gives each process one intra-op thread per core: six workers on eight
cores then run 48 OpenMP threads that spin against each other, and a
conv-heavy test takes minutes instead of seconds. Imported by each
tests/test_torch_*.py, this shares the cores among the workers
(PYTEST_XDIST_WORKER_COUNT, which xdist sets in them); a run without
xdist keeps torch's default."""

import os

import torch


def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


share_cores()
