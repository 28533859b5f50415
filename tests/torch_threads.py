"""Size torch's CPU thread pool to this process's share of the cores.

Imported by every ``tests/test_torch_*.py``. Under pytest-xdist each of
the N workers would otherwise start a pool of one thread per core, so
N x cores OpenMP threads spin for the same cores and a port test runs
5-40 times slower than alone. A worker takes cores // N threads (at
least one); a run without xdist keeps torch's default.
"""

import os

import torch


def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


share_cores()
