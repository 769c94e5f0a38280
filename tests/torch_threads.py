"""One torch intra-op thread per pytest-xdist worker.

Every `tests/test_torch_*.py` imports this module first.  Under xdist
(`-n N`) the N workers share the host's cores, and each worker's torch
would start an intra-op pool of one thread per core: N times the cores in
spinning threads, so every small CPU op waits at its pool's barrier.  A
worker knows it is one by `PYTEST_XDIST_WORKER`; in one process (the card
runs, or `pytest` without `-n`) torch keeps its default.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
