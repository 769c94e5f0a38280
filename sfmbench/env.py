"""The process environment every benchmark process sets before it imports
NumPy or PyTorch: caches of the program's libraries inside the checkout,
at fixed paths (the port's nvcc libraries go to build/kernels/ already),
no Flax through any library, and a fixed number of host threads on as
many fixed cores (the host's cores are shared, and a job's host-bound
loop moves with every thread it competes with)."""

from __future__ import annotations

import os

THREADS = 2          # the fastest of 2, 4 and 8 in one call on the card's host
HOST_CORES = None    # the cores the process was given, before pinning


def pin(root: str) -> None:
    global HOST_CORES
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        root, "build", "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    HOST_CORES = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, HOST_CORES[-THREADS:])
