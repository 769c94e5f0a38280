"""The least time the H100 could take for the 2-NN work, and its peaks.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): 989 TFLOP/s bf16, 1979 TOP/s int8, 3.35 TB/s
of HBM3.  A card set below 700 W runs slower under load, so every share
of these peaks is reported beside the card's power limit.

The 2-NN work of one image pair of n_q query keys and n_db database keys
(128-entry descriptors) is 2·128·n_q·n_db int8 operations (the distance
product), and at least both tables read once plus 12 bytes written per
query row (nearest index, nearest and second distance).  The counts are
the pair's real key counts, not padded rows, so they stay true whatever
computes the match.
"""

from __future__ import annotations

import subprocess
from typing import Iterable, Optional, Tuple

INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
DESC_BYTES = 128
OUT_BYTES_PER_QUERY = 12


def two_nn_least_seconds(n_q: int, n_db: int) -> float:
    """The larger of the operations' and the bytes' least time for one
    pair."""
    ops = 2.0 * DESC_BYTES * n_q * n_db
    nbytes = (n_q + n_db) * DESC_BYTES + OUT_BYTES_PER_QUERY * n_q
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def pairs_least_seconds(counts, pairs: Iterable[Tuple[int, int]]) -> float:
    """Sum of `two_nn_least_seconds` over (query image, db image) pairs
    of images with `counts` keys."""
    return sum(two_nn_least_seconds(counts[a], counts[b]) for a, b in pairs)


def power_limit() -> Optional[str]:
    """nvidia-smi's name and power limit of each card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return "; ".join(out.splitlines())
