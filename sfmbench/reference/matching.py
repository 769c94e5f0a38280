"""KeyMatchFull's matching, written plainly (`src/KeyMatchFull.cpp:59-151`,
`src/keys2a.cpp:347-377`, `src/MatchTracks.cpp:394-452`).

For a pair (a, b), every key of image a queries image b: its nearest and
second-nearest key by squared L2 distance, exact (ties to the lowest
index); the match is kept when `d0 < ratio² · d1`; of the queries that
claim one key of b, the first (lowest index) is kept; a pair with fewer
than `min_matches` matches is dropped.

The distances are computed in float64 from the uint8 entries, so they are
exact integers.  The ratio product is taken in float32, as
`ratio*ratio` rounded to float32 times d1 rounded to float32: that is how
the port states the test (its distances are exact integers below 2**24,
and the product is the only rounding), and the two differ from a float64
product only where d0 lies within 0.2 of ratio²·d1.

`bits` < 8 keeps only the top `bits` of each entry (entry >> (8 - bits)):
the lower-precision control that `sfmbench/control.py` runs at 4 bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def match_pair(q: np.ndarray, db: np.ndarray, ratio: float,
               min_matches: int, device="cpu", bits: int = 8
               ) -> Optional[np.ndarray]:
    """int32 [m, 2] (query index, db index) in ascending query order, or
    None where the pair keeps fewer than `min_matches` matches."""
    if len(q) == 0 or len(db) == 0:
        return None
    shift = 8 - bits
    a = torch.as_tensor(np.asarray(q, np.uint8) >> shift, device=device
                        ).to(torch.float64)
    b = torch.as_tensor(np.asarray(db, np.uint8) >> shift, device=device
                        ).to(torch.float64)
    d = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    i0 = torch.argmin(d, dim=1)                    # first of equal minima
    rows = torch.arange(len(a), device=d.device)
    d0 = d[rows, i0]
    d[rows, i0] = float("inf")
    d1 = d.min(dim=1).values if d.shape[1] > 1 else torch.full_like(d0, 3e38)
    rs = torch.tensor(ratio * ratio, dtype=torch.float32, device=d.device)
    accept = d0.float() < rs * d1.float().clamp(max=3e38)
    qi = torch.nonzero(accept).flatten().cpu().numpy()
    di = i0[accept].cpu().numpy()
    # Keep-first: qi is ascending, so np.unique's first occurrence of each
    # db index is the lowest query claiming it.
    _, first = np.unique(di, return_index=True)
    keep = np.sort(first)
    if len(keep) < min_matches:
        return None
    return np.stack([qi[keep], di[keep]], axis=1).astype(np.int32)
