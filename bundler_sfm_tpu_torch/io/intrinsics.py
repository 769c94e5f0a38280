"""Known-intrinsics file support; a copy of the JAX package's host-only
module.

Reference `ReadIntrinsicsFile` (`src/BundleIO.cpp:1297-1360`): the file holds
N intrinsics records (K as 9 floats, then 5 distortion coefficients); each
image is assigned the record whose focal is closest to its EXIF estimate.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Intrinsics:
    K: np.ndarray   # [3,3]
    k: np.ndarray   # [5] distortion (k1, k2, p1, p2, k3)

    @property
    def focal(self) -> float:
        return 0.5 * (self.K[0, 0] + self.K[1, 1])


def read_intrinsics_file(path: str) -> List[Intrinsics]:
    with open(path) as f:
        tokens = f.read().split()
    pos = 0
    n = int(tokens[pos]); pos += 1
    out = []
    for _ in range(n):
        K = np.array(tokens[pos:pos + 9], dtype=np.float64).reshape(3, 3)
        pos += 9
        k = np.array(tokens[pos:pos + 5], dtype=np.float64)
        pos += 5
        out.append(Intrinsics(K=K, k=k))
    return out


def assign_intrinsics(intrinsics: List[Intrinsics],
                      init_focals: List[float]) -> List[Optional[Intrinsics]]:
    """Per image, the record with the nearest focal (reference behavior:
    requires an init focal per image)."""
    out: List[Optional[Intrinsics]] = []
    for f in init_focals:
        if f <= 0 or not intrinsics:
            out.append(None)
            continue
        best = min(intrinsics, key=lambda I: abs(I.focal - f))
        out.append(best)
    return out
