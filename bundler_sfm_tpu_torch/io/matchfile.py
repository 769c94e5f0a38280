"""matches.init.txt I/O.

Format (reference reader `src/BundleIO.cpp:112-166`, writer
`src/KeyMatchFull.cpp:131-142`): repeated records of

    i1 i2
    num_matches
    k1 k2        (num_matches lines of key-index pairs)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

MatchDict = Dict[Tuple[int, int], np.ndarray]  # (i1,i2) -> int32 [m, 2]


def read_match_file(path: str) -> MatchDict:
    matches: MatchDict = {}
    with open(path) as f:
        tokens = f.read().split()
    pos = 0
    n = len(tokens)
    while pos < n:
        i1, i2 = int(tokens[pos]), int(tokens[pos + 1])
        m = int(tokens[pos + 2])
        pos += 3
        flat = np.array(tokens[pos:pos + 2 * m], dtype=np.int32)
        pos += 2 * m
        matches[(i1, i2)] = flat.reshape(m, 2)
    return matches


def write_match_file(path: str, matches: MatchDict) -> None:
    with open(path, "w") as f:
        for (i1, i2), pairs in matches.items():
            f.write(f"{i1} {i2}\n{len(pairs)}\n")
            for a, b in pairs:
                f.write(f"{a} {b}\n")


def write_match_table(num_images: int, matches: MatchDict,
                      suffix: str = "", directory: str = ".") -> None:
    """Match-table snapshot: `nmatches<suffix>.txt` (N then the N×N count
    matrix, upper triangle populated) + `matches<suffix>.txt` (one line of
    `k1 k2 ...` per cell with i >= j or a matched i < j pair — the exact
    layout of `WriteMatchTable`, `src/BundleIO.cpp:1044-1095`, which the
    reference dumps at the .prune/.ransac/.corresp stages of
    `ComputeGeometricConstraints`, `src/BundlerGeometry.cpp:113,152,188`)."""
    import os
    with open(os.path.join(directory, f"nmatches{suffix}.txt"), "w") as f0, \
         open(os.path.join(directory, f"matches{suffix}.txt"), "w") as f1:
        f0.write(f"{num_images}\n")
        for i in range(num_images):
            for j in range(num_images):
                if i >= j:
                    f0.write("0 ")
                    f1.write("\n")
                elif (i, j) in matches:
                    pairs = matches[(i, j)]
                    f0.write(f"{len(pairs)} ")
                    f1.write("".join(f"{a} {b} " for a, b in pairs) + "\n")
                else:
                    f0.write("0 ")
            f0.write("\n")


def read_match_table(num_images: int, suffix: str = "",
                     directory: str = ".") -> MatchDict:
    """Inverse of `write_match_table` (`ReadMatchTable`,
    `src/BundleIO.cpp:976-1042`)."""
    import os
    with open(os.path.join(directory, f"nmatches{suffix}.txt")) as f0:
        tokens = f0.read().split()
    assert int(tokens[0]) == num_images
    counts = np.array(tokens[1:], dtype=np.int64).reshape(num_images,
                                                          num_images)
    matches: MatchDict = {}
    with open(os.path.join(directory, f"matches{suffix}.txt")) as f1:
        lines = iter(f1)
        for i in range(num_images):
            for j in range(num_images):
                if i >= j:
                    next(lines, "")
                elif counts[i, j] > 0:
                    flat = np.array(next(lines).split(), dtype=np.int32)
                    matches[(i, j)] = flat.reshape(-1, 2)
    return matches


def read_pair_match_files(match_dir: str, num_images: int,
                          min_matches: int = 16) -> MatchDict:
    """Per-pair `match-%03d-%03d.txt` files (`ReadMatchFile`,
    `src/BundleIO.cpp:62-110`): first line num_matches, then index pairs.
    Pairs with fewer than MIN_MATCHES (16) are skipped like the reference."""
    import os
    matches: MatchDict = {}
    for i in range(num_images):
        for j in range(i + 1, num_images):
            path = os.path.join(match_dir, f"match-{i:03d}-{j:03d}.txt")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                toks = f.read().split()
            m = int(toks[0])
            if m < min_matches:
                continue
            matches[(i, j)] = np.array(toks[1:1 + 2 * m],
                                       dtype=np.int32).reshape(m, 2)
    return matches


def read_match_indexes(index_dir: str, num_images: int) -> MatchDict:
    """Per-image `match-%03d.txt` index files (`LoadMatchIndexes`,
    `src/BundleIO.cpp:168-234`): repeated blocks of
    `j`, `num_matches`, then num_matches `k1 k2` lines."""
    import os
    matches: MatchDict = {}
    for i in range(num_images):
        path = os.path.join(index_dir, f"match-{i:03d}.txt")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            toks = f.read().split()
        pos = 0
        while pos + 1 < len(toks):
            j = int(toks[pos]); m = int(toks[pos + 1]); pos += 2
            flat = np.array(toks[pos:pos + 2 * m], dtype=np.int32)
            pos += 2 * m
            key = (i, j) if i < j else (j, i)
            pairs = flat.reshape(m, 2)
            matches[key] = pairs if i < j else pairs[:, ::-1]
    return matches
