"""Lowe-format `.key` text files, as SIFT++ / ToSift write them
(`src/keys2a.h`: a header "<n> 128", then per key a line "row col scale
orientation" and its 128 descriptor entries, 20 to a line), written with
one vectorized pass per file instead of a Python loop over the entries."""

from __future__ import annotations

import numpy as np

# " %3d" for 0..255: every entry is four bytes wide.
_LUT = np.frombuffer(b"".join(b" %3d" % v for v in range(256)),
                     np.uint8).reshape(256, 4)


def key_file_bytes(info: np.ndarray, desc: np.ndarray) -> bytes:
    """The file's bytes for `info` [n, 4] (x=col, y=row, scale, ori) and
    uint8 `desc` [n, 128]."""
    n = len(desc)
    heads = [b"%.2f %.2f %.3f %.3f\n" % (y, x, s, o)
             for x, y, s, o in np.asarray(info, np.float64)]
    parts = []
    for start in range(0, 128, 20):
        chunk = _LUT[np.asarray(desc[:, start:start + 20], np.uint8)]
        parts.append(chunk.reshape(n, -1))
        parts.append(np.full((n, 1), ord("\n"), np.uint8))
    body = np.concatenate(parts, axis=1)
    out = [b"%d 128\n" % n]
    for h, row in zip(heads, body):
        out.append(h)
        out.append(row.tobytes())
    return b"".join(out)


def write_key_file(path: str, info: np.ndarray, desc: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(key_file_bytes(info, desc))
