"""Lowe-format SIFT key file I/O.

Format (reference doc at `src/keys2a.h:81-89`): header line with two ints —
number of keys and descriptor length (128) — then, per key, one line of four
floats ``row col scale orientation`` (orientation in [-pi, pi]) followed by the
128 descriptor values as integers in [0, 255] wrapped over several lines.
Files may be gzip-compressed (``.gz``; reference `ReadKeysGzip`,
`src/keys2a.cpp`).

Coordinate convention: the file stores (row, col) in top-left-origin image
coordinates.  The reference flips y and centers the origin on load
(`src/ImageData.cpp:817-843`):

    x_c = col - 0.5*(W-1)
    y_c = (H - row - 1) - 0.5*(H-1)

`keys_to_centered` applies that transform; everything downstream of the loader
works in centered coordinates, as in the reference.
"""

from __future__ import annotations

import gzip
import io as _io
import os
from typing import Tuple

import numpy as np


def _open_maybe_gzip(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def resolve_key_path(path: str) -> str:
    """Accept `foo.key`, `foo.key.gz`, `foo.key.bin`, or `foo.key.bin.gz` —
    the fallback chain of `ReadKeyFileWithDesc` (src/keys.cpp:107-129)."""
    if os.path.exists(path):
        return path
    for suffix in (".gz", ".bin", ".bin.gz"):
        if os.path.exists(path + suffix):
            return path + suffix
    if path.endswith(".gz") and os.path.exists(path[:-3]):
        return path[:-3]
    raise FileNotFoundError(path)


def _parse_key_bin(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Binary key layout (`ReadKeysFastBin`, src/keys.cpp): int32 count,
    count × keypt_t{float32 x, y, scale, orient} (src/keys.h:134-138), then
    count × 128 uint8 descriptors."""
    n = int(np.frombuffer(data, np.int32, 1, 0)[0])
    info = np.frombuffer(data, np.float32, n * 4, 4).reshape(n, 4).copy()
    desc = np.frombuffer(data, np.uint8, n * 128, 4 + n * 16
                         ).reshape(n, 128).copy()
    return info, desc


def write_key_file_bin(path: str, info: np.ndarray, desc: np.ndarray
                       ) -> None:
    """Write the ReadKeysFastBin layout.  `info` rows are (x, y, scale,
    orient) — note the text format stores y first; the binary struct stores
    x first (src/keys.h:134-138)."""
    n = len(info)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(np.int32(n).tobytes())
        f.write(np.ascontiguousarray(info, dtype=np.float32).tobytes())
        f.write(np.ascontiguousarray(desc, dtype=np.uint8).tobytes())


def read_key_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a key file.

    Returns:
      info: float32 [n, 4] — (x=col, y=row, scale, orientation), raw image coords.
      desc: uint8 [n, 128] descriptors.
    """
    path = resolve_key_path(path)
    with _open_maybe_gzip(path) as f:
        data = f.read()
    if path.endswith((".bin", ".bin.gz")):
        return _parse_key_bin(data)
    # Prefer the native single-pass tokenizer (native/keyio.cc, ~50x).
    # A file it cannot tokenize (e.g. descriptors written `12.0`) falls
    # through to the numpy parser, as in the JAX package.
    from bundler_sfm_tpu_torch import native
    if native.available():
        try:
            return native.parse_key_bytes(data)
        except ValueError:
            pass
    # Otherwise: one vectorized pass over whitespace-separated tokens.
    vals = np.array(data.split(), dtype=np.float64)
    n = int(vals[0])
    dim = int(vals[1])
    if dim != 128:
        raise ValueError(f"descriptor length {dim} != 128 in {path}")
    body = vals[2:]
    expected = n * (4 + dim)
    if body.size < expected:
        raise ValueError(f"truncated key file {path}: {body.size} < {expected}")
    body = body[:expected].reshape(n, 4 + dim)
    row = body[:, 0].astype(np.float32)
    col = body[:, 1].astype(np.float32)
    scale = body[:, 2].astype(np.float32)
    ori = body[:, 3].astype(np.float32)
    info = np.stack([col, row, scale, ori], axis=1)
    desc = body[:, 4:].astype(np.uint8)
    return info, desc


def write_key_file(path: str, info: np.ndarray, desc: np.ndarray) -> None:
    """Write a key file in the Lowe text format (gzip if path ends with .gz).

    `info` is [n,4] (x=col, y=row, scale, ori) in raw image coordinates.
    """
    n = info.shape[0]
    buf = _io.StringIO()
    buf.write(f"{n} 128\n")
    for i in range(n):
        x, y, s, o = info[i]
        buf.write(f"{y:.2f} {x:.2f} {s:.3f} {o:.3f}\n")
        d = desc[i]
        for start in range(0, 128, 20):
            chunk = d[start:start + 20]
            buf.write(" " + " ".join(str(int(v)) for v in chunk) + "\n")
    payload = buf.getvalue().encode("ascii")
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def keys_to_centered(info: np.ndarray, width: int, height: int) -> np.ndarray:
    """Image coords (x=col, y=row) → flipped-y, center-origin coords.

    Mirrors `src/ImageData.cpp:830-843` (the no-descriptor path, which is the
    one used by the reconstruction pipeline).
    """
    out = info.copy()
    out[:, 0] = info[:, 0] - 0.5 * (width - 1)
    out[:, 1] = (height - info[:, 1] - 1.0) - 0.5 * (height - 1)
    return out


def centered_to_image(xy: np.ndarray, width: int, height: int) -> np.ndarray:
    """Inverse of `keys_to_centered` for the (x, y) columns."""
    out = np.asarray(xy, dtype=np.float64).copy()
    out[..., 0] = xy[..., 0] + 0.5 * (width - 1)
    out[..., 1] = height - 1.0 - (xy[..., 1] + 0.5 * (height - 1))
    return out
