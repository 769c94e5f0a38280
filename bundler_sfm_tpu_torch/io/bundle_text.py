"""The text of `bundle.out` and of the points PLY from flat arrays in one
host C++ call (`csrc/bundle_text.cc`), byte for byte what the reference's
writers (and the JAX package's, one Python f-string a field) write.

The library is built with the host compiler at first use into
`build/kernels/` (`csrc_build.py`, keyed by the hash of the source and
flags); a failed build raises.  ctypes releases the interpreter lock for
the call.
"""

from __future__ import annotations

import ctypes

import numpy as np

from bundler_sfm_tpu_torch.csrc_build import build

SOURCE = "bundle_text.cc"

_lib = None


def load():
    """The formatter's library, built at the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build(SOURCE))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bundle_text_bundle.argtypes = [i, ll, p, ll, p, p, p, p, p]
        lib.bundle_text_bundle.restype = i
        lib.bundle_text_ply.argtypes = [i, ll, p, p]
        lib.bundle_text_ply.restype = i
        _lib = lib
    return _lib


def _f64(a, cols: int) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64).reshape(-1, cols)


def _check_colours(color: np.ndarray) -> None:
    """Raises as Python's `int(round(x))` does on the first colour written
    that is not finite."""
    bad = color[~np.isfinite(color)]
    if len(bad) and np.isnan(bad[0]):
        raise ValueError("cannot convert float NaN to integer")
    if len(bad):
        raise OverflowError("cannot convert float infinity to integer")


def _check(rc: int, f) -> None:
    if rc:
        raise OSError(-rc, f"writing {f.name}")


def write_bundle(f, cams, pos, color, counts, views, xy) -> None:
    """`bundle.out` into the open file `f` (nothing written to it yet):
    cams [C, 15] (f, k1, k2, R, t), pos / color [P, 3], counts [P],
    views [V, 2] (image, key), xy [V, 2] with V = Σ counts."""
    cams, pos, color, xy = (_f64(cams, 15), _f64(pos, 3), _f64(color, 3),
                            _f64(xy, 2))
    counts = np.ascontiguousarray(counts, dtype=np.int64).reshape(-1)
    views = np.ascontiguousarray(views, dtype=np.int64).reshape(-1, 2)
    if not (len(pos) == len(color) == len(counts)
            and len(views) == len(xy) == int(counts.sum())
            and (counts >= 0).all()):
        raise ValueError("bundle arrays disagree in length")
    _check_colours(color[counts > 0])
    _check(load().bundle_text_bundle(
        f.fileno(), len(cams), cams.ctypes.data, len(pos), pos.ctypes.data,
        color.ctypes.data, counts.ctypes.data, views.ctypes.data,
        xy.ctypes.data), f)


def write_ply(f, pos, color) -> None:
    """The points PLY into the open file `f` (nothing written to it yet):
    the vertices pos [N, 3] whose color [N, 3] is not (0, 0, 255)."""
    pos, color = _f64(pos, 3), _f64(color, 3)
    if len(pos) != len(color):
        raise ValueError("points and colours disagree in length")
    _check_colours(color)
    _check(load().bundle_text_ply(f.fileno(), len(pos), pos.ctypes.data,
                                  color.ctypes.data), f)
