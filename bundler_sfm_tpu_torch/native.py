"""ctypes bindings to the repository's native C++ helpers
(`native/libbundler_native.so`, built from `native/keyio.cc` and
`native/tracks.cc` by `make -C native`): a single-pass key-file tokenizer
and the BFS track builder.

Callers check `available()` first and use the pure-Python path when the
library is missing or cannot be loaded on this host.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "libbundler_native.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:          # built for another platform / libc
        return None
    lib.parse_keyfile.restype = ctypes.c_longlong
    lib.parse_keyfile.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_longlong,
    ]
    lib.build_tracks_edges.restype = ctypes.c_longlong
    lib.build_tracks_edges.argtypes = [
        ctypes.c_int, ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_key_bytes(data: bytes, max_keys: int = 1 << 20
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse decompressed key-file bytes natively (requires `available()`)."""
    lib = _load()
    info = np.empty((max_keys, 4), dtype=np.float32)
    desc = np.empty((max_keys, 128), dtype=np.uint8)
    n = lib.parse_keyfile(data, len(data), info.reshape(-1),
                          desc.reshape(-1), max_keys)
    if n == -2:
        return parse_key_bytes(data, max_keys * 4)
    if n < 0:
        raise ValueError("malformed key file")
    return info[:n].copy(), desc[:n].copy()


def build_tracks_native(
    matches: Dict[Tuple[int, int], np.ndarray], num_images: int
) -> List[List[Tuple[int, int]]]:
    """Native BFS track builder (requires `available()`); same contract as
    `pipeline.tracks.build_tracks` (symmetric, pruned matches)."""
    lib = _load()
    # Node space: unique (img, key) encoded as img·2³² + key — int64 sort
    # order equals (img, key) lexicographic.
    src_enc_l, dst_enc_l = [], []
    for (i, j), m in matches.items():
        if len(m):
            src_enc_l.append((np.int64(i) << 32) + m[:, 0].astype(np.int64))
            dst_enc_l.append((np.int64(j) << 32) + m[:, 1].astype(np.int64))
    if not src_enc_l:
        return []
    src_enc = np.concatenate(src_enc_l)
    dst_enc = np.concatenate(dst_enc_l)
    # The dict is symmetric, so every endpoint appears as a source.  Nodes
    # are enumerated through a dense [num_images, max_key+1] lookup table:
    # key indices are bounded by the per-image key count.
    max_key = int((src_enc & 0xFFFFFFFF).max())
    if max_key < (1 << 22):
        mark = np.zeros(num_images * (max_key + 1), bool)
        flat_src = ((src_enc >> 32) * (max_key + 1)
                    + (src_enc & 0xFFFFFFFF)).astype(np.int64)
        mark[flat_src] = True
        lut = np.full(mark.shape, -1, np.int64)
        node_flat = np.nonzero(mark)[0]
        n_nodes = len(node_flat)
        lut[node_flat] = np.arange(n_nodes)
        nodes_enc = ((node_flat // (max_key + 1)) << 32) \
            + (node_flat % (max_key + 1))
        src = lut[flat_src]
        dmask = dst_enc & 0xFFFFFFFF
        dok = dmask <= max_key
        flat_dst = ((dst_enc >> 32) * (max_key + 1) + dmask)
        dst = np.where(dok, lut[np.where(dok, flat_dst, 0)], -1)
        ok = dst >= 0
        src, dst = src[ok], dst[ok]
    else:          # degenerate huge key indices: binary search
        nodes_enc = np.unique(src_enc)
        n_nodes = len(nodes_enc)
        src = np.searchsorted(nodes_enc, src_enc)
        dst = np.searchsorted(nodes_enc, dst_enc)
        ok = nodes_enc[np.minimum(dst, n_nodes - 1)] == dst_enc
        src, dst = src[ok], dst[ok]
    # CSR construction happens native-side (stable counting sort: each
    # node's neighbor order stays the edge insertion order).
    out = np.empty(n_nodes, np.int32)
    n_tracks = lib.build_tracks_edges(
        num_images, n_nodes, (nodes_enc >> 32).astype(np.int32),
        len(src), np.ascontiguousarray(src, np.int64),
        np.ascontiguousarray(dst, np.int64), out)
    keep = out >= 0
    ids = out[keep]
    imgs = (nodes_enc[keep] >> 32).astype(np.int64).tolist()
    keys = (nodes_enc[keep] & 0xFFFFFFFF).astype(np.int64).tolist()
    grouped = np.argsort(ids, kind="stable")
    sorted_ids = ids[grouped]
    starts = np.searchsorted(sorted_ids, np.arange(n_tracks))
    ends = np.searchsorted(sorted_ids, np.arange(n_tracks), side="right")
    g = grouped.tolist()
    return [[(imgs[g[k]], keys[g[k]]) for k in range(a, b)]
            for a, b in zip(starts.tolist(), ends.tolist())]
