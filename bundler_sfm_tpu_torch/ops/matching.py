"""Exact descriptor matching — port of `bundler_sfm_tpu/ops/matching.py`.

The reference matches SIFT keys with an approximate 2-NN kd-tree search per
query (`lib/ann_1.1_char`, `src/keys2a.cpp:347-377`: `annkPriSearch` k=2,
ratio test `d0 < ratio²·d1` on squared L2 distances).  Here, as in the JAX
package, the search is exact and brute force:

    D = ‖a‖² + ‖b‖² − 2·A·Bᵀ

with a running top-2 per query.  On the card the distance product and the
top-2 run fused in one hand-written kernel (`ops/matching_cuda.py`), batched
over image pairs; the ratio test and the keep-first dedup run as tensor ops
on its outputs.  uint8 descriptors are stored centered as int8 (u8 − 128):
squared distances are shift-invariant, so the integer distances are exact.

Public entry points:
  two_nn               — exact 2-NN of one query set against one database
  match_pair           — one image pair, host-friendly wrapper
  DescriptorTable      — device-resident table matched over a pair list
                         (the KeyMatchFull replacement); with a `mesh`,
                         each pair batch is split over the ranks
  match_pairs_batched  — the JAX package's signature of
                         DescriptorTable.match_pairs
  prune_double_matches — keep-first dedup of many-to-one matches
                         (src/MatchTracks.cpp:394-452)
  symmetrize           — reversed lists for every pair
  launch_counts        — every 2-NN kernel's launches so far
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bundler_sfm_tpu_torch.ops import matching_cuda, matching_variants
from bundler_sfm_tpu_torch.ops.matching_cuda import (
    DB_TILE, QUERY_TILE, two_nn_pairs,
)
from bundler_sfm_tpu_torch.utils.device import resolve_device
from bundler_sfm_tpu_torch.utils.telemetry import stage


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count so far in this process: the wrappers'
    `LAUNCHES` of `matching_cuda` and `matching_variants` in one dict."""
    return {**matching_cuda.LAUNCHES, **matching_variants.LAUNCHES}


def _prep_desc(x: np.ndarray) -> np.ndarray:
    """uint8 SIFT descriptors -> CENTERED int8 (u8 − 128): bit-identical
    squared distances (shift invariance) on the int8 tensor-core path.
    Float inputs (tests, synthetic data) stay float32 (bf16 operands)."""
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.integer):
        return (a.astype(np.int16) - 128).astype(np.int8)
    return a.astype(np.float32)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def two_nn(query: torch.Tensor, db: torch.Tensor, db_count: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact 2-NN of each query row against the first `db_count` db rows.

    query: [Nq, 128] float32, or int8 CENTERED descriptors (u8 − 128)
    db:    [Nd, 128] same dtype as query
    Returns (d0, i0, d1): squared L2 distance and index of the nearest and
    the squared distance of the second nearest (f32; 3e38 where fewer than
    two db rows are valid).  Ties go to the lowest index.
    """
    nq, nd = query.shape[0], db.shape[0]
    q = torch.nn.functional.pad(query, (0, 0, 0, _round_up(nq, QUERY_TILE) - nq))
    d = torch.nn.functional.pad(db, (0, 0, 0, _round_up(max(nd, 1), DB_TILE) - nd))
    count = torch.tensor([int(db_count)], dtype=torch.int32, device=query.device)
    zero = torch.zeros(1, dtype=torch.int32, device=query.device)
    d0, i0, d1 = two_nn_pairs(q[None], d[None], count, zero, zero)
    return d0[0, :nq], i0[0, :nq], d1[0, :nq]


def _ratio_accept(d0, d1, q_count, ratio_sq: float) -> torch.Tensor:
    """Reference test `dist[0] < ratio²·dist[1]` (src/keys2a.cpp:362) for the
    first q_count queries; batched over leading dims (q_count [...])."""
    nq = d0.shape[-1]
    qidx = torch.arange(nq, device=d0.device)
    valid = qidx < torch.as_tensor(q_count, device=d0.device)[..., None]
    rs = torch.tensor(ratio_sq, dtype=torch.float32, device=d0.device)
    return valid & (d0 < rs * d1)


def match_pair(desc1: np.ndarray, desc2: np.ndarray, ratio: float = 0.6,
               device="cuda") -> np.ndarray:
    """Match image-1 keys against image-2 keys; returns int32 [m, 2] pairs
    (idx1, idx2), in idx1 order — same query direction as `MatchKeys`
    (`src/KeyMatchFull.cpp:127`: earlier image queries later image's tree)."""
    dev = resolve_device(device)
    n1, n2 = len(desc1), len(desc2)
    if n1 == 0 or n2 == 0:
        return np.zeros((0, 2), dtype=np.int32)
    q = torch.from_numpy(_prep_desc(desc1)).to(dev)
    db = torch.from_numpy(_prep_desc(desc2)).to(dev)
    d0, i0, d1 = two_nn(q, db, n2)
    accept = _ratio_accept(d0, d1, n1, ratio * ratio).cpu().numpy()
    i0 = i0.cpu().numpy()
    idx1 = np.nonzero(accept)[0].astype(np.int32)
    return np.stack([idx1, i0[idx1].astype(np.int32)], axis=1)


def _match_masked(qtab, qcounts, dbtab, dbcounts, pi, pj,
                  ratio_sq: float) -> torch.Tensor:
    """Image qtab[pi[b]] against image dbtab[pj[b]] for each pair b: 2-NN +
    ratio test + keep-first dedup, as a MASKED nearest-neighbor row per
    pair: out[b, q] = matched db index, or -1.  The dedup keeps, for each
    db key, the lowest query index claiming it (segment-min claimer, as
    `_match_one_masked`)."""
    d0, i0, d1 = two_nn_pairs(qtab, dbtab, dbcounts, pi, pj)
    acc = _ratio_accept(d0, d1, qcounts[pi.long()], ratio_sq)
    B, K = acc.shape
    i0 = i0.long()
    qidx = torch.arange(K, device=acc.device).expand(B, K)
    claim = torch.where(acc, qidx, K)
    claimer = torch.full((B, K), K, dtype=torch.long, device=acc.device)
    claimer.scatter_reduce_(1, i0, claim, reduce="amin")
    keep = acc & (claimer.gather(1, i0) == qidx)
    return torch.where(keep, i0, -1).to(torch.int32)


def decode_masked_rows(m: np.ndarray, pairs, min_matches: int,
                       max_out: Optional[int] = None
                       ) -> Dict[Tuple[int, int], np.ndarray]:
    """{pairs[p]: int32 [n, 2] (query, db) matches of masked row m[p]} for
    the pairs with >= min_matches matches (after keeping only the first
    max_out, when given), in `pairs` order."""
    out: Dict[Tuple[int, int], np.ndarray] = {}
    # ONE vectorized nonzero over all pairs (a per-pair loop of
    # nonzeros costs ~0.1 ms per pair on the host).
    r, cols = np.nonzero(m >= 0)
    vals = m[r, cols].astype(np.int32)
    per_pair = np.bincount(r, minlength=len(m))
    offs = np.concatenate([[0], np.cumsum(per_pair)])
    cols = cols.astype(np.int32)
    for p, (i, j) in enumerate(pairs):
        a, b = offs[p], offs[p + 1]
        if max_out is not None:
            b = min(b, a + max_out)
        if b - a >= min_matches:
            out[(i, j)] = np.stack([cols[a:b], vals[a:b]], axis=1)
    return out


class DescriptorTable:
    """Device-resident padded descriptor store for repeated pair matching.

    With `mesh` (`parallel/mesh.py`), the table is replicated on every rank
    (on mesh.device) and each pair batch is split over the ranks: each
    matches its slice and the masked rows are all-gathered, so every rank
    gets the dict `mesh=None` gives.  Every rank must call match_pairs with
    the same pairs."""

    @stage("match_table")           # packing and upload
    def __init__(self, descs: Sequence[np.ndarray], block: int = 2048,
                 device="cuda", mesh=None):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
        # Shrink the tile to the actual key budget: padding 1k-key images to
        # a 2k block wastes 4x the work of the distance products.
        maxk = max((len(d) for d in descs), default=1) or 1
        self.block = min(block, _round_up(maxk, 512))
        kmax = _round_up(maxk, self.block)
        # uint8 collections live as centered int8 (int8 tensor cores);
        # float collections as f32 (bf16 operands).
        int_in = all(np.issubdtype(np.asarray(d).dtype, np.integer)
                     for d in descs) if descs else True
        dtype = np.int8 if int_in else np.float32
        table = np.zeros((len(descs), kmax, 128), dtype=dtype)
        counts = np.zeros(len(descs), dtype=np.int32)
        for i, d in enumerate(descs):
            table[i, :len(d)] = _prep_desc(d)
            counts[i] = len(d)
        self.table = torch.from_numpy(table).to(self.device)
        self.counts = torch.from_numpy(counts).to(self.device)

    def match_pairs(self, pairs: Sequence[Tuple[int, int]],
                    ratio: float = 0.6, batch: Optional[int] = None,
                    min_matches: int = 0
                    ) -> Dict[Tuple[int, int], np.ndarray]:
        """Match every (i, j) in `pairs` (image i queries image j); returns
        {(i, j): int32 [m, 2]} for pairs with >= min_matches matches, each
        list deduped keep-first and in ascending idx1 order.  `batch` pairs
        go to one kernel launch (default 1024; with a mesh, the batch is
        split over the ranks)."""
        if not pairs:
            return {}
        masked = self._fetch_masked_rows(pairs, ratio, batch or 1024)
        with stage("match_decode"):
            return decode_masked_rows(masked, pairs, min_matches)

    @stage("match_fetch")
    def _fetch_masked_rows(self, pairs, ratio, batch) -> np.ndarray:
        """Every pair's masked rows on the host: the launches, then the
        host waits for the kernels and the copy."""
        rows = []
        for start in range(0, len(pairs), batch):
            chunk = np.asarray(pairs[start:start + batch], dtype=np.int32)
            n_real = len(chunk)
            if self.mesh is not None:
                # Pad to a multiple of the rank count (with the first pair,
                # as the JAX package does); this rank takes its slice.
                D, me = self.mesh.size, self.mesh.rank
                per = -(-n_real // D)
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[:1], per * D - n_real, 0)])
                chunk = chunk[me * per:(me + 1) * per]
            pi = torch.from_numpy(chunk[:, 0].copy()).to(self.device)
            pj = torch.from_numpy(chunk[:, 1].copy()).to(self.device)
            m = _match_masked(self.table, self.counts, self.table,
                              self.counts, pi, pj, ratio * ratio)
            if self.mesh is not None:
                m = self.mesh.all_gather(m, 0)[:n_real]
            rows.append(m)
        # One device->host fetch for all batches.
        return torch.cat(rows).cpu().numpy()


def match_pairs_batched(
    descs: Sequence[np.ndarray],
    pairs: Sequence[Tuple[int, int]],
    ratio: float = 0.6,
    batch: int = 32,
    block: int = 1024,
    min_matches: int = 0,
    device="cuda",
) -> Dict[Tuple[int, int], np.ndarray]:
    """Match many image pairs, `batch` pairs to one 2-NN kernel call.

    descs: per-image uint8 (centered int8 table, the int8 kernel) or float
    (f32 table, the f32 kernel) [k_i, 128] arrays.  pairs: (i, j) with
    i < j — image i queries image j (KeyMatchFull direction:
    `src/KeyMatchFull.cpp` matches j<i querying into tree_i, emitting pairs
    (j, i)).  Applies keep-first dedup (PruneDoubleMatches) and the
    >= min_matches pair cutoff (`src/KeyMatchFull.cpp:131` uses 16).
    Returns {(i, j): int32 [m, 2]} in ascending idx1 order.

    This is `DescriptorTable.match_pairs` on a table of `descs`; `block`
    (the JAX package's padded width) is accepted for its signature and has
    no effect: the db count masks the padding, so the result depends on
    neither the padded width nor `batch`.
    """
    return DescriptorTable(descs, device=device).match_pairs(
        pairs, ratio, batch, min_matches)


def prune_double_matches(matches: np.ndarray) -> np.ndarray:
    """Keep the first match claiming each target key; drop later repeats.

    Mirrors `PruneDoubleMatches` (`src/MatchTracks.cpp:394-452`) which scans
    the list in order and erases matches whose m_idx2 was already seen.
    """
    if len(matches) == 0:
        return matches
    idx2 = matches[:, 1]
    # np.unique returns the first occurrence index for each unique value.
    _, first = np.unique(idx2, return_index=True)
    keep = np.zeros(len(matches), dtype=bool)
    keep[first] = True
    return matches[keep]


def symmetrize(matches: Dict[Tuple[int, int], np.ndarray]
               ) -> Dict[Tuple[int, int], np.ndarray]:
    """Add the reversed list for every (i, j), as `MakeMatchListsSymmetric`
    (`src/MatchTracks.cpp:337-392`) does before track building."""
    out = dict(matches)
    for (i, j), m in matches.items():
        out[(j, i)] = m[:, ::-1].copy()
    return out
