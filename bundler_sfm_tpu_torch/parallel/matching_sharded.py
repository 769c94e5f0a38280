"""Match-graph sharding — port of `bundler_sfm_tpu/parallel/matching_sharded.py`.

The replacement for `KeyMatchFull`'s O(N²) sequential pair loop
(`src/KeyMatchFull.cpp:105-151`) across ranks, on the hand-written 2-NN
kernel (`ops/matching_cuda.py`, `csrc/two_nn.cu`):

  ShardedDescriptorTable — the descriptor table sharded over images; a
                           ring pass rotates the db shards around the ranks
                           (the ring-attention pattern on distance
                           matrices), so no rank holds more than 1/D of it
  match_pairs_sharded    — the pair list split over the ranks, each rank
                           matching its slice against a replicated table
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bundler_sfm_tpu_torch.ops.matching import (
    DescriptorTable, _match_masked, _prep_desc, _round_up,
    decode_masked_rows,
)


class ShardedDescriptorTable:
    """Descriptor table SHARDED over images across the ranks of `mesh` —
    for collections whose descriptors exceed one device's memory.  Image i
    lives on rank i // I (I = ceil(N / D) images a shard); each rank holds
    its [I, K, 128] shard on mesh.device.  Every rank must make the same
    calls with the same arguments."""

    def __init__(self, descs: Sequence[np.ndarray], mesh, block: int = 2048):
        self.mesh = mesh
        D = mesh.size
        maxk = max((len(d) for d in descs), default=1) or 1
        self.block = min(block, _round_up(maxk, 512))
        kmax = _round_up(maxk, self.block)
        self.num_images = len(descs)
        I = max(1, -(-len(descs) // D))
        self.images_per_shard = I
        int_in = all(np.issubdtype(np.asarray(d).dtype, np.integer)
                     for d in descs) if descs else True
        dtype = np.int8 if int_in else np.float32
        # Every rank knows every image's key count (the lane plan); the
        # descriptors of its own shard only go to its device.
        self.counts_host = np.zeros((D, I), np.int32)
        for i, d in enumerate(descs):
            self.counts_host[i // I, i % I] = len(d)
        table = np.zeros((I, kmax, 128), dtype=dtype)
        lo = mesh.rank * I
        for k, d in enumerate(descs[lo:lo + I]):
            table[k, :len(d)] = _prep_desc(d)
        self.table = torch.from_numpy(table).to(mesh.device)
        self.counts = torch.from_numpy(self.counts_host[mesh.rank]).to(
            mesh.device)

    def _lanes(self, num_rots: int, lane_want) -> List[List[np.ndarray]]:
        """lanes[d][r] = [n, 2] (query row, db row) pairs that rank d
        matches at rotation r: global query image < global db image, both
        with keys, and requested (lane_want [D, R, I, I]) when given."""
        D, I = self.mesh.size, self.images_per_shard
        qi, di = np.meshgrid(np.arange(I), np.arange(I), indexing="ij")
        qi, di = qi.reshape(-1), di.reshape(-1)
        lanes = []
        for d in range(D):
            per = []
            for r in range(num_rots):
                src = (d + r) % D
                want = ((d * I + qi < src * I + di)
                        & (self.counts_host[d, qi] > 0)
                        & (self.counts_host[src, di] > 0))
                if lane_want is not None:
                    want &= lane_want[d, r, qi, di]
                per.append(np.stack([qi[want], di[want]], 1))
            lanes.append(per)
        return lanes

    def match_all_pairs(self, ratio: float = 0.6, min_matches: int = 16,
                        max_out: int = 2048, num_rots: int = None,
                        lane_want: np.ndarray = None
                        ) -> Dict[Tuple[int, int], np.ndarray]:
        """Every i < j pair with >= min_matches matches (at most max_out
        kept a pair, the first in query order), by a ring pass: each rank
        keeps its query shard and at rotation r matches it against db
        shard (rank + r) % D, which it then passes on (`Mesh.ring_shift`:
        to rank − 1, from rank + 1, as the JAX ring's ppermute).  Lanes
        that are not wanted are never launched.  num_rots < D runs a
        BANDED ring: pair (i, j) lands at rotation (shard(j) − shard(i)) %
        D, so a window-limited pair list needs only the rotations its shard
        distances reach (`src/KeyMatchFull.cpp:117-121`)."""
        mesh = self.mesh
        D, I, me = mesh.size, self.images_per_shard, mesh.rank
        num_rots = D if num_rots is None else max(1, min(num_rots, D))
        K = self.table.shape[1]
        max_out = min(max_out, K)
        lanes = self._lanes(num_rots, lane_want)
        db_tab = self.table
        rows = []
        for r in range(num_rots):
            lane = lanes[me][r]
            if len(lane):
                db_cnt = torch.from_numpy(
                    self.counts_host[(me + r) % D]).to(mesh.device)
                pi = torch.from_numpy(lane[:, 0].astype(np.int32)).to(
                    mesh.device)
                pj = torch.from_numpy(lane[:, 1].astype(np.int32)).to(
                    mesh.device)
                rows.append(_match_masked(self.table, self.counts, db_tab,
                                          db_cnt, pi, pj, ratio * ratio))
            if r + 1 < num_rots:
                db_tab = mesh.ring_shift(db_tab)
        # Every rank's rows, padded to the longest (known on every rank).
        n = [sum(len(x) for x in lanes[d]) for d in range(D)]
        if max(n) == 0:
            return {}
        pad = torch.full((max(n) - n[me], K), -1, dtype=torch.int32,
                         device=mesh.device)
        m = mesh.all_gather(torch.cat(rows + [pad])[None], 0).cpu().numpy()
        pairs, flat = [], []
        for d in range(D):
            for r in range(num_rots):
                src = (d + r) % D
                pairs += [(d * I + int(q), src * I + int(b))
                          for q, b in lanes[d][r]]
            flat.append(m[d, :n[d]])
        return decode_masked_rows(np.concatenate(flat), pairs, min_matches,
                                  max_out)

    def match_pairs(self, pairs: Sequence[Tuple[int, int]],
                    ratio: float = 0.6, min_matches: int = 0,
                    max_out: int = 2048, **_ignored
                    ) -> Dict[Tuple[int, int], np.ndarray]:
        """DescriptorTable.match_pairs-compatible entry: the ring pass over
        the rotations the pair list reaches, on the requested lanes only,
        filtered to the pair list (in its order).

        CONTRACT: pairs must be CANONICAL (i < j) — 2-NN ratio matching is
        asymmetric and the ring computes only the i-queries-j direction
        (the KeyMatchFull direction).  With min_matches == 0, requested
        pairs with no match appear as empty entries, like
        DescriptorTable."""
        bad = [(a, b) for (a, b) in pairs if a >= b]
        if bad:
            raise ValueError(
                f"match_pairs requires canonical (i < j) pairs; got {bad[:3]}"
                f"{'...' if len(bad) > 3 else ''}")
        D, I = self.mesh.size, self.images_per_shard
        num_rots = 1 + max(((b // I) - (a // I)) % D for (a, b) in pairs) \
            if pairs else 1
        pa = np.array([a for a, _ in pairs], np.int64)
        pb = np.array([b for _, b in pairs], np.int64)
        lane_want = np.zeros((D, num_rots, I, I), bool)
        lane_want[pa // I, (pb // I - pa // I) % D, pa % I, pb % I] = True
        allp = self.match_all_pairs(ratio=ratio, min_matches=1,
                                    max_out=max_out, num_rots=num_rots,
                                    lane_want=lane_want)
        empty = np.zeros((0, 2), np.int32)
        out: Dict[Tuple[int, int], np.ndarray] = {}
        for (a, b) in pairs:
            m = allp.get((a, b))
            if m is None:
                if min_matches == 0:
                    out[(a, b)] = empty
                continue
            if len(m) >= min_matches:
                out[(a, b)] = m
        return out


def match_pairs_sharded(
    descs: Sequence[np.ndarray],
    pairs: Sequence[Tuple[int, int]],
    mesh,
    ratio: float = 0.6,
    block: int = 1024,
    min_matches: int = 16,
    pairs_per_device: int = 8,
) -> Dict[Tuple[int, int], np.ndarray]:
    """Split the pair list over the ranks of `mesh` and match every pair
    on the 2-NN kernel: `DescriptorTable(descs, mesh=mesh).match_pairs`
    in batches of size · pairs_per_device.  `block` (the JAX package's
    padded width) is accepted for its signature and has no effect: the db
    count masks the padding."""
    if not pairs:
        return {}
    return DescriptorTable(descs, mesh=mesh).match_pairs(
        pairs, ratio, batch=mesh.size * pairs_per_device,
        min_matches=min_matches)
