"""Benchmark of the port: descriptor-matching throughput (pairs/s) on the
int8 2-NN kernel, beside the reference's data path (an exact kd-tree 2-NN
on the CPU, scipy's cKDTree with the same query semantics) and bundle
adjustment rates.  The counterpart of the JAX package's root `bench.py`.

    python -m bundler_sfm_tpu_torch.bench [--num_images 64] [--keys 2048]
        [--batch N] [--block N] [--seed 0] [--ba_small 8 2048]
        [--ba_big 64 8192] [--ba_sparse 64 16384] [--ba_iters 30]
        [--device cuda|cpu]

prints ONE JSON line:
  {"metric": "pairs_matched_per_s", "value": N, "unit": "pairs/s",
   "vs_baseline": null, "detail": {...}}

The workload mirrors `KeyMatchFull` (`src/KeyMatchFull.cpp:105-151`):
all pairs of 64 images with 2048 SIFT-like keys each, exact 2-NN + Lowe
0.6 ratio per query.  Legs, in order, none wrapped in a `try` (a failing
leg fails the run):
  matcher  `DescriptorTable.match_pairs(pairs, batch, min_matches=16)`:
           one warm-up on the reversed order, then three rotations of the
           pair list; `value` is the best rate, `match_seconds_runs` all
           three (each window ends in match_pairs' device->host fetch).
  kernel   `ops/matching.py::_match_masked` on the whole pair list in one
           call per order, 8 warm orders then 8 timed ones; its rate,
           int8 TOP/s (n·2·K²·128 operations) and share of the H100's
           dense int8 peak.
  cpu      the kd-tree on 2 pairs, on the host's CPU.
  ba       `build_problem` / `run_ba` in f64 (the port's BA always runs
           f64) on every-camera-sees-every-point problems of 8 x 2048 and
           64 x 8192, 30 LM iterations at most, warm-up on the problem,
           timed on cam0 + 1e-6; observations·iterations/s, seconds per LM
           iteration and the JAX bench's FLOP count over the H100's f64
           tensor-core peak.
  sparse   the same on 64 x 16384 subsampled to mixed track lengths (60 %
           2-4 views, 25 % 5-8, 15 % 9-24), flat layout; occupancy is the
           real observations over the per-point view table's slots.

Against the JAX bench's line:
  * `tpu_seconds` is `match_seconds` and `tpu_matches` is `matches`;
  * `vs_baseline` is null and the `ref_ann_*` keys are absent: their 11.5
    pairs/s is the reference's `KeyMatchFull` measured on another host,
    with the reference's binaries, which this program does not run;
    `vs_cpu_kdtree`, measured in the run, stays;
  * the `ba_sparse_bucketed_*` keys are absent: `plan_view_buckets` is a
    TPU layout the port does not have;
  * `platform` is the torch device type; new keys: `device` (name, count,
    and nvidia-smi's name and power limit), `launches` (each kernel's
    launches over the run), `match_seconds_runs` and `matches_runs` (each
    timed rotation's), the BA legs' `*_lm_iters`, and `mfu_peaks` (the
    peaks the two MFUs divide by);
  * the environment knobs `BENCH_NUM_IMAGES`, `BENCH_TPU_BATCH` and
    `BENCH_BLOCK` are the options above; `--seed` seeds the descriptors
    (the BA problems keep the JAX bench's seeds, 0 and 7).
A run with `--device cpu` runs every leg on the plain PyTorch versions
and writes null for the device metrics (`kernel_tflops`, `kernel_mfu`,
`ba_mfu`, `ba64_mfu`); without a card and without `--device cpu` it
raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bundler_sfm_tpu_torch.ops.ba import build_problem, run_ba
from bundler_sfm_tpu_torch.ops.matching import (
    DescriptorTable, _match_masked, launch_counts,
)
from bundler_sfm_tpu_torch.utils.device import (
    device_record, resolve_device, synchronize,
)

CPU_PAIRS = 2          # kd-tree pairs measured, rate extrapolated
# NVIDIA's H100 SXM data sheet, dense rates: int8 tensor cores (the 2-NN
# kernel's product) and f64 tensor cores (the BA's FLOPs).
INT8_PEAK = 1979e12
F64_PEAK = 67e12


def make_descriptors(rng, n_images, keys_per_image):
    """SIFT-like descriptors: one base set of keys, each image a permuted
    copy with per-view jitter of +-6 per dimension.  The jitter is small
    against the distance between base keys, so every key of every pair
    passes the 0.6 ratio test: 2016 pairs x 2048 keys give 4128768
    matches (PERF.md section 4), where users' collections match a small
    share of their keys.  A copy of the JAX bench's generator (same
    draws)."""
    base = rng.integers(0, 256, (keys_per_image, 128)).astype(np.int32)
    descs = []
    for _ in range(n_images):
        jit = rng.integers(-6, 7, base.shape)
        d = np.clip(base + jit, 0, 255).astype(np.uint8)
        perm = rng.permutation(keys_per_image)
        descs.append(d[perm])
    return descs


def synthetic_problem(num_cams=4, num_pts=64, seed=0):
    """Cameras on an arc, every camera sees every point: (R, cam0, pts0,
    obs_cam, obs_pt, obs_xy), observations camera-major.  A copy of the
    JAX package's `__graft_entry__._synthetic_problem` (same draws)."""
    rng = np.random.default_rng(seed)
    f = 700.0
    centers = np.array([[np.sin(a) * 6, 0.2 * i, np.cos(a) * 6]
                        for i, a in enumerate(
                            np.linspace(0, 0.8, num_cams))])
    pts = rng.uniform(-2, 2, (num_pts, 3))

    def look_at(c):
        fwd = -c / np.linalg.norm(c)
        z = -fwd
        x = np.cross([0, 1, 0], z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        return np.stack([x, y, z])

    R = np.stack([look_at(c) for c in centers])
    p_cam = np.einsum("cij,cpj->cpi", R, pts[None] - centers[:, None])
    uv = -f * p_cam[:, :, :2] / p_cam[:, :, 2:3]          # [C,P,2]
    obs_cam = np.repeat(np.arange(num_cams, dtype=np.int32), num_pts)
    obs_pt = np.tile(np.arange(num_pts, dtype=np.int32), num_cams)
    obs_xy = uv.reshape(num_cams * num_pts, 2)
    cam0 = np.zeros((num_cams, 9))
    cam0[:, 0:3] = centers + rng.normal(size=centers.shape) * 0.01
    cam0[:, 6] = f
    return (R, cam0, pts + rng.normal(size=pts.shape) * 0.02,
            np.array(obs_cam, np.int32), np.array(obs_pt, np.int32),
            np.array(obs_xy))


def bench_match(descs, pairs, block: int, batch: int, device
                ) -> Tuple[DescriptorTable, List[float], List[int], Dict]:
    """The matcher leg: (table, seconds of the three timed rotations, their
    match counts, the last rotation's match dict)."""
    table = DescriptorTable(descs, block=block, device=device)
    table.match_pairs(pairs[::-1], batch=batch, min_matches=16)
    secs, counts = [], []
    for k in (0, 1, 2):
        ps = pairs[k:] + pairs[:k]
        t0 = time.perf_counter()
        out = table.match_pairs(ps, batch=batch, min_matches=16)
        secs.append(time.perf_counter() - t0)
        counts.append(sum(len(v) for v in out.values()))
    return table, secs, counts, out


def bench_kernel(table: DescriptorTable, pairs, reps: int = 8
                 ) -> Tuple[float, float, float]:
    """The kernel leg: the whole pair list in one `_match_masked` call per
    order (distinct orders), `reps` warm orders then `reps` timed ones,
    the device synchronised once at the end.  Returns (pairs/s, int8
    operations/s, the number of pairs·2·K²·128 operations)."""
    dev = table.table.device

    def tensors(phase):
        out = []
        for k in range(phase, phase + reps):
            p = np.asarray(pairs[k:] + pairs[:k], np.int32)
            out.append((torch.from_numpy(p[:, 0].copy()).to(dev),
                        torch.from_numpy(p[:, 1].copy()).to(dev)))
        return out

    def run(orders):
        for pi, pj in orders:
            _match_masked(table.table, table.counts, table.table,
                          table.counts, pi, pj, 0.36)

    warm, timed = tensors(reps), tensors(0)
    run(warm)
    synchronize(dev)
    t0 = time.perf_counter()
    run(timed)
    synchronize(dev)
    dt = time.perf_counter() - t0
    n = reps * len(pairs)
    K = table.table.shape[1]
    ops = n * 2.0 * K * K * 128
    return n / dt, ops / dt, ops


def bench_cpu_kdtree(descs, pairs):
    """The reference matcher's shape: build kd-tree on image2, 2-NN query
    every image1 key, ratio test (src/keys2a.cpp MatchKeys)."""
    from scipy.spatial import cKDTree
    t0 = time.perf_counter()
    total = 0
    for (i, j) in pairs:
        tree = cKDTree(descs[j].astype(np.float32))
        d, idx = tree.query(descs[i].astype(np.float32), k=2)
        accept = (d[:, 0] ** 2) < 0.36 * (d[:, 1] ** 2)
        total += int(accept.sum())
    dt = time.perf_counter() - t0
    return len(pairs) / dt, total, dt


def _timed_ba(R0, cam0, pts0, oc, op, oxy, max_iters, dev):
    """run_ba once on the problem (warm-up), then timed on cam0 + 1e-6:
    (seconds, the timed BAResult, the warm-up's problem)."""
    prob = build_problem(R0, cam0, pts0, oc, op, oxy, est_focal=True,
                         est_distortion=True, device=dev)
    float(run_ba(prob, max_iters=max_iters).cost)
    prob2 = build_problem(R0, cam0 + 1e-6, pts0, oc, op, oxy,
                          est_focal=True, est_distortion=True, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    res = run_ba(prob2, max_iters=max_iters)
    float(res.cost)
    return time.perf_counter() - t0, res, prob


def bench_ba_shape(num_cams, num_pts, max_iters=30, device="cuda") -> Dict:
    """One dense BA leg: observations·iterations/s, seconds per LM
    iteration, the MFU of the JAX bench's FLOP count (None off the card),
    the timed run's iterations and final cost."""
    dev = resolve_device(device)
    R0, cam0, pts0, oc, op, oxy = synthetic_problem(num_cams=num_cams,
                                                    num_pts=num_pts)
    dt, res, prob = _timed_ba(R0, cam0, pts0, oc, op, oxy, max_iters, dev)
    iters = max(int(res.iters), 1)
    # The JAX bench's algorithmic FLOPs per LM iteration: linearize ~r,A,B
    # ~ 300/obs; U/V/W products ~ 240/obs; Schur dense tables + (C*9)^2
    # contraction; solve C^3*729/3; back-substitute.
    C = prob.cam0.shape[0]
    O = prob.obs_cam.shape[0]
    P = prob.pts0.shape[0]
    flops_iter = (O * 540.0 + (C * 9) ** 2 * 3 * P * 2
                  + (C * 9) ** 3 / 3 + O * 110.0)
    mfu = flops_iter * iters / dt / F64_PEAK if dev.type == "cuda" else None
    return dict(obs_iters_per_s=iters * len(oc) / dt,
                seconds_per_lm_iter=dt / iters, mfu=mfu,
                iters=int(res.iters), cost=float(res.cost))


def bench_ba_sparse(num_cams=64, num_pts=16384, max_iters=30, seed=7,
                    device="cuda") -> Dict:
    """The realistic-sparsity BA leg on the flat layout: mixed track
    lengths (60% 2-4 views, 25% 5-8, 15% 9-24) subsampled from the dense
    problem, which observes each (point, camera) pair once, so the
    subsample does too.  Rate over real observations; occupancy = real
    observations / the per-point view table's slots."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    R0, cam0, pts0, oc, op, oxy = synthetic_problem(num_cams=num_cams,
                                                    num_pts=num_pts)
    u = rng.random(num_pts)
    nv = np.where(u < 0.6, rng.integers(2, 5, num_pts),
                  np.where(u < 0.85, rng.integers(5, 9, num_pts),
                           rng.integers(9, 25, num_pts)))
    rank = np.argsort(rng.random((num_cams, num_pts)), axis=0)
    keep = (rank < nv[None, :]).reshape(-1)
    oc, op, oxy = oc[keep], op[keep], oxy[keep]
    order = np.argsort(op, kind="stable")
    oc, op, oxy = oc[order], op[order], oxy[order]
    dt, res, prob = _timed_ba(R0, cam0, pts0, oc, op, oxy, max_iters, dev)
    iters = max(int(res.iters), 1)
    return dict(obs_iters_per_s=iters * len(oc) / dt,
                occupancy=len(oc) / prob.pt_views.numel(),
                iters=int(res.iters), cost=float(res.cost))


def main(argv: Sequence[str] = None) -> Dict:
    p = argparse.ArgumentParser(
        prog="bench", description="Matching throughput and BA rates of "
        "the port (one JSON line).")
    p.add_argument("--num_images", type=int, default=64)
    p.add_argument("--keys", type=int, default=2048,
                   help="keys per image")
    p.add_argument("--batch", type=int, default=None,
                   help="pairs a matcher launch (default min(1024, pairs))")
    p.add_argument("--block", type=int, default=None,
                   help="DescriptorTable block (default --keys)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the descriptor generator")
    p.add_argument("--ba_small", type=int, nargs=2, default=[8, 2048],
                   metavar=("CAMS", "PTS"))
    p.add_argument("--ba_big", type=int, nargs=2, default=[64, 8192],
                   metavar=("CAMS", "PTS"))
    p.add_argument("--ba_sparse", type=int, nargs=2, default=[64, 16384],
                   metavar=("CAMS", "PTS"))
    p.add_argument("--ba_iters", type=int, default=30,
                   help="LM iterations at most in each BA leg")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions and writes no device metric)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    n = args.num_images
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    batch = args.batch or min(1024, len(pairs))
    block = args.block or args.keys
    descs = make_descriptors(np.random.default_rng(args.seed), n, args.keys)
    before = launch_counts()

    table, match_secs, match_counts, _ = bench_match(descs, pairs, block,
                                                     batch, dev)
    match_dt = min(match_secs)
    rate = len(pairs) / match_dt
    kern_rate, kern_ops_s, _ = bench_kernel(table, pairs)
    small = bench_ba_shape(*args.ba_small, args.ba_iters, dev)
    big = bench_ba_shape(*args.ba_big, args.ba_iters, dev)
    sparse = bench_ba_sparse(*args.ba_sparse, args.ba_iters, device=dev)
    cpu_rate, _, _ = bench_cpu_kdtree(descs, pairs[:CPU_PAIRS])
    launches = {k: v - before[k] for k, v in launch_counts().items()}

    result = {
        "metric": "pairs_matched_per_s",
        "value": rate,
        "unit": "pairs/s",
        "vs_baseline": None,
        "detail": {
            "platform": dev.type,
            "device": device_record(dev),
            "num_pairs": len(pairs),
            "keys_per_image": args.keys,
            "match_seconds": match_dt,
            "match_seconds_runs": match_secs,
            "matches": match_counts[-1],
            "matches_runs": match_counts,
            "kernel_pairs_per_s": kern_rate,
            "kernel_tflops": kern_ops_s / 1e12 if cuda else None,
            "kernel_mfu": kern_ops_s / INT8_PEAK if cuda else None,
            "cpu_kdtree_pairs_per_s": cpu_rate,
            "vs_cpu_kdtree": rate / cpu_rate,
            "ba_obs_iters_per_s": small["obs_iters_per_s"],
            "ba_seconds_per_lm_iter": small["seconds_per_lm_iter"],
            "ba_mfu": small["mfu"],
            "ba_lm_iters": small["iters"],
            "ba64_obs_iters_per_s": big["obs_iters_per_s"],
            "ba64_seconds_per_lm_iter": big["seconds_per_lm_iter"],
            "ba64_mfu": big["mfu"],
            "ba64_lm_iters": big["iters"],
            "ba_sparse_single_obs_iters_per_s": sparse["obs_iters_per_s"],
            "ba_sparse_single_occupancy": sparse["occupancy"],
            "ba_sparse_lm_iters": sparse["iters"],
            "mfu_peaks": {"kernel_mfu": INT8_PEAK, "ba_mfu": F64_PEAK,
                          "source": "NVIDIA H100 SXM data sheet, dense "
                                    "int8 / f64 tensor-core rates"},
            "launches": launches,
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
