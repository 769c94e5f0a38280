"""Measured multi-rank scaling of the sharded BA on gloo CPU ranks: our
side of the JAX package's `benchmarks/scaling_mesh_cpu.py`, on the port.

Where `probes/scaling.py` measures one card's per-shard compute and models
the all-reduces, this runs the whole sharded program — every all_reduce
included — on D ranks of a `torch.distributed` gloo group on the host's
CPU (`parallel/mesh.py::launch(device="cpu")`), as the JAX script runs it
on D virtual CPU devices.  The ranks share the host's cores (each takes
cores / D threads), so absolute times are not a card's; what this
measures is how the collectives' count and size scale with D.

The problem is a copy of `benchmarks/probes/probe_ba_scaling.py::
synthetic` (16 cameras on an arc, 16384 points, each seen by 6
consecutive cameras); `run_ba_sharded` takes 10 LM iterations after a warm
call, as in the JAX script.  The port's BA runs in f64 where the JAX
script runs f32.

    python -m bundler_sfm_tpu_torch.probes.scaling_mesh_cpu
        [--pts 16384] [--iters 10] [--devices 1,2,4,8]

prints a line a D as it finishes and then one JSON line: the JAX line's
keys (`metric`, `host_cores`, `problem`, `ms_per_iter_by_devices`) plus
the usable cores, the threads a rank took, the LM iterations and the
final cost at each D.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Sequence

import numpy as np
import torch

from bundler_sfm_tpu_torch.parallel.ba_sharded import (
    run_ba_sharded, shard_problem,
)
from bundler_sfm_tpu_torch.parallel.mesh import launch

CAMS, VIEWS = 16, 6   # the JAX script's problem: 16 cameras, 6 views a point


def synthetic(num_cams, num_pts, views_per_pt, seed=0):
    """A copy of `benchmarks/probes/probe_ba_scaling.py::synthetic` (same
    draws): cameras on an arc looking at the origin, each point observed
    by a contiguous window of `views_per_pt` cameras."""
    rng = np.random.default_rng(seed)
    f = 700.0
    centers = np.array([[np.sin(a) * 6, 0.2 * i, np.cos(a) * 6]
                        for i, a in enumerate(
                            np.linspace(0, 0.8, num_cams))])
    pts = rng.uniform(-2, 2, (num_pts, 3))

    def look_at(c):
        z = c / np.linalg.norm(c)
        x = np.cross([0, 1, 0], z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        return np.stack([x, y, z])

    R = np.stack([look_at(c) for c in centers])
    start = rng.integers(0, max(1, num_cams - views_per_pt + 1), num_pts)
    obs_cam, obs_pt = [], []
    for p in range(num_pts):
        for c in range(start[p], start[p] + views_per_pt):
            obs_cam.append(c)
            obs_pt.append(p)
    obs_cam = np.array(obs_cam, np.int32)
    obs_pt = np.array(obs_pt, np.int32)
    p_cam = np.einsum("oij,oj->oi", R[obs_cam], pts[obs_pt] - centers[obs_cam])
    obs_xy = -f * p_cam[:, :2] / p_cam[:, 2:3]
    cam0 = np.zeros((num_cams, 9))
    cam0[:, 0:3] = centers + rng.normal(size=centers.shape) * 0.01
    cam0[:, 6] = f
    return (R, cam0, pts + rng.normal(size=pts.shape) * 0.02,
            obs_cam, obs_pt, obs_xy)


def _rank(mesh, problem, iters: int, threads: int) -> Dict:
    """One rank: a warm sharded BA, then a timed one from cameras moved by
    1e-6, started together after a barrier.  Returns its seconds, LM
    iterations and the final cost (replicated)."""
    torch.set_num_threads(threads)
    R0, cam0, pts0, oc, op, oxy = problem
    prob = shard_problem(R0, cam0, pts0, oc, op, oxy, mesh, est_focal=True,
                         est_distortion=True)
    float(run_ba_sharded(prob, mesh, max_iters=iters).cost)
    prob2 = shard_problem(R0, cam0 + 1e-6, pts0, oc, op, oxy, mesh,
                          est_focal=True, est_distortion=True)
    mesh.barrier()
    t0 = time.perf_counter()
    res = run_ba_sharded(prob2, mesh, max_iters=iters)
    cost = float(res.cost)
    return {"seconds": time.perf_counter() - t0, "iters": int(res.iters),
            "cost": cost}


def main(argv: Sequence[str] = None) -> Dict:
    ap = argparse.ArgumentParser(
        prog="scaling_mesh_cpu", description="The sharded BA on D gloo CPU "
        "ranks: ms an LM iteration by D (one JSON line).")
    ap.add_argument("--pts", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--devices", default="1,2,4,8",
                    help="rank counts to run, comma-separated")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])

    problem = synthetic(CAMS, args.pts, VIEWS)
    cores = len(os.sched_getaffinity(0))
    out, iters, costs, threads = {}, {}, {}, {}
    for D in (int(d) for d in args.devices.split(",")):
        threads[D] = max(1, cores // D)
        ranks = launch(_rank, D, device="cpu",
                       args=(problem, args.iters, threads[D]))
        # The slowest rank's time is the iteration's.
        dt = max(r["seconds"] for r in ranks)
        iters[D] = max(ranks[0]["iters"], 1)
        costs[D] = ranks[0]["cost"]
        out[D] = dt / iters[D] * 1e3
        print(f"D={D}: {out[D]:.1f} ms/iter ({iters[D]} iters)", flush=True)
    result = {"metric": "measured_mesh_ms_per_iter_cpu",
              "host_cores": os.cpu_count(), "usable_cores": cores,
              "threads_per_rank": threads,
              "problem": {"cams": CAMS, "pts": args.pts,
                          "obs": len(problem[3])},
              "ms_per_iter_by_devices": out, "lm_iters_by_devices": iters,
              "final_cost_by_devices": costs}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
