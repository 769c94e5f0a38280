"""Multi-card scaling model of the sharded BA and the matchers: our side of
the JAX package's `benchmarks/scaling.py`, on the port.

The JAX script's method, on one card:

  * compute: MEASURED.  The point-sharded BA (`parallel/ba_sharded.py`)
    gives each of D ranks the full camera set and 1/D of the points and
    observations, so a rank's LM iteration at D ranks is the unsharded
    iteration on a 1/D-size problem (same cameras, same replicated camera
    solve: the serial term is in the measurement).  `measure_ba_iter` times
    `ops/ba.py::run_ba` on that problem, f64, on the card.
  * communication: MODELED, from the all-reduces the port's sharded LM
    iteration makes (`allreduce_payload`, counted from `ops/ba.py::_lm_loop`
    and `_solve_schur_cg_sharded`) as a ring all-reduce: 2·(D−1)/D · bytes
    / bandwidth + 2·(D−1) steps · latency a step, per all-reduce.
  * the pair-split matcher needs no communication (each rank matches its
    own pairs), so `measure_matching` measures pairs/s against the pairs a
    kernel launch takes; `ring_matcher_model` projects the image-sharded
    ring matcher (`parallel/matching_sharded.py`).

    python -m bundler_sfm_tpu_torch.probes.scaling [--cams 64] [--pts 32768]
        [--obs_per_pt 8] [--iters 30] [--ici_gbps 450] [--hop_us 0.6]
        [--match_keys 1024] [--match_batches 8,16,32,64] [--device cuda|cpu]

prints one JSON line with the measured per-shard times and the projected
efficiency at D = 1, 2, 4, 8 and 16 cards, under the JAX line's keys, plus
the device (`device_record`) and the comm model's element size.

Two things differ from the JAX script:

  * the payload counts the port's all-reduces, in f64 (8-byte elements;
    the JAX model counts its own psums in f32, "f32 on chip").  The port
    fuses tensors into one all_reduce where the JAX package psums them
    apart, and sums five scalars and takes one max an iteration where the
    JAX model counts four scalars (`allreduce_payload`);
  * the link figures are a card's.  `--ici_gbps` and `--hop_us` keep the
    JAX flags' names, so its command lines carry over, and default to
    H100 SXM5 NVLink 4: 450 GB/s a direction per GPU (NVIDIA's H100
    Tensor Core GPU datasheet: NVLink 900 GB/s, both directions
    together), and 0.6 µs a ring step (NCCL's latency model,
    `src/graph/tuning.cc`, `hwLat` for NVLink, ring, LL protocol; its
    fixed per-call latency is not modelled, as the JAX model has none).
    Both are model inputs, not measurements; the line says so.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Sequence, Tuple

import numpy as np

from bundler_sfm_tpu_torch.ops.ba import build_problem, run_ba
from bundler_sfm_tpu_torch.ops.matching import DescriptorTable
from bundler_sfm_tpu_torch.utils.device import (
    device_record, resolve_device, synchronize,
)

NVLINK_GBPS = 450.0   # H100 SXM5 NVLink 4, a direction (datasheet: 900 both)
NVLINK_HOP_US = 0.6   # NCCL tuning.cc hwLat: NVLink, ring, LL protocol
F64_BYTES = 8
SWEEP = (1, 2, 4, 8, 16)


def synth_ba(num_cams, num_pts, obs_per_pt, seed=0):
    """A copy of the JAX script's generator (same draws): cameras near the
    origin looking down +z, every point seen by obs_per_pt random
    cameras; (R, cam0, pts0, obs_cam, obs_pt, obs_xy)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 1, (num_pts, 3)) + [0, 0, 6]
    centers = rng.normal(0, 0.5, (num_cams, 3))
    R = np.tile(np.eye(3), (num_cams, 1, 1))
    f = 800.0
    obs_pt = np.repeat(np.arange(num_pts), obs_per_pt)
    obs_cam = np.concatenate(
        [rng.choice(num_cams, obs_per_pt, replace=False)
         for _ in range(num_pts)])
    pc = np.einsum("nij,nj->ni", R[obs_cam], pts[obs_pt] - centers[obs_cam])
    xy = -f * pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.5, (len(obs_pt), 2))
    cam0 = np.zeros((num_cams, 9))
    cam0[:, :3] = centers + rng.normal(0, 0.01, centers.shape)
    cam0[:, 6] = f * (1 + rng.normal(0, 0.01, num_cams))
    return (R, cam0, pts + rng.normal(0, 0.02, pts.shape),
            obs_cam.astype(np.int32), obs_pt.astype(np.int32), xy)


def measure_ba_iter(num_cams, num_pts, obs_per_pt, iters,
                    device="cuda") -> float:
    """Seconds an LM iteration of the unsharded BA on `device` (f64) for
    the given shard size: a warm run, then a timed one from cameras moved
    by 1e-7."""
    dev = resolve_device(device)
    R, cam0, pts, oc, op, oxy = synth_ba(num_cams, num_pts, obs_per_pt)
    prob = build_problem(R, cam0, pts, oc, op, oxy, est_focal=True,
                         est_distortion=True, device=dev)
    float(run_ba(prob, max_iters=iters).cost)
    prob2 = build_problem(R, cam0 + 1e-7, pts, oc, op, oxy, est_focal=True,
                          est_distortion=True, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    r = run_ba(prob2, max_iters=iters)
    float(r.cost)
    dt = time.perf_counter() - t0
    return dt / max(int(r.iters), 1)


def allreduce_payload(num_cams, solver="chol", cg_iters=25
                      ) -> Tuple[int, int]:
    """(elements, all-reduces) one LM iteration of the port's sharded BA
    sums or maxes over the ranks (`ops/ba.py::_lm_loop`):

      * the normal blocks U [C,9,9], g_c [C,9] and the cost, one psum_all
        (rebuilt after an accepted step);
      * solver "chol": S_off [C·9, C·9] and rhs_off [C,9], one psum_all;
        solver "cg" (`_solve_schur_cg_sharded`): the preconditioner's
        D_off [C,9,9] and rhs_off [C,9] in one psum_all, then one [C,9]
        psum a CG iteration;
      * the step's new cost, predicted decrease, |pts|² before and after
        and |dpts|², one psum_all; the largest |g_p|, one pmax."""
    C = num_cams
    blocks = C * 81 + C * 9 + 1
    scalars = 5 + 1
    if solver == "cg":
        return (blocks + C * 81 + C * 9 + cg_iters * C * 9 + scalars,
                4 + cg_iters)
    return blocks + C * C * 81 + C * 9 + scalars, 4


def ring_allreduce_seconds(nbytes, reduces, D, link_bytes_per_s, hop_s):
    """A ring all-reduce's time: every rank sends 2·(D−1)/D of the bytes,
    and each all-reduce takes 2·(D−1) steps of `hop_s`."""
    if D == 1:
        return 0.0
    return (2.0 * (D - 1) / D * nbytes / link_bytes_per_s
            + 2.0 * (D - 1) * hop_s * reduces)


def comm_seconds_per_iter(num_cams, D, link_bytes_per_s, hop_s,
                          solver="chol", cg_iters=25, elem_bytes=F64_BYTES):
    """Ring all-reduce seconds of one LM iteration of the port's sharded
    BA (`allreduce_payload`) at `elem_bytes` an element.  solver "chol"
    sums the dense S_off every iteration (up to 200 cameras); "cg" (above
    200, Ceres' ITERATIVE_SCHUR) sums [C,9,9] and [C,9] blocks and one
    [C,9] a CG iteration."""
    elements, reduces = allreduce_payload(num_cams, solver, cg_iters)
    return ring_allreduce_seconds(elem_bytes * elements, reduces, D,
                                  link_bytes_per_s, hop_s)


def ring_matcher_model(n_images, keys_per_image, D, ici_bytes_per_s,
                       pairs_per_s_one_chip):
    """A copy of the JAX script's model of the image-sharded ring matcher:
    each rank computes N²/2D pair matches an all-pairs pass and forwards
    its [I, K, 128] int8 shard D times around the ring; a step's transfer
    can overlap the next rotation's compute, so the model charges
    max(0, comm − compute) a step, an upper bound on the exposed cost."""
    if D == 1:
        return 1.0
    I = -(-n_images // D)
    shard_bytes = I * keys_per_image * 128  # int8
    compute_s = (n_images * n_images / 2.0 / D) / pairs_per_s_one_chip
    per_step_compute = compute_s / D
    per_step_comm = shard_bytes / ici_bytes_per_s
    exposed = D * max(0.0, per_step_comm - per_step_compute)
    return round(compute_s / (compute_s + exposed), 3)


def measure_matching(keys_per_image, pairs_per_batch: Sequence[int],
                     device="cuda") -> Dict[int, float]:
    """Matcher pairs/s against the pairs a kernel launch takes: 32 images
    of `keys_per_image` jittered copies of one base set, 4 launches of
    each batch size, a warm call then a timed one."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n_img = 32
    base = rng.integers(0, 256, (keys_per_image, 128)).astype(np.int32)
    descs = [np.clip(base + rng.integers(-6, 7, base.shape), 0, 255
                     ).astype(np.uint8)[rng.permutation(keys_per_image)]
             for _ in range(n_img)]
    table = DescriptorTable(descs, device=dev)
    all_pairs = [(i, j) for i in range(n_img) for j in range(i + 1, n_img)]
    out = {}
    for bs in pairs_per_batch:
        pairs = all_pairs[:4 * bs]
        table.match_pairs(pairs, batch=bs, min_matches=16)
        t0 = time.perf_counter()
        table.match_pairs(pairs, batch=bs, min_matches=16)
        out[bs] = len(pairs) / (time.perf_counter() - t0)
    return out


def main(argv: Sequence[str] = None) -> Dict:
    ap = argparse.ArgumentParser(
        prog="scaling", description="Measured per-shard BA and matcher "
        "times on one device, projected to D cards (one JSON line).")
    ap.add_argument("--cams", type=int, default=64)
    ap.add_argument("--pts", type=int, default=32768)
    ap.add_argument("--obs_per_pt", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--ici_gbps", type=float, default=NVLINK_GBPS,
                    help="all-reduce ring bandwidth a card, GB/s (default "
                         "H100 SXM5 NVLink 4, 450 GB/s a direction: "
                         "NVIDIA's H100 datasheet, 900 GB/s both ways)")
    ap.add_argument("--hop_us", type=float, default=NVLINK_HOP_US,
                    help="latency of one ring step, µs (default 0.6: "
                         "NCCL's latency model, NVLink, ring, LL)")
    ap.add_argument("--match_keys", type=int, default=1024,
                    help="keys an image of the matcher leg")
    ap.add_argument("--match_batches", default="8,16,32,64",
                    help="pairs a kernel launch, comma-separated")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    dev = resolve_device(args.device)

    measured_ms = {}
    for D in SWEEP:
        p = max(args.pts // D, 1)
        measured_ms[D] = 1e3 * measure_ba_iter(
            args.cams, p, args.obs_per_pt, args.iters, device=dev)

    ici = args.ici_gbps * 1e9
    hop = args.hop_us * 1e-6
    # Dense Cholesky up to 200 cameras, matrix-free CG above
    # (BundleCeres.cpp:132-134), as in the JAX script.
    solver = "cg" if args.cams > 200 else "chol"
    projected_ms, efficiency = {}, {}
    t1 = measured_ms[1]
    for D in SWEEP:
        tD = measured_ms[D] + 1e3 * comm_seconds_per_iter(
            args.cams, D, ici, hop, solver=solver)
        projected_ms[D] = tD
        efficiency[D] = t1 / (D * tD)

    matching = measure_matching(
        args.match_keys, [int(b) for b in args.match_batches.split(",")],
        device=dev)
    rate1 = max(matching.values())
    ring_eff = {D: ring_matcher_model(256, 2048, D, ici, rate1)
                for D in SWEEP}
    elements, reduces = allreduce_payload(args.cams, solver)
    result = {
        "metric": "projected_scaling_efficiency",
        "value": efficiency[8],
        "unit": "fraction at 8 cards",
        "platform": dev.type,
        "device": device_record(dev),
        "ba_problem": {"cams": args.cams, "pts": args.pts,
                       "obs": args.pts * args.obs_per_pt,
                       "solver": solver},
        "ba_measured_ms_per_iter_per_shard": measured_ms,
        "ba_projected_ms_per_iter": projected_ms,
        "ba_projected_efficiency": efficiency,
        "comm_model": {"ici_gbps": args.ici_gbps, "hop_us": args.hop_us,
                       "elem_bytes": F64_BYTES,
                       "allreduces_per_iter": reduces,
                       "psum_payload_mb": F64_BYTES * elements / 1e6,
                       "source": "model inputs, not measurements: "
                                 "--ici_gbps / --hop_us (defaults H100 "
                                 "SXM5 NVLink 4 datasheet, NCCL latency "
                                 "model)"},
        "ring_matcher_projected_efficiency_256img": ring_eff,
        "matching_pairs_per_s_vs_batch": matching,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
