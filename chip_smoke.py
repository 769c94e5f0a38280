"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. build   — compile the hand-written kernels (csrc/*.cu) with nvcc, in
               parallel; check that ptxas reports no spills for the
               wgmma kernels (two_nn.cu's int8 four: one-launch and
               two-launch, 2-NN and product-only; its f32 two;
               two_nn_variants.cu's twenty-one: eleven one-launch, ten
               two-launch), serialises no wgmma and drops no setmaxnreg.
  2. kernels — hold each kernel bit-exact against its plain PyTorch version
               on the card: the int8 2-NN (`wgmma`, one launch), its
               two-launch form (identical bits) and the norms kernel, the
               f32 2-NN (`wgmma`) and its pre-pass kernel, and the first
               design's `mma.sync` kernel of each type beside them, at 64
               images x 2048 keys (all 2016 pairs), ragged keys up to 4096,
               duplicated rows (ties), integer-valued f32 tables and
               garbage rows past the counts; the f32 kernels within the
               stated tolerance on a real-valued table; time each `wgmma`
               kernel, the int8 one's two-launch form and the `mma.sync`
               twin in turns, the plain version, a library yardstick (f32
               matmul + topk), and the bound (the int8 rate; the bf16 rate
               for f32 tables, timed at 2016 pairs x 2048^2 on
               integer-valued f32 descriptors with the product-only split
               and the pre-pass); split an int8 call's device time (CUDA
               events around queued bare launches) and host time
               ("[split]"), one launch against two in turns, at the bench
               and the main-path shapes.
  3. main    — render a 24-view 1024x768 box room and run
               `bundler_sfm_tpu_torch.run_bundler --out bundle` on CUDA (SIFT,
               matching on the kernels, F/H verification, tracks, and the
               reconstruction: initial pair, resection, Schur-LM bundle
               adjustment with the outlier loop) with every launch count
               zeroed; check its outputs and the launch counts (one two_nn
               launch a 2-NN call and no yardstick: no norms kernel; the
               BA's `ba_runs_cuda` count too); hold bundle.out against gt.json
               (similarity-aligned centre error < 0.02, mean reprojection
               error < 1 px, at least as many cameras as the JAX package
               registers on the CPU from the same scene); run the
               reconstruction again on CUDA from the same scene (bundle.out
               byte-identical) and on the CPU with the same draw (the same
               camera count); check that the `mma.sync` kernel gives
               byte-identical matches; compare and time the kernels at the
               main path's shapes; re-run verification on the CPU with the
               same RANSAC draw and count differing pairs.
  4. staged — the reference's staged flow on phase 3's render, list.txt
               and .key.gz files, every run on CUDA in a fresh directory
               (each `bundler` run writes its constraints.txt checkpoint in
               its working directory) with the launch counts zeroed:
               (a) `keymatch` over the 24 key files: matches.init.txt
               byte-identical to run_bundler's; (b) `bundler --options_file`
               with RunBundler.sh's options: 24/24 cameras, centre error <
               0.02, reprojection < 1 px; (c) 4 images held out
               (--ignore_file), then resumed with --bundle --rerun_bundle
               --add_images and point anchors at ground-truth positions
               (mapped into the bundle's frame): 24/24 cameras, every
               anchored point kept; `register_image` of a held-out image on
               CUDA against its CPU run; (d) --slow_bundle
               --construct_max_connectivity --estimate_ignored on the first
               12 views: 12/12, and --slow_bundle --fix_necker on the first
               8 (the flip must run).  Every bundler run is repeated on
               CUDA and its bundle.out must be byte-identical.
  5. tools — the reference's post-bundle tools on phase 3's render,
               bundle.out and key files, every run in a fresh directory
               under build/smoke/tools/, each run's seconds printed: (a)
               `bundler --bundle --compute_covariance` on CUDA and on the
               CPU (24 blocks, each SPD; the CUDA inverse within rtol 1e-8
               of the CPU's); (b) `radialundistort` of the 24 images on
               CUDA and on the CPU (bundle.rd.out and list.rd.txt
               byte-identical; the undistorted arrays equal, or off by 1
               on at most 1e-6 of the values, the count printed); (c)
               `bundle2pmvs` and `bundle2vis` on bundle.rd.out and
               `bundle2ply` (24 projection files, each projecting the
               camera's points onto their observations within a median 1
               px); (d) the fisheye flow: the key files pushed through a
               fisheye lens, every list entry flagged fisheye, `keymatch`
               (launch counts zeroed just before; matches.init.txt
               byte-identical to run_bundler's) and `bundler
               --options_file --fisheye` (24/24 cameras, centre error <
               0.02, reprojection < 1 px), then `fisheyeundistort` on CUDA
               and on the CPU, compared as in (b).
  6. variants — hold every 2-NN variant kernel (csrc/two_nn_variants.cu) of
               both designs (the `wgmma` design, one launch each, its
               two-launch forms `_two_launch` and its `mma.sync` twins
               `_mma`; both ablation modes included) bit-exact against its
               plain version and each one-launch kernel against its
               two-launch form, its twin and (the exact ones) two_nn_pairs,
               logging the cluster size, shared memory a CTA and resident
               clusters of bf16 oneblock at tq 256-1024 (clusters of 2 and
               4 CTAs at 512 and 1024), and the pre-pass kernel and
               bf16_table against their own, at the probe's shape (276
               pairs x 2048 keys), at ragged counts, on ties and with
               garbage rows past the counts; run the probe entry point
               (`probes/probe_two_nn_variants.py`) with the launch counts
               zeroed, check every exact variant IDENTICAL to two_nn,
               every kernel launched once per probe call, no yardstick ran
               and the pre-pass ran once (the bf16 table the probe makes);
               time two_nn, its two-launch form and `mma.sync` kernel,
               each variant kernel beside its two-launch form and
               `mma.sync` twin in turns, its plain version, a library
               yardstick, the int8 and bf16 bounds and the pre-pass at
               2208 pairs x 2048^2, and split each call's device and host
               time, one launch against two.
  7. library — the JAX package's library modules on phase 3's bundle.out
               (24 cameras, 13402 points) and its 24 x 4096-key
               descriptors, under build/smoke/library/, each step's
               seconds printed: (a) `match_pairs_batched` over all 276
               pairs on the uint8 descriptors and on the same values as
               float32, each with the launch counts zeroed just before
               (int8: one two_nn launch per chunk of 32 pairs; f32: one
               two_nn_f32 and one pre-pass launch), both
               dicts and match files identical to
               `DescriptorTable.match_pairs(..., min_matches=16)`, the
               kernels bit-exact against their plain versions on the
               tensors each 2-NN call of that run was given, ms per call
               and in the kernels beside the bound; (b)
               `knn_plane_normals` and `estimate_point_normals` (k=32) on
               CUDA and on the CPU (every normal within 1e-6 rad,
               unoriented resp. oriented); (c)
               `setup_scene_ground_plane`, `fit_plane_to_points` in its
               three modes and `compute_image_rotations` with one draw of
               samples on both devices (same inliers and rotations, planes
               within 1e-9; a 2D line up to its sign) and
               `estimate_point_normals_confidence`; (d)
               `estimate_similarity_ransac` on the pair with the most
               matches (same inliers, model within 1e-9); (e) every
               observation through the four camera models (CUDA vs CPU
               within 1e-6 px; the quaternion and known-intrinsics models
               within 1e-4 px of the Snavely model, < 1 px from the
               observations); (f) cameras.xml / points.xml byte-identical
               with each device's plane.
  8. multi_device — the multi-device paths (`parallel/`) on phase 3's data,
               under build/smoke/multi/, at world 1 over NCCL in this
               process and at world 2 over gloo in two spawned ranks
               sharing cuda:0 (NCCL takes one rank a card), the launch
               counts zeroed just before each counted run: (a) the ring
               matcher (ShardedDescriptorTable) and the pair-split
               DescriptorTable(mesh=) over the 276 pairs, each dict
               identical to DescriptorTable.match_pairs, the 2-NN kernel
               bit-exact on one rotation's tensors (and identical to its
               two-launch form there), each call timed first and warm, ten
               two_nn launches in the counted runs and no other 2-NN
               kernel; (b) the point-sharded outlier loop on phase 3's
               final bundle (points moved by seeded noise): bit-identical
               to run_ba_outlier_loop at world 1; at world 2 the same
               obs_valid, pt_removed and passes, the cost within rtol 1e-9
               and every observation's reprojection within 1e-6 px; LM
               iterations, ms an iteration warm, peak memory per rank; (c)
               run_bundler --num_devices 2 on the render in a directory per
               rank: 24/24, centre error < 0.02, reprojection < 1 px, both
               ranks' cameras identical, no file from rank 1.
  9. ba_scale — bundle adjustment at the JAX package's race scale
               (`probes/ba_scale.py`: benchmarks/ba_vs_sba.py's arc scene
               at 256 cameras / 262144 points and 512 / 524288, 8 views a
               point, f64, the covisibility-window plan), the launch counts
               zeroed first (no kernel may launch): (a) run_ba windowed to
               150 iterations, the final cost <= 1.001 x the cost at the
               generator's ground truth, mean reprojection < 0.6 px, a
               second CUDA run bit-identical; (b) the windowed S_off and
               rhs_off of the first linearization within 1e-12 of the
               largest entry of the full-C ones (one-shot tables at 256,
               chunked at 512); (c) at 256, 3 LM iterations of the
               windowed, chunked and one-shot full-C forms in turns, costs
               within 1e-10 relative; window, groups, wide points,
               iterations, ms an iteration, BA seconds and peak memory
               printed as "[ba_scale]" lines.
 10. bench — the port's two benchmark programs, each with the launch
               counts zeroed just before: (a) `python -m
               bundler_sfm_tpu_torch.bench` at its default shape (64
               images x 2048 keys, all 2016 pairs; BA legs 8 x 2048, 64 x
               8192 and the sparse 64 x 16384, f64): its line's keys,
               its rates finite and positive, kernel_mfu and the BA MFUs
               in (0, 1], the three timed rotations' match counts equal,
               24 launches of two_nn and none of any other kernel; (b)
               `probes/e2e_synthetic` at its default (32 images x 2048
               keys, keys to bundle.out under build/smoke/e2e/): at least
               as many cameras as the JAX package registers on the CPU,
               mean reprojection < 1 px, ate_rel < 0.02, one two_nn launch
               and none of any other kernel; then every 2-NN call of both
               runs (chunks of 1024 and 992 pairs, 2016, and e2e's 496 on
               its track and clutter keys) bit-exact against its plain
               version on the tensors it was given; lines "[bench]" and
               "[e2e]".
 11. pixels — the port's from-pixels program and scaling program, each
               with the launch counts zeroed just before: (a) 24 views of
               the box room rendered at 800x600 (f = 700) under
               build/smoke/pixels/ through `probes/e2e_pixels` at
               --max_keys 4096 (JPEGs, SIFT, the 276 pairs on the 2-NN
               kernel, verification, stage 5, bundle.out): at least 20 of
               24 cameras, mean reprojection < 1 px, ate_rel < 0.02, the
               .key files written, one two_nn launch and none of any other
               kernel; (b) `probes/scaling --iters 5`: its numbers finite
               and positive, 32 two_nn launches (the matcher leg's batches
               of 8-64 pairs) and none of any other kernel; then every
               2-NN call of both runs bit-exact against its plain version
               on the tensors it was given; the stage seconds, SIFT's peak
               memory and the launches logged as "[pixels]" and
               "[scaling]" lines.
`--phases build,kernels,variants` (any subset, in this order) runs only
those phases, checks what they check and prints no result line.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record, and the one before that the card's name and
power limit as nvidia-smi reports them.  `--dump-scene PATH` also writes
the main path's verified scene (the reconstruction's input) as a pickle of
numpy / Python state, so the JAX package can reconstruct the same scene.
"""

import contextlib
import copy
import io
import json
import math
import os
import re
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from bundler_sfm_tpu_torch import bench  # noqa: E402
from bundler_sfm_tpu_torch.ops import matching_cuda  # noqa: E402
from bundler_sfm_tpu_torch.ops import matching_variants  # noqa: E402
from bundler_sfm_tpu_torch.ops.matching import (  # noqa: E402
    DescriptorTable, launch_counts,
)
from bundler_sfm_tpu_torch.probes import probe_two_nn_variants  # noqa: E402
from bundler_sfm_tpu_torch.utils.device import device_record  # noqa: E402

INT8_TOPS = 1979e12      # H100 SXM dense int8 tensor-core peak
BF16_TOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
HBM_BYTES_S = 3.35e12    # H100 SXM HBM3
TWO_NN_SOURCE = "bundler_sfm_tpu_torch/csrc/two_nn.cu"
TWO_NN_REPLACES = "bundler_sfm_tpu/ops/matching_pallas.py:193"
VARIANTS_SOURCE = "bundler_sfm_tpu_torch/csrc/two_nn_variants.cu"
PROBE = "benchmarks/probes/probe_pallas_variants.py"
# Cameras the JAX package's bundle_adjust_fast registers on the CPU (f64)
# from the main path's verified scene, dumped with --dump-scene and
# reconstructed by `python -m tests.test_torch_jax_reference` (PERF.md
# section 5); the port must register at least as many.
JAX_CPU_CAMERAS = 24


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    """A failed check raises (also under python -O, unlike assert)."""
    if not ok:
        raise AssertionError(what)


def failing_into(failures):
    """A check that logs and keeps a failure instead of raising; the
    phase returns `failures` and main() raises once every phase ran."""
    def check_later(ok, what):
        if not ok:
            log(f"FAILED: {what}")
            failures.append(what)
    return check_later


def zero_launches():
    """Every kernel's launch count to 0, just before a path is driven."""
    for counts in (matching_cuda.LAUNCHES, matching_variants.LAUNCHES):
        for k in counts:
            counts[k] = 0


def cuda_ms(fn, reps, warmup=1):
    """Mean device time of fn() over reps calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(fn, calls=20):
    """Median device time of one fn() in µs: CUDA events around each of
    `calls` calls, all queued behind a ~10 ms device sleep, so the device
    runs them back to back and never waits for the host between an event
    and the call (fn must not synchronise: bare launches, or wrappers
    that only allocate and launch).  After one warm-up call."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    torch.cuda._sleep(20_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev])) * 1e3


def host_us(fn, calls):
    """Median host time of fn() in µs over max(calls, 30) calls, each
    started on a drained device (what a call costs the issuing thread; a
    wrapper's own device syncs then wait only for its own work; the median,
    since this host's scheduling puts outliers of several times the
    typical call into a mean)."""
    fn()
    t = []
    for _ in range(max(calls, 30)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(t)) * 1e6


def fmt_us(d):
    return ", ".join(f"{k} {'none' if v is None else f'{v:.2f}'}"
                     for k, v in d.items())


def all_pairs(n):
    return [(j, i) for i in range(n) for j in range(i)]


def pair_tensors(pairs):
    p = torch.tensor(pairs, dtype=torch.int32, device="cuda")
    return p[:, 0].contiguous(), p[:, 1].contiguous()


def compare_outputs(got, want, what):
    """A kernel's (d0, i0, d1) against its plain version's; bit-exact or
    raise.  Returns the max |difference| over finite distances (0)."""
    bad = [int((g != w).sum()) for g, w in zip(got, want)]
    err = 0.0
    for k in (0, 2):
        fin = want[k].abs() < matching_cuda.BIG
        if fin.any():
            err = max(err, float((got[k] - want[k])[fin].abs().max()))
    log(f"{what}: mismatches d0 {bad[0]}, i0 {bad[1]}, d1 {bad[2]}, "
        f"max |err| {err}")
    check(not any(bad), f"kernel disagrees with its plain version: {what}")
    return err


def yardstick_launches(launches):
    """The launches of kernels no path may reach: the int8 2-NN's
    two-launch form (norms kernel included), every variant's, and the
    `mma.sync` kernels."""
    return {k: v for k, v in launches.items() if v and (
        k == "two_nn_norms" or "two_launch" in k or "_mma" in k)}


def compare_prepass_f32(tab, counts, name):
    """The f32 pre-pass kernel (bf16 table, |x|^2, column norms) bit-exact
    against its plain version."""
    got = matching_cuda.prepass_f32(tab, counts)
    torch.cuda.synchronize()
    want = matching_cuda.prepass_f32_plain(tab, counts)
    bad = [int((g != w).sum()) for g, w in zip(got, want)]
    log(f"[kernels] {name} two_nn_f32_prepass: {tab.shape[0]} x "
        f"{tab.shape[1]} rows, mismatches bf16 table {bad[0]}, |x|^2 "
        f"{bad[1]}, column norms {bad[2]}")
    check(not any(bad), f"two_nn_f32_prepass disagrees with its plain "
          f"version: {name}")


def compare_two_nn(tab, counts, pi, pj, name):
    """The 2-NN kernels vs the plain version on the same inputs: two_nn
    (int8 or f32 `wgmma`; for int8 also its two-launch yardstick, which
    must give the same bits) and the first design's `mma.sync` kernel of
    the same type, and the norms kernel (int8) or the pre-pass kernel
    (f32) against its own plain version.  Bit-exact or raise; returns
    two_nn's max |err| over finite distances (0)."""
    M = matching_cuda
    label = f"{len(pi)} pairs x {tab.shape[1]} keys {tab.dtype}"
    want = M._two_nn_pairs_plain(tab, tab, counts, pi, pj)
    f32 = tab.dtype == torch.float32
    kernels = [("two_nn_f32" if f32 else "two_nn", M.two_nn_pairs),
               ("two_nn_f32_mma" if f32 else "two_nn_mma",
                M.two_nn_pairs_mma)]
    if not f32:
        kernels.insert(1, ("two_nn_two_launch", M.two_nn_pairs_two_launch))
    if f32:
        compare_prepass_f32(tab, counts, name)
    else:
        norms = matching_cuda.two_nn_norms(tab, counts)
        torch.cuda.synchronize()
        bad = int((norms != matching_cuda.two_nn_norms_plain(tab, counts))
                  .sum())
        log(f"[kernels] {name} two_nn_norms: {tab.shape[0]} x "
            f"{tab.shape[1]} rows, mismatches {bad}")
        check(bad == 0, f"two_nn_norms disagrees with its plain version: "
              f"{name}")
    errs, outs = [], []
    for kname, fn in kernels:
        outs.append(fn(tab, tab, counts, pi, pj))
        torch.cuda.synchronize()
        errs.append(compare_outputs(outs[-1], want, f"[kernels] {name} "
                                    f"{kname}: {label}"))
    if not f32:
        same = all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
        log(f"[kernels] {name} two_nn identical to its two-launch form: "
            f"{same}")
        check(same, f"two_nn differs from its two-launch form: {name}")
    return errs[0]


def compare_two_nn_real(tab, counts, pi, pj, name):
    """The f32 kernels on a real-valued table, where tensor-core sums run
    in another order than the plain version's: within
    `matching_cuda.f32_tolerance` (|d - d_plain| <= 1e-5 (|q|^2 + |b|^2), i0
    equal wherever the plain d1 - d0 exceeds twice that) or raise.  Returns
    two_nn_f32's largest |d - d_plain| / tolerance."""
    M = matching_cuda
    want = M._two_nn_pairs_plain(tab, tab, counts, pi, pj)
    tol = M.f32_tolerance(tab, tab, counts, pi, pj)
    worst = []
    for kname, fn in (("two_nn_f32", M.two_nn_pairs),
                      ("two_nn_f32_mma", M.two_nn_pairs_mma)):
        got = fn(tab, tab, counts, pi, pj)
        torch.cuda.synchronize()
        bad = M.f32_mismatches(got, want, tol)
        ratio = max(float(((g - w).abs() / tol)[w < M.BIG].max())
                    for g, w in ((got[0], want[0]), (got[2], want[2])))
        # Rows whose nearest two are further apart than twice the
        # tolerance; the zero rows that pad a short image tie everywhere.
        sep = (want[2] - want[0]) > 2 * tol
        log(f"[kernels] {name} {kname}: {len(pi)} pairs x {tab.shape[1]} "
            f"keys real-valued f32: outside the tolerance d0 {bad[0]}, i0 "
            f"{bad[1]}, d1 {bad[2]}; largest |err| / tolerance {ratio:.4f}; "
            f"i0 equal at {int((got[1] == want[1])[sep].sum())} of the "
            f"{int(sep.sum())} rows separated by more than twice it; "
            f"bit-identical d0 {int((got[0] == want[0]).sum())} of "
            f"{got[0].numel()}")
        check(not any(bad), f"{kname} outside its tolerance: {name}")
        worst.append(ratio)
    return worst[0]


def yardstick(tab, counts, pi, pj, chunk=64):
    """Library computation of the same 2-NN: f32 matmul (TF32 off) +
    topk(k=2, largest=False) over masked distances.  Timed only."""
    x = tab.float()
    sq = (x * x).sum(-1)
    col = torch.arange(tab.shape[1], device=tab.device)
    for s in range(0, len(pi), chunk):
        a, b = pi[s:s + chunk].long(), pj[s:s + chunk].long()
        d = sq[a][:, :, None] + sq[b][:, None, :] \
            - 2.0 * torch.matmul(x[a], x[b].transpose(1, 2))
        d = d.masked_fill(col >= counts[b][:, None, None], matching_cuda.BIG)
        torch.topk(d, 2, dim=-1, largest=False)


def two_nn_bound_ms(tab, counts, pi, pj, peak=INT8_TOPS):
    """Least time for the work: 2·128·n_i·n_j operations per pair (valid
    queries x valid db rows) at `peak` (the int8 rate; the bf16 rate for
    the f32 kernel, whose operands are bf16), or the bytes of the table
    read once and the three [B, K] outputs written once — whichever is
    larger."""
    c = counts.long()
    ops = float(2 * 128 * (c[pi.long()] * c[pj.long()]).sum())
    nbytes = tab.numel() * tab.element_size() + 12 * len(pi) * tab.shape[1]
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_two_nn(tab, counts, pi, pj, reps, what):
    """Times of the int8 2-NN at one shape, all in this call (CUDA events
    around back-to-back wrapper calls): the `wgmma` wrapper (one launch),
    its two-launch form (norms kernel + 2-NN kernel) and the `mma.sync`
    kernel in turns (one, two, mma, mma, two, one; the means are kept), the
    norms wrapper alone, the plain version and the library yardstick;
    logged beside the bound.  Returns a dict of ms."""
    M = matching_cuda

    def one():
        return M.two_nn_pairs(tab, tab, counts, pi, pj)

    def two():
        return M.two_nn_pairs_two_launch(tab, tab, counts, pi, pj)

    def old():
        return M.two_nn_pairs_mma(tab, tab, counts, pi, pj)
    turns = [cuda_ms(f, reps) for f in (one, two, old, old, two, one)]
    t = {"ms": (turns[0] + turns[5]) / 2,
         "ms_two_launch": (turns[1] + turns[4]) / 2,
         "ms_before": (turns[2] + turns[3]) / 2,
         "norms_ms": cuda_ms(lambda: matching_cuda.two_nn_norms(tab, counts),
                             reps),
         "plain_ms": cuda_ms(lambda: matching_cuda._two_nn_pairs_plain(
             tab, tab, counts, pi, pj), max(1, reps // 10)),
         "library_ms": cuda_ms(lambda: yardstick(tab, counts, pi, pj),
                               max(1, reps // 10))}
    bound, by = two_nn_bound_ms(tab, counts, pi, pj)
    t.update(bound_ms=bound, bound_by=by)
    log(f"[kernels] {what}: two_nn (wgmma, one launch) {t['ms']:.4f} ms "
        f"({turns[0]:.4f}, {turns[5]:.4f}; {100 * bound / t['ms']:.2f} % of "
        f"the bound), two-launch form {t['ms_two_launch']:.4f} ms "
        f"({turns[1]:.4f}, {turns[4]:.4f}), mma.sync {t['ms_before']:.4f} ms "
        f"({turns[2]:.4f}, {turns[3]:.4f}; "
        f"{100 * bound / t['ms_before']:.2f} %), speed-up "
        f"{t['ms_before'] / t['ms']:.3f}x; norms wrapper {t['norms_ms']:.4f} "
        f"ms; plain {t['plain_ms']:.4f} ms, matmul+topk "
        f"{t['library_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
    return t


def split_two_nn_call(tab, counts, pi, pj, what, calls=20):
    """Where an int8 two_nn_pairs call's time goes, the one-launch kernel
    beside its two-launch form, in turns (one, two, two, one): the device
    time of each form launched bare through ctypes on preallocated tensors
    (`device_us`: the 2-NN kernel alone, and the norms kernel plus the 2-NN
    kernel that reads its constants) and the host time of each wrapper;
    then the host time of the norms wrapper, of the wrapper's output
    allocation and of each bare 2-NN launch.  Returns
    {"device_us", "device_us_two_launch", "host_us",
    "host_us_two_launch"}."""
    M = matching_cuda
    lib = M._load()
    stream = torch.cuda.current_stream().cuda_stream
    B, nq = len(pi), tab.shape[1]
    n_img, nd = tab.shape[0], tab.shape[1]
    norms = M.two_nn_norms(tab, counts)
    d0, i0, d1, scratch = M._outputs(B, nq, tab.device, norms.numel())

    def bare_norms():
        lib.two_nn_norms_i8(tab.data_ptr(), n_img, nd, counts.data_ptr(),
                            norms.data_ptr(), stream)

    def bare(cst, two_launch):
        return lambda: lib.two_nn_pairs_i8(
            tab.data_ptr(), nq * 128, nq, tab.data_ptr(), n_img, nd,
            counts.data_ptr(), cst.data_ptr(), two_launch, pi.data_ptr(),
            pj.data_ptr(), B, d0.data_ptr(), i0.data_ptr(), d1.data_ptr(),
            stream)
    one, ext = bare(scratch, 0), bare(norms, 1)

    def dev_one():
        return device_us(one, calls)

    def dev_two():
        return device_us(lambda: (bare_norms(), ext()), calls)

    def host_one():
        return host_us(lambda: M.two_nn_pairs(tab, tab, counts, pi, pj),
                       calls)

    def host_two():
        return host_us(lambda: M.two_nn_pairs_two_launch(
            tab, tab, counts, pi, pj), calls)
    d = [f() for f in (dev_one, dev_two, dev_two, dev_one)]
    h = [f() for f in (host_one, host_two, host_two, host_one)]
    out = {"device_us": (d[0] + d[3]) / 2,
           "device_us_two_launch": (d[1] + d[2]) / 2,
           "host_us": (h[0] + h[3]) / 2, "host_us_two_launch": (h[1] + h[2]) / 2}
    parts = {"norms wrapper": host_us(lambda: M.two_nn_norms(tab, counts),
                                      calls),
             "outputs": host_us(lambda: M._outputs(B, nq, tab.device,
                                                   norms.numel()), calls),
             "bare 2-NN launch": host_us(one, calls),
             "bare 2-NN launch reading the norms": host_us(ext, calls),
             "bare norms launch": host_us(bare_norms, calls)}
    log(f"[split] {what}: device µs a call, one launch {out['device_us']:.2f}"
        f" ({d[0]:.2f}, {d[3]:.2f}), two-launch form "
        f"{out['device_us_two_launch']:.2f} ({d[1]:.2f}, {d[2]:.2f}); "
        f"wrapper host µs a call, one launch {out['host_us']:.2f} ({h[0]:.2f}"
        f", {h[3]:.2f}), two-launch form {out['host_us_two_launch']:.2f} "
        f"({h[1]:.2f}, {h[2]:.2f}); host µs a call: {fmt_us(parts)}")
    return out


def time_two_nn_f32(tab, counts, pi, pj, reps, what):
    """Times of the f32 2-NN at one shape, all in this call: the `wgmma`
    wrapper (pre-pass + kernel) and its `mma.sync` twin in turns (new, old,
    old, new), the product-only split (one max a score in place of the
    top-2, held bit-exact against its plain version first), the pre-pass
    alone, the plain version and the library yardstick, beside the bound at
    the bf16 tensor-core rate.  Returns a dict of ms."""
    M = matching_cuda
    got = M.two_nn_product_max(tab, tab, counts, pi, pj)
    torch.cuda.synchronize()
    compare_outputs(got, M.product_max_plain(tab, tab, counts, pi, pj),
                    f"[kernels] two_nn_product_max_f32: {len(pi)} pairs x "
                    f"{tab.shape[1]} keys")

    def new():
        return M.two_nn_pairs(tab, tab, counts, pi, pj)

    def old():
        return M.two_nn_pairs_mma(tab, tab, counts, pi, pj)
    turns = [cuda_ms(f, reps) for f in (new, old, old, new)]
    t = {"ms": (turns[0] + turns[3]) / 2,
         "ms_before": (turns[1] + turns[2]) / 2,
         "product_ms": cuda_ms(lambda: M.two_nn_product_max(
             tab, tab, counts, pi, pj), reps),
         "prepass_ms": cuda_ms(lambda: M.prepass_f32(tab, counts), reps),
         "prepass_plain_ms": cuda_ms(lambda: M.prepass_f32_plain(
             tab, counts), reps),
         "plain_ms": cuda_ms(lambda: M._two_nn_pairs_plain(
             tab, tab, counts, pi, pj), max(1, reps // 10)),
         "library_ms": cuda_ms(lambda: yardstick(tab, counts, pi, pj),
                               max(1, reps // 10))}
    bound, by = two_nn_bound_ms(tab, counts, pi, pj, BF16_TOPS)
    t.update(bound_ms=bound, bound_by=by)
    log(f"[kernels] {what}: two_nn_f32 (wgmma) {t['ms']:.4f} ms "
        f"({turns[0]:.4f}, {turns[3]:.4f}; {100 * bound / t['ms']:.2f} % of "
        f"the bound), mma.sync {t['ms_before']:.4f} ms ({turns[1]:.4f}, "
        f"{turns[2]:.4f}; {100 * bound / t['ms_before']:.2f} %), speed-up "
        f"{t['ms_before'] / t['ms']:.3f}x; split: pre-pass + product + one "
        f"max a score {t['product_ms']:.4f} ms "
        f"({100 * bound / t['product_ms']:.2f} % of the bound), top-2 "
        f"epilogue +{t['ms'] - t['product_ms']:.4f} ms; pre-pass "
        f"{t['prepass_ms']:.4f} ms (plain {t['prepass_plain_ms']:.4f}); "
        f"plain {t['plain_ms']:.4f} ms, matmul+topk "
        f"{t['library_ms']:.4f} ms, bound {bound:.4f} ms ({by}, bf16 rate)")
    return t


def prepass_f32_bound_ms(tab):
    """The f32 pre-pass reads the table once and writes its bf16 copy,
    |x|^2 and the column norms (padded to the ring tile) once."""
    kp = -(-tab.shape[1] // matching_cuda.NORM_TILE) * matching_cuda.NORM_TILE
    rows = tab.shape[0] * tab.shape[1]
    nbytes = 4 * tab.numel() + 2 * tab.numel() + 4 * rows \
        + 4 * tab.shape[0] * kp
    return nbytes / HBM_BYTES_S * 1e3, "bytes"


def norms_bound_ms(tab):
    """The norms kernel moves the table once and writes one int32 per row
    (padded to the ring tile); its 128 MAC per row are far below."""
    kp = -(-tab.shape[1] // matching_cuda.NORM_TILE) * matching_cuda.NORM_TILE
    nbytes = tab.numel() * tab.element_size() + 4 * tab.shape[0] * kp
    return nbytes / HBM_BYTES_S * 1e3, "bytes"


def phase_build():
    """One nvcc per source under csrc/, all started together."""
    t0 = time.time()
    sources = sorted(f for f in os.listdir(os.path.join(
        ROOT, "bundler_sfm_tpu_torch", "csrc")) if f.endswith(".cu"))
    check(sources == ["two_nn.cu", "two_nn_variants.cu"], sources)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), ThreadPoolExecutor(
            len(sources)) as pool:
        paths = list(pool.map(
            lambda s: matching_cuda.build(s, verbose=True, force=True),
            sources))
    print(buf.getvalue(), end="", flush=True)
    for p in paths:
        log(f"[build] {os.path.relpath(p, ROOT)}")
    log(f"[build] {len(paths)} libraries in {time.time() - t0:.2f} s")
    # ptxas prints each kernel's spills under "Function properties for":
    # the wgmma kernels of two_nn.cu (int8 2-NN and product-only, each
    # folded and two-launch; f32 2-NN and product-only) and of
    # two_nn_variants.cu (11 folded instantiations, 10 two-launch ones),
    # none of which may spill or have its wgmma serialised.
    out = buf.getvalue()
    for kernel, n in (("two_nn_ws_kernel", 4), ("two_nn_f32_ws_kernel", 2),
                      ("variant_ws_kernel", 21)):
        spills = re.findall(rf"Function properties for \S*{kernel}\S*\n"
                            r"\s*(.*)\n", out)
        check(len(spills) == n and all(
            "0 bytes spill stores, 0 bytes spill loads" in x for x in spills),
            f"{kernel} spills or was not built now: {spills}")
        regs = re.findall(rf"Compiling entry function '\S*{kernel}\S*'.*\n"
                          r"(?:.*\n)*?.*Used (\d+) registers", out)
        log(f"[build] {kernel} ({n} instantiations): no spills; registers "
            f"{regs}")
    serial = [ln for ln in out.splitlines() if "serialized" in ln]
    check(not serial, f"ptxas serialised wgmma: {serial}")
    # A register budget the producer or consumer code cannot keep makes
    # ptxas drop the setmaxnreg it was given.
    dropped = [ln for ln in out.splitlines() if "setmaxnreg" in ln]
    check(not dropped, f"ptxas on setmaxnreg: {dropped}")


def phase_kernels():
    rng = np.random.default_rng(0)
    # (a) bench shape: 64 images x 2048 keys, all 2016 pairs.
    table = DescriptorTable(bench.make_descriptors(rng, 64, 2048),
                            device="cuda")
    pi, pj = pair_tensors(all_pairs(64))
    compare_two_nn(table.table, table.counts, pi, pj, "(a) bench")
    time_two_nn(table.table, table.counts, pi, pj, 20,
                f"(a) 2016 pairs x 2048^2 (2*2016*2048^2*128 = "
                f"{2 * 2016 * 2048**2 * 128:.3e} int8 ops at "
                f"{INT8_TOPS:.3e}/s)")
    split_two_nn_call(table.table, table.counts, pi, pj,
                      "(a) bench 2016 pairs x 2048^2")
    # The main path's shape on bench.py's generator: 24 images x 4096 keys,
    # all 276 pairs (phase 3 repeats it on the main path's descriptors).
    main = DescriptorTable(bench.make_descriptors(
        np.random.default_rng(24), 24, 4096), device="cuda")
    split_two_nn_call(main.table, main.counts, *pair_tensors(all_pairs(24)),
                      "main-path shape 276 pairs x 4096^2 (generated)")
    # (b) 8 images x 4096 keys, ragged counts (incl. 1 key and none).
    sizes = [4096, 4000, 3001, 2048, 1000, 65, 1, 0]
    descs = [rng.integers(0, 256, (n, 128)).astype(np.uint8) for n in sizes]
    for d in descs[1:5]:
        d[: min(len(d), 2000)] = descs[0][: min(len(d), 2000)]
    table = DescriptorTable(descs, device="cuda")
    pi, pj = pair_tensors([(i, j) for i in range(8) for j in range(8)])
    compare_two_nn(table.table, table.counts, pi, pj, "(b) ragged")
    # (c) ties: duplicated db rows, a db of one repeated row.
    descs = [rng.integers(0, 256, (512, 128)).astype(np.uint8)
             for _ in range(4)]
    for d in descs:
        d[100:200] = d[0:100]
        d[300] = d[5]
    descs[3][:] = descs[3][7]
    table = DescriptorTable(descs, device="cuda")
    pi, pj = pair_tensors([(i, j) for i in range(4) for j in range(4)])
    compare_two_nn(table.table, table.counts, pi, pj, "(c) ties")
    # (d) f32 table (integer-valued float descriptors), then f32 ragged
    # counts and f32 ties.
    descs = [rng.integers(0, 256, (n, 128)).astype(np.float32)
             for n in (1024, 700, 1, 513)]
    descs[2] = descs[0][:1].copy()
    descs[1][:50] = descs[0][:50]
    table = DescriptorTable(descs, device="cuda")
    pi, pj = pair_tensors([(i, j) for i in range(4) for j in range(4)])
    err32 = compare_two_nn(table.table, table.counts, pi, pj, "(d) f32")
    sizes = [4096, 3001, 65, 1, 0]
    descs = [rng.integers(0, 256, (n, 128)).astype(np.float32)
             for n in sizes]
    descs[1][:2000] = descs[0][1000:3000]
    descs[2][:] = 255.0
    descs[0][:8] = 0.0
    table = DescriptorTable(descs, device="cuda")
    pi, pj = pair_tensors([(i, j) for i in range(5) for j in range(5)])
    err32 = max(err32, compare_two_nn(table.table, table.counts, pi, pj,
                                      "(d) f32 ragged"))
    descs = [rng.integers(0, 256, (512, 128)).astype(np.float32)
             for _ in range(4)]
    for d in descs:
        d[100:200] = d[0:100]
        d[300] = d[5]
    descs[3][:] = descs[3][7]
    table = DescriptorTable(descs, device="cuda")
    pi, pj = pair_tensors([(i, j) for i in range(4) for j in range(4)])
    err32 = max(err32, compare_two_nn(table.table, table.counts, pi, pj,
                                      "(d) f32 ties"))
    # (e) nonzero garbage in the rows past each count (counts 0 included):
    # the plain version masks them; where a db has no valid row, i0 is 0.
    sizes = [1024, 1000, 129, 1, 0, 0]
    for dtype in (torch.int8, torch.float32):
        tab = torch.from_numpy(rng.integers(-128, 128, (6, 1024, 128))
                               ).to(dtype)
        counts = torch.tensor(sizes, dtype=torch.int32)
        tab[1, 600:1000] = tab[0, 0:400]
        pi, pj = pair_tensors([(i, j) for i in range(6) for j in range(6)])
        tab, counts = tab.cuda(), counts.cuda()
        compare_two_nn(tab, counts, pi, pj, "(e) garbage past the count")
        got = matching_cuda.two_nn_pairs(tab, tab, counts, pi, pj)
        check(not got[1][pj >= 4].any(), "i0 != 0 for a db with no row")
    # (f) the f32 kernel at the bench shape: integer-valued f32 descriptors.
    descs = [d.astype(np.float32)
             for d in bench.make_descriptors(rng, 64, 2048)]
    table = DescriptorTable(descs, device="cuda")
    pi, pj = pair_tensors(all_pairs(64))
    err32 = max(err32, compare_two_nn(table.table, table.counts, pi, pj,
                                      "(f) f32 bench"))
    t32 = time_two_nn_f32(table.table, table.counts, pi, pj, 10,
                          "(f) f32 2016 pairs x 2048^2")
    t32["max_abs_err"] = err32
    t32["prepass_bound"] = prepass_f32_bound_ms(table.table)
    # (g) real-valued f32: L2-normalised Gaussian rows scaled to 512, with
    # near-duplicates (noisy copies) across images, ragged counts.
    sizes = [1024, 1000, 700, 129, 1, 0]
    descs = []
    for n in sizes:
        x = rng.normal(size=(n, 128))
        descs.append(x)
    descs[1][:600] = descs[0][:600] + 0.05 * rng.normal(size=(600, 128))
    descs[2][:300] = descs[0][300:600] + 0.2 * rng.normal(size=(300, 128))
    descs = [(512.0 * d / np.maximum(np.linalg.norm(d, axis=1,
                                                    keepdims=True), 1e-12)
              ).astype(np.float32) for d in descs]
    table = DescriptorTable(descs, device="cuda")
    pi, pj = pair_tensors([(i, j) for i in range(6) for j in range(6)])
    t32["tolerance_ratio"] = compare_two_nn_real(
        table.table, table.counts, pi, pj, "(g) real-valued")
    return t32


def read_scene(workdir):
    """Scene inputs from the files run_bundler wrote (list.txt, .key.gz,
    matches.init.txt)."""
    from PIL import Image
    from bundler_sfm_tpu_torch.io.keyfile import keys_to_centered, read_key_file
    from bundler_sfm_tpu_torch.io.listfile import read_list_file
    from bundler_sfm_tpu_torch.io.matchfile import read_match_file
    entries = read_list_file(os.path.join(workdir, "list.txt"), workdir)
    dims, key_xy, descs = [], [], []
    for e in entries:
        with Image.open(e.name) as im:
            w, h = im.size
        base = os.path.splitext(os.path.basename(e.name))[0]
        info, desc = read_key_file(os.path.join(workdir, base + ".key.gz"))
        dims.append((w, h))
        key_xy.append(keys_to_centered(info, w, h)[:, :2].astype(np.float64))
        descs.append(desc)
    matches = read_match_file(os.path.join(workdir, "matches.init.txt"))
    return entries, dims, key_xy, descs, matches


def verify_on(device, entries, dims, key_xy, matches, outdir):
    """The verification stage on `device`, with the RANSAC draw made on the
    CPU (seed 0), so every device sees the same samples."""
    from bundler_sfm_tpu_torch.config import default_pipeline_config
    from bundler_sfm_tpu_torch.convert import scene_from_numpy
    from bundler_sfm_tpu_torch.io.matchfile import read_match_table
    from bundler_sfm_tpu_torch.pipeline.verify import (
        TorchSampler, compute_geometric_constraints,
    )
    os.makedirs(outdir, exist_ok=True)
    scene = scene_from_numpy(entries, dims, key_xy, matches,
                             default_pipeline_config(), device=device)
    t0 = time.time()
    compute_geometric_constraints(
        scene, seed=0, scores_path=os.path.join(outdir, "scores.txt"),
        snapshot_dir=outdir, sampler=TorchSampler(0, "cpu"))
    secs = time.time() - t0
    inliers = read_match_table(len(entries), ".ransac", outdir)
    return scene, inliers, secs


def _differing_pairs(a, b):
    return [p for p in sorted(set(a) | set(b))
            if p not in a or p not in b or not np.array_equal(a[p], b[p])]


def compare_verification(entries, dims, key_xy, matches, workdir):
    """Verification on CUDA and on the CPU from the same matches and the
    same RANSAC draw.  Minimal-sample fits are ill-conditioned, so the two
    devices' roundings move some pairs' best hypotheses; the CPU run on
    keypoints scaled by (1 + 2^-52) measures that floor.  Requires track
    and F-inlier totals within 2% of the CPU's, and no more differing
    pairs than twice the floor plus 5% of the pairs."""
    runs = {}
    for name, dev, scale in (("cuda", "cuda", 1.0), ("cpu", "cpu", 1.0),
                             ("cpu+1ulp", "cpu", 1.0 + 2.0 ** -52)):
        xy = [k * scale for k in key_xy]
        runs[name] = verify_on(dev, entries, dims, xy, matches,
                               os.path.join(workdir, f"verify_{name}"))
        scene, inl, secs = runs[name]
        log(f"[main] verification on {name}: {secs:.2f} s, {len(inl)} "
            f"pairs kept, {sum(len(m) for m in inl.values())} F inliers, "
            f"{len(scene.tracks)} tracks")
    (sg, ig, _), (sc, ic, _), (sp, ip, _) = (runs[k] for k in
                                             ("cuda", "cpu", "cpu+1ulp"))
    d_dev = _differing_pairs(ig, ic)
    d_ulp = _differing_pairs(ip, ic)
    n_pairs = len(set(ig) | set(ic))
    log(f"[main] F inlier sets differing from the CPU run: CUDA "
        f"{len(d_dev)} of {n_pairs} pairs {d_dev}; CPU with keypoints "
        f"scaled by 1+2^-52: {len(d_ulp)} {d_ulp}")
    tot = {k: sum(len(m) for m in v[1].values()) for k, v in runs.items()}
    for k in ("cuda", "cpu+1ulp"):
        check(abs(tot[k] - tot["cpu"]) <= 0.02 * tot["cpu"], tot)
        nt = len(runs[k][0].tracks)
        check(abs(nt - len(sc.tracks)) <= 0.02 * len(sc.tracks), k)
    check(len(d_dev) <= 2 * len(d_ulp) + 0.05 * n_pairs, (d_dev, d_ulp))


def check_estimators_on_card():
    """F and H RANSAC on CUDA against the CPU on well-conditioned synthetic
    pairs (points in general position, 0.2 px noise, 30% outliers) with the
    same draw: inlier masks identical; unit-norm H within 1e-9, F within
    1e-6."""
    from bundler_sfm_tpu_torch.ops.fmatrix import estimate_fmatrix_ransac
    from bundler_sfm_tpu_torch.ops.homography import (
        estimate_homography_ransac,
    )
    from bundler_sfm_tpu_torch.ops.ransac import sample_indices
    rng = np.random.default_rng(1)
    B, N, n = 32, 512, 300
    x1 = np.zeros((B, N, 2))
    x2 = np.zeros((B, N, 2))
    p1 = np.zeros((B, N, 2))
    p2 = np.zeros((B, N, 2))
    for b in range(B):
        X = rng.uniform(-2, 2, (n, 3)) + [0, 0, 8]
        a = rng.normal(size=3) * 0.15
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        R = np.eye(3) + np.sin(0.2) * K + (1 - np.cos(0.2)) * K @ K
        u, _ = np.linalg.qr(R)
        Xc = X @ u.T + rng.normal(size=3) * 0.5
        x1[b, :n] = 700 * X[:, :2] / X[:, 2:]
        x2[b, :n] = 700 * Xc[:, :2] / Xc[:, 2:] + rng.normal(size=(n, 2)) * 0.2
        bad = rng.choice(n, n * 3 // 10, replace=False)
        x2[b, bad] += rng.normal(size=(len(bad), 2)) * 80
        H = np.eye(3) + rng.normal(size=(3, 3)) * [[0.05, 0.05, 5],
                                                   [0.05, 0.05, 5],
                                                   [1e-4, 1e-4, 0]]
        q = rng.uniform(-300, 300, (n, 2))
        qh = np.concatenate([q, np.ones((n, 1))], 1) @ H.T
        p1[b, :n] = q
        p2[b, :n] = qh[:, :2] / qh[:, 2:] + rng.normal(size=(n, 2)) * 0.2
        p2[b, bad] += rng.normal(size=(len(bad), 2)) * 80
    nv = torch.full((B,), n)
    g = torch.Generator().manual_seed(0)
    sf = sample_indices(g, 2048, 8, nv, N)
    sh = sample_indices(g, 256, 4, nv, N)
    out = {}
    for dev in ("cpu", "cuda"):
        def T(x):
            return torch.from_numpy(x).to(dev)
        f = estimate_fmatrix_ransac(sf.to(dev), T(x1), T(x2), nv.to(dev), 9.0)
        h = estimate_homography_ransac(sh.to(dev), T(p1), T(p2), nv.to(dev),
                                       6.0)
        out[dev] = [x.cpu() for x in f + h]
    worst = {}
    for name, k in (("F", 0), ("H", 3)):
        a, b = out["cpu"][k], out["cuda"][k]
        a = a / a.flatten(1).norm(dim=1)[:, None, None]
        b = b / b.flatten(1).norm(dim=1)[:, None, None]
        worst[name] = float((a - b).abs().max())
    masks = all(torch.equal(out["cpu"][k], out["cuda"][k]) for k in (1, 2, 4, 5))
    log(f"[main] F/H RANSAC on CUDA vs CPU, {B} synthetic pairs: masks and "
        f"counts identical {masks}, largest model difference F "
        f"{worst['F']:.3e}, H {worst['H']:.3e}")
    # H: linear solves only.  F: the rank-2 projection's closed-form 3x3
    # eigensolver loses accuracy like 1/sqrt(1 - r^2) as two singular
    # values approach each other (svd_utils.py), and the card's arccos/cos
    # round differently from the CPU's, so F is held to 1e-6.
    check(masks and worst["H"] < 1e-9 and worst["F"] < 1e-6, worst)


def capture_stage5():
    """Wrap `bundle_adjust_fast` so the main path's call keeps a copy of
    the scene it starts from, its wall time and its peak device memory."""
    from bundler_sfm_tpu_torch.pipeline import incremental
    real = incremental.bundle_adjust_fast
    box = {}

    def wrapped(scene, out_dir=None, seed=0, sampler=None):
        box["scene"], box["seed"] = copy.deepcopy(scene), seed
        torch.cuda.synchronize()
        box["front_peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        recon = real(scene, out_dir=out_dir, seed=seed, sampler=sampler)
        torch.cuda.synchronize()
        box["wall"] = time.time() - t0
        box["peak"] = torch.cuda.max_memory_allocated()
        box["recon"] = recon
        return recon
    return incremental, real, wrapped, box


def similarity_fit(A, B):
    """(s, R, t) with B ≈ s·R·A + t (Horn/Umeyama)."""
    muA, muB = A.mean(0), B.mean(0)
    A0, B0 = A - muA, B - muB
    U, S, Vt = np.linalg.svd(B0.T @ A0)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = (S * np.diag(D)).sum() / (A0 ** 2).sum()
    return s, R, muB - s * R @ muA


def similarity_error(A, B):
    """The residual rms of B ≈ s·R·A + t over the rms spread of B
    (tests/test_pipeline.py's relative centre error)."""
    s, R, t = similarity_fit(A, B)
    res = B - (s * A @ R.T + t)
    B0 = B - B.mean(0)
    return float(np.sqrt((res ** 2).sum(1).mean())
                 / max(np.sqrt((B0 ** 2).sum(1).mean()), 1e-12))


def bundle_quality(path, gt):
    """Registered cameras, points, observations, mean reprojection error
    (px, Snavely model with distortion) and the relative centre error
    against gt.json, from a bundle.out."""
    from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
    b = read_bundle_file(path)
    reg = [i for i, c in enumerate(b.cameras) if c.registered]
    views = [v for p in b.points for v in p.views]
    pos = np.concatenate([np.repeat(p.pos[None], len(p.views), 0)
                          for p in b.points]) if b.points else np.zeros((0, 3))
    views = np.array(views).reshape(-1, 4)
    img = views[:, 0].astype(int)
    R = np.stack([c.R for c in b.cameras])[img]
    t = np.stack([c.t for c in b.cameras])[img]
    fk = np.array([[c.f, c.k1, c.k2] for c in b.cameras])[img]
    q = (R @ pos[..., None])[..., 0] + t
    u = -q[:, :2] / q[:, 2:3]
    r2 = (u * u).sum(1, keepdims=True)
    pred = fk[:, :1] * (1 + fk[:, 1:2] * r2 + fk[:, 2:3] * r2 * r2) * u
    err = np.sqrt(((pred - views[:, 2:4]) ** 2).sum(1))
    centers = np.stack([b.cameras[i].center for i in reg])
    ate = similarity_error(centers, np.array(gt["centers"])[reg])
    return dict(cameras=len(reg), points=len(b.points), observations=len(err),
                reproj_px=float(err.mean()), ate=ate, order=reg,
                centers=centers)


def stage5_checks(work, imgs, box, stages, counters, rc_ok):
    """Quality of the main path's bundle.out, a second CUDA run from the
    same scene (byte-identical bundle.out) and a CPU run with the same
    draw (the same camera count).  Returns the failed checks, which main()
    raises once every phase has run."""
    failures = []
    check_later = failing_into(failures)
    from bundler_sfm_tpu_torch.pipeline.incremental import (
        StageSampler, bundle_adjust_fast,
    )
    with open(os.path.join(imgs, "gt.json")) as f:
        gt = json.load(f)
    out = os.path.join(work, "bundle")
    check(rc_ok and os.path.exists(os.path.join(out, "bundle.out")),
          "bundle/bundle.out was not written")
    plys = sorted(f for f in os.listdir(out) if f.endswith(".ply"))
    check(len(plys) > 0, "no round PLY was written")
    check(counters.get("ba_runs_cuda", 0) > 0, "the BA did not run on CUDA")
    q = bundle_quality(os.path.join(out, "bundle.out"), gt)
    ba_s = stages.get("ba", 0.0)
    rec = {"cameras": q["cameras"], "points": q["points"],
           "observations": q["observations"], "reproj_px": q["reproj_px"],
           "ate": q["ate"], "stage_s": {k: stages.get(k, 0.0) for k in (
               "init_pair", "init_5pt", "init_triangulate", "ba", "register",
               "resection", "refine_camera", "add_points", "triangulate",
               "prune", "total")},
           "stage5_wall_s": box["wall"],
           "lm_iters": int(counters.get("lm_iters", 0)),
           "host_syncs": int(counters.get("host_syncs", 0)),
           "ba_runs_cuda": int(counters.get("ba_runs_cuda", 0)),
           "obs_iters_per_s": counters.get("ba_observations", 0.0)
           / max(ba_s, 1e-9),
           "peak_mem_gib": box["peak"] / 2 ** 30, "plys": len(plys)}
    log("[main] stage5 " + json.dumps(rec))
    check_later(q["ate"] < 0.02, f"relative centre error {q['ate']} >= 0.02")
    check_later(q["reproj_px"] < 1.0,
                f"mean reprojection error {q['reproj_px']} px >= 1")
    check_later(q["cameras"] >= JAX_CPU_CAMERAS,
                f"{q['cameras']} cameras < {JAX_CPU_CAMERAS} (JAX, CPU)")

    buf = io.StringIO()
    runs = {}
    for name, device in (("cuda-again", "cuda"), ("cpu", "cpu")):
        scene = copy.deepcopy(box["scene"])
        scene.device = device
        path = os.path.join(work, f"bundle_{name}")
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            bundle_adjust_fast(scene, out_dir=path, seed=box["seed"],
                               sampler=StageSampler("cuda"))
        runs[name] = bundle_quality(os.path.join(path, "bundle.out"), gt)
        log(f"[main] stage 5 on {name} from the same scene: "
            f"{time.time() - t0:.2f} s, {runs[name]['cameras']} cameras, "
            f"{runs[name]['points']} points, reprojection "
            f"{runs[name]['reproj_px']:.4f} px, centre error "
            f"{runs[name]['ate']:.6f}")
    with open(os.path.join(out, "bundle.out"), "rb") as a, open(os.path.join(
            work, "bundle_cuda-again", "bundle.out"), "rb") as b:
        same = a.read() == b.read()
    log(f"[main] bundle.out of two CUDA runs byte-identical: {same}")
    check_later(same, "two CUDA runs of stage 5 wrote different bundle.out")
    c = runs["cpu"]
    common = [i for i in q["order"] if i in c["order"]]
    dc = [float(np.abs(q["centers"][q["order"].index(i)]
                       - c["centers"][c["order"].index(i)]).max())
          for i in common]
    log(f"[main] CPU vs CUDA: cameras {c['cameras']} vs {q['cameras']}, "
        f"points {c['points']} vs {q['points']} (differ by "
        f"{c['points'] - q['points']}), largest centre difference "
        f"{max(dc) if dc else float('nan'):.3e} over {len(common)} cameras")
    check_later(c["cameras"] == q["cameras"],
                "the CPU run registered another number of cameras")
    return failures


def dump_scene(scene, path):
    """The verified scene as numpy / Python state (pickle)."""
    import pickle
    state = dict(
        entries=[(e.name, bool(e.fisheye), float(e.init_focal))
                 for e in scene.entries],
        dims=scene.dims, key_xy=scene.key_xy, key_color=scene.key_color,
        transforms={k: (v.num_inliers, v.inlier_ratio)
                    for k, v in scene.transforms.items()},
        tracks=scene.tracks, visible_points=scene.visible_points,
        visible_keys=scene.visible_keys, key_track=scene.key_track)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(state, f)
    log(f"[main] scene written to {path}")


def phase_main(dump=None):
    from bundler_sfm_tpu_torch import run_bundler
    from bundler_sfm_tpu_torch.utils import get_telemetry
    from bundler_sfm_tpu_torch.utils.render_scene import render_box_room
    work = os.path.join(ROOT, "build", "smoke")
    imgs = os.path.join(work, "images")
    t0 = time.time()
    render_box_room(imgs, n=24, W=1024, H=768, seed=0, f=896.0)
    log(f"[main] rendered 24 views 1024x768 in {time.time() - t0:.1f} s")
    cwd = os.getcwd()
    os.chdir(work)
    incremental, real_baf, wrapped, box = capture_stage5()
    try:
        get_telemetry().reset()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        incremental.bundle_adjust_fast = wrapped
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = run_bundler.main([imgs, "--max_keys", "4096", "--init_focal",
                                   "896", "--write_keys", "--device", "cuda",
                                   "--out", "bundle"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(matching_cuda.LAUNCHES)
        variant_launches = sum(matching_variants.LAUNCHES.values())
        stages = dict(get_telemetry().stage_seconds)
        counters = dict(get_telemetry().counters)
    finally:
        incremental.bundle_adjust_fast = real_baf
        os.chdir(cwd)
    out = buf.getvalue()
    print(out, end="", flush=True)
    check(rc == 0, f"run_bundler returned {rc}")
    for f in ("list.txt", "matches.init.txt", "pairwise_scores.txt"):
        check(os.path.getsize(os.path.join(work, f)) > 0, f)
    n_tracks = int(re.search(r"\] (\d+) tracks", out).group(1))
    check(n_tracks > 0, "no tracks")
    check(launches["two_nn"] > 0, f"the 2-NN kernel was not launched on "
          f"the main path: {launches}")
    check(yardstick_launches(launches) == {}, f"a yardstick ran on the main "
          f"path: {launches}")
    entries, dims, key_xy, descs, matches = read_scene(work)
    log(f"[main] wall {wall:.2f} s; stage seconds "
        + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    log(f"[main] peak device memory: front end "
        f"{box['front_peak'] / 2**30:.2f} GiB, reconstruction "
        f"{box['peak'] / 2**30:.2f} GiB")
    if dump:
        dump_scene(box["scene"], dump)
    failures = stage5_checks(work, imgs, box, stages, counters, rc == 0)
    log(f"[main] keys {sum(len(k) for k in key_xy)} "
        f"({min(len(k) for k in key_xy)}..{max(len(k) for k in key_xy)} per "
        f"image), pairs {24 * 23 // 2}, matched pairs {len(matches)}, "
        f"matches {sum(len(m) for m in matches.values())}, tracks {n_tracks}, "
        f"2-NN launches {json.dumps(launches)}, variant kernel launches "
        f"{variant_launches}")
    check_mma_matches(descs, work)

    # The kernels at the main path's shapes, against their plain versions.
    table = DescriptorTable(descs, device="cuda")
    pi, pj = pair_tensors(all_pairs(len(descs)))
    err = compare_two_nn(table.table, table.counts, pi, pj, "main path")
    t = time_two_nn(table.table, table.counts, pi, pj, 20,
                    f"main path {len(pi)} pairs x {table.table.shape[1]} keys")
    sp = split_two_nn_call(table.table, table.counts, pi, pj,
                           f"main path {len(pi)} pairs x "
                           f"{table.table.shape[1]} keys")
    nb, nby = norms_bound_ms(table.table)
    norms_dev = device_us(lambda: matching_cuda.two_nn_norms(
        table.table, table.counts))
    records = [
        {"name": "two_nn", "route": "cuda", "source": TWO_NN_SOURCE,
         "replaces": TWO_NN_REPLACES, "launches": launches["two_nn"],
         "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": t["library_ms"], "ms_before": t["ms_before"],
         "ms_two_launch": t["ms_two_launch"], **sp},
        {"name": "two_nn_norms", "route": "cuda", "source": TWO_NN_SOURCE,
         "replaces": TWO_NN_REPLACES, "launches": launches["two_nn_norms"],
         "max_abs_err": 0.0, "ms": t["norms_ms"],
         "device_us": norms_dev,
         "plain_ms": cuda_ms(lambda: matching_cuda.two_nn_norms_plain(
             table.table, table.counts), 20),
         "bound_ms": nb, "bound_by": nby, "library_ms": None}]
    check_estimators_on_card()
    compare_verification(entries, dims, key_xy, matches, work)
    return records, failures, launches


def check_mma_matches(descs, work):
    """The main path's matching redone on the first design's `mma.sync`
    kernel: matches.init.txt must come out byte-identical."""
    from bundler_sfm_tpu_torch.io.matchfile import write_match_file
    from bundler_sfm_tpu_torch.ops import matching
    pairs = all_pairs(len(descs))
    saved = matching.two_nn_pairs
    matching.two_nn_pairs = matching_cuda.two_nn_pairs_mma
    try:
        m = DescriptorTable(descs, device="cuda").match_pairs(
            pairs, min_matches=16)
    finally:
        matching.two_nn_pairs = saved
    path = os.path.join(work, "matches.mma.txt")
    write_match_file(path, m)
    with open(path, "rb") as a, open(os.path.join(
            work, "matches.init.txt"), "rb") as b:
        same = a.read() == b.read()
    log(f"[main] matches.init.txt byte-identical with the mma.sync kernel's "
        f"matches: {same}")
    check(same, "the mma.sync kernel's matches differ from the main path's")


# The options RunBundler.sh writes into options.txt (RunBundler.sh:119-137),
# after the match table.
RUNBUNDLER_OPTIONS = ["--output bundle.out", "--output_all bundle_",
                      "--output_dir bundle", "--variable_focal_length",
                      "--use_focal_estimate", "--constrain_focal",
                      "--constrain_focal_weight 0.0001",
                      "--estimate_distortion", "--run_bundle"]
# Images (c) holds out, then adds back: one end of the orbit, so the other
# 20 views stay one chain (every 6th view held out cut it into 4 pieces).
HELD_OUT = [20, 21, 22, 23]
NUM_ANCHORS = 8


def fresh_dir(path):
    check(not os.path.exists(path), f"{path} is not a fresh directory")
    os.makedirs(path)
    return path


def write_options(path, match_table):
    with open(path, "w") as f:
        f.write("\n".join([f"--match_table {match_table}"]
                          + RUNBUNDLER_OPTIONS) + "\n")


def bundler_run(wdir, argv, label, gt=None):
    """One `bundler.main(argv + --device cuda)` in the fresh directory wdir
    (its constraints.txt checkpoint and match-table snapshots land there),
    with the launch counts and telemetry zeroed just before it.  Logs and
    returns the run's record (stage seconds, launches, quality of
    bundle/bundle.out against `gt`)."""
    from bundler_sfm_tpu_torch import bundler
    from bundler_sfm_tpu_torch.utils import get_telemetry
    fresh_dir(wdir)
    cwd = os.getcwd()
    os.chdir(wdir)
    try:
        get_telemetry().reset()
        zero_launches()
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = bundler.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        os.chdir(cwd)
    check(rc == 0, f"[staged] {label}: bundler returned {rc}")
    tel = get_telemetry()
    rec = {"label": label, "wall_s": wall,
           "stage_s": {k: v for k, v in sorted(tel.stage_seconds.items())},
           "lm_iters": int(tel.counters.get("lm_iters", 0)),
           "ba_runs_cuda": int(tel.counters.get("ba_runs_cuda", 0)),
           "launches": {k: v for k, v in matching_cuda.LAUNCHES.items() if v},
           "bundle": os.path.join(wdir, "bundle", "bundle.out"),
           "log": buf.getvalue()}
    check(rec["ba_runs_cuda"] > 0, f"[staged] {label}: the BA did not run "
          "on CUDA")
    if gt is not None:
        q = bundle_quality(rec["bundle"], gt)
        rec.update(cameras=q["cameras"], points=q["points"],
                   reproj_px=q["reproj_px"], ate=q["ate"])
    log(f"[staged] {label} " + json.dumps(
        {k: v for k, v in rec.items() if k not in ("bundle", "log")}))
    return rec


def same_bytes(a, b, what):
    """Byte-identity of two runs' files; prints the first differing line."""
    with open(a, "rb") as f:
        x = f.read()
    with open(b, "rb") as f:
        y = f.read()
    if x != y:
        la, lb = x.splitlines(), y.splitlines()
        k = next((i for i, (p, q) in enumerate(zip(la, lb)) if p != q),
                 min(len(la), len(lb)))
        log(f"[staged] {what}: first difference at line {k + 1}: "
            f"{la[k] if k < len(la) else b'<end>'!r} vs "
            f"{lb[k] if k < len(lb) else b'<end>'!r}")
    log(f"[staged] {what}: byte-identical {x == y}")
    check(x == y, f"{what}: two CUDA runs wrote different files")


def twice(wdir, argv, label, gt):
    """A bundler run and its repetition on CUDA: bundle.out byte-identical."""
    rec = bundler_run(wdir, argv, label, gt)
    again = bundler_run(wdir + "-again", argv, label + " again", gt)
    same_bytes(rec["bundle"], again["bundle"], f"{label} bundle.out")
    return rec, again


def triangulate_gt(views, gt):
    """A point's position from its bundle.out views (image, key, x, y) and
    the render's true cameras (linear least squares; image = -f·xy/z)."""
    rows, rhs = [], []
    for img, _, x, y in views:
        R = np.array(gt["Rs"][int(img)])
        c = np.array(gt["centers"][int(img)])
        for u, r in ((x, R[0]), (y, R[1])):
            a = u * R[2] + gt["focal"] * r
            rows.append(a)
            rhs.append(a @ c)
    return np.linalg.lstsq(np.array(rows), np.array(rhs), rcond=None)[0]


def anchors_at_ground_truth(path, gt, out):
    """NUM_ANCHORS well-seen points of a bundle.out, each anchored at its
    ground-truth position mapped into the bundle's frame by the similarity
    that aligns the true camera centres with the registered ones.  Writes
    the `x0 y0 z0 x y z` lines to `out`; returns [(first view, anchor)]."""
    from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
    b = read_bundle_file(path)
    reg = [i for i, c in enumerate(b.cameras) if c.registered]
    s, R, t = similarity_fit(np.array(gt["centers"])[reg],
                             np.stack([b.cameras[i].center for i in reg]))
    seen = sorted(range(len(b.points)), key=lambda p: -len(b.points[p].views))
    chosen = sorted(seen[:20 * NUM_ANCHORS])[::20][:NUM_ANCHORS]
    anchors = []
    with open(out, "w") as f:
        for p in chosen:
            pt = b.points[p]
            a = s * R @ triangulate_gt(pt.views, gt) + t
            f.write(" ".join(f"{v:.9f}" for v in (*pt.pos, *a)) + "\n")
            anchors.append(((int(pt.views[0][0]), int(pt.views[0][1])), a,
                            float(np.linalg.norm(a - pt.pos))))
    return anchors


def check_register_image(work, bundle_path, img):
    """`register_image` of image `img` against a bundle.out on CUDA (the
    2-NN kernel must launch) and on the CPU with the same draw: the same
    matches and inliers, the camera within 1e-6 relative."""
    from bundler_sfm_tpu_torch.config import default_pipeline_config
    from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
    from bundler_sfm_tpu_torch.pipeline.incremental import StageSampler
    from bundler_sfm_tpu_torch.pipeline.register import (
        coalesce_point_descriptors, register_image,
    )
    _, _, key_xy, descs, _ = read_scene(work)
    bundle = read_bundle_file(bundle_path)
    pdesc = coalesce_point_descriptors(bundle, descs)
    runs = {}
    for dev in ("cuda", "cpu"):
        zero_launches()
        t0 = time.time()
        runs[dev] = register_image(
            bundle, pdesc, descs[img], key_xy[img],
            config=default_pipeline_config(), seed=0, device=dev,
            sampler=StageSampler("cpu"))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(matching_cuda.LAUNCHES)
        log(f"[staged] register_image of image {img} against "
            f"{len(bundle.points)} points on {dev}: {time.time() - t0:.2f} "
            f"s, {runs[dev] and runs[dev]['num_inliers']} inliers")
    g, c = runs["cuda"], runs["cpu"]
    check(g is not None and c is not None, "register_image failed")
    check(launches["two_nn"] > 0 and yardstick_launches(launches) == {},
          f"register_image: two_nn was not launched on CUDA, or a "
          f"yardstick was: {launches}")
    rel = max(float(np.abs(g["R"] - c["R"]).max()),
              float(np.abs(g["center"] - c["center"]).max()
                    / np.abs(c["center"]).max()),
              abs(g["f"] / c["f"] - 1))
    log(f"[staged] register_image CUDA vs CPU: matches identical "
        f"{np.array_equal(g['matches'], c['matches'])}, inliers identical "
        f"{np.array_equal(g['inlier_idx'], c['inlier_idx'])}, largest "
        f"relative camera difference {rel:.3e}; launches {launches}")
    check(np.array_equal(g["matches"], c["matches"])
          and np.array_equal(g["inlier_idx"], c["inlier_idx"])
          and rel < 1e-6, "register_image on CUDA disagrees with the CPU")
    return launches


def phase_staged():
    """The reference's staged flow (`RunBundler.sh`: KeyMatchFull, then
    bundler with the options file) on phase 3's render and key files.
    Returns the 2-NN launch counts summed over the phase's runs and the
    failed quality checks (camera counts, centre error, reprojection,
    anchors), which main() raises once every phase has run; a launch or
    byte-identity check raises at once."""
    from bundler_sfm_tpu_torch import keymatch
    from bundler_sfm_tpu_torch.io.listfile import read_list_file
    from bundler_sfm_tpu_torch.io.matchfile import (
        read_match_file, write_match_file,
    )
    work = os.path.join(ROOT, "build", "smoke")
    imgs = os.path.join(work, "images")
    stg = os.path.join(work, "staged")
    if os.path.exists(stg):
        import shutil
        shutil.rmtree(stg)
    os.makedirs(stg)
    with open(os.path.join(imgs, "gt.json")) as f:
        gt = json.load(f)
    t_phase = time.time()
    total = dict.fromkeys(matching_cuda.LAUNCHES, 0)
    failures = []
    check_later = failing_into(failures)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # (a) KeyMatchFull over the key files run_bundler wrote.
    entries = read_list_file(os.path.join(work, "list.txt"), work)
    keys = [os.path.join(work, os.path.splitext(os.path.basename(e.name))[0]
                         + ".key.gz") for e in entries]
    with open(os.path.join(stg, "list_keys.txt"), "w") as f:
        f.write("".join(k + "\n" for k in keys))
    matches = os.path.join(stg, "matches.init.txt")
    zero_launches()
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = keymatch.main([os.path.join(stg, "list_keys.txt"), matches])
    torch.cuda.synchronize()
    launches = dict(matching_cuda.LAUNCHES)
    add(launches)
    print(buf.getvalue(), end="", flush=True)
    check(rc == 0, f"keymatch returned {rc}")
    log(f"[staged] (a) keymatch: {time.time() - t0:.2f} s, launches "
        f"{json.dumps(launches)}")
    check(launches["two_nn"] > 0 and yardstick_launches(launches) == {},
          f"keymatch launches {launches}")
    same_bytes(os.path.join(work, "matches.init.txt"), matches,
               "(a) keymatch vs run_bundler matches.init.txt")

    # (b) bundler with RunBundler.sh's options file.
    opts = os.path.join(stg, "options.txt")
    write_options(opts, matches)
    lst = os.path.join(work, "list.txt")
    base = [lst, "--options_file", opts, "--key_dir", work]
    b, b2 = twice(os.path.join(stg, "b"), base, "(b) options_file", gt)
    add(b["launches"])
    add(b2["launches"])
    check_later(b["cameras"] == 24 and b["ate"] < 0.02
                and b["reproj_px"] < 1.0,
          f"(b): {b['cameras']} cameras, centre error {b['ate']}, "
          f"reprojection {b['reproj_px']} px")

    # (c) hold 4 images out, then resume with anchors and add them back.
    ignore = os.path.join(stg, "ignore.txt")
    with open(ignore, "w") as f:
        f.write("".join(f"{i}\n" for i in HELD_OUT))
    held = os.path.join(stg, "held_out.txt")
    with open(held, "w") as f:
        f.write("".join(os.path.basename(entries[i].name) + "\n"
                        for i in HELD_OUT))
    c1, c1b = twice(os.path.join(stg, "c1"), base + ["--ignore_file", ignore],
                    "(c) held out", gt)
    add(c1["launches"])
    add(c1b["launches"])
    check_later(c1["cameras"] == 24 - len(HELD_OUT), f"(c): {c1['cameras']}"
                f" cameras with {len(HELD_OUT)} held out")
    pc = os.path.join(stg, "pc.txt")
    anchors = anchors_at_ground_truth(c1["bundle"], gt, pc)
    log(f"[staged] (c) {len(anchors)} anchors, distances from their points "
        f"{[round(a[2], 6) for a in anchors]}")
    c2, c2b = twice(os.path.join(stg, "c2"), base + [
        "--bundle", c1["bundle"], "--rerun_bundle", "--add_images", held,
        "--point_constraint_file", pc, "--point_constraint_weight", "1.0"],
        "(c) resumed", gt)
    add(c2["launches"])
    add(c2b["launches"])
    from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
    final = read_bundle_file(c2["bundle"])
    where = {(int(v[0]), int(v[1])): p for p, pt in enumerate(final.points)
             for v in pt.views}
    kept = [where.get(view) for view, _, _ in anchors]
    dist = [None if k is None else float(np.linalg.norm(
        final.points[k].pos - a)) for k, (_, a, _) in zip(kept, anchors)]
    log(f"[staged] (c) anchored points kept {sum(k is not None for k in kept)}"
        f"/{len(anchors)}, distances to their anchors {dist}")
    check_later(c2["cameras"] == 24 and c2["reproj_px"] < 1.0,
                f"(c) resumed: {c2['cameras']} cameras, {c2['reproj_px']} px")
    check_later(all(k is not None for k in kept),
                "(c) an anchored point was lost")
    add(check_register_image(work, c1["bundle"], HELD_OUT[0]))

    # (d) the slow bundle with frontier-connectivity order and
    # ignored-camera recovery on the first 12 views (depth cut for time).
    def first_views(n):
        lst_n = os.path.join(stg, f"list{n}.txt")
        with open(lst) as f, open(lst_n, "w") as g:
            g.write("".join(f.readlines()[:n]))
        m_n = os.path.join(stg, f"matches{n}.txt")
        write_match_file(m_n, {k: v for k, v in read_match_file(
            matches).items() if max(k) < n})
        opts_n = os.path.join(stg, f"options{n}.txt")
        write_options(opts_n, m_n)
        return [lst_n, "--options_file", opts_n, "--key_dir", work,
                "--slow_bundle"]
    d, d2 = twice(os.path.join(stg, "d"), first_views(12) + [
        "--construct_max_connectivity", "--estimate_ignored"],
        "(d) slow bundle", gt)
    add(d["launches"])
    add(d2["launches"])
    check_later(d["cameras"] == 12 and d["ate"] < 0.02
                and d["reproj_px"] < 1.0, f"(d): {d['cameras']} cameras, "
                f"centre error {d['ate']}, {d['reproj_px']} px")
    # --fix_necker swaps the initial pair's poses and commits to the flip
    # unconditionally, as the reference does (its error check is compiled
    # out, BundleFast.cpp:202-213).  On this render the flip settles in the
    # mirrored minimum in the port and in the JAX package alike (PERF.md
    # section 6), so on the card the run is held to going through the flip on
    # CUDA and to byte-identity; its parity with the JAX package is held on
    # the CPU (tests/test_torch_staged.py).
    n, n2 = twice(os.path.join(stg, "d-necker"), first_views(8) + [
        "--fix_necker"], "(d) slow bundle --fix_necker", gt)
    add(n["launches"])
    add(n2["launches"])
    check("[FixNecker] Re-bundling" in n["log"], "(d) the Necker flip did "
          "not run")
    log(f"[staged] phase {time.time() - t_phase:.1f} s; 2-NN launches "
        f"{json.dumps(total)}")
    check(yardstick_launches(total) == {}, f"a yardstick ran in the staged "
          f"flow: {total}")
    return total, failures


# The fisheye lens the tools phase pushes the key files through
# (tests/test_fisheye.py's end-to-end parameters).
FISHEYE = dict(fCx=0.0, fCy=0.0, fRad=480.0, fAngle=160.0, fFocal=420.0)


def timed(label, fn):
    """fn() with stdout captured; logs its seconds; returns its result."""
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        out = fn()
    torch.cuda.synchronize()
    log(f"[tools] {label}: {time.time() - t0:.2f} s")
    return out


def compare_images(jobs, what, check_later):
    """Each (image path, undistort(arr, device)) job's array on CUDA and on
    the CPU: equal, or off by at most 1 on at most 1e-6 of the values (the
    count printed)."""
    from PIL import Image
    n_off, n_all, worst = 0, 0, 0
    for path, undistort in jobs:
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"))
        d = np.abs(undistort(arr, "cuda").astype(np.int16)
                   - undistort(arr, "cpu").astype(np.int16))
        n_off += int((d > 0).sum())
        n_all += d.size
        worst = max(worst, int(d.max()))
    log(f"[tools] {what}: CUDA vs CPU arrays of {len(jobs)} images, "
        f"{n_off} of {n_all} values differ (largest difference {worst})")
    check_later(worst <= 1 and n_off <= 1e-6 * n_all,
                f"{what}: {n_off} values differ by up to {worst}")


def pmvs_projection_error(pmvs_dir, bundle_path, W, H):
    """Median pixel distance, per exported camera, between each point the
    camera sees projected by its txt/%08d.txt matrix and the observation
    (top-left pixel coordinates; the matrix leaves out distortion)."""
    from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
    b = read_bundle_file(bundle_path)
    reg = [i for i, c in enumerate(b.cameras) if c.registered]
    pos = {i: [] for i in reg}
    obs = {i: [] for i in reg}
    for p in b.points:
        for v in p.views:
            pos[int(v[0])].append(p.pos)
            obs[int(v[0])].append(v[2:4])
    med = []
    for k, i in enumerate(reg):
        with open(os.path.join(pmvs_dir, "txt", f"{k:08d}.txt")) as f:
            lines = f.read().splitlines()
        check(lines[0] == "CONTOUR", f"txt/{k:08d}.txt has no CONTOUR line")
        P = np.array([[float(x) for x in ln.split()] for ln in lines[1:4]])
        X = np.concatenate([np.array(pos[i]), np.ones((len(pos[i]), 1))], 1)
        q = X @ P.T
        xy = np.array(obs[i])
        ref = np.stack([xy[:, 0] + 0.5 * (W - 1),
                        (H - 1) - (xy[:, 1] + 0.5 * (H - 1))], 1)
        med.append(float(np.median(np.linalg.norm(q[:, :2] / q[:, 2:3] - ref,
                                                  axis=1))))
    return med


def phase_tools():
    """The reference's post-bundle tools on phase 3's render, bundle.out
    and key files, every run in a fresh directory under build/smoke/tools/:
    (a) `bundler --bundle --compute_covariance` on CUDA and on the CPU;
    (b) `radialundistort` on CUDA and on the CPU; (c) `bundle2pmvs`,
    `bundle2vis` on bundle.rd.out and `bundle2ply`; (d) the fisheye flow:
    the key files pushed through a fisheye lens, every list entry flagged
    fisheye, `keymatch` and `bundler --options_file --fisheye` with the
    launch counts zeroed, then `fisheyeundistort` on CUDA and on the CPU.
    Returns the 2-NN launch counts of (d) and the failed checks, which
    main() raises once every phase has run."""
    from bundler_sfm_tpu_torch import (
        bundle2ply, bundle2pmvs, bundle2vis, bundler, fisheyeundistort,
        keymatch, radialundistort,
    )
    from bundler_sfm_tpu_torch.export.undistort import undistort_image
    from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
    from bundler_sfm_tpu_torch.io.keyfile import (
        centered_to_image, keys_to_centered, read_key_file, write_key_file_bin,
    )
    from bundler_sfm_tpu_torch.io.listfile import (
        read_list_file, write_list_file,
    )
    from bundler_sfm_tpu_torch.ops import fisheye
    from bundler_sfm_tpu_torch.pipeline.two_frame import scene_covariance
    work = os.path.join(ROOT, "build", "smoke")
    tools = os.path.join(work, "tools")
    if os.path.exists(tools):
        import shutil
        shutil.rmtree(tools)
    os.makedirs(tools)
    with open(os.path.join(work, "images", "gt.json")) as f:
        gt = json.load(f)
    lst = os.path.join(work, "list.txt")
    bundle_out = os.path.join(work, "bundle", "bundle.out")
    entries = read_list_file(lst, work)
    from PIL import Image
    with Image.open(entries[0].name) as im:
        dims = im.size
    t_phase = time.time()
    failures = []
    check_later = failing_into(failures)

    # (a) --compute_covariance in surgery mode, on CUDA and on the CPU.
    covs = {}
    bundle = read_bundle_file(bundle_out)
    for dev in ("cuda", "cpu"):
        d = fresh_dir(os.path.join(tools, f"a-{dev}"))
        rc = timed(f"(a) bundler --compute_covariance on {dev}",
                   lambda: bundler.main([
                       lst, "--bundle", bundle_out, "--compute_covariance",
                       "--estimate_distortion", "--key_dir", work,
                       "--output_dir", d, "--device", dev]))
        check(rc == 0, f"(a) bundler --compute_covariance on {dev}: rc {rc}")
        with open(os.path.join(d, "covariance.txt")) as f:
            lines = f.read().splitlines()
        check_later(len(lines) == 3 * 24, f"(a) {dev}: covariance.txt has "
                    f"{len(lines) // 3} cameras")
        covs[dev] = timed(f"(a) scene_covariance on {dev}",
                          lambda: scene_covariance(bundle, device=dev))
    regs, cov, blocks = covs["cuda"]
    eig = min(float(np.linalg.eigvalsh(C).min()) for C in blocks)
    rel = float(np.abs(cov - covs["cpu"][1]).max() / np.abs(cov).max())
    with open(os.path.join(tools, "a-cuda", "covariance.txt"), "rb") as a, \
            open(os.path.join(tools, "a-cpu", "covariance.txt"), "rb") as b:
        same = a.read() == b.read()
    log(f"[tools] (a) {len(blocks)} blocks, smallest eigenvalue {eig:.6e}, "
        f"CUDA vs CPU inverse: largest difference {rel:.3e} of its largest "
        f"entry; covariance.txt byte-identical {same}")
    check_later(len(blocks) == 24 and eig > 0,
                f"(a) {len(blocks)} blocks, smallest eigenvalue {eig}")
    check_later(np.allclose(cov, covs["cpu"][1], rtol=1e-8,
                            atol=1e-8 * np.abs(cov).max()),
                f"(a) CUDA covariance differs from the CPU's by {rel}")

    # (b) RadialUndistort on CUDA and on the CPU, each writing rd/ in its
    # own directory (list.rd.txt names the images by that path).
    rd = {}
    cwd = os.getcwd()
    for dev in ("cuda", "cpu"):
        d = fresh_dir(os.path.join(tools, f"b-{dev}"))
        rd[dev] = os.path.join(d, "rd")
        os.chdir(d)
        try:
            timed(f"(b) radialundistort of 24 images on {dev}",
                  lambda: radialundistort.main([lst, bundle_out, "rd",
                                                "--device", dev]))
        finally:
            os.chdir(cwd)
    for name in ("bundle.rd.out", "list.rd.txt"):
        with open(os.path.join(rd["cuda"], name), "rb") as a, \
                open(os.path.join(rd["cpu"], name), "rb") as b:
            x, y = a.read(), b.read()
        log(f"[tools] (b) {name} byte-identical CUDA vs CPU: {x == y}")
        check_later(x == y, f"(b) {name} differs between CUDA and the CPU")
    with open(os.path.join(rd["cuda"], "list.rd.txt")) as f:
        check_later(len(f.read().split()) == 24, "(b) list.rd.txt does not "
                    "list 24 images")
    compare_images([(e.name, lambda arr, dev, c=c: undistort_image(
        arr, c.f, c.k1, c.k2, device=dev))
        for e, c in zip(entries, bundle.cameras) if c.registered],
        "(b)", check_later)

    # (c) Bundle2PMVS and Bundle2Vis on bundle.rd.out, Bundle2Ply.
    rd_bundle = os.path.join(rd["cuda"], "bundle.rd.out")
    pmvs = os.path.join(tools, "c", "pmvs")
    os.makedirs(os.path.dirname(pmvs))
    timed("(c) bundle2pmvs", lambda: bundle2pmvs.main([lst, rd_bundle, pmvs]))
    txts = sorted(os.listdir(os.path.join(pmvs, "txt")))
    med = pmvs_projection_error(pmvs, rd_bundle, *dims)
    log(f"[tools] (c) {len(txts)} projection files; median distance of "
        f"projected points to their observations per camera: "
        f"{min(med):.4f}..{max(med):.4f} px")
    check_later(len(txts) == 24 and max(med) < 1.0,
                f"(c) {len(txts)} projection files, median distances "
                f"up to {max(med)} px")
    vis = os.path.join(pmvs, "vis.dat")
    timed("(c) bundle2vis", lambda: bundle2vis.main([rd_bundle, vis]))
    with open(vis) as f:
        rows = f.read().splitlines()
    check_later(rows[:2] == ["VISDATA", "24"] and len(rows) == 26,
                f"(c) vis.dat header {rows[:2]}, {len(rows)} lines")
    ply = os.path.join(tools, "c", "points.ply")
    timed("(c) bundle2ply", lambda: bundle2ply.main([bundle_out, ply]))
    with open(ply) as f:
        head = f.read(200)
    n_vert = int(re.search(r"element vertex (\d+)", head).group(1))
    log(f"[tools] (c) vis.dat {len(rows)} lines; points.ply {n_vert} "
        f"vertices")
    check_later(n_vert >= 48, f"(c) points.ply has {n_vert} vertices")

    # (d) The fisheye flow: key files through the lens, keymatch, bundler
    # --fisheye, FisheyeUndistort.
    fd = fresh_dir(os.path.join(tools, "d"))
    keys = fresh_dir(os.path.join(fd, "keys"))
    params = fisheye.FisheyeParams(**FISHEYE)
    fish_txt = os.path.join(fd, "fisheye.txt")
    with open(fish_txt, "w") as f:
        f.write(f"FisheyeCenter: {params.fCx} {params.fCy}\n"
                f"FisheyeRadius: {params.fRad}\nFisheyeAngle: "
                f"{params.fAngle}\nFisheyeFocal: {params.fFocal}\n")
    t0 = time.time()
    key_paths = []
    for e in entries:
        base = os.path.splitext(os.path.basename(e.name))[0]
        info, desc = read_key_file(os.path.join(work, base + ".key.gz"))
        cent = keys_to_centered(info, *dims)[:, :2].astype(np.float64)
        fish = fisheye.distort_points(torch.as_tensor(cent, device="cuda"),
                                      params).cpu().numpy()
        info = info.copy()
        info[:, :2] = centered_to_image(fish, *dims)
        key_paths.append(os.path.join(keys, base + ".key.bin"))
        write_key_file_bin(key_paths[-1], info, desc)
    for e in entries:
        e.fisheye = True
    fish_list = os.path.join(fd, "list.txt")
    write_list_file(fish_list, entries)
    with open(os.path.join(fd, "list_keys.txt"), "w") as f:
        f.write("".join(k + "\n" for k in key_paths))
    log(f"[tools] (d) 24 key files through the fisheye lens: "
        f"{time.time() - t0:.2f} s")
    matches = os.path.join(fd, "matches.init.txt")
    zero_launches()
    rc = timed("(d) keymatch", lambda: keymatch.main([
        os.path.join(fd, "list_keys.txt"), matches]))
    launches = dict(matching_cuda.LAUNCHES)
    check(rc == 0, f"(d) keymatch returned {rc}")
    check(launches["two_nn"] > 0 and yardstick_launches(launches) == {},
          f"(d) keymatch launches {launches}")
    with open(matches, "rb") as a, open(os.path.join(
            work, "matches.init.txt"), "rb") as b:
        same = a.read() == b.read()
    log(f"[tools] (d) keymatch launches {json.dumps(launches)}; "
        f"matches.init.txt byte-identical with run_bundler's: {same}")
    check_later(same, "(d) keymatch on the fisheye keys matched otherwise")
    opts = os.path.join(fd, "options.txt")
    write_options(opts, matches)
    rec = bundler_run(os.path.join(fd, "run"), [
        fish_list, "--options_file", opts, "--key_dir", keys, "--fisheye",
        fish_txt], "(d) bundler --fisheye", gt)
    for k, v in rec["launches"].items():
        launches[k] = launches.get(k, 0) + v
    check_later(rec["cameras"] == 24 and rec["ate"] < 0.02
                and rec["reproj_px"] < 1.0,
                f"(d) fisheye: {rec['cameras']} cameras, centre error "
                f"{rec['ate']}, reprojection {rec['reproj_px']} px")
    for dev in ("cuda", "cpu"):
        timed(f"(d) fisheyeundistort of 24 images on {dev}",
              lambda: fisheyeundistort.main([
                  lst, fish_txt, os.path.join(fd, f"fd-{dev}"),
                  "--device", dev]))
    check_later(len(os.listdir(os.path.join(fd, "fd-cuda"))) == 24,
                "(d) fisheyeundistort did not write 24 images")
    compare_images([(e.name, lambda arr, dev: fisheye.undistort_image(
        arr, params, device=dev)) for e in entries], "(d)", check_later)
    log(f"[tools] phase {time.time() - t_phase:.1f} s; 2-NN launches "
        f"{json.dumps(launches)}")
    return launches, failures


# The TPU kernel each variant kernel replaces, by its wrapper's name.
REPLACES = {"two_nn_oneblock": f"{PROBE}:62",
            "two_nn_blockmerge_bf16": f"{PROBE}:111",
            "two_nn_ablation": f"{PROBE}:171"}


def _replaces(kernel):
    return next(v for k, v in REPLACES.items() if kernel.startswith(k))


def _plain_kind(kernel):
    """The plain version a variant kernel is held to: "oneblock",
    "blockmerge" or an ablation mode (a `_mma` twin shares its kernel's)."""
    if kernel.startswith("two_nn_oneblock"):
        return "oneblock"
    if kernel.startswith("two_nn_blockmerge_bf16"):
        return "blockmerge"
    return (kernel[len("two_nn_ablation_"):].replace("mma_", "", 1)
            .replace("two_launch_", "", 1))


def _variant_plain(kernel):
    V = matching_variants
    kind = _plain_kind(kernel)
    if kind == "oneblock":
        return V.oneblock_plain
    if kind == "blockmerge":
        return V.blockmerge_plain
    return lambda *a: V.ablation_plain(*a, kind)


def variant_kernels(table16=None):
    """{counter: wrapper} of every variant kernel: the oneblock tiles and
    dots, blockmerge, the ablations, their two-launch yardsticks
    (`_two_launch`) and the first design's `mma.sync` yardsticks (`_mma`).
    The one-launch bf16 kernels read `table16` when it is given."""
    V = matching_variants
    t16 = {"table16": table16}
    out = {}
    for dot in V.DOTS:
        for tq in V.ONEBLOCK_TILES:
            for mid, fn, kw in (("", V.two_nn_oneblock,
                                 t16 if dot == "bf16" else {}),
                                ("mma_", V.two_nn_oneblock_mma, {})):
                out[f"two_nn_oneblock_{mid}{dot}_{tq}"] = (
                    lambda f, t, d, k: lambda *a: f(*a, tq=t, dot=d, **k))(
                        fn, tq, dot, kw)
            out[f"two_nn_oneblock_two_launch_{dot}_{tq}"] = (
                lambda t, d: lambda *a: V.two_nn_oneblock_two_launch(
                    *a, tq=t, dot=d))(tq, dot)
    out["two_nn_blockmerge_bf16"] = lambda *a: V.two_nn_blockmerge_bf16(
        *a, **t16)
    out["two_nn_blockmerge_bf16_two_launch"] = \
        V.two_nn_blockmerge_bf16_two_launch
    out["two_nn_blockmerge_bf16_mma"] = V.two_nn_blockmerge_bf16_mma
    for m in V.ABLATION_MODES:
        for mid, fn in (("", V.two_nn_ablation), ("mma_", V.two_nn_ablation_mma)):
            out[f"two_nn_ablation_{mid}{m}"] = (
                lambda f, mode: lambda *a: f(*a, mode))(fn, m)
    out["two_nn_ablation_two_launch_top1"] = V.two_nn_ablation_two_launch
    return out


# The instantiations on the `wgmma` design, by counter; the last three (bf16
# oneblock above 128 rows; clusters at 512 and 1024) are on no path.
UNPATHED = [f"two_nn_oneblock_bf16_{tq}" for tq in (256, 512, 1024)]
WGMMA_VARIANTS = ([f"two_nn_oneblock_int8_{tq}" for tq in (128, 256, 512, 1024)]
                  + ["two_nn_oneblock_bf16_128", "two_nn_blockmerge_bf16",
                     "two_nn_ablation_matmul_max", "two_nn_ablation_top1"]
                  + UNPATHED)


def two_launch_twin(kernel):
    """The counter of a `wgmma` variant's two-launch form, or None
    ("matmul_max" reads no constants)."""
    if kernel.startswith("two_nn_oneblock_"):
        return kernel.replace("two_nn_oneblock_", "two_nn_oneblock_two_launch_")
    if kernel == "two_nn_ablation_top1":
        return "two_nn_ablation_two_launch_top1"
    if kernel == "two_nn_blockmerge_bf16":
        return "two_nn_blockmerge_bf16_two_launch"
    return None


def mma_twin(kernel):
    if kernel.startswith("two_nn_oneblock"):
        return kernel.replace("two_nn_oneblock_", "two_nn_oneblock_mma_")
    if kernel.startswith("two_nn_ablation"):
        return kernel.replace("two_nn_ablation_", "two_nn_ablation_mma_")
    return kernel + "_mma"


def compare_variant(kernel, fn, tab, counts, pi, pj, label):
    """A variant kernel vs its plain version on the same inputs."""
    got = fn(tab, counts, pi, pj)
    torch.cuda.synchronize()
    return compare_outputs(
        got, _variant_plain(kernel)(tab, counts, pi, pj),
        f"[variants] {kernel} {label}: {len(pi)} pairs x {tab.shape[1]} keys")


def library_yardstick(kind, tab, counts, pi, pj, chunk=64):
    """One library computation of the same function per chunk of pairs,
    f32 matmul (TF32 off) plus: topk(2) of the masked distances (exact
    variants), amax (matmul_max), max with its argmax over the max-form
    score (top1).  Timed only; the port never calls it."""
    if kind == "exact":
        return yardstick(tab, counts, pi, pj, chunk)
    x = tab.float()
    hb = 0.5 * torch.where(
        torch.arange(tab.shape[1], device=tab.device) < counts[:, None],
        (x * x).sum(-1), torch.full_like(x[..., 0], matching_cuda.BIG))
    for s in range(0, len(pi), chunk):
        a, b = pi[s:s + chunk].long(), pj[s:s + chunk].long()
        dots = torch.matmul(x[a], x[b].transpose(1, 2))
        if kind == "matmul_max":
            dots.amax(-1)
        else:
            torch.max(dots - hb[b][:, None, :], dim=-1)


def _ragged_table(rng):
    """5 images x 4096 keys, counts 4096, 3001, 65, 1, 0; shared rows give
    exact hits, and image 0 holds duplicated rows."""
    sizes = [4096, 3001, 65, 1, 0]
    descs = [rng.integers(0, 256, (n, 128)).astype(np.uint8) for n in sizes]
    descs[0][3000:3500] = descs[0][:500]
    descs[1][:2000] = descs[0][1000:3000]
    descs[2][:] = descs[0][5]
    table = DescriptorTable(descs, device="cuda")
    return table.table, table.counts


def _ties_table(rng):
    """4 images x 1024 keys: duplicated rows, a db of one repeated row."""
    descs = [rng.integers(0, 256, (1024, 128)).astype(np.uint8)
             for _ in range(4)]
    for d in descs:
        d[500:600] = d[0:100]
        d[1023] = d[7]
    descs[3][:] = descs[3][9]
    descs[1][:300] = descs[0][200:500]
    table = DescriptorTable(descs, device="cuda")
    return table.table, table.counts


def _garbage_table(rng):
    """6 images x 1024 keys, counts 1024, 1000, 513, 129, 1, 0, with random
    nonzero rows past every count (which must not change any result), exact
    hits and duplicated rows."""
    sizes = [1024, 1000, 513, 129, 1, 0]
    tab = torch.from_numpy(rng.integers(-128, 128, (6, 1024, 128))
                           .astype(np.int8))
    tab[1, 600:1000] = tab[0, 0:400]
    tab[2, :50] = tab[2, 300]
    return tab.cuda(), torch.tensor(sizes, dtype=torch.int32, device="cuda")


def compare_prepass(tab, counts, label):
    """The pre-pass kernel (int8 and bf16 flavours, and the bf16 table
    alone) bit-exact against its plain version."""
    V = matching_variants
    bad = int((V.bf16_table(tab).view(torch.int16)
               != tab.to(torch.bfloat16).view(torch.int16)).sum())
    log(f"[variants] bf16_table {label}: mismatches {bad}")
    check(bad == 0, f"bf16_table disagrees with its plain version: {label}")
    for bf16 in (False, True):
        got = V.variants_prepass(tab, counts, bf16)
        torch.cuda.synchronize()
        want = V.prepass_plain(tab, counts, bf16)
        bad = [0 if w is None else int((g != w).sum())
               for g, w in zip(got, want)]
        log(f"[variants] two_nn_variants_prepass {label} "
            f"{'bf16' if bf16 else 'int8'}: {tab.shape[0]} x {tab.shape[1]} "
            f"rows, mismatches norms {bad[0]}, qsq {bad[1]}, bf16 table "
            f"{bad[2]}")
        check(not any(bad), f"two_nn_variants_prepass disagrees with its "
              f"plain version: {label}")


def prepass_bound_ms(tab, bf16):
    """The pre-pass reads the table once and writes two int32 per row (and
    the bf16 table); its dp4a work is far below."""
    rows = tab.shape[0] * tab.shape[1]
    nbytes = tab.numel() + 8 * rows + (2 * tab.numel() if bf16 else 0)
    return nbytes / HBM_BYTES_S * 1e3, "bytes"


def split_two_nn(tab, counts, pi, pj, base, ragged):
    """The wgmma kernel's time split: its product-only ablation (one max a
    score in place of the top-2) and that ablation's two-launch form, held
    bit-exact against their plain version at the probe shape and on ragged
    counts, then timed beside base."""
    M = matching_cuda
    for label, (t, c), a, b in (("probe", (tab, counts), pi, pj),
                                ("ragged", ragged, *pair_tensors(
                                    [(i, j) for i in range(5)
                                     for j in range(5)]))):
        want = M.product_max_plain(t, t, c, a, b)
        for name, fn in (("two_nn_product_max", M.two_nn_product_max),
                         ("two_nn_product_max_two_launch",
                          M.two_nn_product_max_two_launch)):
            got = fn(t, t, c, a, b)
            torch.cuda.synchronize()
            compare_outputs(got, want, f"[variants] {name} {label}: "
                            f"{len(a)} pairs x {t.shape[1]} keys")
    ms = cuda_ms(lambda: M.two_nn_product_max(tab, tab, counts, pi, pj), 10)
    ms2 = cuda_ms(lambda: M.two_nn_product_max_two_launch(
        tab, tab, counts, pi, pj), 10)
    log(f"[variants] product-only split, two-launch form {ms2:.4f} ms")
    log(f"[variants] wgmma split at 2208 pairs x 2048^2: product + one max "
        f"a score {ms:.4f} ms ({100 * base['bound_ms'] / ms:.2f} % of the "
        f"bound), top-2 epilogue +{base['ms'] - ms:.4f} ms, whole "
        f"{base['ms']:.4f} ms")


def bare_variant(kernel, tab, counts, pi, pj, two_launch):
    """A `wgmma` variant launched bare through ctypes on preallocated
    tensors, for `device_us`: the one-launch kernel on its scratch (the
    bf16 table made beforehand, as the probe makes it), or the two-launch
    form, the pre-pass kernel (which also writes the bf16 table) and then
    the kernel reading its output."""
    V = matching_variants
    lib = V._load()
    stream = torch.cuda.current_stream().cuda_stream
    B, (n_img, K) = len(pi), tab.shape[:2]
    bf16 = "bf16" in kernel
    *out, scratch = V._outputs(B, K, tab.device, 2 * n_img * K)
    norms, qsq, t16 = V.variants_prepass(tab, counts, bf16)
    if not two_launch:
        norms, qsq = scratch.view(2, -1)
    if kernel.startswith("two_nn_oneblock"):
        entry, extra = lib.two_nn_oneblock, (int(kernel.rsplit("_", 1)[1]),
                                             int(bf16))
    elif kernel.startswith("two_nn_blockmerge"):
        entry, extra = lib.two_nn_blockmerge_bf16, ()
    else:
        entry, extra = lib.two_nn_ablation, (1,)

    def run():
        if two_launch:
            lib.two_nn_variants_prepass(
                tab.data_ptr(), n_img, K, counts.data_ptr(), int(bf16),
                norms.data_ptr(), qsq.data_ptr(),
                t16.data_ptr() if bf16 else None, stream)
        entry(tab.data_ptr(), t16.data_ptr() if bf16 else None, n_img, K,
              counts.data_ptr(), norms.data_ptr(), qsq.data_ptr(),
              int(two_launch), pi.data_ptr(), pj.data_ptr(), B, *extra,
              *(o.data_ptr() for o in out), stream)
    return run


def split_variant_calls(rows, kinds, tab, counts, pi, pj, calls=10):
    """Where a variant call's time goes at the timing shape, each `wgmma`
    variant that reads constants beside its two-launch form, in turns (one,
    two, two, one): the device time of the call's kernels launched bare
    (`bare_variant`, `device_us`) and the wrapper's host time; then the
    device time of the pre-pass kernel and the host time of the pre-pass
    wrapper, of the output allocation and of one bare variant launch in
    each form (oneblock int8 at tq 128).  Returns ({counter: {"device_us",
    "device_us_two_launch", "host_us", "host_us_two_launch"}}, device µs,
    host µs)."""
    V = matching_variants
    res = {}
    for v in rows:
        twin = two_launch_twin(v.kernel)
        if twin is None:
            continue
        one, two = (bare_variant(v.kernel, tab, counts, pi, pj, t)
                    for t in (False, True))
        d = [device_us(f, calls) for f in (one, two, two, one)]
        h = [host_us(lambda f=f: f(tab, counts, pi, pj), calls)
             for f in (v.fn, kinds[twin], kinds[twin], v.fn)]
        res[v.kernel] = {"device_us": (d[0] + d[3]) / 2,
                         "device_us_two_launch": (d[1] + d[2]) / 2,
                         "host_us": (h[0] + h[3]) / 2,
                         "host_us_two_launch": (h[1] + h[2]) / 2}
        log(f"[split] {v.kernel} at {len(pi)} pairs: device µs a call, one "
            f"launch {res[v.kernel]['device_us']:.2f} ({d[0]:.2f}, "
            f"{d[3]:.2f}), two-launch form "
            f"{res[v.kernel]['device_us_two_launch']:.2f} ({d[1]:.2f}, "
            f"{d[2]:.2f}); wrapper host µs a call, one launch "
            f"{res[v.kernel]['host_us']:.2f} ({h[0]:.2f}, {h[3]:.2f}), "
            f"two-launch form {res[v.kernel]['host_us_two_launch']:.2f} "
            f"({h[1]:.2f}, {h[2]:.2f})")
    B, (n_img, K) = len(pi), tab.shape[:2]
    dev = {f"pre-pass {d}": device_us(
        lambda b=(d == "bf16"): V.variants_prepass(tab, counts, b), calls)
        for d in ("int8", "bf16")}
    dev["bf16 table alone"] = device_us(lambda: V.bf16_table(tab), calls)
    host = {"pre-pass int8 wrapper": host_us(
                lambda: V.variants_prepass(tab, counts, False), calls),
            "pre-pass bf16 wrapper": host_us(
                lambda: V.variants_prepass(tab, counts, True), calls),
            "bf16_table wrapper": host_us(lambda: V.bf16_table(tab), calls),
            "outputs": host_us(lambda: V._outputs(B, K, tab.device,
                                                  2 * n_img * K), calls),
            "bare oneblock_int8_128 launch": host_us(bare_variant(
                "two_nn_oneblock_int8_128", tab, counts, pi, pj, False),
                calls),
            "bare oneblock_int8_128 two-launch form": host_us(bare_variant(
                "two_nn_oneblock_int8_128", tab, counts, pi, pj, True),
                calls)}
    log(f"[split] variants at {len(pi)} pairs x {K}^2: device µs a call: "
        f"{fmt_us(dev)}; host µs a call: {fmt_us(host)}")
    return res, dev, host


def time_variant(kernel, fn, kinds, tab, counts, pi, pj, bound, ops):
    """A variant kernel at the timing shape, by CUDA events around 10
    back-to-back calls: in turns with its two-launch form where it has one
    and its `mma.sync` twin (one, two, mma, mma, two, one);
    the plain version and the library yardstick; logged with the shares of
    the int8 (and bf16) bound."""
    bf16 = "bf16" in kernel
    twin = kinds.get(mma_twin(kernel))
    two = kinds.get(two_launch_twin(kernel))
    if twin is None:
        t = {"ms": cuda_ms(lambda: fn(tab, counts, pi, pj), 10)}
        turns = ""
    else:
        order = [fn, twin, twin, fn] if two is None else \
            [fn, two, twin, twin, two, fn]
        r = [cuda_ms(lambda f=f: f(tab, counts, pi, pj), 10) for f in order]
        t = {"ms": (r[0] + r[-1]) / 2,
             "ms_before": (r[len(r) // 2 - 1] + r[len(r) // 2]) / 2}
        turns = (f" ({r[0]:.4f}, {r[-1]:.4f}); mma.sync {t['ms_before']:.4f} "
                 f"ms ({r[len(r) // 2 - 1]:.4f}, {r[len(r) // 2]:.4f}; "
                 f"{100 * bound / t['ms_before']:.2f} % of the int8 bound), "
                 f"speed-up {t['ms_before'] / t['ms']:.3f}x")
        if two is not None:
            t["ms_two_launch"] = (r[1] + r[4]) / 2
            turns += (f"; two-launch form {t['ms_two_launch']:.4f} ms "
                      f"({r[1]:.4f}, {r[4]:.4f})")
    t["plain_ms"] = cuda_ms(
        lambda: _variant_plain(kernel)(tab, counts, pi, pj), 2)
    kind = ("exact" if "ablation" not in kernel
            else _plain_kind(kernel))
    t["library_ms"] = cuda_ms(
        lambda: library_yardstick(kind, tab, counts, pi, pj), 2)
    extra = ""
    if bf16:
        t["bound_bf16_ms"] = ops / BF16_TOPS * 1e3
        extra = (f", {100 * t['bound_bf16_ms'] / t['ms']:.2f} % of the bf16 "
                 f"bound ({t['bound_bf16_ms']:.4f} ms)")
    log(f"[variants] {kernel}: {t['ms']:.4f} ms{turns}; "
        f"{100 * bound / t['ms']:.2f} % of the int8 bound{extra}; plain "
        f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms")
    return t


def phase_variants():
    V = matching_variants
    P = probe_two_nn_variants
    rng = np.random.default_rng(3)
    shapes = {"probe": P.make_table(2048, "cuda"),
              "ragged": _ragged_table(rng), "ties": _ties_table(rng),
              "garbage": _garbage_table(rng)}
    # Every kernel and mode of both designs and every two-launch form,
    # bit-exact on every table; each one-launch kernel also identical to
    # its two-launch form and its `mma.sync` twin, and each exact one to
    # two_nn_pairs.  The bf16 kernels read the table's bf16 copy, made once
    # per table as the probe makes it.
    for kernel in UNPATHED:
        tq = int(kernel.rsplit("_", 1)[1])
        lay = V.oneblock_layout(tq, "bf16")
        log(f"[variants] {kernel}: {lay['cluster']} CTA(s) a cluster, "
            f"{lay['smem']} B of shared memory a CTA, {lay['resident']} "
            f"cluster(s) resident")
        check(lay["cluster"] == max(1, tq // 256) and lay["resident"] > 0,
              f"{kernel} layout {lay}")
    errs = {}
    for label, (tab, counts) in shapes.items():
        n = tab.shape[0]
        pairs = (P.make_pairs(276) if label == "probe"
                 else [(i, j) for i in range(n) for j in range(n)])
        pi, pj = pair_tensors(pairs)
        compare_prepass(tab, counts, label)
        kinds = variant_kernels(V.bf16_table(tab))
        plain, outs = {}, {}
        for kernel, fn in kinds.items():
            key = _plain_kind(kernel)
            if key not in plain:
                plain[key] = _variant_plain(kernel)(tab, counts, pi, pj)
            outs[kernel] = fn(tab, counts, pi, pj)
            torch.cuda.synchronize()
            errs[kernel] = max(errs.get(kernel, 0.0), compare_outputs(
                outs[kernel], plain[key], f"[variants] {kernel} {label}: "
                f"{len(pi)} pairs x {tab.shape[1]} keys"))
        pairs_out = matching_cuda.two_nn_pairs(tab, tab, counts, pi, pj)
        for kernel in WGMMA_VARIANTS:
            for twin, what in ((two_launch_twin(kernel), "two-launch form"),
                               (mma_twin(kernel), "mma.sync twin")):
                if twin is not None:
                    check(all(torch.equal(a, b) for a, b in zip(
                        outs[kernel], outs[twin])), f"{kernel} differs from "
                        f"its {what}: {label}")
            if "ablation" not in kernel:
                check(all(torch.equal(a, b) for a, b in zip(
                    outs[kernel], pairs_out)), f"{kernel} differs from "
                    f"two_nn_pairs: {label}")
        log(f"[variants] {label}: every one-launch kernel identical to its "
            f"two-launch form and its mma.sync twin, every exact one to "
            f"two_nn_pairs")
    check(len(errs) == len(kinds), f"compared {sorted(errs)}")

    # The probe path through its command-line entry point, with every
    # launch count zeroed just before it.
    zero_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = P.main(["276", "2048", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(V.LAUNCHES, **matching_cuda.LAUNCHES)
    res = {}
    for line in buf.getvalue().splitlines():
        log(f"[probe] {line}")
        if "vs_base:" in line:
            res[line.split()[0]] = (
                line.rsplit("vs_base: ", 1)[1],
                float(re.search(r"ms:\s+([0-9.]+)", line).group(1)))
    check(rc == 0, f"probe returned {rc}")
    log("[variants] probe-path launches: "
        + json.dumps({k: v for k, v in launches.items() if v}))
    calls = 1 + 3 * P.REPS_PER_ORDER     # the warm-up, 3 orders x reps
    for v in P.variants():
        check(v.name in res, f"probe skipped {v.name}")
        check(launches[v.kernel] == calls, f"probe: {v.kernel} launched "
              f"{launches[v.kernel]} times, not {calls}")
        if v.exact and v.kernel != "two_nn":
            check(res[v.name][0] == "IDENTICAL",
                  f"probe: {v.name} {res[v.name][0]}")
    check(yardstick_launches(launches) == {}, f"probe: a yardstick ran: "
          f"{yardstick_launches(launches)}")
    check(launches["two_nn_variants_prepass"] == 1,
          "probe: one pre-pass launch (the bf16 table, made once), got "
          f"{launches['two_nn_variants_prepass']}")

    # Times at 2208 pairs x 2048^2, the bf16 kernels on one bf16 table.
    tab, counts = shapes["probe"]
    table16 = V.bf16_table(tab)
    rows = [v for v in P.variants(table16) if v.kernel != "two_nn"]
    kinds = variant_kernels(table16)
    pi, pj = pair_tensors(P.make_pairs(2208))
    bound, by = two_nn_bound_ms(tab, counts, pi, pj)
    ops = 2.0 * 128 * float((counts.long()[pi.long()]
                             * counts.long()[pj.long()]).sum())
    log(f"[variants] 2208 pairs x 2048^2: bound {bound:.4f} ms ({by}: "
        f"{ops:.4e} int8 ops at {INT8_TOPS:.3e}/s; bf16 "
        f"{ops / BF16_TOPS * 1e3:.4f} ms at {BF16_TOPS:.3e}/s)")
    base = time_two_nn(tab, counts, pi, pj, 10,
                       "probe shape (base), 2208 pairs x 2048^2")
    split_two_nn(tab, counts, pi, pj, base, shapes["ragged"])
    split_two_nn_call(tab, counts, pi, pj, "probe shape 2208 pairs x 2048^2")
    splits, pre_dev, pre_host = split_variant_calls(
        rows + [types.SimpleNamespace(kernel=k, fn=kinds[k])
                for k in UNPATHED], kinds, tab, counts, pi, pj)
    records = []
    for v in rows:
        compare_variant(v.kernel, v.fn, tab, counts, pi, pj, "2208 pairs")
        t = time_variant(v.kernel, v.fn, kinds, tab, counts, pi, pj, bound,
                         ops)
        log(f"[variants] {v.kernel}: probe best-of-3 {res[v.name][1]:.4f} ms "
            f"at 276 pairs")
        records.append({"name": v.kernel, "route": "cuda",
                        "source": VARIANTS_SOURCE,
                        "replaces": _replaces(v.kernel),
                        "launches": launches[v.kernel],
                        "max_abs_err": errs[v.kernel], "bound_ms": bound,
                        "bound_by": by, **t, **splits.get(v.kernel, {})})
    # Oneblock bf16 above 128 rows: no path launches them; timed for the
    # record beside their two-launch forms and mma.sync twins.
    for k in UNPATHED:
        compare_variant(k, kinds[k], tab, counts, pi, pj, "2208 pairs")
        t = time_variant(k, kinds[k], kinds, tab, counts, pi, pj, bound, ops)
        records.append({"name": k, "route": "cuda", "source": VARIANTS_SOURCE,
                        "replaces": _replaces(k), "launches": launches[k],
                        "max_abs_err": errs[k], "bound_ms": bound,
                        "bound_by": by, **t, **splits[k]})
    # The pre-pass kernel: the two-launch forms' first launch, and the
    # bf16 table the probe makes once.
    pb, pby = prepass_bound_ms(tab, True)
    pre = {"ms": cuda_ms(lambda: V.variants_prepass(tab, counts, True), 10),
           "plain_ms": cuda_ms(lambda: V.prepass_plain(tab, counts, True), 10),
           "bf16_table_ms": cuda_ms(lambda: V.bf16_table(tab), 10),
           "device_us": pre_dev["pre-pass bf16"],
           "bf16_table_device_us": pre_dev["bf16 table alone"]}
    log(f"[variants] two_nn_variants_prepass (bf16, {tab.shape[0]} x "
        f"{tab.shape[1]} rows): {pre['ms']:.4f} ms, int8 "
        f"{cuda_ms(lambda: V.variants_prepass(tab, counts, False), 10):.4f} "
        f"ms, the bf16 table alone {pre['bf16_table_ms']:.4f} ms; plain "
        f"{pre['plain_ms']:.4f} ms; bound {pb:.4f} ms ({pby})")
    records.append({"name": "two_nn_variants_prepass", "route": "cuda",
                    "source": VARIANTS_SOURCE, "replaces": f"{PROBE}:62",
                    "launches": launches["two_nn_variants_prepass"],
                    "max_abs_err": 0.0, "bound_ms": pb, "bound_by": pby,
                    "library_ms": None, **pre})
    return records, launches


def library_matching(descs, lib, check_later):
    """(a) of the library phase: `match_pairs_batched` over every pair, on
    the uint8 descriptors and on the same values as float32, each with the
    launch counts zeroed just before; both dicts (and match files)
    identical to `DescriptorTable.match_pairs`; every 2-NN call of the
    counted run held against its plain version on the very tensors it was
    given; per-call times beside the bound.  Returns the launches of both
    runs, summed, and the kernels' times."""
    from bundler_sfm_tpu_torch.io.matchfile import write_match_file
    from bundler_sfm_tpu_torch.ops import matching
    M = matching_cuda
    pairs = all_pairs(len(descs))
    want = DescriptorTable(descs, device="cuda").match_pairs(
        pairs, min_matches=16)
    write_match_file(os.path.join(lib, "matches.table.txt"), want)
    with open(os.path.join(lib, "matches.table.txt"), "rb") as f:
        want_bytes = f.read()
    batch = 32
    n_chunks = -(-len(pairs) // batch)
    launches, times = {}, {}
    real = matching.two_nn_pairs
    for name, dtype, peak in (("uint8", np.uint8, INT8_TOPS),
                              ("float32", np.float32, BF16_TOPS)):
        ds = [d.astype(dtype) for d in descs]
        # Record the arguments of every 2-NN call the counted run makes.
        calls = []

        def record(*args):
            calls.append(args)
            return real(*args)
        matching.two_nn_pairs = record
        zero_launches()
        t0 = time.time()
        got = matching.match_pairs_batched(ds, pairs, batch=batch,
                                           min_matches=16, device="cuda")
        torch.cuda.synchronize()
        first_s = time.time() - t0
        run = {k: v for k, v in M.LAUNCHES.items() if v}
        matching.two_nn_pairs = real
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v
        path = os.path.join(lib, f"matches.{name}.txt")
        write_match_file(path, got)
        with open(path, "rb") as f:
            same = f.read() == want_bytes
        same &= got.keys() == want.keys() and all(
            np.array_equal(got[k], want[k]) for k in want)
        # One table, as query table and db table, for every chunk: one
        # launch a call (int8), or one pre-pass and the kernel (f32).
        expect = ({"two_nn": n_chunks}
                  if name == "uint8" else
                  {"two_nn_f32": n_chunks, "two_nn_f32_prepass": n_chunks})
        log(f"[library] (a) match_pairs_batched {name}: {len(got)} matched "
            f"pairs, {sum(len(m) for m in got.values())} matches, identical "
            f"to DescriptorTable.match_pairs (dict and file bytes): {same}; "
            f"launches {json.dumps(run)}")
        check_later(same, f"(a) match_pairs_batched {name} differs from "
                    f"DescriptorTable.match_pairs")
        check(run == expect, f"(a) match_pairs_batched {name}: launches "
              f"{run}, expected {expect}")
        tab, counts = calls[0][0], calls[0][2]
        check(len(calls) == n_chunks and all(
            c[0] is tab and c[1] is tab and c[2] is counts for c in calls),
            f"(a) match_pairs_batched {name}: {len(calls)} 2-NN calls, "
            f"expected {n_chunks} on one table")
        # The kernels of the counted run against their plain versions.
        if name != "uint8":
            compare_prepass_f32(tab, counts, "library")
        err = 0.0
        for c, (_, _, _, pi, pj) in enumerate(calls):
            got_k = M.two_nn_pairs(tab, tab, counts, pi, pj)
            torch.cuda.synchronize()
            err = max(err, compare_outputs(
                got_k, M._two_nn_pairs_plain(tab, tab, counts, pi, pj),
                f"[library] (a) chunk {c} {name}: {len(pi)} pairs of "
                f"{tab.shape[0]} images x {tab.shape[1]} keys"))
            if name == "uint8":
                two = M.two_nn_pairs_two_launch(tab, tab, counts, pi, pj)
                check(all(torch.equal(a, b) for a, b in zip(got_k, two)),
                      f"(a) chunk {c}: two_nn differs from its two-launch "
                      f"form")
        reps = 5
        t0 = time.time()
        for _ in range(reps):
            matching.match_pairs_batched(ds, pairs, batch=batch,
                                         min_matches=16, device="cuda")
        torch.cuda.synchronize()
        call_ms = (time.time() - t0) / reps * 1e3
        kernel_ms = cuda_ms(lambda: [M.two_nn_pairs(*a) for a in calls], 10)
        bound, by = two_nn_bound_ms(tab, counts, *pair_tensors(pairs), peak)
        times[name] = dict(call_ms=call_ms, kernel_ms=kernel_ms,
                           bound_ms=bound, bound_by=by, max_abs_err=err)
        log(f"[library] (a) match_pairs_batched {name}, {len(pairs)} pairs "
            f"in {n_chunks} chunks of {batch}: first call {first_s:.3f} s; "
            f"{call_ms:.2f} ms a call (host clock, {reps} calls); its "
            f"{n_chunks} two_nn_pairs calls {kernel_ms:.4f} ms (CUDA "
            f"events); bound {bound:.4f} ms ({by}), "
            f"{100 * bound / kernel_ms:.2f} % of it in the kernels, "
            f"{100 * bound / call_ms:.3f} % in the call")
    return launches, times


def unit_angles(a, b, signed):
    """Angle (rad) between the rows of two unit-vector arrays (up to sign
    unless `signed`)."""
    c = (a * b).sum(1)
    c = c if signed else np.abs(c)
    return np.arccos(np.clip(c, -1.0, 1.0))


def phase_library():
    """Phase 7: the JAX package's library modules the port now has, on
    phase 3's bundle.out and descriptors, on CUDA against the CPU:
    (a) matching (`library_matching`); (b) point normals; (c) scene
    geometry with one draw of samples; (d) similarity RANSAC on one matched
    pair; (e) every observation through each camera model; (f) the XML
    writers.  Returns the 2-NN launches of (a), the kernels' times and the
    failed checks, which main() raises once every phase has run."""
    from bundler_sfm_tpu_torch import models
    from bundler_sfm_tpu_torch.export import scene_geometry as SG
    from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
    from bundler_sfm_tpu_torch.io.xmlfile import (
        write_cameras_xml, write_points_xml,
    )
    from bundler_sfm_tpu_torch.models.camera import _quat_from_matrix
    from bundler_sfm_tpu_torch.ops import horn, plane
    from bundler_sfm_tpu_torch.ops.fisheye import FisheyeParams
    from bundler_sfm_tpu_torch.ops.ransac import sample_indices
    work = os.path.join(ROOT, "build", "smoke")
    lib = os.path.join(work, "library")
    if os.path.exists(lib):
        import shutil
        shutil.rmtree(lib)
    os.makedirs(lib)
    t_phase = time.time()
    failures = []
    check_later = failing_into(failures)

    def step(label, fn):
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        log(f"[library] {label}: {time.time() - t0:.3f} s")
        return out

    entries, dims, key_xy, descs, matches = read_scene(work)
    bundle = read_bundle_file(os.path.join(work, "bundle", "bundle.out"))
    regs = [i for i, c in enumerate(bundle.cameras) if c.registered]
    pos = np.stack([p.pos for p in bundle.points])
    n_obs = sum(len(p.views) for p in bundle.points)
    log(f"[library] bundle.out: {len(regs)} cameras, {len(pos)} points, "
        f"{n_obs} observations; {len(descs)} x "
        f"{max(len(d) for d in descs)} keys")
    launches, times = step("(a) matching", lambda: library_matching(
        descs, lib, check_later))

    # (b) point normals: unoriented kNN normals and the oriented ones.
    knn, oriented = {}, {}
    for dev in ("cuda", "cpu"):
        knn[dev] = step(f"(b) knn_plane_normals k=32 on {dev}",
                        lambda: plane.knn_plane_normals(
                            pos, np.ones(len(pos)), k=32,
                            device=dev).cpu().numpy())
        oriented[dev] = step(f"(b) estimate_point_normals k=32 on {dev}",
                             lambda: SG.estimate_point_normals(
                                 bundle, k=32, device=dev))
    for what, d, signed in (("knn_plane_normals", knn, False),
                            ("estimate_point_normals", oriented, True)):
        ang = unit_angles(d["cuda"], d["cpu"], signed)
        log(f"[library] (b) {what}: {len(ang)} normals, CUDA vs CPU largest "
            f"angle {ang.max():.3e} rad (point {int(ang.argmax())}), median "
            f"{np.median(ang):.3e}")
        check_later(np.isfinite(d["cuda"]).all() and ang.max() <= 1e-6,
                    f"(b) {what}: CUDA vs CPU largest angle {ang.max()} rad "
                    f"(point {int(ang.argmax())})")

    # (c) scene geometry, one draw of samples for both devices.
    gen = torch.Generator().manual_seed(0)
    s_cams = plane.draw_samples(gen, 1024, 3, torch.ones(len(regs)))
    s3 = plane.draw_samples(gen, 1024, 3, torch.ones(len(pos)))
    s2 = plane.draw_samples(gen, 1024, 2, torch.ones(len(pos)))
    spread = float(np.sqrt(((pos - pos.mean(0)) ** 2).sum(1).mean()))
    thr = 0.01 * spread
    up = np.array([0.0, 1.0, 0.0])
    geo = {}
    for dev in ("cuda", "cpu"):
        r = {}
        r["ground"] = step(f"(c) setup_scene_ground_plane on {dev}",
                           lambda: SG.setup_scene_ground_plane(
                               bundle, samples=s_cams, device=dev))
        for mode, s in (("free", s3), ("perp_to_up", s3),
                        ("par_to_up", s2)):
            r[mode] = step(f"(c) fit_plane_to_points {mode} on {dev}",
                           lambda: SG.fit_plane_to_points(
                               pos, ransac_threshold=thr, samples=s, up=up,
                               par_to_up=mode == "par_to_up",
                               perp_to_up=mode == "perp_to_up", device=dev))
        r["rotations"] = step(f"(c) compute_image_rotations on {dev}",
                              lambda: SG.compute_image_rotations(
                                  bundle, samples=s_cams, device=dev))
        geo[dev] = r
    diff = max(float(np.abs(a - b).max()) for a, b in
               zip(geo["cuda"]["ground"], geo["cpu"]["ground"]))
    log(f"[library] (c) setup_scene_ground_plane: up "
        f"{np.round(geo['cuda']['ground'][1], 6).tolist()}, CUDA vs CPU "
        f"largest difference {diff:.3e}")
    check_later(diff <= 1e-9, f"(c) ground plane: CUDA vs CPU {diff}")
    for mode in ("free", "perp_to_up", "par_to_up"):
        (pc, ic), (pp, ip) = geo["cuda"][mode], geo["cpu"][mode]
        # A 2D line's sign is the eigensolver's (cuSOLVER's or LAPACK's).
        sign = np.sign(pc @ pp) if mode == "par_to_up" else 1.0
        d = float(np.abs(sign * pc - pp).max())
        same = np.array_equal(ic, ip)
        log(f"[library] (c) fit_plane_to_points {mode} (threshold {thr:.4e}):"
            f" plane {np.round(pp, 6).tolist()}, {len(ip)} of {len(pos)} "
            f"inliers; CUDA vs CPU: same inliers {same}, largest plane "
            f"difference {d:.3e}")
        check_later(same and d <= 1e-9, f"(c) fit_plane_to_points {mode}: "
                    f"same inliers {same}, plane difference {d}")
    rots = geo["cuda"]["rotations"]
    log(f"[library] (c) compute_image_rotations: {rots}; CUDA == CPU "
        f"{rots == geo['cpu']['rotations']}")
    check_later(rots == geo["cpu"]["rotations"],
                "(c) compute_image_rotations differ between CUDA and CPU")
    normals, conf = step("(c) estimate_point_normals_confidence (host)",
                         lambda: SG.estimate_point_normals_confidence(bundle))
    log(f"[library] (c) confidence: mean {conf.mean():.4f}, "
        f"{int((conf > 0).sum())} of {len(conf)} above 0")
    check_later(np.isfinite(normals).all() and np.isfinite(conf).all(),
                "(c) estimate_point_normals_confidence is not finite")

    # (d) similarity RANSAC on the pair with the most matches.
    (i, j), m = max(matches.items(), key=lambda kv: len(kv[1]))
    p1, p2 = key_xy[i][m[:, 0]], key_xy[j][m[:, 1]]
    samples = sample_indices(gen, 256, 3, torch.tensor([len(m)]), len(m))[0]
    sim = {dev: step(f"(d) estimate_similarity_ransac on {dev}",
                     lambda: [x.cpu().numpy() for x in
                              horn.estimate_similarity_ransac(
                                  p1, p2, len(m), 8.0, samples=samples,
                                  device=dev)])
           for dev in ("cuda", "cpu")}
    same = np.array_equal(sim["cuda"][1], sim["cpu"][1])
    d = float(np.abs(sim["cuda"][0] - sim["cpu"][0]).max()
              / np.abs(sim["cpu"][0]).max())
    log(f"[library] (d) pair {(i, j)}, {len(m)} matches: {int(sim['cpu'][2])}"
        f" inliers at 8 px; CUDA vs CPU same inliers {same}, model "
        f"difference {d:.3e} of its largest entry")
    check_later(same and d <= 1e-9, f"(d) similarity RANSAC: same inliers "
                f"{same}, model difference {d}")

    # (e) every observation through each camera model.
    views = np.concatenate([p.views for p in bundle.points])
    obs_pt = np.repeat(np.arange(len(pos)), [len(p.views)
                                             for p in bundle.points])
    cam = views[:, 0].astype(int)
    R = np.stack([c.R for c in bundle.cameras])[cam]
    C = np.stack([c.center for c in bundle.cameras])[cam]
    fk = np.array([[c.f, c.k1, c.k2] for c in bundle.cameras])[cam]
    X = pos[obs_pt]
    fp = FisheyeParams(fCx=0.0, fCy=0.0, fRad=480.0, fAngle=160.0,
                       fFocal=420.0)
    # The quaternion layout [q, t, f, k1, k2], q by Shepperd's method (every
    # branch: the orbit holds rotations near 180 degrees).
    q = np.stack([np.concatenate([_quat_from_matrix(c.R), c.t,
                                  [c.f, c.k1, c.k2]])
                  for c in bundle.cameras])[cam]

    def project_all(dev):
        tt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        p9 = tt(np.concatenate([C, np.zeros_like(C), fk], 1))
        out = {"snavely": models.SnavelyModel.project(p9, tt(R), tt(X)),
               "snavely_quaternion": models.SnavelyQuaternionModel.project(
                   tt(q), None, tt(X)),
               "known_intrinsics": models.KnownIntrinsicsModel.project(
                   p9[:, :6], (tt(R), tt(fk[:, 0]), tt(fk[:, 1]),
                               tt(fk[:, 2])), tt(X)),
               "fisheye": models.FisheyeModel.project(p9, (tt(R), fp),
                                                      tt(X))}
        return {k: v.cpu().numpy() for k, v in out.items()}
    proj = {dev: step(f"(e) {len(X)} observations through 4 camera models "
                      f"on {dev}", lambda: project_all(dev))
            for dev in ("cuda", "cpu")}
    for name in models.CAMERA_MODELS:
        d = float(np.abs(proj["cuda"][name] - proj["cpu"][name]).max())
        ref = float(np.abs(proj["cpu"][name] - proj["cpu"]["snavely"]).max())
        err = np.linalg.norm(proj["cuda"][name] - views[:, 2:4], axis=1)
        log(f"[library] (e) {name}: CUDA vs CPU largest difference {d:.3e} "
            f"px; vs the Snavely model {ref:.3e} px; mean distance to the "
            f"observations {err.mean():.4f} px"
            + (" (a lens the scene was not taken with)"
               if name == "fisheye" else ""))
        check_later(d <= 1e-6, f"(e) {name}: CUDA vs CPU {d} px")
        # The quaternion is of a rotation read from text (10 digits), so
        # it agrees with the Snavely model to ~1e-6 px, not to rounding.
        if name != "fisheye":
            check_later(ref <= 1e-4 and err.mean() < 1.0,
                        f"(e) {name}: {ref} px from the Snavely model, "
                        f"{err.mean()} px from the observations")

    # (f) the XML writers, with each device's fitted plane.
    names = [os.path.basename(e.name) for e in entries]
    body = {}
    for dev in ("cuda", "cpu"):
        cams = os.path.join(lib, f"cameras.{dev}.xml")
        pts = os.path.join(lib, f"points.{dev}.xml")
        step(f"(f) write_cameras_xml / write_points_xml ({dev} plane)",
             lambda: (write_cameras_xml(cams, bundle, names, dims,
                                        fit_plane=geo[dev]["free"][0]),
                      write_points_xml(pts, bundle)))
        with open(cams, "rb") as f1, open(pts, "rb") as f2:
            body[dev] = (f1.read(), f2.read())
    same = body["cuda"] == body["cpu"]
    log(f"[library] (f) cameras.xml ({body['cpu'][0].count(b'<camera>')} "
        f"cameras) and points.xml ({body['cpu'][1].count(b'<point>')} points)"
        f" byte-identical CUDA vs CPU: {same}")
    check_later(same, "(f) the XML files differ between CUDA and CPU")
    log(f"[library] phase {time.time() - t_phase:.1f} s; 2-NN launches "
        f"{json.dumps(launches)}")
    return launches, times, failures


def ba_problem_from_bundle(bundle_path, entries, seed=0):
    """Phase 3's final bundle as a bundle-adjustment problem (host arrays):
    every registered camera (w = 0, R0 = its rotation), every point moved
    by seeded noise of 1e-3 of the scene's spread (so LM has work to do),
    every observation; the focal and distortion priors of run_sfm under
    RunBundler.sh's options.  Returns (problem kwargs, run kwargs of the
    outlier loop)."""
    from bundler_sfm_tpu_torch.config import default_pipeline_config
    from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
    cfg = default_pipeline_config()
    b = read_bundle_file(bundle_path)
    regs = [i for i, c in enumerate(b.cameras) if c.registered]
    slot = {img: s for s, img in enumerate(regs)}
    cams = [b.cameras[i] for i in regs]
    C = len(cams)
    cam0 = np.zeros((C, 9))
    cam0[:, 0:3] = np.stack([c.center for c in cams])
    cam0[:, 6:9] = [[c.f, c.k1, c.k2] for c in cams]
    pos = np.stack([p.pos for p in b.points])
    views = [np.atleast_2d(p.views) for p in b.points]
    obs_pt = np.concatenate([np.full(len(v), k) for k, v in
                             enumerate(views)])
    v = np.concatenate(views)
    obs_cam = np.array([slot[int(i)] for i in v[:, 0]])
    cc = np.zeros((C, 9)); ct = np.zeros((C, 9)); cw = np.zeros((C, 9))
    cc[:, 6] = 1.0
    ct[:, 6] = [entries[i].init_focal for i in regs]
    cw[:, 6] = cfg.constrain_focal_weight
    cc[:, 7:9] = 1.0
    cw[:, 7:9] = cfg.distortion_weight
    spread = float(np.sqrt(((pos - pos.mean(0)) ** 2).sum(1).mean()))
    rng = np.random.default_rng(seed)
    host = dict(R0=np.stack([c.R for c in cams]), cam0=cam0,
                pts0=pos + rng.normal(size=pos.shape) * 1e-3 * spread,
                obs_cam=obs_cam, obs_pt=obs_pt, obs_xy=v[:, 2:4],
                est_focal=not cfg.fixed_focal_length,
                est_distortion=cfg.estimate_distortion,
                cam_constrained=cc, cam_constraints=ct, cam_weights=cw)
    run = dict(max_iters=cfg.sfm_max_iters, tau=cfg.sfm_mu0_tau,
               eps1=cfg.sfm_eps1, eps2=cfg.sfm_eps2,
               outlier_factor=1.2 * cfg.outlier_num_stddev,
               min_thresh=cfg.min_proj_error_threshold,
               max_thresh=cfg.max_proj_error_threshold,
               min_outliers=cfg.sfm_min_outliers,
               min_points=cfg.sfm_min_points, max_passes=8)
    return host, run


def _ba_outcome(res, cam, R, pts, ov, removed, secs, peak):
    """What phase 8 (b) holds and prints of one outlier-loop run, as host
    arrays (global point and observation order)."""
    return dict(cam=cam, R=R, pts=pts, obs_valid=ov, pt_removed=removed,
                cost=float(res.cost), passes=int(res.passes),
                iters=int(res.iters), stats=res.stats.cpu().numpy(),
                secs=secs, peak_gib=peak / 2 ** 30)


def _multi_device_rank(mesh, descs, pairs, host, run, workdir, imgs):
    """Phase 8 on one rank (world 1 over NCCL in the smoke's process, world
    2 over gloo in two spawned processes sharing cuda:0): (a) the ring
    matcher and the pair-split table with the launch counts zeroed just
    before each, then the 2-NN kernel on one rotation's tensors against
    its plain version; (b) the point-sharded outlier loop on phase 3's
    final problem; (c) at world 2, run_bundler.main --num_devices 2 in a
    directory of this rank's own.  Returns host values only."""
    from bundler_sfm_tpu_torch.ops.matching import DescriptorTable as Table
    from bundler_sfm_tpu_torch.parallel import ba_sharded as S
    from bundler_sfm_tpu_torch.parallel.matching_sharded import (
        ShardedDescriptorTable,
    )
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend}
    M = matching_cuda
    for name, make in (("ring", lambda: ShardedDescriptorTable(descs, mesh)),
                       ("split", lambda: Table(descs, mesh=mesh))):
        # The counted call, then a second one timed warm (the first call
        # of a group also sets up its communicators).
        secs = []
        for rep in range(2):
            if rep == 0:
                zero_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            table = make()
            got = table.match_pairs(pairs, min_matches=16)
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
            if rep == 0:
                out[name] = dict(matches=got, launches={
                    k: v for k, v in M.LAUNCHES.items() if v})
        out[name]["secs"] = secs
    # The kernel on the tensors of rotation 1 (rotation 0 at world 1): the
    # query shard this rank keeps and the db shard it receives.
    ring = ShardedDescriptorTable(descs, mesh)
    q, qc = ring.table, ring.counts
    db = mesh.ring_shift(q)
    dbc = torch.from_numpy(ring.counts_host[(mesh.rank + 1) % mesh.size]).to(
        mesh.device)
    I = q.shape[0]
    grid = torch.arange(I * I, dtype=torch.int32, device=mesh.device)
    pi, pj = (grid // I).contiguous(), (grid % I).contiguous()
    got = M.two_nn_pairs(q, db, dbc, pi, pj)
    torch.cuda.synchronize()
    want = M._two_nn_pairs_plain(q, db, dbc, pi, pj)
    two = M.two_nn_pairs_two_launch(q, db, dbc, pi, pj)
    out["kernel_mismatches"] = [int((g != w).sum()) for g, w in zip(got, want)]
    out["kernel_mismatches"] += [int((g != w).sum()) for g, w in zip(two, got)]
    out["kernel_pairs"] = int(len(pi))

    # (b) the outlier loop, point-sharded: run twice, timed warm (the
    # first BA of a process also loads the solver libraries).
    P = len(host["pts0"])
    torch.cuda.reset_peak_memory_stats(mesh.device)
    prob = S.shard_problem(mesh=mesh, **host)
    co = S.build_cam_obs_table_sharded(host["obs_cam"], host["obs_pt"], mesh,
                                       len(host["cam0"]))
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        res = S.run_ba_outlier_loop_sharded(prob, co, mesh, **run)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
    # This rank's observations are the global ones of its points, in input
    # order: gather every rank's obs_valid (padded to the longest).
    shard_of = np.asarray(host["obs_pt"]) % mesh.size
    n_obs = np.bincount(shard_of, minlength=mesh.size)
    ov = torch.zeros(int(n_obs.max()), dtype=torch.bool, device=mesh.device)
    ov[:n_obs[mesh.rank]] = res.obs_valid
    ov_all = mesh.all_gather(ov[None], 0).cpu().numpy()
    obs_valid = np.zeros(len(shard_of), bool)
    for s in range(mesh.size):
        obs_valid[shard_of == s] = ov_all[s, :n_obs[s]]
    out["ba"] = _ba_outcome(
        res, res.cam.cpu().numpy(), res.R.cpu().numpy(),
        S.unshard_points(res.pts, mesh, P), obs_valid,
        S.unshard_flat(res.pt_removed, mesh, P), secs,
        torch.cuda.max_memory_allocated(mesh.device))

    if imgs is None:
        return out
    # (c) the whole pipeline on this rank, in a directory of its own.
    from bundler_sfm_tpu_torch import run_bundler
    from bundler_sfm_tpu_torch.utils import get_telemetry
    wdir = os.path.join(workdir, f"rank{mesh.rank}")
    os.makedirs(wdir)
    incremental, real_baf, wrapped, box = capture_stage5()
    os.chdir(wdir)
    get_telemetry().reset()
    zero_launches()
    incremental.bundle_adjust_fast = wrapped
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = run_bundler.main([imgs, "--max_keys", "4096", "--init_focal",
                               "896", "--device", str(mesh.device),
                               "--num_devices", str(mesh.size), "--out",
                               "bundle"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    incremental.bundle_adjust_fast = real_baf
    rec = box["recon"]
    out["e2e"] = dict(
        rc=rc, wall=wall, stage5_wall=box["wall"], peak_gib=box["peak"] / 2 ** 30,
        launches={k: v for k, v in matching_cuda.LAUNCHES.items() if v},
        stages=dict(get_telemetry().stage_seconds),
        counters=dict(get_telemetry().counters),
        order=list(rec.added_order), cams=np.stack(rec.cam_params),
        R=np.stack(rec.cam_R), points=sum(1 for v in rec.pt_views if v),
        files=sorted(os.path.relpath(os.path.join(d, f), wdir)
                     for d, _, fs in os.walk(wdir) for f in fs),
        log_tail=buf.getvalue()[-2000:])
    return out


def phase_multi_device():
    """Phase 8: the multi-device paths (`bundler_sfm_tpu_torch/parallel/`) on
    phase 3's data, against the single-device port: world 1 over NCCL in
    this process, world 2 over gloo in two ranks sharing cuda:0 (NCCL takes
    one rank a card).  (a) the ring matcher and the pair-split table over
    the 276 pairs: dicts identical to DescriptorTable.match_pairs; the
    2-NN kernel bit-exact on one rotation's tensors; (b) the point-sharded
    outlier loop on phase 3's final bundle (points moved by seeded noise):
    identical to run_ba_outlier_loop at world 1; at world 2 the same
    obs_valid, pt_removed and passes, the final cost within rtol 1e-9 and
    every observation's reprojection within 1e-6 px; (c) run_bundler
    --num_devices 2 on the render: 24/24 cameras, centre error < 0.02,
    reprojection < 1 px, both ranks' cameras identical, files from rank 0
    only.  Returns the 2-NN launches of the phase's counted runs and the
    failed checks."""
    import shutil
    import torch.distributed as dist
    from bundler_sfm_tpu_torch.ops.ba import (
        _predict_obs, build_problem, run_ba_outlier_loop,
    )
    from bundler_sfm_tpu_torch.parallel.mesh import launch, make_mesh
    work = os.path.join(ROOT, "build", "smoke")
    md = os.path.join(work, "multi")
    if os.path.exists(md):
        shutil.rmtree(md)
    os.makedirs(md)
    imgs = os.path.join(work, "images")
    t_phase = time.time()
    failures = []
    check_later = failing_into(failures)

    entries, dims, key_xy, descs, matches = read_scene(work)
    pairs = all_pairs(len(descs))
    want = DescriptorTable(descs, device="cuda").match_pairs(pairs,
                                                             min_matches=16)
    host, run = ba_problem_from_bundle(
        os.path.join(work, "bundle", "bundle.out"), entries)
    P, O = len(host["pts0"]), len(host["obs_cam"])
    log(f"[multi] {len(descs)} x {max(len(d) for d in descs)} keys, "
        f"{len(pairs)} pairs ({len(want)} with >= 16 matches, "
        f"{sum(len(m) for m in want.values())} matches); BA problem {len(host['cam0'])} cameras, {P} "
        f"points, {O} observations")

    # The single-device outlier loop the sharded runs are held to.
    prob1 = build_problem(**host, device="cuda")
    torch.cuda.synchronize()
    secs = []
    for _ in range(2):
        t0 = time.time()
        res1 = run_ba_outlier_loop(prob1, **run)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
    one = _ba_outcome(res1, res1.cam.cpu().numpy(), res1.R.cpu().numpy(),
                      res1.pts.cpu().numpy(), res1.obs_valid.cpu().numpy(),
                      res1.pt_removed.cpu().numpy(), secs, 0)
    log(f"[multi] (b) one device: {one['passes']} passes, {one['iters']} LM "
        f"iterations, {1e3 * secs[1] / max(one['iters'], 1):.2f} ms an "
        f"iteration warm ({secs[1]:.4f} s a run; the first {secs[0]:.4f} "
        f"s), cost {one['cost']!r}")

    def reprojection(o):
        pred, _ = _predict_obs(*(torch.as_tensor(o[k], device="cuda")
                                 for k in ("cam", "pts", "R")), prob1)
        return pred.cpu().numpy()
    pred1 = reprojection(one)

    t0 = time.time()
    mesh = make_mesh(1, device="cuda:0")
    w1 = _multi_device_rank(mesh, descs, pairs, host, run, md, None)
    dist.destroy_process_group()
    log(f"[multi] world 1 ({w1['backend']}) {time.time() - t0:.1f} s")
    t0 = time.time()
    w2 = launch(_multi_device_rank, 2, "cuda:0", backend="gloo",
                args=(descs, pairs, host, run, md, imgs))
    log(f"[multi] world 2 (gloo, both ranks on cuda:0) {time.time() - t0:.1f}"
        f" s with the ranks' start")
    counted = {}
    for r in [w1] + w2:
        tag = f"world {r['size']} rank {r['rank']}"
        for name in ("ring", "split"):
            x = r[name]
            same = list(x["matches"]) == list(want) and all(
                np.array_equal(x["matches"][p], want[p]) for p in want)
            log(f"[multi] (a) {tag} {name}: {len(x['matches'])} pairs, "
                f"{sum(len(m) for m in x['matches'].values())} matches, "
                f"identical to DescriptorTable.match_pairs {same}; a call "
                f"(table upload included) {x['secs'][0]:.4f} s first, "
                f"{x['secs'][1]:.4f} s warm; launches "
                f"{json.dumps(x['launches'])}")
            check_later(same, f"(a) {tag} {name} differs from "
                        "DescriptorTable.match_pairs")
            for k, v in x["launches"].items():
                counted[k] = counted.get(k, 0) + v
        log(f"[multi] (a) {tag}: two_nn on one rotation's tensors "
            f"({r['kernel_pairs']} pairs x 4096 keys) vs its plain version, "
            f"then its two-launch form vs two_nn: mismatches d0/i0/d1 "
            f"{r['kernel_mismatches']}")
        check_later(not any(r["kernel_mismatches"]),
                    f"(a) {tag}: two_nn disagrees with its plain version")
        b = r["ba"]
        pred = reprojection(b)
        dpx = float(np.abs(pred - pred1).max())
        same_sets = (np.array_equal(b["obs_valid"], one["obs_valid"])
                     and np.array_equal(b["pt_removed"], one["pt_removed"]))
        log(f"[multi] (b) {tag}: {b['passes']} passes, {b['iters']} LM "
            f"iterations, {1e3 * b['secs'][1] / max(b['iters'], 1):.2f} ms "
            f"an iteration warm ({b['secs'][1]:.4f} s a run; the first "
            f"{b['secs'][0]:.4f} s), "
            f"cost {b['cost']!r} (rel. difference "
            f"{abs(b['cost'] - one['cost']) / abs(one['cost']):.3e}), "
            f"largest reprojection difference {dpx:.3e} px, same obs_valid "
            f"and pt_removed {same_sets}, peak device memory "
            f"{b['peak_gib']:.3f} GiB")
        if r["size"] == 1:
            ident = all(np.array_equal(b[k], one[k]) for k in (
                "cam", "R", "pts", "obs_valid", "pt_removed", "stats")) and \
                (b["cost"], b["passes"], b["iters"]) == \
                (one["cost"], one["passes"], one["iters"])
            log(f"[multi] (b) {tag}: bit-identical to run_ba_outlier_loop "
                f"{ident}")
            check_later(ident, "(b) world 1 differs from run_ba_outlier_loop")
        else:
            check_later(same_sets and b["passes"] == one["passes"]
                        and abs(b["cost"] - one["cost"])
                        <= 1e-9 * abs(one["cost"]) and dpx <= 1e-6,
                        f"(b) {tag} outside its tolerance")
    e = [r["e2e"] for r in w2]
    for r, x in zip(w2, e):
        print(x["log_tail"] if x["rc"] else "", end="")
        log(f"[multi] (c) rank {r['rank']}: rc {x['rc']}, wall "
            f"{x['wall']:.2f} s, stage 5 {x['stage5_wall']:.2f} s, "
            f"{len(x['order'])} cameras, {x['points']} points, LM iterations "
            f"{int(x['counters'].get('lm_iters', 0))}, peak device memory "
            f"(stage 5) {x['peak_gib']:.3f} GiB, launches "
            f"{json.dumps(x['launches'])}, stage seconds "
            + json.dumps({k: round(v, 4) for k, v in x["stages"].items()}))
        for k, v in x["launches"].items():
            counted[k] = counted.get(k, 0) + v
    check_later(all(x["rc"] == 0 for x in e), "(c) run_bundler failed")
    same = (e[0]["order"] == e[1]["order"]
            and np.array_equal(e[0]["cams"], e[1]["cams"])
            and np.array_equal(e[0]["R"], e[1]["R"]))
    log(f"[multi] (c) both ranks' cameras identical {same}; files of rank 0 "
        f"{e[0]['files'][:6]}... ({len(e[0]['files'])}), of rank 1 "
        f"{e[1]['files']}")
    check_later(same, "(c) the ranks' cameras differ")
    check_later(e[1]["files"] == [] and "bundle/bundle.out" in e[0]["files"],
                "(c) rank 1 wrote files, or rank 0 wrote no bundle.out")
    with open(os.path.join(imgs, "gt.json")) as f:
        gt = json.load(f)
    q = bundle_quality(os.path.join(md, "rank0", "bundle", "bundle.out"), gt)
    log(f"[multi] (c) bundle.out: {q['cameras']} cameras, {q['points']} "
        f"points, {q['observations']} observations, reprojection "
        f"{q['reproj_px']:.4f} px, centre error {q['ate']:.6f}")
    check_later(q["cameras"] == len(entries) and q["ate"] < 0.02
                and q["reproj_px"] < 1.0, "(c) outside phase 3's bounds")
    log(f"[multi] phase {time.time() - t_phase:.1f} s; 2-NN launches of the "
        f"counted runs {json.dumps(counted)}")
    # One launch a 2-NN call: the ring and the split at world 1 (1 + 1),
    # at world 2 (ring 2 + 1, split 1 + 1), run_bundler's ring (2 + 1).
    check_later(counted == {"two_nn": 10}, f"(a, c) 2-NN launches "
                f"{counted}, expected 10 of two_nn and no other")
    return counted, failures


# The JAX package's BA race problems (BASELINE.md, "BA head-to-head"):
# cameras, points, views a point, of benchmarks/ba_vs_sba.py's synthesize.
BA_SCALE_SIZES = {256: (256, 262144, 8), 512: (512, 524288, 8)}


def _ba_linearization(prob):
    """Y, W and g_p of the first LM iteration from prob's start, through
    the helpers _lm_loop itself calls (tau = 1e-3, run_ba's default)."""
    from bundler_sfm_tpu_torch.ops.ba import (
        build_normal_blocks, eliminate_points, initial_mu)
    U, V, W, _, g_p, _ = build_normal_blocks(prob.cam0, prob.pts0, prob,
                                             False)
    _, Y = eliminate_points(V, W, initial_mu(U, V, 1e-3), prob)
    return Y, W, g_p


def _timed_assembly(prob, Y, W, g_p, **kw):
    """(S_off, rhs_off, ms, peak GiB) of one assemble_schur_off call."""
    from bundler_sfm_tpu_torch.ops.ba import assemble_schur_off
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    S, r = assemble_schur_off(Y, W, g_p, prob, prob.cam0.shape[0], **kw)
    torch.cuda.synchronize()
    return (S, r, 1e3 * (time.perf_counter() - t0),
            torch.cuda.max_memory_allocated() / 2 ** 30)


@contextlib.contextmanager
def _one_shot_tables():
    """The full-C assembly in one chunk (the port's dense tables before
    they were chunked): SCHUR_TABLE_BYTES out of reach for the duration."""
    from bundler_sfm_tpu_torch.ops import ba as BA
    saved = BA.SCHUR_TABLE_BYTES
    BA.SCHUR_TABLE_BYTES = 1 << 62
    try:
        yield
    finally:
        BA.SCHUR_TABLE_BYTES = saved


def phase_ba_scale(cams=(256, 512)):
    """Phase 9: bundle adjustment at the JAX package's race scale
    (`probes/ba_scale.py`: benchmarks/ba_vs_sba.py's arc scene, f64, the
    window plan of plan_schur_windows) for each camera count in `cams`,
    with every launch count zeroed first: (a) run_ba windowed to 150
    iterations: the final cost <= 1.001 x the cost at the generator's
    ground truth, mean reprojection < 0.6 px, a second CUDA run
    bit-identical; (b) on the first iteration's linearization, the
    windowed S_off and rhs_off within 1e-12 of the largest entry of the
    full-C ones (256: the one-shot tables; 512: chunked), each assembly
    timed with its peak memory; (c) at 256, 3 LM iterations of the
    windowed, chunked full-C and one-shot full-C forms in turns: costs
    within 1e-10 relative, ms per iteration.  No kernel may launch.
    Returns (records, launches, failed checks)."""
    from bundler_sfm_tpu_torch.ops.ba import run_ba
    from bundler_sfm_tpu_torch.probes import ba_scale
    failures, records = [], {}
    check_later = failing_into(failures)

    t_phase = time.time()
    torch.cuda.empty_cache()
    zero_launches()
    for n in cams:
        C, P, V = BA_SCALE_SIZES[n]
        tag = f"[ba_scale] {C} cams"
        t0 = time.time()
        sp = ba_scale.build(C, P, V, device="cuda")
        torch.cuda.synchronize()
        build_s = time.time() - t0
        win = ba_scale.plan_summary(sp.plan)
        check(sp.plan is not None, f"{tag}: no window plan")
        log(f"{tag}: {sp.prob.pts0.shape[0]} points, "
            f"{sp.prob.obs_cam.shape[0]} observations; window "
            f"{win['window']}, {win['groups']} groups of {win['group_pts']}, "
            f"{win['wide_points']} wide points; built in {build_s:.3f} s")
        # (a) the windowed BA, twice.
        rec, res = ba_scale.solve(sp)
        log(f"{tag} (a) {json.dumps(rec)}")
        rec2, res2 = ba_scale.solve(sp)
        same = res.iters == res2.iters and all(torch.equal(
            getattr(res, f), getattr(res2, f))
            for f in ("cam", "R", "pts", "cost", "mu"))
        log(f"{tag} (a) rerun: {rec2['ba_s']:.3f} s, {rec2['ms_per_iter']:.3f}"
            f" ms an iteration, bit-identical: {same}")
        check_later(same, f"{tag} (a): the CUDA rerun differs")
        check_later(np.isfinite(rec["cost"])
                    and rec["cost"] <= 1.001 * rec["gt_cost"],
                    f"{tag} (a): cost {rec['cost']} above 1.001 x the "
                    f"ground truth's {rec['gt_cost']}")
        check_later(rec["mean_reproj_px"] < 0.6, f"{tag} (a): mean "
                    f"reprojection {rec['mean_reproj_px']} px >= 0.6")
        rec["rerun"] = dict(ba_s=rec2["ba_s"], ms_per_iter=rec2["ms_per_iter"],
                            bit_identical=same)
        del res, res2
        # (b) one assembly of each form on the first linearization.
        prob = sp.prob
        Y, W, g_p = _ba_linearization(prob)
        kw = dict(window=win["window"], group_pts=win["group_pts"])
        S_w, r_w, ms_w, peak_w = _timed_assembly(prob, Y, W, g_p, **kw)
        S_w, r_w, ms_w, peak_w = _timed_assembly(prob, Y, W, g_p, **kw)
        if C == 256:
            with _one_shot_tables():
                S_f, r_f, ms_f, peak_f = _timed_assembly(prob, Y, W, g_p)
            form = "one-shot"
        else:
            S_f, r_f, ms_f, peak_f = _timed_assembly(prob, Y, W, g_p)
            form = "chunked"
        err = float((S_w - S_f).abs().max() / S_f.abs().max())
        rerr = float((r_w - r_f).abs().max() / r_f.abs().max())
        rec["assembly"] = dict(windowed_ms=ms_w, windowed_peak_gib=peak_w,
                               full_form=form, full_ms=ms_f,
                               full_peak_gib=peak_f, rel_err=err,
                               rhs_rel_err=rerr)
        log(f"{tag} (b) {json.dumps(rec['assembly'])}")
        check_later(err <= 1e-12 and rerr <= 1e-12, f"{tag} (b): windowed "
                    f"S_off / rhs_off {err} / {rerr} of the largest entry "
                    f"from the {form} full-C form")
        del S_w, r_w, S_f, r_f, Y, W, g_p
        torch.cuda.empty_cache()
        # (c) at 256, 3 LM iterations of each form, in turns.
        if C == 256:
            turns = {"windowed": [], "chunked": [], "one-shot": []}
            cost = {}
            for name in ("windowed", "chunked", "one-shot", "one-shot",
                         "chunked", "windowed"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                if name == "windowed":
                    r = run_ba(prob, 3, **kw)
                else:
                    with (_one_shot_tables() if name == "one-shot"
                          else contextlib.nullcontext()):
                        r = run_ba(prob, 3)
                c = float(r.cost)
                turns[name].append((1e3 * (time.perf_counter() - t0)
                                    / r.iters,
                                    torch.cuda.max_memory_allocated()
                                    / 2 ** 30))
                cost.setdefault(name, c)
                del r
                torch.cuda.empty_cache()
            rec["lm3"] = {k: dict(ms_per_iter=[t for t, _ in v],
                                  peak_gib=max(p for _, p in v),
                                  cost=cost[k]) for k, v in turns.items()}
            log(f"{tag} (c) {json.dumps(rec['lm3'])}")
            for k in ("chunked", "one-shot"):
                d = abs(cost[k] - cost["windowed"]) / cost["windowed"]
                check_later(d <= 1e-10, f"{tag} (c): {k} cost {cost[k]} "
                            f"{d} from the windowed {cost['windowed']}")
        records[C] = rec
        del sp, prob
        torch.cuda.empty_cache()
    launches = launch_counts()
    check_later(not any(launches.values()),
                f"kernels launched in the BA: {launches}")
    log(f"[ba_scale] phase {time.time() - t_phase:.1f} s")
    return records, launches, failures


def only_launches(tag, name, n, launches, check_later):
    """n launches of `name` and none of any other kernel."""
    others = {k: v for k, v in launches.items() if v and k != name}
    check_later(launches[name] == n and not others,
                f"{tag}: launches {others or launches[name]}, expected "
                f"{n} of {name} and no other")


def record_two_nn(fn):
    """fn() with every 2-NN call's arguments recorded (wrapping
    `ops.matching.two_nn_pairs`, through which DescriptorTable launches
    the kernel): (fn(), calls)."""
    from bundler_sfm_tpu_torch.ops import matching
    real = matching.two_nn_pairs
    calls = []

    def record(*args):
        calls.append(args)
        return real(*args)
    matching.two_nn_pairs = record
    try:
        out = fn()
    finally:
        matching.two_nn_pairs = real
    return out, calls


def compare_recorded(tag, calls, sizes, shape, check_later):
    """The recorded calls' pair counts and table against the path's (one
    table of `shape` = (images, keys) rows, every call on it); then each
    call's kernels bit-exact against the plain version (raises)."""
    tab, counts = calls[0][0], calls[0][2]
    got = [len(c[3]) for c in calls]
    check_later(got == sizes and tab.shape[:2] == shape and all(
        c[0] is tab and c[1] is tab and c[2] is counts for c in calls),
        f"{tag}: 2-NN calls of {got} pairs on {tuple(tab.shape)}, "
        f"expected {sizes} on one table of {shape[0]} x {shape[1]}")
    for c, (_, _, _, pi, pj) in enumerate(calls):
        compare_two_nn(tab, counts, pi, pj, f"{tag} call {c}")


# Cameras the JAX package registers on the CPU (f64) from
# probes/e2e_synthetic.py's default collection (32 images x 2048 keys,
# seed 0): `benchmarks/e2e_synthetic.py 32 2048 --skip_reference` under
# JAX_PLATFORMS=cpu (PERF.md section 5); the port must register as many.
E2E_JAX_CPU_CAMERAS = 32
# bench.main's line: the JAX bench's keys that apply (bench.py:311-355,
# tpu_seconds / tpu_matches renamed), what the port adds, and the rates.
BENCH_KEYS = ("platform", "device", "num_pairs", "keys_per_image",
              "match_seconds", "matches", "kernel_pairs_per_s",
              "kernel_tflops", "kernel_mfu", "cpu_kdtree_pairs_per_s",
              "vs_cpu_kdtree", "ba_obs_iters_per_s",
              "ba_seconds_per_lm_iter", "ba_mfu", "ba64_obs_iters_per_s",
              "ba64_seconds_per_lm_iter", "ba64_mfu",
              "ba_sparse_single_obs_iters_per_s",
              "ba_sparse_single_occupancy", "launches", "matches_runs")
BENCH_RATES = ("kernel_pairs_per_s", "ba_obs_iters_per_s",
               "ba64_obs_iters_per_s", "ba_sparse_single_obs_iters_per_s",
               "cpu_kdtree_pairs_per_s")
BENCH_MFUS = ("kernel_mfu", "ba_mfu", "ba64_mfu")


def phase_bench():
    """Phase 10: the port's two benchmark programs on the card, each with
    the launch counts zeroed just before: (a) `bench.main` at its default
    shape (64 images x 2048 keys, 2016 pairs; BA legs 8 x 2048, 64 x 8192
    and the sparse 64 x 16384): the line's keys, value and rates finite
    and positive, the MFUs in (0, 1], the three timed rotations' match
    counts equal, 24 launches of two_nn (the matcher leg's 4 calls x 2
    batches of <= 1024 pairs, the kernel leg's 16 one-launch calls) and
    none of any other kernel; (b) `probes/e2e_synthetic` at its default
    (32 images x 2048 keys): at least E2E_JAX_CPU_CAMERAS cameras, mean
    reprojection < 1 px, ate_rel < 0.02, one two_nn launch (496 pairs,
    one batch) and none of any other kernel.  Every 2-NN call of both
    counted runs is recorded (the matcher leg's chunks of 1024 and 992
    pairs, the kernel leg's 2016, e2e's 496 on synthesize()'s track and
    clutter keys) and held bit-exact against its plain version on the
    very tensors it was given, after the counts are read.  Returns
    (lines, bench launches, e2e launches, failed checks)."""
    from bundler_sfm_tpu_torch.probes import e2e_synthetic
    failures = []
    check_later = failing_into(failures)
    t_phase = time.time()
    torch.cuda.empty_cache()
    tag = "[bench]"
    zero_launches()
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        res, calls = record_two_nn(lambda: bench.main([]))
    log(f"{tag} {buf.getvalue().strip()}")
    log(f"{tag} {time.time() - t0:.1f} s")
    d = res["detail"]
    check_later(set(res) == {"metric", "value", "unit", "vs_baseline",
                             "detail"} and set(BENCH_KEYS) <= set(d)
                and res["metric"] == "pairs_matched_per_s",
                f"{tag}: keys {sorted(res)}, {sorted(d)}")
    launches = launch_counts()
    check_later(d["launches"] == launches, f"{tag}: the line's launches "
                f"{d['launches']} differ from the counts {launches}")
    check_later(d["num_pairs"] == 2016 and d["device"]["name"]
                == torch.cuda.get_device_name(0), f"{tag}: shape / device")
    rates = [res["value"]] + [d[k] for k in BENCH_RATES]
    check_later(all(math.isfinite(x) and x > 0 for x in rates),
                f"{tag}: rates {rates}")
    mfus = [d[k] for k in BENCH_MFUS]
    check_later(all(x is not None and 0 < x <= 1 for x in mfus),
                f"{tag}: MFUs {mfus} outside (0, 1]")
    check_later(len(set(d["matches_runs"])) == 1 and d["matches"] > 0,
                f"{tag}: match counts {d['matches_runs']}")
    only_launches(tag, "two_nn", 24, launches, check_later)
    bench_launches = launches
    compare_recorded(tag, calls, [1024, 992] * 4 + [2016] * 16, (64, 2048),
                     check_later)

    tag = "[e2e]"
    work = fresh_dir(os.path.join(ROOT, "build", "smoke", "e2e"))
    zero_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line, calls = record_two_nn(
            lambda: e2e_synthetic.main(["--workdir", work]))
    log(f"{tag} {json.dumps(line)}")
    ours = line["ours"]
    check_later(ours["cameras"] >= E2E_JAX_CPU_CAMERAS,
                f"{tag}: {ours['cameras']} cameras < {E2E_JAX_CPU_CAMERAS} "
                f"(JAX, CPU)")
    check_later(ours["mean_reproj_px"] < 1.0 and ours["ate_rel"] < 0.02,
                f"{tag}: reprojection {ours['mean_reproj_px']} px, ate_rel "
                f"{ours['ate_rel']}")
    e2e_launches = launch_counts()
    check_later(ours["launches"] == e2e_launches, f"{tag}: the line's "
                f"launches differ from the counts {e2e_launches}")
    only_launches(tag, "two_nn", 1, e2e_launches, check_later)
    compare_recorded(tag, calls, [496], (32, 2048), check_later)
    log(f"[bench] phase {time.time() - t_phase:.1f} s")
    return dict(bench=res, e2e=line), bench_launches, e2e_launches, failures


# The from-pixels phase's render (utils/render_scene.py's CLI defaults at
# 800x600, the size of the JAX package's benchmarks/e2e_pixels.py runs)
# and its gate: at least PIXELS_MIN_CAMERAS of the views registered.
PIXELS_VIEWS, PIXELS_W, PIXELS_H, PIXELS_FOCAL = 24, 800, 600, 700.0
PIXELS_MIN_CAMERAS = 20
SCALING_BATCHES = (8, 16, 32, 64)


def phase_pixels():
    """Phase 11: the from-pixels program and the scaling program on the
    card, each with the launch counts zeroed just before: (a) render
    PIXELS_VIEWS views at 800x600 (f = 700) under build/smoke/pixels/ and
    run `probes/e2e_pixels` on them at --max_keys 4096 (JPEGs -> SIFT ->
    all 276 pairs on the 2-NN kernel -> verification -> stage 5 ->
    bundle.out): at least PIXELS_MIN_CAMERAS cameras, mean reprojection
    < 1 px, ate_rel < 0.02, one two_nn launch and none of any other
    kernel, the .key files written; (b) `probes/scaling --iters 5`: every
    number of its line finite, 32 two_nn launches (the matcher leg's
    batches of 8-64 pairs, 4 a call, a warm and a timed call each) and
    none of any other kernel.  Every 2-NN call of both runs is recorded
    and held bit-exact against its plain version on the very tensors it
    was given, after the counts are read.  Logs the stage seconds,
    SIFT's peak device memory and the launches ("[pixels]",
    "[scaling]").  Returns (lines, pixels launches, scaling launches,
    failed checks)."""
    from bundler_sfm_tpu_torch.probes import e2e_pixels, scaling
    from bundler_sfm_tpu_torch.utils.render_scene import render_box_room
    failures = []
    check_later = failing_into(failures)
    t_phase = time.time()
    torch.cuda.empty_cache()
    tag = "[pixels]"
    work = fresh_dir(os.path.join(ROOT, "build", "smoke", "pixels"))
    imgs = os.path.join(work, "images")
    t0 = time.time()
    render_box_room(imgs, n=PIXELS_VIEWS, W=PIXELS_W, H=PIXELS_H, seed=0,
                    f=PIXELS_FOCAL)
    log(f"{tag} rendered {PIXELS_VIEWS} views {PIXELS_W}x{PIXELS_H} in "
        f"{time.time() - t0:.1f} s")
    run = os.path.join(work, "run")
    zero_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line, calls = record_two_nn(lambda: e2e_pixels.main(
            [imgs, "--max_keys", "4096", "--workdir", run]))
    log(f"{tag} {json.dumps(line)}")
    ours = line["ours"]
    stages = {k: round(v, 4) for k, v in ours["stages_s"].items()}
    log(f"{tag} sift {ours['sift_s']:.3f} s ({ours['keys']} keys, "
        f"{ours['keys_per_s']:.0f} keys/s, peak "
        f"{ours['sift_peak_bytes'] / 2**30:.2f} GiB), match "
        f"{ours['match_s']:.3f} s, bundle {ours['bundle_s']:.3f} s, total "
        f"{ours['total_s']:.3f} s; stages {json.dumps(stages)}; LM "
        f"iterations {ours['counters'].get('lm_iters', 0)}, host syncs "
        f"{ours['counters'].get('host_syncs', 0)}, windowed BAs "
        f"{ours['counters'].get('ba_schur_windowed', 0)}")
    check_later(ours["cameras"] >= PIXELS_MIN_CAMERAS,
                f"{tag}: {ours['cameras']} cameras < {PIXELS_MIN_CAMERAS} of "
                f"{PIXELS_VIEWS}")
    check_later(ours["mean_reproj_px"] < 1.0 and ours["ate_rel"] < 0.02,
                f"{tag}: reprojection {ours['mean_reproj_px']} px, ate_rel "
                f"{ours['ate_rel']}")
    check_later(ours["keys"] > 0 and ours["sift_peak_bytes"] > 0,
                f"{tag}: keys {ours['keys']}, SIFT peak "
                f"{ours['sift_peak_bytes']}")
    keys = sorted(f for f in os.listdir(run) if f.endswith(".key"))
    check_later(len(keys) == PIXELS_VIEWS, f"{tag}: {len(keys)} .key files")
    pixels_launches = launch_counts()
    check_later(ours["launches"] == pixels_launches, f"{tag}: the line's "
                f"launches differ from the counts {pixels_launches}")
    only_launches(tag, "two_nn", 1, pixels_launches, check_later)
    pairs = PIXELS_VIEWS * (PIXELS_VIEWS - 1) // 2
    compare_recorded(tag, calls, [pairs],
                     (PIXELS_VIEWS, calls[0][0].shape[1]), check_later)

    tag = "[scaling]"
    zero_launches()
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        res, calls = record_two_nn(lambda: scaling.main(["--iters", "5"]))
    log(f"{tag} {json.dumps(res)}")
    log(f"{tag} {time.time() - t0:.1f} s")
    numbers = [res["value"]] + [v for k in (
        "ba_measured_ms_per_iter_per_shard", "ba_projected_ms_per_iter",
        "ba_projected_efficiency", "matching_pairs_per_s_vs_batch")
        for v in res[k].values()]
    check_later(all(math.isfinite(x) and x > 0 for x in numbers)
                and res["platform"] == "cuda", f"{tag}: numbers {numbers}")
    scaling_launches = launch_counts()
    only_launches(tag, "two_nn", 8 * len(SCALING_BATCHES), scaling_launches,
                  check_later)
    compare_recorded(tag, calls, [b for b in SCALING_BATCHES
                                  for _ in range(8)], (32, 1024), check_later)
    log(f"[pixels] phase {time.time() - t_phase:.1f} s")
    return (dict(pixels=line, scaling=res), pixels_launches,
            scaling_launches, failures)


PHASES = ("build", "kernels", "main", "staged", "tools", "variants", "library",
          "multi_device", "ba_scale", "bench", "pixels")


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="smoke test of the port on one "
                                "NVIDIA GPU")
    p.add_argument("--dump-scene", default=None,
                   help="also write the main path's verified scene here")
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated phases to run, in their order "
                        "(default all); a run of fewer than all checks what "
                        "they check and prints no result line")
    args = p.parse_args(argv)
    phases = args.phases.split(",")
    check(set(phases) <= set(PHASES), f"unknown phases in {phases}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if set(phases) != set(PHASES):
        # Where each phase returns its failed checks (variants raises).
        failed_at = {"main": 1, "staged": 1, "tools": 1, "library": 2,
                     "multi_device": 1, "ba_scale": 2, "bench": 3,
                     "pixels": 3}
        for name in PHASES:
            if name in phases:
                res = (phase_main(args.dump_scene) if name == "main"
                       else globals()[f"phase_{name}"]())
                if name in failed_at:
                    check(not res[failed_at[name]],
                          f"{name} checks failed: {res[failed_at[name]]}")
        smi = device_record(torch.device("cuda"))["nvidia_smi"]
        log(f"[partial] phases {phases} passed on {smi}")
        return 0
    phase_build()
    t32 = phase_kernels()
    kernels, failures, main_launches = phase_main(args.dump_scene)
    staged_launches, staged_failures = phase_staged()
    tools_launches, tools_failures = phase_tools()
    variant_records, probe_launches = phase_variants()
    lib_launches, lib_times, lib_failures = phase_library()
    md_launches, md_failures = phase_multi_device()
    _, ba_launches, ba_failures = phase_ba_scale()
    _, bench_launches, e2e_launches, bench_failures = phase_bench()
    _, pixels_launches, scaling_launches, pixels_failures = phase_pixels()
    check(not failures, f"stage-5 checks failed: {failures}")
    check(not staged_failures, f"staged checks failed: {staged_failures}")
    check(not tools_failures, f"tools checks failed: {tools_failures}")
    check(not lib_failures, f"library checks failed: {lib_failures}")
    check(not md_failures, f"multi-device checks failed: {md_failures}")
    check(not ba_failures, f"ba_scale checks failed: {ba_failures}")
    check(not bench_failures, f"bench checks failed: {bench_failures}")
    check(not pixels_failures, f"pixels checks failed: {pixels_failures}")
    kernels[0]["staged_launches"] = staged_launches["two_nn"]
    kernels[1]["staged_launches"] = staged_launches["two_nn_norms"]
    kernels[0]["tools_launches"] = tools_launches["two_nn"]
    kernels[1]["tools_launches"] = tools_launches["two_nn_norms"]
    kernels[0]["library_path_launches"] = lib_launches["two_nn"]
    kernels[1]["library_path_launches"] = lib_launches.get("two_nn_norms", 0)
    kernels[0]["library_path_ms"] = lib_times["uint8"]["kernel_ms"]
    kernels[0]["multi_device_launches"] = md_launches.get("two_nn", 0)
    kernels[1]["multi_device_launches"] = md_launches.get("two_nn_norms", 0)
    kernels.append(
        {"name": "two_nn_f32", "route": "cuda", "source": TWO_NN_SOURCE,
         "replaces": TWO_NN_REPLACES, "launches": main_launches["two_nn_f32"],
         "max_abs_err": t32["max_abs_err"], "ms": t32["ms"],
         "plain_ms": t32["plain_ms"], "bound_ms": t32["bound_ms"],
         "bound_by": t32["bound_by"], "library_ms": t32["library_ms"],
         "ms_before": t32["ms_before"], "product_ms": t32["product_ms"],
         "tolerance_ratio": t32["tolerance_ratio"],
         "staged_launches": staged_launches["two_nn_f32"],
         "probe_launches": probe_launches["two_nn_f32"],
         "library_path_launches": lib_launches["two_nn_f32"],
         "library_path_ms": lib_times["float32"]["kernel_ms"],
         "multi_device_launches": md_launches.get("two_nn_f32", 0)})
    kernels.append(
        {"name": "two_nn_f32_prepass", "route": "cuda",
         "source": TWO_NN_SOURCE, "replaces": TWO_NN_REPLACES,
         "launches": main_launches["two_nn_f32_prepass"], "max_abs_err": 0.0,
         "ms": t32["prepass_ms"], "plain_ms": t32["prepass_plain_ms"],
         "bound_ms": t32["prepass_bound"][0],
         "bound_by": t32["prepass_bound"][1], "library_ms": None,
         "staged_launches": staged_launches["two_nn_f32_prepass"],
         "probe_launches": probe_launches["two_nn_f32_prepass"],
         "library_path_launches": lib_launches["two_nn_f32_prepass"],
         "multi_device_launches": md_launches.get("two_nn_f32_prepass", 0)})
    kernels += variant_records
    for k in kernels:
        k["ba_scale_launches"] = ba_launches.get(k["name"], 0)
        k["bench_launches"] = bench_launches.get(k["name"], 0)
        k["e2e_launches"] = e2e_launches.get(k["name"], 0)
        k["pixels_launches"] = pixels_launches.get(k["name"], 0)
        k["scaling_launches"] = scaling_launches.get(k["name"], 0)
    print(device_record(torch.device("cuda"))["nvidia_smi"][0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
