"""Keys to `bundle.out` at scale on synthetic data: our side of the JAX
package's `benchmarks/e2e_synthetic.py`, on the port.

A geometrically consistent synthetic collection (cameras on an arc, 3D
points, per-track descriptors with per-view jitter, clutter keys) goes
through `DescriptorTable` matching on the 2-NN kernel, geometric
verification and the incremental reconstruction, every stage on one
device in f64, and `bundle.out` is scored against the ground truth:
registered cameras, mean reprojection error, and the camera-centre ATE
after a similarity alignment.

    python -m bundler_sfm_tpu_torch.probes.e2e_synthetic [num_images]
        [keys_per_image] [--track_ratio 0.6] [--seed 0]
        [--device cuda|cpu] [--workdir DIR] [--out PATH]

prints one JSON line: images, keys_per_image, seed, workdir (null
without --workdir: the run then works in a temporary directory that it
removes at its end), and `ours` with the device,
match / bundle / total seconds, the telemetry's stage seconds and
counters (LM iterations, host syncs, `ba_schur_windowed`: the bundle
adjustments run on a covisibility-window plan, from 129 cameras), each
kernel's launches, cameras, points, mean_reproj_px and ate_rel.

Left out against the JAX script: the reference side
(`write_reference_inputs`, `run_reference`, `--ref`, `--skip_reference`,
`--skip_ours` and the speed-ups), which drives the C++ reference binaries
that `benchmarks/build_reference.sh` builds from a reference checkout;
this program has none to run.  The JAX script's f32 BA override for a
TPU is gone too: the port's BA runs in f64.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from typing import Dict, Sequence

import numpy as np

from bundler_sfm_tpu_torch.config import default_pipeline_config
from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
from bundler_sfm_tpu_torch.io.keyfile import keys_to_centered
from bundler_sfm_tpu_torch.io.listfile import ImageEntry
from bundler_sfm_tpu_torch.ops.matching import DescriptorTable, launch_counts
from bundler_sfm_tpu_torch.pipeline.incremental import bundle_adjust_fast
from bundler_sfm_tpu_torch.pipeline.scene import Scene
from bundler_sfm_tpu_torch.pipeline.verify import (
    compute_geometric_constraints,
)
from bundler_sfm_tpu_torch.utils.device import device_record, resolve_device
from bundler_sfm_tpu_torch.utils.telemetry import get_telemetry

W_IMG, H_IMG = 1024, 768
FOCAL = 900.0
PIX_NOISE = 0.4


def look_at(c, target):
    z = c - target
    z = z / np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def synthesize(num_images, keys_per_image, track_ratio, seed=0):
    """Returns (infos, descs, gt) where infos are RAW image coords [n,4].
    A copy of the JAX script's generator (same draws)."""
    rng = np.random.default_rng(seed)
    centers = np.array([[np.sin(a) * 10, 1.5 * np.sin(2 * a),
                         np.cos(a) * 10]
                        for a in np.linspace(0, 1.6, num_images)])
    Rs = np.stack([look_at(c, np.zeros(3)) for c in centers])

    # World points: a FIXED pool relative to per-image key budget (NOT
    # scaled with num_images) so that two overlapping views have a high
    # chance of sampling the same points — otherwise shared tracks dilute
    # quadratically with N and the collection stops being reconstructable.
    num_pts = int(keys_per_image * track_ratio * 5)
    pts = rng.uniform(-3, 3, (num_pts, 3))
    base_desc = rng.integers(0, 256, (num_pts, 128)).astype(np.int32)

    infos, descs = [], []
    half_w, half_h = (W_IMG - 1) / 2, (H_IMG - 1) / 2
    for i in range(num_images):
        p = np.einsum("ij,nj->ni", Rs[i], pts - centers[i])
        uv = -FOCAL * p[:, :2] / p[:, 2:3]
        vis = ((p[:, 2] < -1.0) & (np.abs(uv[:, 0]) < half_w - 8)
               & (np.abs(uv[:, 1]) < half_h - 8))
        idx = np.nonzero(vis)[0]
        n_track = min(len(idx), int(keys_per_image * track_ratio))
        idx = rng.choice(idx, n_track, replace=False)
        xy = uv[idx] + rng.normal(0, PIX_NOISE, (n_track, 2))
        # Centered, y-up -> raw image row/col.
        col = xy[:, 0] + half_w
        row = (H_IMG - 1) - (xy[:, 1] + half_h)
        d = np.clip(base_desc[idx] + rng.integers(-6, 7, (n_track, 128)),
                    0, 255).astype(np.uint8)
        n_clutter = keys_per_image - n_track
        ccol = rng.uniform(0, W_IMG - 1, n_clutter)
        crow = rng.uniform(0, H_IMG - 1, n_clutter)
        cd = rng.integers(0, 256, (n_clutter, 128)).astype(np.uint8)
        info = np.zeros((keys_per_image, 4), np.float32)
        info[:n_track, 0] = col
        info[:n_track, 1] = row
        info[n_track:, 0] = ccol
        info[n_track:, 1] = crow
        info[:, 2] = 2.0
        perm = rng.permutation(keys_per_image)
        infos.append(info[perm])
        descs.append(np.concatenate([d, cd])[perm])
    return infos, descs, {"centers": centers, "Rs": Rs}


def similarity_ate(est_centers, gt_centers):
    """RMS centre error after the best similarity, over the RMS spread of
    the ground truth."""
    A, B = np.asarray(est_centers), np.asarray(gt_centers)
    muA, muB = A.mean(0), B.mean(0)
    A0, B0 = A - muA, B - muB
    U, S, Vt = np.linalg.svd(B0.T @ A0)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = (S * np.diag(D)).sum() / (A0 ** 2).sum()
    res = B0 - s * A0 @ R.T
    scene = np.sqrt((B0 ** 2).sum(1).mean())
    return float(np.sqrt((res ** 2).sum(1).mean()) / max(scene, 1e-12))


def model_quality(bundle_path, gt):
    """Registered cameras, points, mean reprojection error (px) and
    ate_rel of a bundle.out against the generator's ground truth."""
    b = read_bundle_file(bundle_path)
    reg = [(i, c) for i, c in enumerate(b.cameras) if c.registered]
    errs = []
    for p in b.points:
        for (ci, _k, x, y) in np.atleast_2d(p.views):
            c = b.cameras[int(ci)]
            pc = c.R @ (p.pos - c.center)
            uv = -pc[:2] / pc[2]
            r2 = uv @ uv
            pred = c.f * (1 + c.k1 * r2 + c.k2 * r2 * r2) * uv
            errs.append(np.hypot(pred[0] - x, pred[1] - y))
    ate = similarity_ate([c.center for _, c in reg],
                         [gt["centers"][i] for i, _ in reg]) if len(reg) >= 3 \
        else None
    return {"cameras": len(reg), "points": len(b.points),
            "mean_reproj_px": round(float(np.mean(errs)), 4) if errs else None,
            "ate_rel": round(ate, 5) if ate is not None else None}


def run_ours(workdir, infos, descs, device="cuda") -> Dict:
    """Keys -> matches -> verification -> incremental SfM -> bundle.out
    under `workdir`/ours, on `device`.  Returns match / bundle seconds,
    the telemetry's stage seconds and counters of this run and the
    bundle.out path; the telemetry is also dumped to
    `workdir`/ours_telemetry.json."""
    dev = resolve_device(device)
    n = len(infos)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    tel = get_telemetry()
    tel.reset()
    t0 = time.perf_counter()
    table = DescriptorTable(descs, device=dev)
    matches = table.match_pairs(pairs, min_matches=16)
    t_match = time.perf_counter() - t0

    entries = [ImageEntry(f"img{i:04d}.jpg", init_focal=FOCAL)
               for i in range(n)]
    key_xy = [keys_to_centered(info, W_IMG, H_IMG)[:, :2].astype(np.float64)
              for info in infos]
    scene = Scene(config=default_pipeline_config(), entries=entries,
                  dims=[(W_IMG, H_IMG)] * n, key_xy=key_xy, matches=matches,
                  device=str(dev))
    out = os.path.join(workdir, "ours")
    t0 = time.perf_counter()
    compute_geometric_constraints(scene, seed=0)
    bundle_adjust_fast(scene, out_dir=out, seed=0)
    t_bundle = time.perf_counter() - t0
    tel.dump(os.path.join(workdir, "ours_telemetry.json"))
    return {"match_s": t_match, "bundle_s": t_bundle,
            "stages_s": dict(tel.stage_seconds),
            "counters": dict(tel.counters),
            "bundle_out": os.path.join(out, "bundle.out")}


def main(argv: Sequence[str] = None) -> Dict:
    ap = argparse.ArgumentParser(
        prog="e2e_synthetic", description="Synthetic keys to bundle.out on "
        "the port, scored against ground truth (one JSON line).")
    ap.add_argument("num_images", nargs="?", type=int, default=32)
    ap.add_argument("keys_per_image", nargs="?", type=int, default=2048)
    ap.add_argument("--track_ratio", type=float, default=0.6)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic collection")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every stage (default cuda)")
    ap.add_argument("--workdir", default=None,
                    help="keep ours/bundle.out and ours_telemetry.json "
                         "here (default a temporary directory, removed "
                         "when the run ends)")
    ap.add_argument("--out", default=None,
                    help="also write the result JSON to this path")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    dev = resolve_device(args.device)

    infos, descs, gt = synthesize(args.num_images, args.keys_per_image,
                                  args.track_ratio, seed=args.seed)
    with contextlib.ExitStack() as stack:
        if args.workdir:
            workdir = args.workdir
            os.makedirs(workdir, exist_ok=True)
        else:
            workdir = stack.enter_context(tempfile.TemporaryDirectory(
                prefix=f"e2e_syn{args.num_images}_"))
        before = launch_counts()
        run = run_ours(workdir, infos, descs, device=dev)
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        quality = model_quality(run["bundle_out"], gt)
    result = {"images": args.num_images,
              "keys_per_image": args.keys_per_image, "seed": args.seed,
              "workdir": args.workdir,
              "ours": {"device": device_record(dev),
                       "match_s": run["match_s"], "bundle_s": run["bundle_s"],
                       "total_s": run["match_s"] + run["bundle_s"],
                       "stages_s": run["stages_s"],
                       "counters": run["counters"], "launches": launches,
                       **quality}}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
