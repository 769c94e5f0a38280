"""JPEGs to `bundle.out` at scale: our side of the JAX package's
`benchmarks/e2e_pixels.py`, on the port.

A rendered collection (`python -m bundler_sfm_tpu_torch.utils.render_scene
DIR N 800 600`: img%04d.jpg and gt.json) goes through SIFT, all-pairs
`DescriptorTable` matching on the 2-NN kernel, geometric verification and
the incremental reconstruction, every stage on one device in f64, and
`bundle.out` is scored against the ground truth: registered cameras,
points, mean reprojection error, and the camera-centre ATE after a
similarity alignment.  Each stage's timer stops after the device has
finished: SIFT and matching return host arrays, and the reconstruction
synchronizes the device before its timer stops.

    python -m bundler_sfm_tpu_torch.probes.e2e_pixels SCENE_DIR
        [--max_keys 4096] [--device cuda|cpu] [--workdir DIR] [--out PATH]

prints one JSON line: images, workdir (null without --workdir: the run
then works in a temporary directory that it removes at its end),
max_keys, and `ours` with the device, sift / match / bundle / total
seconds, keys and keys_per_s, SIFT's peak device memory in bytes
(`sift_peak_bytes`, null on the CPU), the telemetry's stage seconds and
counters of the reconstruction (LM iterations, host syncs,
`ba_schur_windowed`: bundle adjustments run on a covisibility-window
plan, from 129 cameras), each kernel's launches, and cameras, points,
mean_reproj_px and ate_rel.  The .key files of every image are written
into the work directory outside the timed path, as the JAX script writes
them for the reference side.

Left out against the JAX script: the reference side (`stage_reference`,
`run_reference`, `--ref`, `--skip_reference`, `--skip_ours`, the copies
of the images into the work directory that the reference's list.txt
names, and the speed-up), which drives the C++ reference binaries that
`benchmarks/build_reference.sh` builds from a reference checkout; this
program has none to run.  The JAX script's f32 BA override for a TPU is
gone too: the port's BA runs in f64.  The JAX script's scenes are
`benchmarks/render_scene.py`'s, textured with reference photographs;
this program reads any directory of that layout, such as the port's
procedural renders.
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
import torch

from bundler_sfm_tpu_torch.config import default_pipeline_config
from bundler_sfm_tpu_torch.features.sift import (
    extract_sift_batch, load_grayscale,
)
from bundler_sfm_tpu_torch.io.keyfile import keys_to_centered, write_key_file
from bundler_sfm_tpu_torch.io.listfile import ImageEntry
from bundler_sfm_tpu_torch.ops.matching import DescriptorTable, launch_counts
from bundler_sfm_tpu_torch.pipeline.incremental import bundle_adjust_fast
from bundler_sfm_tpu_torch.pipeline.scene import Scene
from bundler_sfm_tpu_torch.pipeline.verify import (
    compute_geometric_constraints,
)
from bundler_sfm_tpu_torch.probes.e2e_synthetic import model_quality
from bundler_sfm_tpu_torch.utils.device import (
    device_record, resolve_device, synchronize,
)
from bundler_sfm_tpu_torch.utils.telemetry import get_telemetry

CONTRAST_THR = 0.02


def run_ours(scene_dir, images, gt, max_keys, workdir,
             device="cuda") -> Dict:
    """JPEGs -> SIFT -> matches -> verification -> incremental SfM ->
    bundle.out under `workdir`/ours, on `device`.  Returns the stage
    seconds, key counts, SIFT's peak device memory, the telemetry's stage
    seconds and counters of this run and the bundle.out path; the
    telemetry is also dumped to `workdir`/ours_telemetry.json."""
    dev = resolve_device(device)
    W, H, focal = gt["W"], gt["H"], gt["focal"]
    n = len(images)
    tel = get_telemetry()
    tel.reset()
    synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    grays = [load_grayscale(os.path.join(scene_dir, name))
             for name in images]
    results = extract_sift_batch(grays, max_keys_total=max_keys,
                                 contrast_thr=CONTRAST_THR, device=dev)
    infos = [r[0] for r in results]
    descs = [r[1] for r in results]
    t_sift = time.perf_counter() - t0
    sift_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else None
    total_keys = int(sum(len(i) for i in infos))

    # The .key files the reference side would read (outside the timing).
    for name, info, desc in zip(images, infos, descs):
        write_key_file(os.path.join(workdir, name.rsplit(".", 1)[0] + ".key"),
                       info, desc)

    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    t0 = time.perf_counter()
    table = DescriptorTable(descs, device=dev)
    matches = table.match_pairs(pairs, min_matches=16)
    t_match = time.perf_counter() - t0

    entries = [ImageEntry(name, init_focal=focal) for name in images]
    key_xy = [keys_to_centered(info, W, H)[:, :2].astype(np.float64)
              for info in infos]
    scene = Scene(config=default_pipeline_config(), entries=entries,
                  dims=[(W, H)] * n, key_xy=key_xy, matches=matches,
                  device=str(dev))
    out = os.path.join(workdir, "ours")
    t0 = time.perf_counter()
    compute_geometric_constraints(scene, seed=0)
    bundle_adjust_fast(scene, out_dir=out, seed=0)
    synchronize(dev)
    t_bundle = time.perf_counter() - t0
    tel.dump(os.path.join(workdir, "ours_telemetry.json"))
    return {"sift_s": t_sift, "keys": total_keys,
            "keys_per_s": total_keys / max(t_sift, 1e-9),
            "match_s": t_match, "bundle_s": t_bundle,
            "total_s": t_sift + t_match + t_bundle,
            "sift_peak_bytes": sift_peak,
            "stages_s": dict(tel.stage_seconds),
            "counters": dict(tel.counters),
            "bundle_out": os.path.join(out, "bundle.out")}


def main(argv: Sequence[str] = None) -> Dict:
    ap = argparse.ArgumentParser(
        prog="e2e_pixels", description="Rendered JPEGs to bundle.out on the "
        "port, scored against ground truth (one JSON line).")
    ap.add_argument("scene_dir", help="img*.jpg and gt.json, as "
                    "utils/render_scene.py writes them")
    ap.add_argument("--max_keys", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every stage (default cuda)")
    ap.add_argument("--workdir", default=None,
                    help="keep the .key files, ours/bundle.out and "
                         "ours_telemetry.json here (default a temporary "
                         "directory, removed when the run ends)")
    ap.add_argument("--out", default=None,
                    help="also write the result JSON to this path")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    dev = resolve_device(args.device)

    with open(os.path.join(args.scene_dir, "gt.json")) as f:
        gt = json.load(f)
    gt["centers"] = np.array(gt["centers"])
    images = sorted(f for f in os.listdir(args.scene_dir)
                    if f.endswith(".jpg"))
    with contextlib.ExitStack() as stack:
        if args.workdir:
            workdir = args.workdir
            os.makedirs(workdir, exist_ok=True)
        else:
            workdir = stack.enter_context(tempfile.TemporaryDirectory(
                prefix=f"e2e_px{len(images)}_"))
        before = launch_counts()
        run = run_ours(args.scene_dir, images, gt, args.max_keys, workdir,
                       device=dev)
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        quality = model_quality(run.pop("bundle_out"), gt)
    result = {"images": len(images), "workdir": args.workdir,
              "max_keys": args.max_keys,
              "ours": {"device": device_record(dev), **run,
                       "launches": launches, **quality}}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
