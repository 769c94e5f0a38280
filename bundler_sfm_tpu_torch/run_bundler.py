"""RunBundler front end on PyTorch — port of `bundler_sfm_tpu/run_bundler.py`.

The reference's `RunBundler.sh:56-143` glues extract_focal.pl → ToSift →
KeyMatchFull → bundler via shell and temp files; here the stages run
in-process on the device:

    python -m bundler_sfm_tpu_torch.run_bundler <image_dir>
        [--init_focal F | --no_exif] [--window N] [--max_keys N]
        [--out DIR] [--seed S] [--device cuda|cpu] [--num_devices D]
        [--telemetry PATH]
    torchrun --nproc_per_node D -m bundler_sfm_tpu_torch.run_bundler <dir>

Stages:
  1. list.txt — EXIF focal extraction (bin/extract_focal.pl port)
  2. SIFT    — DoG-SIFT, batched per image shape
  3. match   — all-pairs exact 2-NN on the hand-written kernel
  4. verify  — F / H RANSAC, symmetric matches, tracks
  5. bundle  — incremental reconstruction (`bundle_adjust_fast`: initial
               pair, batched resection, Schur-LM bundle adjustment with the
               outlier loop), f64 on the device
Artifacts (list.txt, .key.gz, matches.init.txt, pairwise_scores.txt) are
written in the reference's formats into the working directory; the
reconstruction (bundle.out, bundle_NNN.out and pointsNNN.ply per round)
into --out (default `bundle`).

With --num_devices D > 1 (0: every visible card) one process runs per
device: `main` starts D ranks (`parallel.mesh.launch`, rank r on cuda:r),
or, inside a process group that already exists (torchrun, or
--multihost_coordinator), runs as this process's rank of it.  Every rank
runs the same pipeline: matching on the image-sharded ring
(`ShardedDescriptorTable`), bundle adjustment point-sharded; only rank 0
writes files.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List

import numpy as np

from bundler_sfm_tpu_torch.parallel.mesh import run_entry


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="run_bundler", description=__doc__)
    p.add_argument("image_dir")
    p.add_argument("--init_focal", type=float, default=0.0,
                   help="fixed initial focal (px); overrides EXIF")
    p.add_argument("--no_exif", action="store_true")
    p.add_argument("--window", type=int, default=-1,
                   help="match window radius (RunBundler.sh MATCH_WINDOW_RADIUS)")
    p.add_argument("--max_keys", type=int, default=4096)
    p.add_argument("--contrast_thr", type=float, default=0.02,
                   help="SIFT DoG contrast threshold (Lowe's binary: 0.04)")
    p.add_argument("--write_keys", action="store_true",
                   help="also write .key.gz files")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="bundle",
                   help="output directory of the reconstruction")
    p.add_argument("--device", default="cuda",
                   help="torch device of every stage (a bare 'cuda' is "
                        "each rank's own card)")
    p.add_argument("--num_devices", type=int, default=1,
                   help="ranks (one process and one device each) for "
                        "sharded matching and BA (0 = every visible card)")
    p.add_argument("--multihost_coordinator", default=None,
                   help="host:port of rank 0 — start ONE run_bundler per "
                        "GPU, on every host, with identical arguments plus "
                        "--process_id; the ranks form one process group")
    p.add_argument("--num_processes", type=int, default=None,
                   help="with --multihost_coordinator: the number of GPUs "
                        "over all hosts (one process each)")
    p.add_argument("--process_id", type=int, default=None,
                   help="with --multihost_coordinator: this process's rank")
    p.add_argument("--telemetry", metavar="PATH", default=None,
                   help="log every span and write the log, the stage "
                        "seconds and the counters to PATH (JSON; rank 0)")
    return p


def main(argv=None) -> int:
    return run_entry(argv if argv is not None else sys.argv[1:], _parse,
                     _run)


def _parse(argv) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def _run(args, mesh) -> int:
    """The pipeline on this rank: one device when `mesh` is None; rank 0
    writes the span log to --telemetry."""
    from bundler_sfm_tpu_torch.utils import span_log
    writer = mesh is None or mesh.rank == 0
    with span_log(args.telemetry if writer else None):
        return _pipeline(args, mesh)


def _pipeline(args, mesh) -> int:
    from PIL import Image

    from bundler_sfm_tpu_torch.config import default_pipeline_config
    from bundler_sfm_tpu_torch.features.sift import (
        extract_sift_batch, load_grayscale,
    )
    from bundler_sfm_tpu_torch.io.exif import extract_focal_pixels
    from bundler_sfm_tpu_torch.io.keyfile import keys_to_centered, write_key_file
    from bundler_sfm_tpu_torch.io.listfile import ImageEntry, write_list_file
    from bundler_sfm_tpu_torch.io.matchfile import write_match_file
    from bundler_sfm_tpu_torch.ops.matching import DescriptorTable
    from bundler_sfm_tpu_torch.pipeline.incremental import bundle_adjust_fast
    from bundler_sfm_tpu_torch.pipeline.scene import Scene
    from bundler_sfm_tpu_torch.pipeline.verify import (
        compute_geometric_constraints,
    )
    from bundler_sfm_tpu_torch.parallel.matching_sharded import (
        ShardedDescriptorTable,
    )
    from bundler_sfm_tpu_torch.utils import resolve_device, stage

    device = str(mesh.device if mesh is not None else
                 resolve_device(args.device))
    # SPMD: every rank runs the same pipeline (the collectives must line
    # up); only rank 0 writes.
    sharded = mesh is not None and mesh.size > 1
    writer = mesh is None or mesh.rank == 0
    images = sorted(
        f for f in os.listdir(args.image_dir)
        if f.lower().endswith((".jpg", ".jpeg")))
    if not images:
        print(f"[RunBundler] no jpegs in {args.image_dir}")
        return 1
    print(f"[RunBundler] {len(images)} images on {device}"
          + (f", rank {mesh.rank} of {mesh.size}" if sharded else ""))

    # 1. Focal estimates -> list.txt
    entries: List[ImageEntry] = []
    with stage("focal"):
        for name in images:
            path = os.path.join(args.image_dir, name)
            if args.init_focal > 0:
                focal = args.init_focal
            elif not args.no_exif:
                focal = extract_focal_pixels(path)
            else:
                focal = 0.0
            entries.append(ImageEntry(path, init_focal=focal))
        if writer:
            write_list_file("list.txt", entries)

    # 2. SIFT (batched: same-shape images run each octave as one batch)
    t0 = time.time()
    with stage("sift"):
        grays = [load_grayscale(e.name) for e in entries]
        dims = [(g.shape[1], g.shape[0]) for g in grays]
        results = extract_sift_batch(grays, max_keys_total=args.max_keys,
                                     contrast_thr=args.contrast_thr,
                                     device=device)
    infos = [r[0] for r in results]
    descs = [r[1] for r in results]
    for e, info, desc in zip(entries, infos, descs):
        print(f"[RunBundler] {os.path.basename(e.name)}: {len(info)} keys")
        if args.write_keys and writer:
            base = os.path.splitext(os.path.basename(e.name))[0]
            write_key_file(base + ".key.gz", info, desc)
    print(f"[RunBundler] SIFT took {time.time()-t0:.1f}s")

    # 3. Matching
    n = len(images)
    pairs = []
    for i in range(n):
        start = max(i - args.window, 0) if args.window > 0 else 0
        for j in range(start, i):
            pairs.append((j, i))
    t0 = time.time()
    with stage("match"):
        # Several ranks: the image-sharded ring, each rank holding 1/D of
        # the descriptor table.
        table = ShardedDescriptorTable(descs, mesh) if sharded else \
            DescriptorTable(descs, device=device)
        matches = table.match_pairs(pairs, min_matches=16)
    print(f"[RunBundler] matched {len(matches)}/{len(pairs)} pairs in "
          f"{time.time()-t0:.1f}s")
    if writer:
        with stage("write_matches"):
            write_match_file("matches.init.txt", matches)

    # 4. Geometric verification + tracks (f64 on every device).
    cfg = default_pipeline_config(num_devices=mesh.size if sharded else 1)
    with stage("key_colors"):
        key_xy = [keys_to_centered(info, w, h)[:, :2].astype(np.float64)
                  for info, (w, h) in zip(infos, dims)]
        key_color = []
        for e, info in zip(entries, infos):
            with Image.open(e.name) as img:
                arr = np.asarray(img.convert("RGB"))
            h, w = arr.shape[:2]
            xs = np.clip(info[:, 0].astype(int), 0, w - 1)
            ys = np.clip(info[:, 1].astype(int), 0, h - 1)
            key_color.append(arr[ys, xs])
        scene = Scene(config=cfg, entries=entries, dims=dims, key_xy=key_xy,
                      key_color=key_color, matches=matches, device=device)
    t0 = time.time()
    compute_geometric_constraints(
        scene, seed=args.seed,
        scores_path="pairwise_scores.txt" if writer else None)
    print(f"[RunBundler] {len(scene.tracks)} tracks "
          f"({time.time()-t0:.1f}s)")

    # 5. Reconstruction (f64 on every device).
    bundle_adjust_fast(scene, out_dir=args.out if writer else None,
                       seed=args.seed)
    if writer:
        print(f"[RunBundler] output in {args.out}/bundle.out")
    return 0


if __name__ == "__main__":
    sys.exit(main())
