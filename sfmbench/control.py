"""Readings that set the limits of `correct`: the program's numbers on a
dozen seeds or more and each control's on three or more, at the cell's
own size, in one process on the card.  The benchmark's runs do not run
this.

    python3 -m sfmbench.control --workload <cell> --seeds 1,2,...
        --control_seeds 7,8,9 [--orders] [--out <file.jsonl>]

For each seed: the cell's inputs, one job of the program, its checks; for
each control seed: the same inputs and every control of the job kind
(its functions named `control*`) judged alike.  `--orders` (job kind
`full`) renames each seed's views into an order drawn from that seed,
to read how sound runs on other inputs than the cell's fixed one go.
Prints one JSON line a reading.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time

from sfmbench import env


def reorder_views(inputs, seed) -> None:
    """Rename a `full` job's views `img%04d.jpg` into an order drawn from
    `seed`, and its ground-truth centres with them."""
    import numpy as np
    n, d = inputs["views"], inputs["image_dir"]
    perm = np.random.default_rng(seed).permutation(n)
    for i in range(n):
        os.rename(os.path.join(d, f"img{i:04d}.jpg"),
                  os.path.join(d, f"new{perm[i]:04d}.jpg"))
    for i in range(n):
        os.rename(os.path.join(d, f"new{i:04d}.jpg"),
                  os.path.join(d, f"img{i:04d}.jpg"))
    centers = np.empty_like(inputs["gt_centers"])
    centers[perm] = inputs["gt_centers"]
    inputs["gt_centers"] = centers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sfmbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--orders", action="store_true",
                    help="order each seed's views by the seed (job kind "
                         "full)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from sfmbench import harness
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    with open("BENCHMARK.json") as f:
        spec = harness.cell_spec(json.load(f), args.workload)
    root = harness.PKG
    config = harness.load_json(root, "configs", spec["config"])
    traffic = harness.load_json(root, "traffic", spec["traffic"])
    limits = harness.load_json(root, "cells", args.workload)["limits"]
    job = harness.load_module(root, "jobs", traffic["job"])
    controls = sorted(k for k in dir(job) if k.startswith("control"))
    dev = torch.device(args.device)
    out = open(args.out, "a") if args.out else None

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    plan = [(s, "program") for s in seeds(args.seeds)]
    plan += [(s, kind) for s in seeds(args.control_seeds)
             for kind in controls]
    current = None                  # (seed, workdir, inputs)
    try:
        for seed, kind in plan:
            if current is None or current[0] != seed:
                if current is not None:
                    shutil.rmtree(current[1], ignore_errors=True)
                workdir = tempfile.mkdtemp(prefix="sfmbench_ctl_")
                inputs = job.prepare(config, traffic, seed, workdir, dev)
                if args.orders:
                    reorder_views(inputs, seed)
                current = (seed, workdir, inputs)
            _, workdir, inputs = current
            job_dir = os.path.join(workdir, kind)
            os.makedirs(job_dir)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                if kind == "program":
                    answer = job.run(inputs, job_dir, dev)
                else:
                    answer = getattr(job, kind)(inputs, job_dir, dev, seed)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            checks = job.judge(inputs, [answer], limits, seed, dev)
            line = {"workload": args.workload, "seed": seed, "kind": kind,
                    "orders": args.orders, "wall_s": wall,
                    "numbers": {c["name"]: c["value"] for c in checks},
                    "correct": all(c["value"] <= c["limit"]
                                   for c in checks)}
            if hasattr(job, "diagnose"):
                line["scores"] = job.diagnose(inputs, answer)
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    finally:
        if current is not None:
            shutil.rmtree(current[1], ignore_errors=True)
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    env.pin(os.getcwd())          # before NumPy or PyTorch is imported
    sys.exit(main())
