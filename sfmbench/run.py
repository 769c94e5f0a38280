"""The benchmark's command: one run of one cell on one or more cards.

    python3 -m sfmbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout (it reads `BENCHMARK.json` there).  Prints
the card's name and power limit, whether the native key-file parser
loads, each job's launches and stage seconds, and last, on standard
error, each number `correct` compares beside its limit; the last line of
standard output is the result's JSON object.  Exits with 2, printing no
result, without enough CUDA cards, and with 3 if JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from sfmbench import env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sfmbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    with open("BENCHMARK.json") as f:
        chips = {w["name"]: w["chips"]
                 for w in json.load(f)["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from bundler_sfm_tpu_torch import native

    from sfmbench import harness, roofline

    print(f"[sfmbench] card {torch.cuda.get_device_name(0)}; nvidia-smi "
          f"{roofline.power_limit()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; native key parser "
          f"{native.available()}", flush=True)
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device="cuda",
                                  t_start=T_START)
    except harness.ForbiddenImport as exc:
        print(f"[sfmbench] {exc}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    env.pin(os.getcwd())          # before NumPy or PyTorch is imported
    sys.exit(main())
