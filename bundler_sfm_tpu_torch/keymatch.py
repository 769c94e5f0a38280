"""`KeyMatchFull` executable equivalent — port of `bundler_sfm_tpu/keymatch.py`:
all-pairs (or sliding-window) exact 2-NN descriptor matching, on CUDA
through the hand-written 2-NN kernel.

Reference `src/KeyMatchFull.cpp:59-151`: read every key file, for each image
i match every earlier image j (or only j within a window radius) with 2-NN +
0.6 ratio, write pairs with >= 16 matches to the output table.

    python -m bundler_sfm_tpu_torch.keymatch list_keys.txt matches.init.txt
        [window] [--device cuda|cpu] [--telemetry PATH]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


def match_full(key_files: List[str], window_radius: int = -1,
               ratio: float = 0.6, min_matches: int = 16, device="cuda"):
    """{(j, i): int32 [m, 2]} for every pair j < i of the key files (j within
    `window_radius` of i when it is > 0) with both files non-empty and at
    least `min_matches` matches, on `device`: one descriptor upload, then
    `DescriptorTable.match_pairs` (the 2-NN kernel on CUDA)."""
    from bundler_sfm_tpu_torch.io.keyfile import read_key_file
    from bundler_sfm_tpu_torch.ops.matching import DescriptorTable
    from bundler_sfm_tpu_torch.utils import stage

    descs = []
    with stage("read_keys") as span:
        for kf in key_files:
            try:
                _, d = read_key_file(kf)
            except FileNotFoundError:
                d = np.zeros((0, 128), np.uint8)
            descs.append(d)
    print(f"[KeyMatchFull] Reading keys took {span.seconds:.3f}s "
          f"({sum(len(d) for d in descs)} keys)")

    pairs = []
    for i in range(len(descs)):
        start = max(i - window_radius, 0) if window_radius > 0 else 0
        for j in range(start, i):
            if len(descs[j]) and len(descs[i]):
                pairs.append((j, i))
    with stage("match") as span:
        table = DescriptorTable(descs, device=device)
        out = table.match_pairs(pairs, ratio=ratio, min_matches=min_matches)
    dt = span.seconds
    total = sum(len(v) for v in out.values())
    print(f"[KeyMatchFull] Matching took {dt:.3f}s "
          f"({len(pairs)} pairs, {len(pairs)/max(dt,1e-9):.1f} pairs/s, "
          f"{total} matches)")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="keymatch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("list_file", help="one key file per line")
    p.add_argument("out_file")
    p.add_argument("window", nargs="?", type=int, default=-1,
                   help="match window radius (-1: all pairs)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--telemetry", metavar="PATH", default=None,
                   help="log every span and write the log, the stage "
                        "seconds and the counters to PATH (JSON)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    with open(args.list_file) as f:
        key_files = [line.split()[0] for line in f if line.strip()]
    from bundler_sfm_tpu_torch.io.matchfile import write_match_file
    from bundler_sfm_tpu_torch.utils import span_log
    with span_log(args.telemetry):
        matches = match_full(key_files, window_radius=args.window,
                             device=args.device)
        write_match_file(args.out_file, matches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
