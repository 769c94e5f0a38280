"""KeyMatch — match a single pair of key files (reference `src/KeyMatch.cpp`);
port of `bundler_sfm_tpu/keymatchsingle.py`.

    python -m bundler_sfm_tpu_torch.keymatchsingle a.key b.key out.txt
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="keymatchsingle", description=__doc__)
    p.add_argument("key1")
    p.add_argument("key2")
    p.add_argument("out_file")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    from bundler_sfm_tpu_torch.io.keyfile import read_key_file
    from bundler_sfm_tpu_torch.ops.matching import (
        match_pair, prune_double_matches,
    )
    _, d1 = read_key_file(args.key1)
    _, d2 = read_key_file(args.key2)
    m = prune_double_matches(match_pair(d1, d2, device=args.device))
    with open(args.out_file, "w") as f:
        f.write(f"{len(m)}\n")
        for a, b in m:
            f.write(f"{a} {b}\n")
    print(f"[KeyMatch] {len(m)} matches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
