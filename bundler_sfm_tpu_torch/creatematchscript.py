"""CreateMatchScript — emit a shell script of pairwise KeyMatch invocations
(`src/CreateMatchScript.cpp:26-92`).

Reads an image list, rewrites each name's extension to `.key`, and prints
one `KeyMatch keyA keyB match-%03d-%03d.txt` line per (i, j<i) pair,
honoring optional key/match directories exactly like the reference.  The
KeyMatch executable here is our single-pair CLI
(`python -m bundler_sfm_tpu_torch.keymatchsingle`).  Port of
`bundler_sfm_tpu/creatematchscript.py` (host only).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, TextIO


def key_name(image_name: str) -> str:
    """Replace the last 3 characters with 'key' (the reference's literal
    in-place rewrite, `CreateMatchScript.cpp:61-63`)."""
    return image_name[:-3] + "key"


def create_match_script(image_names: List[str],
                        key_dir: Optional[str] = None,
                        match_dir: Optional[str] = None,
                        keymatch_cmd: str = "KeyMatch",
                        out: TextIO = sys.stdout) -> None:
    keys = [key_name(n.strip().split()[0]) for n in image_names if n.strip()]
    for i in range(len(keys)):
        for j in range(i + 1, len(keys)):
            a = f"{key_dir}/{keys[i]}" if key_dir else keys[i]
            b = f"{key_dir}/{keys[j]}" if key_dir else keys[j]
            m = f"match-{i:03d}-{j:03d}.txt"
            if match_dir:
                m = f"{match_dir}/{m}"
            out.write(f"{keymatch_cmd} {a} {b} {m}\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Emit pairwise KeyMatch commands "
                    "(src/CreateMatchScript.cpp)")
    p.add_argument("list_in")
    p.add_argument("key_dir", nargs="?", default=None)
    p.add_argument("match_dir", nargs="?", default=None)
    p.add_argument("--keymatch_cmd",
                   default="python -m bundler_sfm_tpu_torch.keymatchsingle")
    args = p.parse_args(argv)
    with open(args.list_in) as f:
        names = f.readlines()
    create_match_script(names, args.key_dir, args.match_dir,
                        args.keymatch_cmd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
