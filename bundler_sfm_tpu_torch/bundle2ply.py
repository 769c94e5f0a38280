"""Bundle2Ply — bundle.out -> .ply (reference `src/Bundle2Ply.cpp`); a copy of
`bundler_sfm_tpu/bundle2ply.py` (host).

    python -m bundler_sfm_tpu_torch.bundle2ply bundle.out points.ply
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
    from bundler_sfm_tpu_torch.io.plyfile import write_points_ply
    bundle = read_bundle_file(argv[0])
    pts = np.stack([p.pos for p in bundle.points]) if bundle.points else \
        np.zeros((0, 3))
    cols = np.stack([p.color for p in bundle.points]) if bundle.points else \
        np.zeros((0, 3))
    regs = [c for c in bundle.cameras if c.registered]
    write_points_ply(argv[1], pts, cols,
                     np.stack([c.R for c in regs]) if regs else None,
                     np.stack([c.center for c in regs]) if regs else None)
    print(f"[Bundle2Ply] wrote {len(pts)} points, {len(regs)} cameras")
    return 0


if __name__ == "__main__":
    sys.exit(main())
