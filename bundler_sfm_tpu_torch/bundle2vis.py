"""Bundle2Vis — covisibility vis.dat (reference `src/Bundle2Vis.cpp`); a copy
of `bundler_sfm_tpu/bundle2vis.py` (host).

    python -m bundler_sfm_tpu_torch.bundle2vis bundle.out vis.dat
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    from bundler_sfm_tpu_torch.export.vis import write_vis_file
    write_vis_file(argv[0], argv[1])
    print(f"[Bundle2Vis] wrote {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
