"""RadialUndistort — undistorted images + bundle.rd.out (reference
`src/RadialUndistort.cpp`); port of `bundler_sfm_tpu/radialundistort.py`,
resampling on `--device`.

    python -m bundler_sfm_tpu_torch.radialundistort list.txt bundle.out \\
        out_dir [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="radialundistort", description=__doc__)
    p.add_argument("list_file")
    p.add_argument("bundle_file")
    p.add_argument("out_dir")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    from bundler_sfm_tpu_torch.export.undistort import radial_undistort
    kept, _ = radial_undistort(args.list_file, args.bundle_file, args.out_dir,
                               device=args.device)
    print(f"[RadialUndistort] wrote {len(kept)} undistorted images to "
          f"{args.out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
