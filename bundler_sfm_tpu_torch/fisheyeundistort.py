"""FisheyeUndistort — fisheye images -> rectilinear (reference
`src/FisheyeUndistort.cpp`); port of `bundler_sfm_tpu/fisheyeundistort.py`,
resampling on `--device`.

    python -m bundler_sfm_tpu_torch.fisheyeundistort list.txt fisheye.txt \\
        out_dir [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fisheyeundistort", description=__doc__)
    p.add_argument("list_file")
    p.add_argument("params_file")
    p.add_argument("out_dir")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    from PIL import Image
    import numpy as np
    from bundler_sfm_tpu_torch.io.listfile import read_list_file
    from bundler_sfm_tpu_torch.ops.fisheye import (
        read_fisheye_file, undistort_image,
    )
    from bundler_sfm_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    params = read_fisheye_file(args.params_file)
    entries = read_list_file(args.list_file)
    os.makedirs(args.out_dir, exist_ok=True)
    count = 0
    for e in entries:
        try:
            with Image.open(e.name) as im:
                arr = np.asarray(im.convert("RGB"))
        except FileNotFoundError:
            continue
        und = undistort_image(arr, params, device=args.device)
        base = os.path.splitext(os.path.basename(e.name))[0]
        Image.fromarray(und).save(os.path.join(args.out_dir, base + ".fd.jpg"),
                                  quality=95)
        count += 1
    print(f"[FisheyeUndistort] wrote {count} images to {args.out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
