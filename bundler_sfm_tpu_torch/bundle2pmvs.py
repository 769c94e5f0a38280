"""Bundle2PMVS — export to PMVS (reference `src/Bundle2PMVS.cpp:259`); a copy
of `bundler_sfm_tpu/bundle2pmvs.py` (host text).

    python -m bundler_sfm_tpu_torch.bundle2pmvs list.txt bundle.out [pmvs_dir]
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    out = argv[2] if len(argv) > 2 else "pmvs"
    from bundler_sfm_tpu_torch.export.pmvs import write_pmvs
    count = write_pmvs(out, argv[0], argv[1])
    print(f"[Bundle2PMVS] exported {count} cameras to {out}/")
    print(f"[Bundle2PMVS] @@ Execute {out}/prep_pmvs.sh to finalize")
    return 0


if __name__ == "__main__":
    sys.exit(main())
