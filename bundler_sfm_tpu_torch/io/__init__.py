"""Host-side I/O: the reference's text-file formats are the de-facto API
(SURVEY.md §1 "Dataflow between stages is via text files").  Copies of the
JAX package's host-only modules; the files they write are byte-identical."""

from bundler_sfm_tpu_torch.io.keyfile import (  # noqa: F401
    read_key_file,
    write_key_file,
    keys_to_centered,
    centered_to_image,
)
from bundler_sfm_tpu_torch.io.listfile import ImageEntry, read_list_file, write_list_file  # noqa: F401
from bundler_sfm_tpu_torch.io.matchfile import read_match_file, write_match_file  # noqa: F401
from bundler_sfm_tpu_torch.io.bundlefile import (  # noqa: F401
    BundleCamera,
    BundlePoint,
    BundleFile,
    read_bundle_file,
    write_bundle_file,
)
from bundler_sfm_tpu_torch.io.plyfile import write_points_ply  # noqa: F401
