"""The `bundler` entry on what RunBundler.sh leaves on disk, on the CPU: a
small arc collection written as the benchmark's `sfm` job writes it (JPEGs
with their gzip'd Lowe key files beside them, list.txt with the focal,
options.txt, KeyMatchFull's matches.init.txt from the plain matcher), run
through `bundler.main --options_file`, against a Scene built in memory
from the same read-back keys and matches and run through verification and
stage 5 directly; and the spans and counters of the entry's load path and
verification's checkpoints."""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import contextlib
import io
import json

import numpy as np
import pytest
from PIL import Image

from bundler_sfm_tpu_torch import bundler
from bundler_sfm_tpu_torch.config import default_pipeline_config
from bundler_sfm_tpu_torch.io.keyfile import keys_to_centered, read_key_file
from bundler_sfm_tpu_torch.io.listfile import ImageEntry
from bundler_sfm_tpu_torch.io.matchfile import read_match_file
from bundler_sfm_tpu_torch.pipeline.incremental import bundle_adjust_fast
from bundler_sfm_tpu_torch.pipeline.scene import Scene
from bundler_sfm_tpu_torch.pipeline.verify import (
    compute_geometric_constraints,
)
from bundler_sfm_tpu_torch.utils import get_telemetry, span_log

from sfmbench.gen import arc
from sfmbench.jobs import sfm

VIEWS, KEYS, W, H, FOCAL = 8, 768, 1024, 768, 900.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(collection root, the span log of bundler.main run there, the
    in-memory Scene after verification, its bundle.out path)."""
    root = tmp_path_factory.mktemp("arc")
    infos, descs, _ = arc.synthesize(VIEWS, KEYS, 0.6, seed=0)
    arc.write_views(str(root / "images"), VIEWS, W, H, 0)
    sfm.write_collection(str(root), infos, descs, FOCAL, 0.6, 16, "cpu")

    get_telemetry().reset()
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.MonkeyPatch.context() as mp, \
            span_log(str(root / "tel.json")):
        mp.chdir(root)
        assert bundler.main(["list.txt", "--options_file", "options.txt",
                             "--device", "cpu"]) == 0
    log = json.loads((root / "tel.json").read_text())

    entries, key_xy, key_color = [], [], []
    for i in range(VIEWS):
        name = f"images/img{i:04d}.jpg"
        info, _ = read_key_file(str(root / f"images/img{i:04d}.key.gz"))
        entries.append(ImageEntry(name, init_focal=FOCAL))
        key_xy.append(keys_to_centered(info, W, H)[:, :2].astype(np.float64))
        rgb = np.asarray(Image.open(root / name).convert("RGB"))
        key_color.append(rgb[np.clip(info[:, 1].astype(int), 0, H - 1),
                             np.clip(info[:, 0].astype(int), 0, W - 1)])
    scene = Scene(config=default_pipeline_config(), entries=entries,
                  dims=[(W, H)] * VIEWS, key_xy=key_xy, key_color=key_color,
                  matches=read_match_file(str(root / "matches.init.txt")),
                  device="cpu")
    out = tmp_path_factory.mktemp("memory")
    with contextlib.redirect_stdout(io.StringIO()):
        compute_geometric_constraints(scene, seed=0)
        bundle_adjust_fast(scene, out_dir=str(out), seed=0)
    return root, log, scene, out / "bundle.out"


def test_bundle_equals_the_in_memory_run(runs):
    root, _, scene, memory = runs
    got = (root / "bundle" / "bundle.out").read_bytes()
    assert got == memory.read_bytes()
    assert got.splitlines()[1].split()[0] == str(VIEWS).encode()
    for snap in ("prune", "ransac", "corresp"):
        assert (root / f"matches.{snap}.txt").exists()
        assert (root / f"nmatches.{snap}.txt").exists()
    assert (root / "constraints.txt").exists()


def test_spans_of_the_load_path_and_checkpoints(runs):
    _, log, _, _ = runs
    calls = log["stage_calls"]
    assert calls["load_keys"] == VIEWS
    assert calls["key_colors"] == 2 * VIEWS      # sizes, then colours
    assert calls["read_matches"] == 1
    assert calls["match_snapshots"] == 3         # .prune, .ransac, .corresp
    assert calls["write_constraints"] == 1
    spans = log["spans"]
    parent = {k: spans[s[3]][0] if s[3] >= 0 else None
              for k, s in enumerate(spans)}
    for k, s in enumerate(spans):
        if s[0] in ("load_keys", "key_colors", "read_matches",
                    "write_constraints"):
            assert parent[k] is None, s[0]
    snaps = [parent[k] for k, s in enumerate(spans)
             if s[0] == "match_snapshots"]
    assert snaps == ["verify", "verify", None]


def test_counters_equal_what_the_files_and_tracks_hold(runs):
    root, log, scene, _ = runs
    counters = log["counters"]
    keys = sum(len(read_key_file(str(p))[0])
               for p in sorted((root / "images").glob("*.key.gz")))
    assert counters["keys_loaded"] == keys == VIEWS * KEYS
    table = read_match_file(str(root / "matches.init.txt"))
    assert counters["matches_loaded"] == sum(len(m) for m in table.values())
    assert counters["corresp_pairs"] == sum(
        len(t) * (len(t) - 1) // 2 for t in scene.tracks) > 0


@pytest.mark.parametrize("name,key_dir,want", [
    ("images/img0003.jpg", ".", "images/img0003.key"),
    ("img0003.jpg", ".", "img0003.key"),
    ("images/img0003.jpg", "keys", "keys/img0003.key"),
    ("/data/set/b.JPG", "/k", "/k/b.key")])
def test_key_file_beside_the_image_unless_a_key_dir_is_given(name, key_dir,
                                                             want):
    assert ImageEntry(name).key_name(key_dir) == want
