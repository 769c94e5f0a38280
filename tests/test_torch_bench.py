"""The port's benchmark (`bundler_sfm_tpu_torch/bench.py`) against the JAX
package's root `bench.py`, on the CPU at small sizes:

  * the copied generators (`make_descriptors`, `__graft_entry__`'s
    `_synthetic_problem`, `benchmarks/e2e_synthetic.py`'s `synthesize`)
    array-equal to the originals for two seeds and two sizes each;
  * the matcher leg's match dict bit-exact against the JAX
    `DescriptorTable.match_pairs` (tier a), and its match count equal to
    the JAX bench's `bench_tpu`;
  * the BA legs (f64) against the JAX `run_ba` in f64 from the same
    problem: the same LM iteration count, the final cost within 1e-9
    relative;
  * `main` with `--device cpu` at a toy size: one JSON line with exactly
    the JAX bench's keys less the documented omissions and renames (plus
    the documented additions), device metrics null, every other number
    finite;
  * without a card and without `--device cpu`, `main` raises.

The JAX programs are loaded from their files; each sets environment
variables (and `sys.path`) when imported, so the loads run inside
`mock.patch.dict(os.environ)` and a saved `sys.path`, and leak nothing
into later tests of the same worker.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import ast
import contextlib
import importlib.util
import io
import json
import math
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import bundler_sfm_tpu  # noqa: F401  (x64 on, before any JAX program)
from bundler_sfm_tpu_torch import bench
from bundler_sfm_tpu_torch.probes import e2e_synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_jax_program(relpath, name):
    """A JAX program of the repository, imported from its file with the
    environment and sys.path restored afterwards."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ), \
            mock.patch.object(sys, "path", list(sys.path)):
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbench():
    return load_jax_program("bench.py", "jax_bench")


@pytest.fixture(scope="module")
def jgraft():
    return load_jax_program("__graft_entry__.py", "jax_graft_entry")


@pytest.fixture(scope="module")
def je2e():
    return load_jax_program("benchmarks/e2e_synthetic.py", "jax_e2e")


@pytest.mark.parametrize("relpath", ["bench.py", "__graft_entry__.py",
                                     "benchmarks/e2e_synthetic.py"])
def test_loading_leaks_nothing(relpath):
    env, path = dict(os.environ), list(sys.path)
    load_jax_program(relpath, "jax_" + os.path.basename(relpath)[:-3])
    assert dict(os.environ) == env and sys.path == path


def _arrays_equal(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _arrays_equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _arrays_equal(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("gen,size", [
    ("make_descriptors", (4, 64)), ("make_descriptors", (7, 300)),
    ("synthetic_problem", (4, 64)), ("synthetic_problem", (9, 200)),
    ("synthesize", (6, 256)), ("synthesize", (10, 512)),
])
def test_generators_equal_jax(gen, size, seed, jbench, jgraft, je2e):
    if gen == "make_descriptors":
        got = bench.make_descriptors(np.random.default_rng(seed), *size)
        want = jbench.make_descriptors(np.random.default_rng(seed), *size)
    elif gen == "synthetic_problem":
        got = bench.synthetic_problem(*size, seed=seed)
        want = jgraft._synthetic_problem(*size, seed=seed)
    else:
        got = e2e_synthetic.synthesize(*size, 0.6, seed=seed)
        want = je2e.synthesize(*size, 0.6, seed=seed)
    _arrays_equal(got, want)


def test_matcher_leg_equals_jax(jbench):
    """6 images x 256 keys, all 15 pairs: the leg's dict bit-exact against
    the JAX DescriptorTable's, the three rotations' counts equal, and the
    count equal to the JAX bench's matcher leg."""
    from bundler_sfm_tpu.ops.matching import DescriptorTable as JTable
    descs = bench.make_descriptors(np.random.default_rng(0), 6, 256)
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    _, secs, counts, got = bench.bench_match(descs, pairs, 256, 15, "cpu")
    want = JTable(descs, block=256).match_pairs(pairs, batch=15,
                                                min_matches=16)
    assert len(secs) == 3 and len(set(counts)) == 1
    assert set(got) == set(want) and len(got) > 0
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    _, _, jax_count, _ = jbench.bench_tpu(descs, pairs)
    assert counts[0] == jax_count


def test_kernel_leg_counts_operations():
    descs = bench.make_descriptors(np.random.default_rng(1), 4, 128)
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    table = bench.DescriptorTable(descs, block=128, device="cpu")
    rate, ops_s, ops = bench.bench_kernel(table, pairs, reps=2)
    K = table.table.shape[1]
    assert ops == 2 * len(pairs) * 2.0 * K * K * 128
    assert rate > 0 and ops_s > 0 and math.isfinite(ops_s)


@pytest.mark.parametrize("cams,pts", [(8, 64), (5, 96)])
def test_ba_leg_equals_jax_f64(cams, pts, jgraft):
    """The leg's timed run (cam0 + 1e-6, 3 LM iterations at most, f64)
    against the JAX run_ba in f64 from the same problem: the same
    iteration count, the final cost within 1e-9 relative."""
    from bundler_sfm_tpu.ops.ba import build_problem, run_ba
    got = bench.bench_ba_shape(cams, pts, max_iters=3, device="cpu")
    R0, cam0, pts0, oc, op, oxy = jgraft._synthetic_problem(cams, pts)
    prob = build_problem(R0, cam0 + 1e-6, pts0, oc, op, oxy, est_focal=True,
                         est_distortion=True, dtype=np.float64)
    res = run_ba(prob, max_iters=3)
    assert got["iters"] == int(res.iters)
    want = float(res.cost)
    assert abs(got["cost"] - want) <= 1e-9 * abs(want), (got["cost"], want)
    assert got["mfu"] is None
    assert got["obs_iters_per_s"] > 0 and got["seconds_per_lm_iter"] > 0


def test_sparse_leg_keeps_one_observation_per_pair():
    """build_problem raises on a (point, camera) pair observed twice, so a
    finished leg shows the subsample kept one each."""
    got = bench.bench_ba_sparse(12, 300, max_iters=2, device="cpu")
    assert 0 < got["occupancy"] <= 1 and got["iters"] >= 1
    assert math.isfinite(got["cost"])


def _jax_line_keys():
    """The keys of the JAX bench's result dict and of its `detail`, read
    from bench.py's source."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "result"
                        for t in node.targets):
            top = [k.value for k in node.value.keys]
            detail = node.value.values[top.index("detail")]
            return set(top), {k.value for k in detail.keys}
    raise AssertionError("no result dict in bench.py")


# The port's line against the JAX bench's (bench.py's module docstring).
RENAMED = {"tpu_seconds": "match_seconds", "tpu_matches": "matches"}
OMITTED = {"ref_ann_pairs_per_s", "ref_ann_conditions",
           "ba_sparse_bucketed_obs_iters_per_s",
           "ba_sparse_bucketed_occupancy"}
ADDED = {"device", "launches", "match_seconds_runs", "matches_runs",
         "ba_lm_iters", "ba64_lm_iters", "ba_sparse_lm_iters", "mfu_peaks"}
DEVICE_METRICS = {"kernel_tflops", "kernel_mfu", "ba_mfu", "ba64_mfu"}


def _numbers(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _numbers(v)
    elif isinstance(x, list):
        for v in x:
            yield from _numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


def test_main_cpu_line():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = bench.main(["--device", "cpu", "--num_images", "5", "--keys",
                          "256", "--ba_small", "4", "48", "--ba_big", "6",
                          "64", "--ba_sparse", "10", "128", "--ba_iters",
                          "3"])
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == res
    top, detail = _jax_line_keys()
    assert set(res) == top
    want = {RENAMED.get(k, k) for k in detail} - OMITTED | ADDED
    assert set(res["detail"]) == want
    d = res["detail"]
    assert res["metric"] == "pairs_matched_per_s" and res["unit"] == "pairs/s"
    assert res["vs_baseline"] is None
    assert d["platform"] == "cpu" and d["device"]["name"] == "cpu"
    assert all(d[k] is None for k in DEVICE_METRICS)
    assert d["num_pairs"] == 10 and d["keys_per_image"] == 256
    assert not any(d["launches"].values())
    rest = {k: v for k, v in d.items() if k not in DEVICE_METRICS
            and k != "device"}
    nums = [res["value"], *_numbers(rest)]
    assert all(math.isfinite(x) for x in nums)
    assert res["value"] > 0 and d["kernel_pairs_per_s"] > 0
    assert d["match_seconds"] == min(d["match_seconds_runs"])


@pytest.mark.parametrize("entry", ["bench", "e2e_synthetic"])
def test_main_without_card_raises(entry, tmp_path, monkeypatch):
    """No fallback: the default device is cuda, and without a card the run
    raises before it generates anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = bench.main if entry == "bench" else e2e_synthetic.main
    argv = [] if entry == "bench" else ["4", "64", "--workdir",
                                        str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    assert not os.listdir(tmp_path)
