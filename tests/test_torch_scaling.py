"""The port's two scaling programs (`bundler_sfm_tpu_torch/probes/scaling.py`
and `probes/scaling_mesh_cpu.py`) against the JAX package's
`benchmarks/scaling.py`, `benchmarks/scaling_mesh_cpu.py` and
`benchmarks/probes/probe_ba_scaling.py`, on the CPU:

  * the copied generators (`synth_ba`, `synthetic`) array-equal to the
    originals for two seeds and two sizes each;
  * the comm model: the ring formula the JAX `comm_seconds_per_iter` uses,
    fed the JAX payload (its four scalars in six psums) at 4 bytes, equals
    the JAX function over a grid of C, D, solver and CG iterations to
    1e-12 relative; the port's payload (`allreduce_payload`: five scalars
    and one max, tensors fused into four all-reduces) is what one LM
    iteration of the port's sharded BA sends, counted on every
    all_reduce of a run at both solvers; `ring_matcher_model` equals the
    JAX one;
  * `scaling.main` on the CPU at a toy size: the JAX line's keys plus the
    documented additions, every number finite;
  * `scaling_mesh_cpu.main` at D = 1 and 2 gloo ranks on a small problem:
    its keys, the same LM iterations, and the D = 2 final cost within
    1e-9 relative of D = 1's.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import contextlib
import io
import json
import math
from unittest import mock

import numpy as np
import pytest
import torch

from bundler_sfm_tpu_torch.ops import ba
from bundler_sfm_tpu_torch.parallel.mesh import Mesh
from bundler_sfm_tpu_torch.probes import scaling, scaling_mesh_cpu
from tests.test_torch_bench import load_jax_program

JAX_SCALARS, JAX_EXTRA_REDUCES = 4, 2   # the JAX model's count less ours


@pytest.fixture(scope="module")
def jscaling():
    return load_jax_program("benchmarks/scaling.py", "jax_scaling")


@pytest.fixture(scope="module")
def jprobe():
    return load_jax_program("benchmarks/probes/probe_ba_scaling.py",
                            "jax_probe_ba_scaling")


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("size", [(8, 100, 4), (20, 300, 8)])
def test_synth_ba_equals_jax(seed, size, jscaling):
    got = scaling.synth_ba(*size, seed=seed)
    want = jscaling.synth_ba(*size, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("size", [(16, 200, 6), (9, 50, 3)])
def test_synthetic_equals_jax(seed, size, jprobe):
    got = scaling_mesh_cpu.synthetic(*size, seed=seed)
    want = jprobe.synthetic(*size, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_comm_model_equals_jax(solver, jscaling):
    for C in (8, 64, 201, 512):
        for D in (1, 2, 4, 8, 16):
            for cg_iters in (10, 25):
                for bw, hop in ((100e9, 1e-6), (450e9, 0.6e-6), (1.0, 0.0)):
                    want = jscaling.comm_seconds_per_iter(
                        C, D, bw, hop, solver=solver, cg_iters=cg_iters)
                    el, red = scaling.allreduce_payload(C, solver, cg_iters)
                    jax_el = el - (6 - JAX_SCALARS)
                    got = scaling.ring_allreduce_seconds(
                        4 * jax_el, red + JAX_EXTRA_REDUCES, D, bw, hop)
                    assert got == pytest.approx(want, rel=1e-12, abs=0)
                    assert scaling.comm_seconds_per_iter(
                        C, D, bw, hop, solver, cg_iters, elem_bytes=4) == \
                        scaling.ring_allreduce_seconds(4 * el, red, D, bw,
                                                       hop)


def test_ring_matcher_model_equals_jax(jscaling):
    for n, k, D, bw, rate in ((256, 2048, 8, 450e9, 600.0),
                              (256, 2048, 16, 100e9, 50000.0),
                              (64, 1024, 4, 1e9, 1e6), (10, 512, 1, 1e9, 1.0)):
        assert scaling.ring_matcher_model(n, k, D, bw, rate) == \
            jscaling.ring_matcher_model(n, k, D, bw, rate)


def _recording_mesh():
    """A one-rank Mesh whose collectives are recorded and return their
    input: (mesh, calls), calls a list of (elements, op)."""
    mesh = Mesh.__new__(Mesh)
    mesh.group, mesh.device, mesh.rank, mesh.size = None, torch.device(
        "cpu"), 0, 1
    mesh.backend, mesh._via_host = "gloo", False
    calls = []

    def reduce(x, op):
        calls.append((x.numel(), op))
        return x.clone()
    mesh._reduce = reduce
    return mesh, calls


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_allreduce_payload_is_the_code(solver):
    """The all-reduces of LM iteration 2 (run to 2 iterations, less a run
    to 1; both steps accepted) are `allreduce_payload`'s, with the CG
    iterations counted as the [C, 9] all-reduces the run made."""
    C = 6
    R, cam0, pts, oc, op, oxy = scaling.synth_ba(C, 80, 4)
    prob = ba.build_problem(R, cam0, pts, oc, op, oxy, device="cpu")
    runs = []
    for iters in (1, 2):
        mesh, calls = _recording_mesh()
        res = ba.run_ba(prob, max_iters=iters, solver=solver, mesh=mesh)
        assert res.iters == iters and float(res.cost) < float(
            res.initial_cost)
        runs.append(calls)
    one = runs[1][len(runs[0]):]
    assert runs[1][:len(runs[0])] == runs[0]
    cg = sum(1 for n, _ in one if n == C * 9) if solver == "cg" else 0
    model = "cg" if solver == "cg" else "chol"
    assert scaling.allreduce_payload(C, model, cg) == (
        sum(n for n, _ in one), len(one))
    assert solver == "cholesky" or cg >= 10


def test_scaling_main_cpu():
    """A toy sweep on the CPU: the JAX line's keys (platform reads cpu)
    plus device and the comm model's element size and source."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = scaling.main(["--cams", "6", "--pts", "192", "--obs_per_pt",
                            "4", "--iters", "3", "--match_keys", "64",
                            "--match_batches", "2,4", "--device", "cpu"])
    line = json.loads(buf.getvalue().splitlines()[-1])
    assert line == json.loads(json.dumps(res))
    assert set(res) == {"metric", "value", "unit", "platform", "device",
                        "ba_problem", "ba_measured_ms_per_iter_per_shard",
                        "ba_projected_ms_per_iter", "ba_projected_efficiency",
                        "comm_model",
                        "ring_matcher_projected_efficiency_256img",
                        "matching_pairs_per_s_vs_batch"}
    assert res["platform"] == "cpu" and res["device"]["name"] == "cpu"
    assert res["ba_problem"] == {"cams": 6, "pts": 192, "obs": 768,
                                 "solver": "chol"}
    for key in ("ba_measured_ms_per_iter_per_shard",
                "ba_projected_ms_per_iter", "ba_projected_efficiency",
                "ring_matcher_projected_efficiency_256img"):
        assert sorted(res[key]) == list(scaling.SWEEP)
        assert all(math.isfinite(v) and v > 0 for v in res[key].values())
    assert res["ba_projected_efficiency"][1] == 1.0
    assert res["value"] == res["ba_projected_efficiency"][8]
    assert sorted(res["matching_pairs_per_s_vs_batch"]) == [2, 4]
    cm = res["comm_model"]
    assert (cm["ici_gbps"], cm["hop_us"], cm["elem_bytes"]) == (450.0, 0.6, 8)
    el, red = scaling.allreduce_payload(6, "chol")
    assert cm["psum_payload_mb"] == 8 * el / 1e6
    assert cm["allreduces_per_iter"] == red == 4


def test_scaling_mesh_cpu_d1_d2():
    """The sharded BA on one and two gloo ranks: the same iterations and
    final cost to 1e-9 relative."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = scaling_mesh_cpu.main(["--pts", "512", "--iters", "5",
                                     "--devices", "1,2"])
    line = json.loads(buf.getvalue().splitlines()[-1])
    assert line == json.loads(json.dumps(res))
    assert {"metric", "host_cores", "problem",
            "ms_per_iter_by_devices"} <= set(res)
    assert res["metric"] == "measured_mesh_ms_per_iter_cpu"
    assert res["problem"] == {"cams": 16, "pts": 512, "obs": 512 * 6}
    assert sorted(res["ms_per_iter_by_devices"]) == [1, 2]
    assert all(math.isfinite(v) and v > 0
               for v in res["ms_per_iter_by_devices"].values())
    it, cost = res["lm_iters_by_devices"], res["final_cost_by_devices"]
    assert it[1] == it[2] == 5
    assert cost[2] == pytest.approx(cost[1], rel=1e-9, abs=0)


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with mock.patch("sys.stdout", io.StringIO()), \
            pytest.raises(RuntimeError, match="CUDA is not available"):
        scaling.main(["--cams", "4", "--pts", "16", "--iters", "1"])
