"""The bundle-adjustment LM loop replayed as CUDA graphs (`ops/ba.py`
`_LMGraphs`) against the eager loop.

On the card (which has no JAX, so the repository's conftest is left out):

    python -m pytest tests/test_torch_ba_graph.py --noconftest -q

`run_ba` and `run_ba_outlier_loop` on CUDA, where the graphs engage, are
held `torch.equal` field by field, iteration counts and every step's
(accept, done) flags included, to the eager loop on the same CUDA tensors
(taken by making `_lm_graphs` hold None, as it does on the CPU): 8 and 150
LM iterations, outlier passes, a start that rejects steps, fixed points
and the windowed arc of `tests/test_torch_ba_windows.py`.  Every LM
iteration of the graph path is a replay (`ba_graph_iters` = `lm_iters`),
each call captures two graphs once (`ba_graph_captures`), its passes
included, and the eager loop and the `cg` solver capture none.  The CPU
runs of the same problems, which record no `ba_graph_*` counter, are held
to the JAX package in tests/test_torch_ba.py.

This file imports nothing of JAX or of the JAX package.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import contextlib

import numpy as np
import pytest
import torch

from bundler_sfm_tpu_torch.convert import ba_problem_from_numpy
from bundler_sfm_tpu_torch.ops import ba
from bundler_sfm_tpu_torch.utils import get_telemetry
from tests.synthetic import Scene, random_rotation
from tests.test_torch_ba_windows import _arc

RUN_FIELDS = ("cam", "R", "pts", "cost", "initial_cost", "mu")
LOOP_FIELDS = ("cam", "R", "pts", "obs_valid", "pt_removed", "stats", "hist",
               "hist_edges", "avg_dist", "cost", "initial_cost")


def ba_host(C=24, P=3000, seed=0, cam_noise=0.02, pt_noise=0.03,
            outliers=0.0):
    """A seeded scene as host arrays (`tests/test_torch_cuda.py::
    _ba_problem`'s, 24 cameras and 3000 points by default): ~80 % of the
    (camera, point) pairs observed with 0.4 px of noise, an `outliers`
    share of the observations moved 30-80 px, the start perturbed by
    cam_noise / pt_noise (world units; the scene spans ±2 at radius 6)."""
    rng = np.random.default_rng(seed)
    sc = Scene(rng, num_cams=C, num_pts=P, noise=0.4, k1=-0.03)
    R0 = np.stack([random_rotation(rng, 0.02) @ sc.R[i] for i in range(C)])
    cam0 = np.zeros((C, 9))
    cam0[:, 0:3] = sc.centers + rng.normal(size=(C, 3)) * cam_noise
    cam0[:, 6] = sc.f
    keep = rng.random((C, P)) < 0.8
    oc, op = np.nonzero(keep)
    oxy = np.stack([sc.obs[c][p] for c, p in zip(oc, op)])
    bad = rng.random(len(oc)) < outliers
    oxy[bad] += rng.uniform(30, 80, (int(bad.sum()), 2)) * \
        rng.choice([-1, 1], (int(bad.sum()), 2))
    pts0 = sc.points + rng.normal(size=sc.points.shape) * pt_noise
    return dict(R0=R0, cam0=cam0, pts0=pts0, obs_cam=oc, obs_pt=op,
                obs_xy=oxy)


def _problem(device, **kw):
    return ba_problem_from_numpy(**ba_host(**kw), device=device)


def windowed_host(outliers=0.0):
    """The windowed arc of `tests/test_torch_ba_windows.py` (48 cameras,
    1500 points, windows of 8 or 16) with an `outliers` share of its
    observations moved 40 px: (host arrays, plan)."""
    host, plan = _arc(P=1500)
    bad = np.random.default_rng(1).random(len(host["obs_xy"])) < outliers
    host["obs_xy"][bad] += 40.0
    return host, plan


def _windowed(device, outliers=0.0):
    """`windowed_host`'s problem and its window arguments."""
    host, plan = windowed_host(outliers)
    prob = ba.build_problem(**host, schur_plan=plan, device=device)
    return prob, dict(window=plan[2], group_pts=plan[3])


def _counts():
    c = get_telemetry().counters
    return {k: c.get(k, 0) for k in ("lm_iters", "ba_graph_iters",
                                     "ba_graph_captures")}


@contextlib.contextmanager
def flags_and_counts(out):
    """Inside the block, every LM step's (accept, done) is appended to
    out["flags"]; at its end out["counts"] holds the change of `lm_iters`
    and the `ba_graph_*` counters."""
    real = ba._lm_iterate
    out["flags"] = []

    def iterate(step, rebuild, max_iters):
        def noting():
            flags = step()
            out["flags"].append(tuple(flags.tolist()))
            return flags
        return real(noting, rebuild, max_iters)
    before = _counts()
    ba._lm_iterate = iterate
    try:
        yield out
    finally:
        ba._lm_iterate = real
        out["counts"] = {k: v - before[k] for k, v in _counts().items()}


def _same(a, b, fields):
    assert a.iters == b.iters
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _graph_and_eager(monkeypatch, fn):
    """fn() on the graph path, then on the eager loop: (graph result, its
    record, eager result, its record)."""
    with flags_and_counts({}) as g_rec:
        g = fn()
    with monkeypatch.context() as m:
        m.setattr(ba, "_lm_graphs",
                  lambda *a: contextlib.nullcontext())
        with flags_and_counts({}) as e_rec:
            e = fn()
    return g, g_rec, e, e_rec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# The card: graph against eager
# --------------------------------------------------------------------------

# name: (problem keywords, run_ba keywords)
RUN_CASES = {
    "8-iters": ({}, dict(max_iters=8)),
    "150-iters": ({}, dict(max_iters=150)),
    "rejecting": (dict(seed=3, cam_noise=0.6, pt_noise=0.4),
                  dict(max_iters=150)),
    "fixed-points": ({}, dict(max_iters=150, fix_points=True)),
    "huber": (dict(outliers=0.03), dict(max_iters=60, loss="huber")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_ba_graph_equals_eager(cuda, monkeypatch, case):
    pkw, rkw = RUN_CASES[case]
    prob = _problem(cuda, **pkw)
    g, g_rec, e, e_rec = _graph_and_eager(
        monkeypatch, lambda: ba.run_ba(prob, **rkw))
    _same(g, e, RUN_FIELDS)
    assert g_rec["flags"] == e_rec["flags"]
    assert g_rec["counts"] == dict(lm_iters=g.iters, ba_graph_iters=g.iters,
                                   ba_graph_captures=2)
    assert e_rec["counts"] == dict(lm_iters=e.iters, ba_graph_iters=0,
                                   ba_graph_captures=0)
    if case == "8-iters":
        assert g.iters == 8
    if case == "rejecting":
        assert any(not a for a, d in g_rec["flags"][:-1]), \
            "no step was rejected"


@pytest.mark.cuda
@pytest.mark.parametrize("windowed", [False, True])
def test_outlier_loop_graph_equals_eager(cuda, monkeypatch, windowed):
    """The passes share one capture: two graphs for the whole call."""
    if windowed:
        prob, win = _windowed(cuda, outliers=0.01)
        kw = dict(max_iters=40, min_outliers=2, **win)
    else:
        prob = _problem(cuda, outliers=0.02)
        kw = dict(max_iters=60, min_outliers=2)
    g, g_rec, e, e_rec = _graph_and_eager(
        monkeypatch, lambda: ba.run_ba_outlier_loop(prob, **kw))
    _same(g, e, LOOP_FIELDS)
    assert g.passes == e.passes and g.passes > 1
    assert np.array_equal(g.n_outliers, e.n_outliers)
    assert g_rec["flags"] == e_rec["flags"]
    assert g_rec["counts"] == dict(lm_iters=g.iters, ba_graph_iters=g.iters,
                                   ba_graph_captures=2)
    assert e_rec["counts"]["ba_graph_captures"] == 0


@pytest.mark.cuda
def test_windowed_run_ba_graph_equals_eager(cuda, monkeypatch):
    prob, win = _windowed(cuda)
    g, g_rec, e, e_rec = _graph_and_eager(
        monkeypatch, lambda: ba.run_ba(prob, max_iters=150, **win))
    _same(g, e, RUN_FIELDS)
    assert g_rec["flags"] == e_rec["flags"]
    assert g_rec["counts"] == dict(lm_iters=g.iters, ba_graph_iters=g.iters,
                                   ba_graph_captures=2)


@pytest.mark.cuda
def test_graphs_hold_no_memory_past_the_run(cuda):
    """The graphs, their pool and the capture stream's cuBLAS workspace
    are freed when run_ba returns."""
    prob = _problem(cuda, C=8, P=500)
    ba.run_ba(prob, max_iters=5)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    res = ba.run_ba(prob, max_iters=5)
    del res
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= before


@pytest.mark.cuda
def test_captures_reuse_one_pool(cuda):
    """Run after run, the captures take their memory from the blocks the
    earlier runs gave back: the device memory reserved does not grow."""
    probs = [_problem(cuda, C=8, P=500, seed=s) for s in range(3)]
    for p in probs:
        ba.run_ba(p, max_iters=5)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    for _ in range(3):
        for p in probs:
            ba.run_ba(p, max_iters=5)
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() == reserved


@pytest.mark.cuda
def test_cg_solver_captures_nothing(cuda):
    prob = _problem(cuda, C=8, P=500)
    with flags_and_counts({}) as rec:
        res = ba.run_ba(prob, max_iters=20, solver="cg")
    assert rec["counts"] == dict(lm_iters=res.iters, ba_graph_iters=0,
                                 ba_graph_captures=0)
