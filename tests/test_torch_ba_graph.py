"""The bundle-adjustment LM loop replayed as CUDA graphs (`ops/ba.py`
`_LMGraphs`) against the eager loop, and the eager loop against the loop
as it was before the graphs.

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
included, and the eager loop, the `cg` solver and the CPU capture none.

On the CPU the loop runs eagerly, records no `ba_graph_*` counter and
returns, to the bit, what `_lm_loop_before` (the loop as it was, kept here
verbatim) returns.

This file imports nothing of JAX or of the JAX package.
"""

import contextlib

import numpy as np
import pytest
import torch

from bundler_sfm_tpu_torch.convert import ba_problem_from_numpy
from bundler_sfm_tpu_torch.ops import ba
from bundler_sfm_tpu_torch.ops.ba import (
    CNP, _add_block_diag, _local_max, _pmax, _solve_schur_cg_sharded,
    assemble_schur_off, back_substitute, build_normal_blocks, compute_cost,
    eliminate_points, initial_mu, solve_schur, solve_schur_cg,
)
from bundler_sfm_tpu_torch.utils import counter, get_telemetry
from tests.synthetic import Scene, random_rotation
from tests.test_torch_ba_windows import _arc

RUN_FIELDS = ("cam", "R", "pts", "cost", "initial_cost", "mu")
LOOP_FIELDS = ("cam", "R", "pts", "obs_valid", "pt_removed", "stats", "hist",
               "hist_edges", "avg_dist", "cost", "initial_cost")


def _lm_loop_before(prob, max_iters, fix_points, tau, eps1, eps2, loss,
                    huber_param, solver, mesh=None, window=0, group_pts=0,
                    graphs=None):
    """`ops/ba.py::_lm_loop` before the CUDA graphs, verbatim but for the
    `graphs` argument, which it takes only as None."""
    assert graphs is None
    dtype, dev = prob.cam0.dtype, prob.cam0.device
    eyec = torch.eye(CNP, dtype=dtype, device=dev)
    huber_b = huber_param * huber_param
    inv_s = 1.0 / prob.cam_scale
    frozen = torch.diag_embed(1.0 - prob.cam_mask)
    C = prob.cam0.shape[0]

    def blocks(cam, pts):
        U, V, W, g_c, g_p, cost = build_normal_blocks(
            cam, pts, prob, fix_points, loss=loss, huber_b=huber_b)
        if mesh is not None:
            U, g_c, cost = mesh.psum_all(U, g_c, cost)
        return U, V, W, g_c, g_p, cost
    U, V, W, g_c, g_p, cost0 = blocks(prob.cam0, prob.pts0)
    mu = initial_mu(U, V, tau, mesh)
    nu = torch.tensor(2.0, dtype=dtype, device=dev)
    cam, pts, cost = prob.cam0, prob.pts0, cost0
    it = 0
    while it < max_iters:
        Vinv, Y = eliminate_points(V, W, mu, prob)
        U_aug = U + frozen + mu * eyec
        if solver == "cg" and mesh is not None:
            dcam = _solve_schur_cg_sharded(U_aug, Y, W, g_c, g_p, prob, mesh)
        else:
            S_off, rhs_off = assemble_schur_off(Y, W, g_p, prob, C, window,
                                                group_pts)
            if mesh is not None:
                S_off, rhs_off = mesh.psum_all(S_off, rhs_off)
            S = _add_block_diag(S_off, U_aug)
            rhs = (g_c + rhs_off).reshape(-1)
            dcam = solve_schur_cg(S, rhs) if solver == "cg" else \
                solve_schur(S, rhs)
        dcam = dcam.reshape(-1, CNP) * prob.cam_mask
        dpts = torch.zeros_like(pts) if fix_points else \
            back_substitute(Vinv, W, g_p, dcam, prob)
        cam_new = cam + dcam * inv_s[None]
        pts_new = pts + dpts
        new_cost = compute_cost(cam_new, pts_new, prob, loss, huber_b)
        pred_p = 0.5 * (dpts * (mu * dpts + g_p)).sum()
        sq_old, sq_new = (pts * pts).sum(), (pts_new * pts_new).sum()
        dpts_sq = (dpts * dpts).sum()
        if mesh is not None:
            new_cost, pred_p, sq_old, sq_new, dpts_sq = mesh.psum_all(
                new_cost, pred_p, sq_old, sq_new, dpts_sq)
        pred = 0.5 * (dcam * (mu * dcam + g_c)).sum() + pred_p
        rho = (cost - new_cost) / torch.clamp(pred, min=1e-300)
        accept = new_cost < cost
        gnorm = torch.maximum(g_c.abs().max(),
                              _pmax(_local_max(g_p.abs()), mesh))
        cam = torch.where(accept, cam_new, cam)
        pts = torch.where(accept, pts_new, pts)
        cost = torch.where(accept, new_cost, cost)
        mu = torch.where(accept, mu * torch.clamp(
            1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0), mu * nu)
        nu = torch.where(accept, 2.0, nu * 2.0)
        q = cam * prob.cam_scale[None]
        pnorm = torch.sqrt((q * q).sum() + torch.where(accept, sq_new, sq_old))
        dnorm = torch.sqrt((dcam * dcam).sum() + dpts_sq)
        done = (gnorm < eps1) | (dnorm < eps2 * (pnorm + eps2)) | (mu > 1e30)
        it += 1
        counter("ba_host_syncs")
        accepted, finished = torch.stack([accept, done]).tolist()
        if finished:
            break
        if accepted:
            U, V, W, g_c, g_p, _ = blocks(cam, pts)
    return cam, pts, cost, cost0, it, mu


def _problem(device, C=24, P=3000, seed=0, cam_noise=0.02, pt_noise=0.03,
             outliers=0.0):
    """A seeded scene (`tests/test_torch_cuda.py::_ba_problem`'s, 24
    cameras and 3000 points by default): ~80 % of the (camera, point) pairs
    observed with 0.4 px of noise, an `outliers` share of the observations
    moved 30-80 px, the start perturbed by cam_noise / pt_noise (world
    units; the scene spans ±2 at radius 6)."""
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
    return ba_problem_from_numpy(R0, cam0, pts0, oc, op, oxy, device=device)


def _windowed(device, outliers=0.0):
    """The windowed arc of `tests/test_torch_ba_windows.py` (48 cameras,
    1500 points, windows of 8 or 16), an `outliers` share of its
    observations moved 40 px, and its window arguments."""
    host, plan = _arc(P=1500)
    bad = np.random.default_rng(1).random(len(host["obs_xy"])) < outliers
    host["obs_xy"][bad] += 40.0
    prob = ba.build_problem(**host, schur_plan=plan, device=device)
    return prob, dict(window=plan[2], group_pts=plan[3])


def _counts():
    c = get_telemetry().counters
    return {k: c.get(k, 0) for k in ("lm_iters", "ba_graph_iters",
                                     "ba_graph_captures")}


@contextlib.contextmanager
def _flags_and_counts(out):
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
    with _flags_and_counts({}) as g_rec:
        g = fn()
    with monkeypatch.context() as m:
        m.setattr(ba, "_lm_graphs",
                  lambda *a: contextlib.nullcontext())
        with _flags_and_counts({}) as e_rec:
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
    with _flags_and_counts({}) as rec:
        res = ba.run_ba(prob, max_iters=20, solver="cg")
    assert rec["counts"] == dict(lm_iters=res.iters, ba_graph_iters=0,
                                 ba_graph_captures=0)


# --------------------------------------------------------------------------
# The CPU: the eager loop, as before
# --------------------------------------------------------------------------

CPU_RUN_CASES = {
    "8-iters": ({}, dict(max_iters=8)),
    "150-iters": ({}, dict(max_iters=150)),
    "rejecting": (dict(seed=3, cam_noise=0.6, pt_noise=0.4),
                  dict(max_iters=40)),
    "fixed-points": ({}, dict(max_iters=40, fix_points=True)),
    "huber-cg": (dict(outliers=0.03),
                 dict(max_iters=20, loss="huber", solver="cg")),
}


@pytest.mark.parametrize("case", list(CPU_RUN_CASES))
def test_cpu_run_ba_is_the_loop_before(monkeypatch, case):
    pkw, rkw = CPU_RUN_CASES[case]
    prob = _problem("cpu", C=6, P=300, **pkw)
    with _flags_and_counts({}) as rec:
        now = ba.run_ba(prob, **rkw)
    monkeypatch.setattr(ba, "_lm_loop", _lm_loop_before)
    _same(now, ba.run_ba(prob, **rkw), RUN_FIELDS)
    assert rec["counts"] == dict(lm_iters=now.iters, ba_graph_iters=0,
                                 ba_graph_captures=0)
    if case == "rejecting":
        assert any(not a for a, d in rec["flags"][:-1])


@pytest.mark.parametrize("windowed", [False, True])
def test_cpu_outlier_loop_is_the_loop_before(monkeypatch, windowed):
    if windowed:
        prob, win = _windowed("cpu", outliers=0.01)
        kw = dict(max_iters=8, min_outliers=2, **win)
    else:
        prob = _problem("cpu", C=6, P=300, outliers=0.02)
        kw = dict(max_iters=40, min_outliers=2)
    with _flags_and_counts({}) as rec:
        now = ba.run_ba_outlier_loop(prob, **kw)
    monkeypatch.setattr(ba, "_lm_loop", _lm_loop_before)
    before = ba.run_ba_outlier_loop(prob, **kw)
    _same(now, before, LOOP_FIELDS)
    assert now.passes == before.passes and now.passes > 1
    assert rec["counts"] == dict(lm_iters=now.iters, ba_graph_iters=0,
                                 ba_graph_captures=0)
