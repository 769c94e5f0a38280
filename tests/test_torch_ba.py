"""The port's bundle adjustment against the JAX package's on the CPU in f64,
from the same host problem (`convert.ba_problem_from_numpy` and the JAX
package's `build_problem` on the same arrays), on `tests/synthetic.py`
scenes with ragged views (15% of observations dropped).

Tolerances:
  * `run_ba` capped at 8 LM iterations (every case still converging, point
    anchors included): the same iteration count, cameras and points within 1e-8 of the largest
    entry, costs within 1e-9 relative;
  * `run_ba` to convergence: cameras and points within 1e-8, final costs
    within 1e-10 relative.  The iteration at which LM stops is NOT held:
    the last iterations accept or reject steps whose cost change is at the
    rounding floor, so the count is chaotic — the JAX package itself stops
    at 23, 27, 23 and 24 iterations on one problem with the observations
    scaled by 1, 1+2^-52, 1-2^-53 and 1+2^-51;
  * `run_ba_outlier_loop`: the same passes, removed points and final
    observation set; cameras and points within 1e-8; per-camera stats
    within 1e-9.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import Scene, random_rotation

from bundler_sfm_tpu.ops import ba as J

from bundler_sfm_tpu_torch.convert import ba_problem_from_numpy
from bundler_sfm_tpu_torch.ops import ba as T
from tests.test_torch_ba_graph import ba_host, flags_and_counts, windowed_host
from tests.test_torch_ba_windows import _jax_problem


def host_problem(rng, C=4, P=100, noise=0.3, cam_noise=0.02, pt_noise=0.03,
                 k1=0.0):
    sc = Scene(rng, num_cams=C, num_pts=P, noise=noise, k1=k1)
    R0 = np.stack([random_rotation(rng, cam_noise) @ sc.R[i]
                   for i in range(C)])
    cam0 = np.zeros((C, 9))
    cam0[:, 0:3] = sc.centers + rng.normal(size=(C, 3)) * cam_noise
    cam0[:, 6] = sc.f * (1.0 + rng.normal(size=C) * 0.01)
    pts0 = sc.points + rng.normal(size=sc.points.shape) * pt_noise
    keep = rng.random((C, P)) < 0.85
    oc, op = np.nonzero(keep)
    oxy = np.stack([sc.obs[c][p] for c, p in zip(oc, op)])
    return dict(R0=R0, cam0=cam0, pts0=pts0, obs_cam=oc, obs_pt=op,
                obs_xy=oxy)


def both(host, **opts):
    jp = J.build_problem(**host, **opts)
    tp = ba_problem_from_numpy(**host, device="cpu", **opts)
    return jp, tp


def close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.abs(a).max(), 1e-300)
    assert np.abs(a - b).max() <= rel * scale, np.abs(a - b).max() / scale


def check_result(jr, tr, C, P, rel=1e-8):
    close(np.asarray(jr.cam)[:C], tr.cam.numpy(), rel)
    close(np.asarray(jr.R)[:C], tr.R.numpy(), rel)
    close(np.asarray(jr.pts)[:P], tr.pts.numpy(), rel)


CASES = {
    "l2-cholesky": (dict(), dict()),
    "huber-cholesky": (dict(), dict(loss="huber", huber_param=1.0)),
    "l2-cg": (dict(), dict(solver="cg")),
    "huber-cg": (dict(), dict(loss="huber", huber_param=1.0, solver="cg")),
    "fix-points": (dict(), dict(fix_points=True)),
    "frozen-focal-distortion": (dict(est_focal=False, est_distortion=False),
                                dict()),
}


def _constrained(host):
    C = len(host["cam0"])
    cc = np.zeros((C, 9)); ct = np.zeros((C, 9)); cw = np.zeros((C, 9))
    cc[:, 6], ct[:, 6], cw[:, 6] = 1.0, 700.0, 1e-4
    cc[:, 7:9], cw[:, 7:9] = 1.0, 100.0
    return dict(cam_constrained=cc, cam_constraints=ct, cam_weights=cw)


def _anchored(host):
    """Every 7th point anchored 0.05 off its start, weight 10."""
    P = len(host["pts0"])
    flags = (np.arange(P) % 7 == 0).astype(float)
    return dict(pt_constrained=flags, pt_constraints=host["pts0"] + 0.05,
                pt_weight=10.0)


@pytest.mark.parametrize("case", list(CASES) + ["constraints",
                                                "point-constraints"])
def test_run_ba_capped(case, rng):
    host = host_problem(rng, k1=-0.03)
    if case == "constraints":
        opts, run = _constrained(host), dict()
    elif case == "point-constraints":
        opts, run = _anchored(host), dict()
    else:
        opts, run = CASES[case]
    jp, tp = both(host, **opts)
    jr = J.run_ba(jp, max_iters=8, **run)
    tr = T.run_ba(tp, max_iters=8, **run)
    assert int(jr.iters) == tr.iters == 8
    close(float(jr.cost), float(tr.cost), 1e-9)
    close(float(jr.initial_cost), float(tr.initial_cost), 1e-12)
    check_result(jr, tr, 4, 100)
    assert float(tr.cost) < 0.5 * float(tr.initial_cost)


@pytest.mark.parametrize("case", ["l2-cholesky", "huber-cg",
                                  "frozen-focal-distortion"])
def test_run_ba_converged(case, rng):
    host = host_problem(rng)
    opts, run = CASES[case]
    jp, tp = both(host, **opts)
    jr = J.run_ba(jp, max_iters=150, **run)
    tr = T.run_ba(tp, max_iters=150, **run)
    close(float(jr.cost), float(tr.cost), 1e-10)
    check_result(jr, tr, 4, 100)


def test_outlier_loop(rng):
    host = host_problem(rng, C=4, P=160, noise=0.5)
    bad = rng.choice(160, 10, replace=False)
    sel = np.isin(host["obs_pt"], bad)
    host["obs_xy"][sel] += rng.uniform(40, 90, (sel.sum(), 2))
    jp, tp = both(host, est_distortion=False)
    cam_obs, cam_mask = J.build_cam_obs_table(host["obs_cam"],
                                              host["obs_pt"], 4)
    kw = dict(max_iters=60, min_outliers=2, min_points=8, max_passes=4)
    jr = J.run_ba_outlier_loop(jp, jnp.asarray(cam_obs),
                               jnp.asarray(cam_mask), **kw)
    tr = T.run_ba_outlier_loop(tp, **kw)
    assert int(jr.passes) == tr.passes >= 2
    removed = tr.pt_removed.numpy()
    np.testing.assert_array_equal(np.asarray(jr.pt_removed)[:160], removed)
    assert removed[bad].all() and removed.sum() <= 15
    np.testing.assert_array_equal(np.asarray(jr.n_outliers), tr.n_outliers)
    ov = np.asarray(jr.obs_valid)[J.slot_ids(host["obs_pt"],
                                             jp.views_mask.shape[1])]
    np.testing.assert_array_equal(ov, tr.obs_valid.numpy())
    assert bool(jr.too_few) == tr.too_few is False
    check_result(jr, tr, 4, 160)
    close(np.asarray(jr.stats)[:tr.passes], tr.stats.numpy()[:tr.passes],
          1e-9)
    np.testing.assert_array_equal(np.asarray(jr.hist)[:tr.passes],
                                  tr.hist.numpy()[:tr.passes])
    close(float(jr.avg_dist), float(tr.avg_dist), 1e-9)


def test_outlier_loop_keeps_anchored_points(rng):
    """Half of the corrupted points anchored (weight 1e3): the JAX package
    and the port keep exactly those and remove the same others."""
    host = host_problem(rng, C=4, P=160, noise=0.5)
    bad = rng.choice(160, 10, replace=False)
    sel = np.isin(host["obs_pt"], bad)
    host["obs_xy"][sel] += rng.uniform(40, 90, (sel.sum(), 2))
    flags = np.zeros(160)
    flags[bad[:5]] = 1.0
    jp, tp = both(host, est_distortion=False, pt_constrained=flags,
                  pt_constraints=host["pts0"], pt_weight=1e3)
    cam_obs, cam_mask = J.build_cam_obs_table(host["obs_cam"],
                                              host["obs_pt"], 4)
    kw = dict(max_iters=60, min_outliers=2, min_points=8, max_passes=4)
    jr = J.run_ba_outlier_loop(jp, jnp.asarray(cam_obs),
                               jnp.asarray(cam_mask), **kw)
    tr = T.run_ba_outlier_loop(tp, **kw)
    assert int(jr.passes) == tr.passes >= 2
    removed = tr.pt_removed.numpy()
    np.testing.assert_array_equal(np.asarray(jr.pt_removed)[:160], removed)
    assert not removed[bad[:5]].any() and removed[bad[5:]].all()
    check_result(jr, tr, 4, 160)


def test_outlier_loop_without_removal_is_run_ba(rng):
    host = host_problem(rng, C=3, P=80)
    _, tp = both(host, est_distortion=False)
    res = T.run_ba_outlier_loop(tp, max_iters=40, remove_outliers=False,
                                max_passes=4)
    ref = T.run_ba(tp, max_iters=40)
    assert res.passes == 1 and not res.pt_removed.any()
    assert torch.equal(res.cam, ref.cam) and torch.equal(res.pts, ref.pts)


def test_non_positive_definite_step_is_rejected(rng):
    """A Cholesky failure gives a NaN step (as the JAX package's failed
    factorization does), which LM rejects and damps harder."""
    S = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    assert torch.isnan(T.solve_schur(S, torch.ones(2, dtype=torch.float64))
                       ).all()


def test_repeated_pair_is_refused(rng):
    host = host_problem(rng, C=2, P=10)
    for k in ("obs_cam", "obs_pt", "obs_xy"):
        host[k] = np.concatenate([host[k], host[k][:1]])
    with pytest.raises(ValueError, match="observed more than once"):
        ba_problem_from_numpy(**host, device="cpu")


# The LM loop's CPU runs on the problems that tests/test_torch_ba_graph.py
# replays as CUDA graphs on the card, cut to 6 cameras and 300 points:
# (problem keywords, run_ba keywords).  On the CPU the loop runs eagerly and
# records no `ba_graph_*` counter.
LOOP_RUN_CASES = {
    "8-iters": ({}, dict(max_iters=8)),
    "150-iters": ({}, dict(max_iters=150)),
    "rejecting": (dict(seed=3, cam_noise=0.6, pt_noise=0.4),
                  dict(max_iters=40)),
    "fixed-points": ({}, dict(max_iters=40, fix_points=True)),
    "huber-cg": (dict(outliers=0.03),
                 dict(max_iters=20, loss="huber", solver="cg")),
}
NO_GRAPHS = dict(ba_graph_iters=0, ba_graph_captures=0)


@pytest.mark.parametrize("case", list(LOOP_RUN_CASES))
def test_cpu_run_ba_is_the_loop_before(case):
    """`run_ba` against the JAX package's: a run that stops at max_iters
    is held as `test_run_ba_capped` holds one (the same iteration count,
    costs within 1e-9), one that converges first as
    `test_run_ba_converged` does (final costs within 1e-10); cameras and
    points within 1e-8 in both."""
    pkw, rkw = LOOP_RUN_CASES[case]
    jp, tp = both(ba_host(C=6, P=300, **pkw))
    with flags_and_counts({}) as rec:
        tr = T.run_ba(tp, **rkw)
    jr = J.run_ba(jp, **rkw)
    capped = tr.iters == rkw["max_iters"]
    if capped:
        assert int(jr.iters) == tr.iters
    close(float(jr.cost), float(tr.cost), 1e-9 if capped else 1e-10)
    close(float(jr.initial_cost), float(tr.initial_cost), 1e-12)
    check_result(jr, tr, 6, 300)
    assert rec["counts"] == dict(lm_iters=tr.iters, **NO_GRAPHS)
    if case == "rejecting":
        assert any(not a for a, d in rec["flags"][:-1]), \
            "no step was rejected"


@pytest.mark.parametrize("windowed", [False, True])
def test_cpu_outlier_loop_is_the_loop_before(windowed):
    """`run_ba_outlier_loop` against the JAX package's, as
    `test_outlier_loop` holds it (windowed: as
    tests/test_torch_ba_windows.py holds its windowed loop): the same
    passes (more than one) and removed points, cameras and points within
    1e-8."""
    if windowed:
        host, plan = windowed_host(outliers=0.01)
        row_of, _, Wd, G, _ = plan
        jp = _jax_problem(host, plan)
        obs_pt = row_of[host["obs_pt"]]
        kw = dict(max_iters=8, min_outliers=2, window=Wd, group_pts=G)
        tp = T.build_problem(**host, schur_plan=plan, device="cpu")
    else:
        host = ba_host(C=6, P=300, outliers=0.02)
        jp, tp = both(host)
        row_of, obs_pt = np.arange(300), host["obs_pt"]
        kw = dict(max_iters=40, min_outliers=2)
    C = len(host["cam0"])
    cam_obs, cam_mask = J.build_cam_obs_table(
        host["obs_cam"], obs_pt, C, max_views=jp.views_mask.shape[1])
    with flags_and_counts({}) as rec:
        tr = T.run_ba_outlier_loop(tp, **kw)
    jr = J.run_ba_outlier_loop(jp, jnp.asarray(cam_obs),
                               jnp.asarray(cam_mask), **kw)
    assert int(jr.passes) == tr.passes > 1
    np.testing.assert_array_equal(np.asarray(jr.pt_removed)[row_of],
                                  tr.pt_removed.numpy())
    np.testing.assert_array_equal(np.asarray(jr.n_outliers), tr.n_outliers)
    close(np.asarray(jr.cam)[:C], tr.cam.numpy(), 1e-8)
    close(np.asarray(jr.R)[:C], tr.R.numpy(), 1e-8)
    close(np.asarray(jr.pts)[row_of], tr.pts.numpy(), 1e-8)
    assert rec["counts"] == dict(lm_iters=tr.iters, **NO_GRAPHS)
