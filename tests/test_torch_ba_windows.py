"""The port's covisibility-windowed Schur assembly against the JAX
package's, on the CPU in f64, from seeded numpy inputs.

Held:
  * `plan_schur_windows` and `plan_shard_windows` (D = 2, 3): every array
    of the plan equal to the JAX package's, every None where it returns
    None;
  * `assemble_schur_off` on one Y, W, g_p (random, seeded): the windowed
    S_off and rhs_off within 1e-12 of their largest entry of the JAX
    package's windowed ones (its problem built as
    `benchmarks/ba_vs_sba.py::run_ours` builds it) and of the port's own
    full-C form, with the plan on the true and on a padded camera count
    and with wide points;
    the chunked full-C form and the windowed form in batches of one group
    within 1e-12 of the one-shot forms;
  * `run_ba` (cholesky and cg) and `run_ba_outlier_loop` with a window,
    capped at 8 LM iterations, against the JAX ones with window /
    group_pts on the arc scene: the same iteration count (and passes and
    removed points), cameras and points within 1e-8 of the largest entry,
    costs within 1e-9 relative;
  * `run_sfm`: the planner called with the JAX package's arguments (so
    windows from 129 cameras); with the planner's threshold lowered, the
    windowed outlier loop within 1e-8 of the JAX package's with the same
    surviving points; with the fabricated plan of
    `tests/test_pipeline.py::test_run_sfm_windowed_planner_bookkeeping`,
    bit-identical to the port's own unplanned run (the port keeps the
    points' order), the same surviving points as the JAX package's, and
    within 1e-8 of the largest entry plus the move the plan causes in the
    JAX package's own result.

JAX is imported inside the tests only: `tests/test_torch_parallel.py`'s
ranks import `arc_sfm_state` from here.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import dataclasses
import functools

import numpy as np
import pytest
import torch

from bundler_sfm_tpu_torch.convert import (
    reconstruction_from_numpy, scene_from_numpy,
)
from bundler_sfm_tpu_torch.ops import ba as T
from bundler_sfm_tpu_torch.parallel import ba_sharded as TS
from bundler_sfm_tpu_torch.pipeline import incremental as T_inc
from bundler_sfm_tpu_torch.probes.ba_scale import FOCAL, synthesize

# The planner's threshold and widths lowered for a 48-camera arc.
SMALL = dict(min_cameras=16, windows=(8, 16))


def _close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.abs(a).max(), 1e-300)
    assert np.abs(a - b).max() <= rel * scale, np.abs(a - b).max() / scale


# --------------------------------------------------------------------------
# The planners
# --------------------------------------------------------------------------

def _runs(C, P, V, wide=0.0, seed=0):
    """Points seen by runs of V consecutive cameras (start uniform in
    [0, C − V]); a `wide` share of them also seen C/2 cameras away."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, C - V + 1, P)
    obs_cam = (start[:, None] + np.arange(V)).reshape(-1)
    obs_pt = np.repeat(np.arange(P), V)
    far = np.nonzero(rng.random(P) < wide)[0]
    obs_cam = np.concatenate([obs_cam, (start[far] + C // 2) % C])
    obs_pt = np.concatenate([obs_pt, far])
    return obs_cam, obs_pt, P, C, V + (len(far) > 0)


# name: (_runs arguments, planner keywords, plan expected)
PLAN_CASES = {
    "below-threshold": (dict(C=191, P=4000, V=8), {}, False),
    "at-threshold": (dict(C=192, P=4000, V=8), {}, True),
    "above-threshold": (dict(C=256, P=6000, V=8), {}, True),
    "end-clamp": (dict(C=200, P=4000, V=8), dict(windows=(32,)), True),
    "window-32": (dict(C=512, P=8000, V=8), dict(windows=(32,)), True),
    "window-64": (dict(C=512, P=8000, V=40), dict(windows=(64,)), True),
    "window-128": (dict(C=512, P=8000, V=8), dict(windows=(128,)), True),
    "long-runs": (dict(C=512, P=8000, V=40), {}, True),
    "narrow-and-wide": (dict(C=256, P=6000, V=8, wide=0.05), {}, True),
    "small-groups": (dict(C=256, P=20000, V=8), dict(group_budget=1 << 14),
                     True),
    "all-wide": (dict(C=256, P=3000, V=8, wide=1.0), {}, False),
    "padding-waste": (dict(C=512, P=40, V=8), {}, False),
    "no-points": (dict(C=256, P=0, V=8), {}, False),
    "windows-past-half": (dict(C=60, P=2000, V=8), dict(min_cameras=0),
                          False),
}


def _plans(case):
    from bundler_sfm_tpu.ops import ba as J
    args, kw, expect = PLAN_CASES[case]
    obs = _runs(**args)
    got, want = T.plan_schur_windows(*obs, **kw), J.plan_schur_windows(
        *obs, **kw)
    assert (got is not None) == (want is not None) == expect
    return got, want


def _same_tuple(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_schur_windows_matches_jax(case):
    got, want = _plans(case)
    if want is not None:
        _same_tuple(got, want)


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("case", [c for c, v in PLAN_CASES.items() if v[2]])
def test_plan_shard_windows_matches_jax(case, D):
    from bundler_sfm_tpu.parallel import ba_sharded as JS
    got, want = _plans(case)
    row_of, win, Wd, G, total = want
    _same_tuple(TS.plan_shard_windows(row_of, win, Wd, G, total, D),
                JS.plan_shard_windows(row_of, win, Wd, G, total, D))


# --------------------------------------------------------------------------
# The assembly
# --------------------------------------------------------------------------

def _arc(C=48, P=3000, V=4, num_cams=None, seed=0, wide=0.0):
    """synthesize()'s arc scene as host arrays, with the plan made on
    num_cams (default C) cameras under SMALL; a `wide` share of the points
    also seen C/2 cameras from their first view (its xy repeated), which
    makes them the plan's wide points."""
    (R, centers, centers_init, pts, pts_init, obs_cam, obs_pt,
     obs_xy) = synthesize(C, P, V, seed=seed)
    if wide:
        first = np.unique(obs_pt, return_index=True)[1]
        far = first[np.random.default_rng(seed).random(len(first)) < wide]
        obs_cam = np.concatenate([obs_cam, (obs_cam[far] + C // 2) % C])
        obs_pt = np.concatenate([obs_pt, obs_pt[far]])
        obs_xy = np.concatenate([obs_xy, obs_xy[far]])
    cam0 = np.zeros((C, 9))
    cam0[:, 0:3] = centers_init
    cam0[:, 6] = FOCAL
    plan = T.plan_schur_windows(obs_cam, obs_pt, len(pts_init),
                                num_cams or C, int(np.bincount(obs_pt).max()),
                                **SMALL)
    assert plan is not None
    host = dict(R0=R, cam0=cam0, pts0=pts_init, obs_cam=obs_cam,
                obs_pt=obs_pt, obs_xy=obs_xy)
    return host, plan


def _jax_problem(host, plan, pad_cams=None, **opts):
    """The JAX package's problem as ba_vs_sba.run_ours builds it: points
    at their plan rows, obs_pt remapped, schur_win set."""
    from bundler_sfm_tpu.ops import ba as J
    row_of, schur_win, _, _, total = plan
    pts = np.zeros((total, 3))
    pts[row_of] = host["pts0"]
    return J.build_problem(host["R0"], host["cam0"], pts, host["obs_cam"],
                           row_of[host["obs_pt"]], host["obs_xy"],
                           schur_win=schur_win, pad_cams=pad_cams, **opts)


def _random_blocks(host, seed=1):
    rng = np.random.default_rng(seed)
    O, P = len(host["obs_cam"]), len(host["pts0"])
    return (rng.normal(size=(O, 9, 3)), rng.normal(size=(O, 9, 3)),
            rng.normal(size=(P, 3)))


@pytest.mark.parametrize("cams", ["true", "padded", "wide"])
def test_windowed_schur_matches_jax_and_full(cams, monkeypatch):
    """The plan on 48 cameras, or on 56 (the JAX run_sfm plans on padded
    counts, so a window may reach past the last camera: clipped), or on 48
    with 5 % of the points wide (the full-C form beside the windows)."""
    import jax.numpy as jnp
    from bundler_sfm_tpu.ops import ba as J
    C = 48
    host, plan = _arc(C, num_cams=56 if cams == "padded" else None,
                      wide=0.05 if cams == "wide" else 0.0)
    row_of, starts, Wd, G, total = plan
    if cams == "padded":
        assert max(starts) + Wd > C
    assert (np.sum(row_of >= len(starts) * G) > 0) == (cams == "wide")
    Y, W, gp = _random_blocks(host)
    jp = _jax_problem(host, plan, pad_cams=56 if cams == "padded" else None)
    Cj = jp.cam0.shape[0]
    M = jp.views_mask.shape[1]
    sid = J.slot_ids(row_of[host["obs_pt"]], M)
    Yj, Wj = np.zeros((total * M, 9, 3)), np.zeros((total * M, 9, 3))
    Yj[sid], Wj[sid] = Y, W
    gpj = np.zeros((total, 3))
    gpj[row_of] = gp
    Sj, rj = J.assemble_schur_off(jnp.asarray(Yj), jnp.asarray(Wj),
                                  jnp.asarray(gpj), jp, Cj, window=Wd,
                                  group_pts=G)
    Sj = np.asarray(Sj).transpose(0, 2, 1, 3).reshape(Cj * 9, Cj * 9)
    tp = T.build_problem(**host, schur_plan=plan, device="cpu")
    args = (torch.as_tensor(Y), torch.as_tensor(W), torch.as_tensor(gp), tp,
            C)
    S, r = T.assemble_schur_off(*args, window=Wd, group_pts=G)
    _close(S.numpy(), Sj[:C * 9, :C * 9], 1e-12)
    _close(r.numpy(), np.asarray(rj)[:C], 1e-12)
    assert not Sj[C * 9:].any() and not Sj[:, C * 9:].any()
    S_full, r_full = T.assemble_schur_off(*args)
    _close(S.numpy(), S_full.numpy(), 1e-12)
    assert torch.equal(r, r_full)
    # One group a batch; the full-C form in chunks of 5 points (the table
    # holds a spare camera row for padding).
    monkeypatch.setattr(T, "SCHUR_TABLE_BYTES", 5 * (C + 1) * 27 * 8)
    S1, _ = T.assemble_schur_off(*args, window=Wd, group_pts=G)
    _close(S1.numpy(), S.numpy(), 1e-12)
    S5, _ = T.assemble_schur_off(*args)
    _close(S5.numpy(), S_full.numpy(), 1e-12)


def test_window_arguments_name_the_plan():
    host, plan = _arc(P=600)
    Y, W, gp = (torch.as_tensor(x) for x in _random_blocks(host))
    tp = T.build_problem(**host, schur_plan=plan, device="cpu")
    with pytest.raises(ValueError, match="window plan"):
        T.assemble_schur_off(Y, W, gp, tp, 48, plan[2] * 2, plan[3])
    with pytest.raises(ValueError, match="window plan"):
        T.assemble_schur_off(Y, W, gp, tp._replace(schur=None), 48,
                             plan[2], plan[3])
    # A window of C or more runs the full-C form, as the JAX gate does.
    P = len(host["pts0"])
    whole = T.build_problem(**host, schur_plan=(
        np.arange(P), np.zeros(1, np.int32), 48, P, P), device="cpu")
    S, _ = T.assemble_schur_off(Y, W, gp, whole, 48, 48, P)
    S_full, _ = T.assemble_schur_off(Y, W, gp, whole, 48)
    assert torch.equal(S, S_full)
    # A plan whose groups do not hold their points' cameras is refused.
    row_of, starts, Wd, G, total = plan
    with pytest.raises(ValueError, match="outside its window"):
        T.build_problem(**host, schur_plan=(row_of, starts + Wd, Wd, G,
                                            total), device="cpu")


# --------------------------------------------------------------------------
# The LM loop and the outlier loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_run_ba_windowed_matches_jax(solver):
    from bundler_sfm_tpu.ops import ba as J
    host, plan = _arc(P=1500)
    row_of, _, Wd, G, _ = plan
    jr = J.run_ba(_jax_problem(host, plan), max_iters=8, solver=solver,
                  window=Wd, group_pts=G)
    tp = T.build_problem(**host, schur_plan=plan, device="cpu")
    tr = T.run_ba(tp, max_iters=8, solver=solver, window=Wd, group_pts=G)
    assert int(jr.iters) == tr.iters == 8
    _close(float(jr.cost), float(tr.cost), 1e-9)
    _close(np.asarray(jr.cam), tr.cam.numpy(), 1e-8)
    _close(np.asarray(jr.R), tr.R.numpy(), 1e-8)
    _close(np.asarray(jr.pts)[row_of], tr.pts.numpy(), 1e-8)
    assert float(tr.cost) < 0.5 * float(tr.initial_cost)


def test_outlier_loop_windowed_matches_jax():
    import jax.numpy as jnp
    from bundler_sfm_tpu.ops import ba as J
    host, plan = _arc(P=1500)
    rng = np.random.default_rng(7)
    bad = rng.choice(len(host["pts0"]), 30, replace=False)
    sel = np.isin(host["obs_pt"], bad)
    host["obs_xy"][sel] += rng.uniform(40, 90, (sel.sum(), 2))
    row_of, _, Wd, G, total = plan
    jp = _jax_problem(host, plan)
    M = jp.views_mask.shape[1]
    cam_obs, cam_mask = J.build_cam_obs_table(
        host["obs_cam"], row_of[host["obs_pt"]], 48, max_views=M)
    kw = dict(max_iters=8, min_outliers=2, min_points=8, max_passes=4,
              window=Wd, group_pts=G)
    jr = J.run_ba_outlier_loop(jp, jnp.asarray(cam_obs),
                               jnp.asarray(cam_mask), **kw)
    tp = T.build_problem(**host, schur_plan=plan, device="cpu")
    tr = T.run_ba_outlier_loop(tp, **kw)
    assert int(jr.passes) == tr.passes >= 2
    assert int(jr.iters) == tr.iters
    jrem = np.asarray(jr.pt_removed)[row_of]
    assert jrem[bad].all()
    np.testing.assert_array_equal(tr.pt_removed.numpy(), jrem)
    _close(np.asarray(jr.cam), tr.cam.numpy(), 1e-8)
    _close(np.asarray(jr.pts)[row_of], tr.pts.numpy(), 1e-8)


# --------------------------------------------------------------------------
# run_sfm
# --------------------------------------------------------------------------

def arc_sfm_state(C=48, P=2000, V=4, n_bad=30, seed=0):
    """Host state of a run_sfm round on the arc scene: every camera
    registered at its perturbed start, every point with its views, keys
    numbered per camera in observation order; `n_bad` points with every
    observation moved by 40-90 px.  Returns (scene fields, recon
    fields, config overrides)."""
    (R, _, centers_init, _, pts_init, obs_cam, obs_pt,
     obs_xy) = synthesize(C, P, V, seed=seed)
    rng = np.random.default_rng(seed + 1)
    bad = rng.choice(len(pts_init), n_bad, replace=False)
    sel = np.isin(obs_pt, bad)
    obs_xy = obs_xy.copy()
    obs_xy[sel] += rng.uniform(40, 90, (sel.sum(), 2))
    key = np.zeros(len(obs_cam), np.int64)
    key_xy = []
    for c in range(C):
        mine = np.nonzero(obs_cam == c)[0]
        key[mine] = np.arange(len(mine))
        key_xy.append(obs_xy[mine])
    pt_views = [[] for _ in range(len(pts_init))]
    for o in range(len(obs_cam)):
        pt_views[obs_pt[o]].append((int(obs_cam[o]), int(key[o])))
    cam = np.zeros((C, 9))
    cam[:, 0:3] = centers_init
    cam[:, 6] = FOCAL
    names = [f"arc{c:03d}.jpg" for c in range(C)]
    scene = dict(names=names, dims=[(640, 480)] * C, key_xy=key_xy)
    recon = dict(added_order=list(range(C)), cam_R=list(R),
                 cam_params=list(cam), points=list(pts_init),
                 colors=[np.zeros(3)] * len(pts_init), pt_views=pt_views,
                 track_extra=np.full(len(pts_init), -1, np.int64),
                 key_extra=[{} for _ in range(C)])
    cfg = dict(sfm_max_iters=8, sfm_min_outliers=10)
    return scene, recon, cfg


def port_state(scene, recon, cfg, device="cpu", **more):
    """The port's Scene and Reconstruction of arc_sfm_state's fields."""
    from bundler_sfm_tpu_torch.config import default_pipeline_config
    from bundler_sfm_tpu_torch.io.listfile import ImageEntry
    entries = [ImageEntry(n, init_focal=FOCAL) for n in scene["names"]]
    ts = scene_from_numpy(entries, scene["dims"], scene["key_xy"], {},
                          default_pipeline_config(**cfg, **more),
                          device=device)
    return ts, reconstruction_from_numpy(**recon)


def _jax_state(scene, recon, cfg):
    import copy
    from bundler_sfm_tpu.config import default_pipeline_config
    from bundler_sfm_tpu.io.listfile import ImageEntry
    from bundler_sfm_tpu.pipeline.incremental import Reconstruction
    from bundler_sfm_tpu.pipeline.scene import Scene
    entries = [ImageEntry(n, init_focal=FOCAL) for n in scene["names"]]
    js = Scene(config=default_pipeline_config(**cfg), entries=entries,
               dims=list(scene["dims"]),
               key_xy=[k.copy() for k in scene["key_xy"]])
    return js, Reconstruction(**copy.deepcopy(recon))


def _same_recon(a, b, rel=1e-8):
    assert [len(v) for v in a.pt_views] == [len(v) for v in b.pt_views]
    for x, y in ((a.cam_params, b.cam_params), (a.cam_R, b.cam_R),
                 (a.points, b.points)):
        _close(np.stack(x), np.stack(y), rel)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("C", [128, 129])
def test_run_sfm_plans_as_jax(C, monkeypatch):
    """Both packages hand the planner the same arguments (the bucketed
    camera and view counts) and get the same plan: none at 128 cameras,
    one at 129 (where _bucket(C, 8) reaches min_cameras = 192)."""
    from bundler_sfm_tpu.ops import ba as J
    from bundler_sfm_tpu.pipeline import incremental as J_inc
    scene, recon, cfg = arc_sfm_state(C=C, P=600, V=8, n_bad=0)
    calls = {}

    def spy(name, planner):
        def call(*args, **kw):
            calls[name] = (args, kw, planner(*args, **kw))
            raise _Stop
        return call
    monkeypatch.setattr(J, "plan_schur_windows",
                        spy("jax", J.plan_schur_windows))
    monkeypatch.setattr(T, "plan_schur_windows",
                        spy("port", T.plan_schur_windows))
    js, jrec = _jax_state(scene, recon, cfg)
    ts, trec = port_state(scene, recon, cfg)
    with pytest.raises(_Stop):
        J_inc.run_sfm(jrec, js, verbose=False)
    with pytest.raises(_Stop):
        T_inc.run_sfm(trec, ts, verbose=False)
    (ja, jkw, jplan), (ta, tkw, tplan) = calls["jax"], calls["port"]
    assert jkw == tkw == {}
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(a, b)
    assert (jplan is None) == (C == 128) and (tplan is None) == (C == 128)
    if jplan is not None:
        _same_tuple(tplan, jplan)


def test_run_sfm_windowed_matches_jax(monkeypatch):
    """The planner's threshold lowered in both packages: the one-device
    windowed outlier loop of run_sfm, JAX against the port."""
    from bundler_sfm_tpu.ops import ba as J
    from bundler_sfm_tpu.pipeline import incremental as J_inc
    scene, recon, cfg = arc_sfm_state()
    monkeypatch.setattr(J, "plan_schur_windows",
                        functools.partial(J.plan_schur_windows, **SMALL))
    monkeypatch.setattr(T, "plan_schur_windows",
                        functools.partial(T.plan_schur_windows, **SMALL))
    js, jrec = _jax_state(scene, recon, cfg)
    ts, trec = port_state(scene, recon, cfg)
    before = T_inc.get_telemetry().counters.get("ba_schur_windowed", 0.0)
    ja = J_inc.run_sfm(jrec, js, verbose=False)
    ta = T_inc.run_sfm(trec, ts, verbose=False)
    assert T_inc.get_telemetry().counters["ba_schur_windowed"] > before
    removed = sum(1 for v in trec.pt_views if not v)
    assert removed >= 30
    _same_recon(jrec, trec)
    assert abs(ja - ta) <= 1e-8 * abs(ja)


def test_run_sfm_fabricated_plan_matches_jax(monkeypatch):
    """tests/test_pipeline.py:411's fabricated plan (a point-row
    permutation with 7 padding rows, one group of one point, window ==
    the padded camera count, so no window runs) in both packages, from
    the JAX package's initial-pair state of that test's scene."""
    import copy
    from bundler_sfm_tpu.config import default_pipeline_config
    from bundler_sfm_tpu.ops import ba as J
    from bundler_sfm_tpu.pipeline import incremental as J_inc
    from bundler_sfm_tpu.pipeline.verify import compute_geometric_constraints
    from tests.test_pipeline import make_pipeline_scene
    js, _ = make_pipeline_scene(
        np.random.default_rng(0), num_cams=5, num_pts=200,
        seed_cfg=default_pipeline_config(
            fmatrix_rounds=256, homography_rounds=64, projection_rounds=256,
            sfm_max_iters=30))
    compute_geometric_constraints(js, seed=3)
    i, j = J_inc.pick_initial_pair(js, True)
    jrec = J_inc.setup_initial_pair(js, i, j, seed=5)
    trec = reconstruction_from_numpy(**dataclasses.asdict(jrec))
    trec_plain = copy.deepcopy(trec)
    ts = scene_from_numpy(js.entries, js.dims, js.key_xy, js.matches,
                          dataclasses.asdict(js.config), device="cpu")
    calls = []

    def forced(oc, op, npts, ncams, mv, **kw):
        calls.append(ncams)
        total = npts + 7
        row_of = np.random.default_rng(0).permutation(total)[:npts] \
            .astype(np.int32)
        return row_of, np.zeros(1, np.int32), int(ncams), 1, total

    jrec_plain = copy.deepcopy(jrec)
    J_inc.run_sfm(jrec_plain, copy.deepcopy(js), verbose=False)
    T_inc.run_sfm(trec_plain, ts, verbose=False)
    monkeypatch.setattr(J, "plan_schur_windows", forced)
    monkeypatch.setattr(T, "plan_schur_windows", forced)
    J_inc.run_sfm(jrec, js, verbose=False)
    T_inc.run_sfm(trec, ts, verbose=False)
    assert len(calls) >= 2
    _same_recon(trec_plain, trec, 0.0)
    # The JAX package's own result moves with the plan's point order (its
    # sums follow the slot layout; two cameras leave the gauge weak): hold
    # the port within that move plus 1e-8 of the largest entry.
    assert [len(v) for v in jrec.pt_views] == [len(v) for v in trec.pt_views]
    for f in ("cam_params", "cam_R", "points"):
        a, b, a0 = (np.stack(getattr(r, f)) for r in (jrec, trec, jrec_plain))
        assert np.abs(a - b).max() <= np.abs(a - a0).max() + \
            1e-8 * np.abs(a).max(), f
