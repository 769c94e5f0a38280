"""The port's multi-device paths (`bundler_sfm_tpu_torch/parallel/`) against
the JAX package's on the CPU: the port runs D ranks (spawned processes in
one gloo group, one group per world size for the whole module, meeting at
a FileStore under a temporary directory), the JAX package its 8-device
virtual mesh cut to D (`tests/conftest.py`).  JAX is imported inside the
tests only, so the ranks never load it.

`Mesh` itself is held on a mock of torch.distributed that records each
call (gloo stages collectives through the host, NCCL does not; the ring
sends to rank - 1).

Tolerances:
  * matching (the ring, the pair-split table, match_pairs_sharded):
    dicts identical to the JAX package's and to the port's one-device
    DescriptorTable;
  * shard_problem / build_cam_obs_table_sharded / unshard_*: the arrays
    equal the JAX package's, through its slot layout (row p·M + k of
    shard s holds the k-th observation of local point p);
  * run_ba_sharded (cholesky and cg) capped at 8 LM iterations and the
    outlier loop (l2 with cholesky; Huber with cg at D = 2), f64, against
    the JAX package at the same D: the same iterations (the capped runs)
    and passes, identical removed points; cameras and points within 1e-8
    of the largest entry (points within 1e-7 under Huber and cg: the JAX
    package's own D = 1, 4 and 8 results spread 7.4e-8 from D = 2 there),
    costs within 1e-9 relative; per-camera stats within rtol 1e-6;
  * D = 1 (a one-rank group in this process): the sharded BA (cholesky)
    and outlier loop bit-identical to the unsharded functions, the ring
    and the pair-split table to DescriptorTable;
  * the covisibility-windowed assembly at D = 2 (plan_shard_windows'
    layout): the shard layout equal to the JAX package's; run_ba_sharded,
    the outlier loop and run_sfm's D > 1 branch within 1e-9 of the
    one-device windowed runs (cameras and points, of the largest entry),
    with the same iterations, passes and removed points;
  * run_bundler.main at world 2 on an 8-view 320x240 render: the same
    registered cameras as at world 1, both ranks holding identical
    cameras, and files from rank 0 only.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import datetime
import os
import pickle
import queue
import shutil
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tests.synthetic import Scene, random_rotation

from bundler_sfm_tpu_torch.ops import ba as TB
from bundler_sfm_tpu_torch.ops.matching import DescriptorTable
from bundler_sfm_tpu_torch.parallel import ba_sharded as TS
from bundler_sfm_tpu_torch.parallel.matching_sharded import (
    ShardedDescriptorTable, match_pairs_sharded,
)
from bundler_sfm_tpu_torch.parallel.mesh import Mesh, make_mesh

GROUP_TIMEOUT_S = 120
JOB_TIMEOUT_S = 300


# --------------------------------------------------------------------------
# Ranks: D spawned processes in one gloo group, serving jobs
# --------------------------------------------------------------------------

def _serve(rank, size, store_path, inbox, outbox):
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, size), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mesh = Mesh(dist.group.WORLD, torch.device("cpu"))
    for fn, args in iter(inbox.get, None):
        outbox.put((rank, pickle.dumps(fn(mesh, *args))))
    dist.destroy_process_group()


class _Ranks:
    def __init__(self, size, store_dir):
        ctx = mp.get_context("spawn")
        self.size = size
        self.inboxes = [ctx.Queue() for _ in range(size)]
        self.outbox = ctx.Queue()
        path = os.path.join(store_dir, "store")
        self.procs = [ctx.Process(target=_serve, daemon=True, args=(
            r, size, path, self.inboxes[r], self.outbox))
            for r in range(size)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args):
        """fn(mesh, *args) on every rank; the results in rank order."""
        for q in self.inboxes:
            q.put((fn, args))
        got, deadline = {}, time.time() + JOB_TIMEOUT_S
        while len(got) < self.size:
            try:
                rank, out = self.outbox.get(timeout=1.0)
                got[rank] = pickle.loads(out)
            except queue.Empty:
                assert all(p.is_alive() for p in self.procs), "a rank died"
                assert time.time() < deadline, "the ranks timed out"
        return [got[r] for r in range(self.size)]

    def close(self):
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)
        assert not any(p.is_alive() for p in self.procs)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    made = {}

    def get(size):
        if size not in made:
            made[size] = _Ranks(size, str(tmp_path_factory.mktemp(
                f"store{size}")))
        return made[size]
    yield get
    for r in made.values():
        r.close()


@pytest.fixture
def one_rank():
    """A one-rank gloo group in this process."""
    mesh = make_mesh(1, device="cpu", timeout=GROUP_TIMEOUT_S)
    yield mesh
    dist.destroy_process_group()


def _jax_mesh(size):
    from bundler_sfm_tpu.parallel.mesh import make_mesh as jax_make_mesh
    return jax_make_mesh(size)


def _same_dicts(a, b):
    assert list(a) == list(b) or set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


# --------------------------------------------------------------------------
# Mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_mesh_collectives_on_a_recording_group(backend, monkeypatch):
    """Mesh on a CUDA device, against a mock of torch.distributed that
    records each call: a gloo group gets host copies of every tensor (bool
    as uint8), an NCCL group the tensors on their device; ring_shift sends
    to rank - 1 and receives from rank + 1; results come back in the
    caller's dtype."""
    calls = []
    D, me = 4, 1

    def record(op):
        def fn(*a, **k):
            tensors = [t for t in a if torch.is_tensor(t)]
            tensors += [t for t in (a[0] if a and isinstance(a[0], list)
                                    else []) if torch.is_tensor(t)]
            calls.append((op, tensors))
        return fn

    def all_gather(parts, w, group=None):
        calls.append(("all_gather", [w]))
        for i, t in enumerate(parts):
            t.copy_(w + i)

    class Req:
        def wait(self):
            pass

    def batch_isend_irecv(ops):
        calls.append(("p2p", [(o.op.__name__, o.peer, o.tensor.device)
                              for o in ops]))
        return [Req() for _ in ops]
    class P2POp:
        def __init__(self, op, tensor, peer, group=None):
            self.op, self.tensor, self.peer = op, tensor, peer
    m = dist
    monkeypatch.setattr(m, "P2POp", P2POp)
    monkeypatch.setattr(m, "get_rank", lambda g=None: me)
    monkeypatch.setattr(m, "get_world_size", lambda g=None: D)
    monkeypatch.setattr(m, "get_backend", lambda g=None: backend)
    monkeypatch.setattr(m, "get_global_rank", lambda g, r: r)
    monkeypatch.setattr(m, "all_reduce", record("all_reduce"))
    monkeypatch.setattr(m, "broadcast", record("broadcast"))
    monkeypatch.setattr(m, "all_gather", all_gather)
    monkeypatch.setattr(m, "batch_isend_irecv", batch_isend_irecv)
    mesh = Mesh(object(), "cuda")
    assert mesh._via_host == (backend == "gloo")
    # Where the wire copy goes, shown on a device-less ("meta") tensor: an
    # NCCL group keeps it on its device; a gloo group copies it to the host,
    # which a meta tensor refuses.
    meta = torch.zeros(3, device="meta")
    if backend == "nccl":
        assert mesh._wire(meta).device.type == "meta"
    else:
        with pytest.raises(NotImplementedError):
            mesh._wire(meta)
    x = torch.arange(6.0).reshape(2, 3)
    flags = torch.tensor([True, False])
    assert torch.equal(mesh.psum(x), x)
    assert mesh.all_gather(flags, 0).dtype == torch.bool
    assert mesh.all_gather(x, 1).shape == (2, 12)
    assert mesh.ring_shift(x).shape == x.shape
    assert torch.equal(mesh.broadcast(x), x)
    wired = [t for op, ts in calls if op != "p2p" for t in ts]
    assert all(t.device.type == "cpu" for t in wired)
    assert all(t is not x and t is not flags for t in wired)
    assert [t.dtype for op, ts in calls if op == "all_gather"
            for t in ts] == [torch.uint8, torch.float32]
    (_, p2p), = [c for c in calls if c[0] == "p2p"]
    assert [(o, peer) for o, peer, _ in p2p] == [("isend", (me - 1) % D),
                                                  ("irecv", (me + 1) % D)]


# --------------------------------------------------------------------------
# Matching
# --------------------------------------------------------------------------

def _descs(n_images, seed=0):
    """uint8 descriptors with shared clusters (tests/test_matching.py's
    make_descs), key counts 96 + 5·i; every fifth image (5, 10) shares
    none, so its pairs have no match."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (120, 128))
    out = []
    for i in range(n_images):
        d = rng.integers(0, 256, (96 + 5 * i, 128))
        if i % 5 or i == 0:
            d[:50] = np.clip(base[:50] + rng.integers(-4, 5, (50, 128)), 0,
                             255)
        out.append(d[rng.permutation(len(d))].astype(np.uint8))
    return out


def _ring_job(mesh, descs, pairs):
    ring = ShardedDescriptorTable(descs, mesh, block=128)
    return dict(all=ring.match_all_pairs(min_matches=1),
                banded0=ring.match_pairs(pairs, min_matches=0),
                banded16=ring.match_pairs(pairs, min_matches=16))


@pytest.mark.parametrize("size", [2, 4])
def test_ring_matcher_matches_jax_and_one_device(size, ranks):
    from bundler_sfm_tpu.parallel.matching_sharded import (
        ShardedDescriptorTable as JaxRing,
    )
    descs = _descs(13)       # 13 images: the last shard is padded
    allp = [(i, j) for i in range(13) for j in range(i + 1, 13)]
    pairs = [(j, i) for i in range(13) for j in range(max(0, i - 3), i)]
    one = DescriptorTable(descs, device="cpu")
    jring = JaxRing(descs, _jax_mesh(size), block=128)
    want = {"all": jring.match_all_pairs(min_matches=1),
            "banded0": jring.match_pairs(pairs, min_matches=0),
            "banded16": jring.match_pairs(pairs, min_matches=16)}
    _same_dicts(want["all"], one.match_pairs(allp, min_matches=1))
    _same_dicts(want["banded0"], one.match_pairs(pairs, min_matches=0))
    assert any(len(m) == 0 for m in want["banded0"].values())
    for got in ranks(size).run(_ring_job, descs, pairs):
        for k in want:
            _same_dicts(got[k], want[k])


def _table_job(mesh, descs, pairs):
    return dict(table=DescriptorTable(descs, mesh=mesh).match_pairs(
        pairs, min_matches=0, batch=7),
        sharded=match_pairs_sharded(descs, pairs, mesh, min_matches=0,
                                    pairs_per_device=2))


@pytest.mark.parametrize("size", [2, 4])
def test_pair_split_matching_matches_jax_and_one_device(size, ranks):
    from bundler_sfm_tpu.ops.matching import DescriptorTable as JaxTable
    from bundler_sfm_tpu.parallel.matching_sharded import (
        match_pairs_sharded as jax_match_pairs_sharded,
    )
    descs = _descs(7, seed=1)
    pairs = [(i, j) for i in range(7) for j in range(i + 1, 7)]
    one = DescriptorTable(descs, device="cpu").match_pairs(pairs,
                                                           min_matches=0)
    jmesh = _jax_mesh(size)
    _same_dicts(JaxTable(descs, block=128, mesh=jmesh).match_pairs(
        pairs, min_matches=0), one)
    _same_dicts(jax_match_pairs_sharded(descs, pairs, jmesh, block=128,
                                        min_matches=0, pairs_per_device=2),
                one)
    for got in ranks(size).run(_table_job, descs, pairs):
        _same_dicts(got["table"], one)
        _same_dicts(got["sharded"], one)


# --------------------------------------------------------------------------
# Bundle adjustment
# --------------------------------------------------------------------------

def _ba_inputs(seed=0, C=4, P=100):
    """tests/test_parallel.py's _make_ba_inputs (every point in every
    camera) with 0.3 px of noise, so the cost stays well above rounding,
    and a focal prior."""
    rng = np.random.default_rng(seed)
    sc = Scene(rng, num_cams=C, num_pts=P, noise=0.3)
    R0 = np.stack([random_rotation(rng, 0.02) @ sc.R[i] for i in range(C)])
    cam0 = np.zeros((C, 9))
    cam0[:, 0:3] = sc.centers + rng.normal(size=(C, 3)) * 0.02
    cam0[:, 6] = sc.f
    pts0 = sc.points + rng.normal(size=sc.points.shape) * 0.03
    oc, op = np.nonzero(np.ones((C, P), bool))
    oxy = np.stack([sc.obs[c][p] for c, p in zip(oc, op)])
    cc = np.zeros((C, 9)); cc[:, 6] = 1.0
    ct = np.zeros((C, 9)); ct[:, 6] = sc.f
    cw = np.zeros((C, 9)); cw[:, 6] = 1e-3
    return dict(R0=R0, cam0=cam0, pts0=pts0, obs_cam=oc, obs_pt=op,
                obs_xy=oxy), dict(est_distortion=False, cam_constrained=cc,
                                  cam_constraints=ct, cam_weights=cw)


def _outlier_inputs(seed=0, C=4, P=160):
    """tests/test_parallel.py's outlier-loop scene: noise 0.5 px, 10
    points with every observation moved by 60-120 px."""
    rng = np.random.default_rng(seed)
    sc = Scene(rng, num_cams=C, num_pts=P, noise=0.5)
    cam0 = np.zeros((C, 9))
    cam0[:, 0:3] = sc.centers
    cam0[:, 6] = sc.f
    oc, op = np.nonzero(np.ones((C, P), bool))
    oxy = np.stack([sc.obs[c][p] for c, p in zip(oc, op)])
    bad = rng.choice(P, 10, replace=False)
    sel = np.isin(op, bad)
    oxy[sel] += rng.uniform(60, 120, (sel.sum(), 2))
    pts0 = sc.points + rng.normal(size=sc.points.shape) * 0.02
    return dict(R0=np.stack(sc.R[:C]), cam0=cam0, pts0=pts0, obs_cam=oc,
                obs_pt=op, obs_xy=oxy), dict(est_distortion=False), bad


def _close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.abs(a).max(), 1e-300)
    assert np.abs(a - b).max() <= rel * scale, np.abs(a - b).max() / scale


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _layout_job(mesh, host, opts):
    prob = TS.shard_problem(mesh=mesh, **host, **opts)
    co = TS.build_cam_obs_table_sharded(host["obs_cam"], host["obs_pt"],
                                        mesh, len(host["cam0"]))
    P = len(host["pts0"])
    return dict(pts0=_np(prob.pts0), obs_cam=_np(prob.obs_cam),
                obs_pt=_np(prob.obs_pt), obs_xy=_np(prob.obs_xy),
                cam_weights=_np(prob.cam_weights), cam_obs=_np(co),
                pts=TS.unshard_points(prob.pts0, mesh, P),
                flat=TS.unshard_flat(prob.pt_constrained > -1, mesh, P),
                mapped=TS.unshard_with_map(
                    prob.pts0, mesh, np.arange(P) % mesh.size,
                    np.arange(P) // mesh.size))


@pytest.mark.parametrize("size", [2, 4])
def test_shard_layout_matches_jax(size, ranks):
    from bundler_sfm_tpu.parallel import ba_sharded as JS
    host, opts = _ba_inputs(C=3, P=23)
    rng = np.random.default_rng(5)
    keep = rng.random(len(host["obs_cam"])) < 0.8       # ragged views
    host = dict(host, **{k: host[k][keep] for k in ("obs_cam", "obs_pt",
                                                     "obs_xy")})
    C, P = len(host["cam0"]), len(host["pts0"])
    jp = JS.shard_problem(num_shards=size, **host, **opts)
    Pp, M = jp.views_mask.shape[1:]
    jco, jcm = JS.build_cam_obs_table_sharded(
        host["obs_cam"], host["obs_pt"], size, C, Pp, M)
    for s, got in enumerate(ranks(size).run(_layout_job, host, opts)):
        np.testing.assert_array_equal(got["pts0"], np.asarray(jp.pts0[s]))
        np.testing.assert_array_equal(got["cam_weights"],
                                      np.asarray(jp.cam_weights))
        # The port keeps the shard's observations in input order; the JAX
        # package at slot row (local point)·M + (k-th view of it).
        sid = got["obs_pt"] * M + TB._slot_within(got["obs_pt"])
        assert np.asarray(jp.obs_valid[s]).sum() == len(sid)
        for f in ("obs_cam", "obs_xy"):
            np.testing.assert_array_equal(got[f], np.asarray(
                getattr(jp, f)[s])[sid])
        np.testing.assert_array_equal(
            got["obs_pt"], np.asarray(jp.obs_pt[s])[sid])
        co = got["cam_obs"]
        assert co.shape == jco[s].shape
        mask = co < len(sid)
        np.testing.assert_array_equal(mask, jcm[s])
        np.testing.assert_array_equal(sid[co[mask]], jco[s][mask])
        np.testing.assert_array_equal(got["pts"], host["pts0"])
        np.testing.assert_array_equal(got["pts"], JS.unshard_points(
            np.asarray(jp.pts0), P))
        np.testing.assert_array_equal(got["mapped"], host["pts0"])
        assert got["flat"].all() and got["flat"].shape == (P,)


def _ba_job(mesh, host, opts, kw):
    prob = TS.shard_problem(mesh=mesh, **host, **opts)
    r = TS.run_ba_sharded(prob, mesh, **kw)
    return dict(cam=_np(r.cam), R=_np(r.R), cost=float(r.cost),
                cost0=float(r.initial_cost), iters=r.iters,
                pts=TS.unshard_points(r.pts, mesh, len(host["pts0"])))


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_run_ba_sharded_matches_jax(size, solver, ranks):
    from bundler_sfm_tpu.parallel import ba_sharded as JS
    host, opts = _ba_inputs()
    kw = dict(max_iters=8, solver=solver)
    jr = JS.run_ba_sharded(JS.shard_problem(num_shards=size, **host, **opts),
                           _jax_mesh(size), **kw)
    jpts = JS.unshard_points(np.asarray(jr.pts), len(host["pts0"]))
    for got in ranks(size).run(_ba_job, host, opts, kw):
        assert got["iters"] == int(jr.iters) == 8
        _close(got["cam"], jr.cam, 1e-8)
        _close(got["R"], jr.R, 1e-8)
        _close(got["pts"], jpts, 1e-8)
        for k, j in (("cost", jr.cost), ("cost0", jr.initial_cost)):
            assert abs(got[k] - float(j)) <= 1e-9 * abs(float(j)), k


def _outlier_job(mesh, host, opts, kw):
    prob = TS.shard_problem(mesh=mesh, **host, **opts)
    co = TS.build_cam_obs_table_sharded(host["obs_cam"], host["obs_pt"],
                                        mesh, len(host["cam0"]))
    r = TS.run_ba_outlier_loop_sharded(prob, co, mesh, **kw)
    P = len(host["pts0"])
    return dict(cam=_np(r.cam), passes=r.passes, stats=_np(r.stats),
                hist=_np(r.hist), n_out=_np(r.n_outliers),
                pts=TS.unshard_points(r.pts, mesh, P),
                removed=TS.unshard_flat(r.pt_removed, mesh, P))


def _check_outlier_loop_against_jax(size, ranks, kw, pts_rel=1e-8):
    import jax.numpy as jnp
    from bundler_sfm_tpu.parallel import ba_sharded as JS
    host, opts, bad = _outlier_inputs()
    C, P = len(host["cam0"]), len(host["pts0"])
    jp = JS.shard_problem(num_shards=size, **host, **opts)
    Pp, M = jp.views_mask.shape[1:]
    jco, jcm = JS.build_cam_obs_table_sharded(
        host["obs_cam"], host["obs_pt"], size, C, Pp, M)
    jr = JS.run_ba_outlier_loop_sharded(jp, jnp.asarray(jco),
                                        jnp.asarray(jcm), _jax_mesh(size),
                                        **kw)
    jrem = JS.unshard_flat(np.asarray(jr.pt_removed), P)
    assert jrem[bad].all()
    for got in ranks(size).run(_outlier_job, host, opts, kw):
        assert got["passes"] == int(jr.passes)
        np.testing.assert_array_equal(got["removed"], jrem)
        np.testing.assert_array_equal(got["n_out"], np.asarray(
            jr.n_outliers))
        _close(got["cam"], jr.cam, 1e-8)
        _close(got["pts"], JS.unshard_points(np.asarray(jr.pts), P),
               pts_rel)
        np.testing.assert_array_equal(got["hist"], np.asarray(jr.hist))
        np.testing.assert_array_equal(got["stats"][..., 0],
                                      np.asarray(jr.stats)[..., 0])
        np.testing.assert_allclose(got["stats"], np.asarray(jr.stats),
                                   rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("size", [2, 4])
def test_outlier_loop_sharded_matches_jax(size, ranks):
    _check_outlier_loop_against_jax(size, ranks, dict(
        max_iters=50, min_outliers=2, max_passes=4))


def test_outlier_loop_sharded_huber_cg_matches_jax(ranks):
    """The outlier loop as run_sfm runs it under use_ceres past
    ceres_dense_max_cameras: Huber loss and the matrix-free sharded PCG.
    PCG stops at a relative residual of 1e-8, so the points carry that
    solve's error: the JAX package's own results at D = 1, 4 and 8 differ
    from its D = 2 result by 2.5e-8 to 7.4e-8 of the largest point
    coordinate, and the points are held within 1e-7."""
    _check_outlier_loop_against_jax(2, ranks, dict(
        max_iters=50, min_outliers=2, max_passes=4, loss="huber",
        huber_param=25.0, solver="cg"), pts_rel=1e-7)


def test_one_rank_is_bit_identical(one_rank):
    """At D = 1 the sharded BA and outlier loop (cholesky), the ring and
    the pair-split table give exactly the unsharded results: a sum over
    one rank is the identity."""
    mesh = one_rank
    host, opts, _ = _outlier_inputs(seed=3)
    prob1 = TB.build_problem(**host, **opts, device="cpu")
    probS = TS.shard_problem(mesh=mesh, **host, **opts)
    co = TS.build_cam_obs_table_sharded(host["obs_cam"], host["obs_pt"],
                                        mesh, len(host["cam0"]))
    assert torch.equal(co, prob1.cam_views)
    a = TB.run_ba(prob1, max_iters=20)
    b = TS.run_ba_sharded(probS, mesh, max_iters=20)
    for f in ("cam", "R", "pts", "cost", "initial_cost", "mu"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.iters == b.iters
    kw = dict(max_iters=50, min_outliers=2, max_passes=4)
    a = TB.run_ba_outlier_loop(prob1, **kw)
    b = TS.run_ba_outlier_loop_sharded(probS, co, mesh, **kw)
    for f in ("cam", "R", "pts", "obs_valid", "pt_removed", "stats", "hist",
              "hist_edges", "avg_dist", "cost", "initial_cost"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.passes, a.iters, a.too_few) == (b.passes, b.iters, b.too_few)
    np.testing.assert_array_equal(a.n_outliers, b.n_outliers)
    descs = _descs(6, seed=2)
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    want = DescriptorTable(descs, device="cpu").match_pairs(pairs,
                                                            min_matches=0)
    _same_dicts(ShardedDescriptorTable(descs, mesh, block=128).match_pairs(
        pairs, min_matches=0), want)
    _same_dicts(DescriptorTable(descs, mesh=mesh).match_pairs(
        pairs, min_matches=0), want)


# --------------------------------------------------------------------------
# The covisibility-windowed assembly over ranks (plan_shard_windows)
# --------------------------------------------------------------------------

def _windowed_inputs():
    """tests/test_torch_ba_windows.py's 48-camera arc with its plan and
    that plan split over 2 ranks."""
    from tests.test_torch_ba_windows import _arc
    host, plan = _arc(P=1500)
    split = TS.plan_shard_windows(*plan, 2)
    return host, plan, split


def _windowed_layout_job(mesh, host, plan, split):
    shard_of, local_idx, sw_local, _ = split
    prob = TS.shard_problem(mesh=mesh, **host, shard_of_pt=shard_of,
                            local_idx=local_idx, schur_win_local=sw_local,
                            window=plan[2], group_pts=plan[3])
    co = TS.build_cam_obs_table_sharded(host["obs_cam"], host["obs_pt"],
                                        mesh, len(host["cam0"]),
                                        shard_of_pt=shard_of)
    return dict(pts0=_np(prob.pts0), obs_cam=_np(prob.obs_cam),
                obs_pt=_np(prob.obs_pt), obs_xy=_np(prob.obs_xy),
                cam_obs=_np(co), starts=prob.schur.starts,
                mapped=TS.unshard_with_map(prob.pts0, mesh, shard_of,
                                           local_idx))


def test_shard_layout_windowed_matches_jax(ranks):
    """shard_problem / build_cam_obs_table_sharded under plan_shard_windows'
    explicit layout against the JAX package's, as
    test_shard_layout_matches_jax holds the round-robin one."""
    from bundler_sfm_tpu.parallel import ba_sharded as JS
    host, plan, split = _windowed_inputs()
    shard_of, local_idx, sw_local, rows = split
    C = len(host["cam0"])
    jp = JS.shard_problem(num_shards=2, **host, pad_pts_per_shard=rows,
                          shard_of_pt=shard_of, local_idx=local_idx,
                          schur_win_local=sw_local)
    Pp, M = jp.views_mask.shape[1:]
    jco, jcm = JS.build_cam_obs_table_sharded(
        host["obs_cam"], host["obs_pt"], 2, C, Pp, M, shard_of_pt=shard_of,
        local_idx=local_idx)
    for s, got in enumerate(ranks(2).run(_windowed_layout_job, host, plan,
                                         split)):
        n = len(got["pts0"])
        np.testing.assert_array_equal(got["pts0"], np.asarray(jp.pts0[s])[:n])
        assert not np.asarray(jp.pts0[s])[n:].any()
        sid = got["obs_pt"] * M + TB._slot_within(got["obs_pt"])
        assert np.asarray(jp.obs_valid[s]).sum() == len(sid)
        for f in ("obs_cam", "obs_xy", "obs_pt"):
            np.testing.assert_array_equal(got[f], np.asarray(
                getattr(jp, f)[s])[sid])
        co = got["cam_obs"]
        mask = co < len(sid)
        np.testing.assert_array_equal(mask, jcm[s][:, :co.shape[1]])
        assert not jcm[s][:, co.shape[1]:].any()
        np.testing.assert_array_equal(sid[co[mask]], jco[s][:, :co.shape[1]]
                                      [mask])
        assert got["starts"] == tuple(int(v) for v in sw_local[s])
        np.testing.assert_array_equal(got["mapped"], host["pts0"])


def _windowed_ba_job(mesh, host, plan, split, kw, outlier):
    shard_of, local_idx, sw_local, _ = split
    prob = TS.shard_problem(mesh=mesh, **host, shard_of_pt=shard_of,
                            local_idx=local_idx, schur_win_local=sw_local,
                            window=plan[2], group_pts=plan[3])
    win = dict(window=plan[2], group_pts=plan[3])
    if outlier:
        co = TS.build_cam_obs_table_sharded(
            host["obs_cam"], host["obs_pt"], mesh, len(host["cam0"]),
            shard_of_pt=shard_of)
        r = TS.run_ba_outlier_loop_sharded(prob, co, mesh, **kw, **win)
        extra = dict(passes=r.passes, removed=TS.unshard_with_map(
            r.pt_removed, mesh, shard_of, local_idx))
    else:
        r = TS.run_ba_sharded(prob, mesh, **kw, **win)
        extra = {}
    return dict(cam=_np(r.cam), R=_np(r.R), cost=float(r.cost),
                iters=r.iters, **extra,
                pts=TS.unshard_with_map(r.pts, mesh, shard_of, local_idx))


@pytest.mark.parametrize("loop", ["run_ba", "outlier_loop"])
def test_windowed_sharded_ba_matches_one_device(loop, ranks):
    """Each rank's windowed assembly over its own groups, S_off summed over
    2 ranks over gloo, against the one-device windowed BA: cameras and
    points within 1e-9 of the largest entry, the cost within 1e-9
    relative, the same iterations (and passes and removed points)."""
    host, plan, split = _windowed_inputs()
    win = dict(window=plan[2], group_pts=plan[3])
    prob = TB.build_problem(**host, schur_plan=plan, device="cpu")
    if loop == "outlier_loop":
        rng = np.random.default_rng(7)
        bad = rng.choice(len(host["pts0"]), 30, replace=False)
        sel = np.isin(host["obs_pt"], bad)
        host["obs_xy"][sel] += rng.uniform(40, 90, (sel.sum(), 2))
        prob = TB.build_problem(**host, schur_plan=plan, device="cpu")
        kw = dict(max_iters=8, min_outliers=2, max_passes=4)
        want = TB.run_ba_outlier_loop(prob, **kw, **win)
        assert want.passes >= 2 and want.pt_removed.numpy()[bad].all()
    else:
        kw = dict(max_iters=8)
        want = TB.run_ba(prob, **kw, **win)
    for got in ranks(2).run(_windowed_ba_job, host, plan, split, kw,
                            loop == "outlier_loop"):
        assert got["iters"] == want.iters
        _close(got["cam"], want.cam.numpy(), 1e-9)
        _close(got["R"], want.R.numpy(), 1e-9)
        _close(got["pts"], want.pts.numpy(), 1e-9)
        assert abs(got["cost"] - float(want.cost)) <= 1e-9 * float(want.cost)
        if loop == "outlier_loop":
            assert got["passes"] == want.passes
            np.testing.assert_array_equal(got["removed"],
                                          want.pt_removed.numpy())


def _run_sfm_windowed(mesh=None):
    """run_sfm on tests/test_torch_ba_windows.py's arc state with the
    planner's threshold lowered (in this process), at world mesh.size or
    on one device; the cameras, points and live views."""
    import functools
    from tests.test_torch_ba_windows import SMALL, arc_sfm_state, port_state
    from bundler_sfm_tpu_torch.pipeline import incremental
    scene, recon, cfg = arc_sfm_state()
    ts, trec = port_state(scene, recon, cfg,
                          num_devices=1 if mesh is None else mesh.size)
    counters = incremental.get_telemetry().counters
    before = counters.get("ba_schur_windowed", 0.0)
    real = TB.plan_schur_windows
    TB.plan_schur_windows = functools.partial(real, **SMALL)
    try:
        incremental.run_sfm(trec, ts, verbose=False)
    finally:
        TB.plan_schur_windows = real
    return dict(cams=np.stack(trec.cam_params), R=np.stack(trec.cam_R),
                pts=np.stack(trec.points),
                views=[len(v) for v in trec.pt_views],
                windowed=counters["ba_schur_windowed"] - before)


def _run_sfm_windowed_job(mesh):
    return _run_sfm_windowed(mesh)


def test_run_sfm_sharded_windowed_matches_one_device(ranks):
    """run_sfm's D > 1 branch with a plan (plan_shard_windows' layout, the
    windowed assembly on each rank) against its one-device branch: the
    same surviving points, cameras and points within 1e-9 of the largest
    entry, both ranks identical."""
    want = _run_sfm_windowed()
    got = ranks(2).run(_run_sfm_windowed_job)
    for k in ("cams", "R", "pts"):
        np.testing.assert_array_equal(got[0][k], got[1][k])
    assert got[0]["views"] == want["views"]
    assert want["windowed"] == got[0]["windowed"] == got[1]["windowed"] > 0
    assert sum(v == 0 for v in want["views"]) >= 30
    for k in ("cams", "R", "pts"):
        _close(got[0][k], want[k], 1e-9)


# --------------------------------------------------------------------------
# The whole pipeline
# --------------------------------------------------------------------------

RB_ARGS = ["--device", "cpu", "--init_focal", "160", "--max_keys", "1024"]


def _in_dir(workdir, call, module, name):
    """call() in `workdir` with module.name wrapped to keep what it
    returns; (call's result, the value kept, the files in workdir)."""
    real, box = getattr(module, name), {}

    def wrapped(*a, **k):
        box["out"] = real(*a, **k)
        return box["out"]
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    setattr(module, name, wrapped)
    try:
        rc = call()
    finally:
        setattr(module, name, real)
        os.chdir(cwd)
    files = sorted(os.path.relpath(os.path.join(d, f), workdir)
                   for d, _, fs in os.walk(workdir) for f in fs)
    return rc, box["out"], files


def _summary(rec):
    return dict(order=list(rec.added_order), cams=np.stack(rec.cam_params),
                R=np.stack(rec.cam_R),
                points=sum(1 for v in rec.pt_views if v))


def _run_bundler(workdir, imgs, extra=()):
    """run_bundler.main in `workdir`; (rc, the reconstruction, the files
    written there)."""
    from bundler_sfm_tpu_torch import run_bundler
    from bundler_sfm_tpu_torch.pipeline import incremental
    rc, rec, files = _in_dir(
        workdir, lambda: run_bundler.main([imgs] + RB_ARGS + list(extra)),
        incremental, "bundle_adjust_fast")
    return rc, _summary(rec), files


def _run_bundler_job(mesh, workdir, imgs):
    return _run_bundler(os.path.join(workdir, f"rank{mesh.rank}"), imgs,
                        ["--num_devices", str(mesh.size)])


def test_run_bundler_two_ranks(ranks, tmp_path):
    from bundler_sfm_tpu_torch.utils.render_scene import render_box_room
    imgs = str(tmp_path / "imgs")
    render_box_room(imgs, n=8, W=320, H=240, f=160.0)
    rc, one, files1 = _run_bundler(str(tmp_path / "w1"), imgs)
    assert rc == 0 and len(one["order"]) >= 3 and one["points"] > 0
    got = ranks(2).run(_run_bundler_job, str(tmp_path / "w2"), imgs)
    (rc0, r0, files0), (rc1, r1, files_1) = got
    assert rc0 == rc1 == 0
    assert len(r0["order"]) == len(one["order"])
    assert r0["order"] == r1["order"]
    np.testing.assert_array_equal(r0["cams"], r1["cams"])
    np.testing.assert_array_equal(r0["R"], r1["R"])
    assert r0["points"] == r1["points"]
    assert files_1 == []
    assert files0 == files1
    assert {"list.txt", "matches.init.txt", "pairwise_scores.txt",
            "bundle/bundle.out"} <= set(files0)


def _bundler_job(mesh, workdir, argv, keep):
    """bundler.main at world mesh.size in workdir/rank<r>; (rc, the
    reconstruction that `keep` (a function of the bundler module) returns
    with the count of sharded outlier loops run, the files there,
    constraints.txt's bytes or None)."""
    from bundler_sfm_tpu_torch import bundler
    wd = os.path.join(workdir, f"rank{mesh.rank}")
    real, calls = TS.run_ba_outlier_loop_sharded, []

    def sharded(*a, **k):
        calls.append(1)
        return real(*a, **k)
    TS.run_ba_outlier_loop_sharded = sharded
    try:
        rc, rec, files = _in_dir(
            wd, lambda: bundler.main(argv + ["--num_devices",
                                             str(mesh.size)]),
            bundler, keep)
    finally:
        TS.run_ba_outlier_loop_sharded = real
    cache = os.path.join(wd, "constraints.txt")
    kept = open(cache, "rb").read() if os.path.exists(cache) else None
    return rc, dict(_summary(rec), sharded_bas=len(calls)), files, kept


def test_bundler_two_ranks(ranks, tmp_path):
    """bundler --run_bundle at world 2 on the keys and matches of an 8-view
    render (each rank in a directory of its own): first with no
    constraints.txt, then with one in each directory (every rank reads
    it), then --bundle --rerun_bundle on rank 0's bundle.out (the resume
    path: run_sfm sharded, then continue_reconstruction).  Both ranks hold
    identical cameras, rank 0 alone writes, and reading the checkpoint
    gives the run without it."""
    from bundler_sfm_tpu_torch.utils.render_scene import render_box_room
    imgs = str(tmp_path / "imgs")
    render_box_room(imgs, n=8, W=320, H=240, f=160.0)
    prep = str(tmp_path / "prep")
    rc, _, _ = _run_bundler(prep, imgs, ["--write_keys"])
    assert rc == 0
    base = [os.path.join(prep, "list.txt"), "--key_dir", prep,
            "--match_table", os.path.join(prep, "matches.init.txt"),
            "--output", "bundle.out", "--output_dir", "bundle",
            "--variable_focal_length", "--use_focal_estimate",
            "--constrain_focal", "--constrain_focal_weight", "0.0001",
            "--estimate_distortion", "--device", "cpu"]
    work = str(tmp_path / "w")
    runs = {}
    for name, extra, keep in (
            ("fresh", ["--run_bundle"], "bundle_adjust_fast"),
            ("cached", ["--run_bundle"], "bundle_adjust_fast"),
            ("rerun", ["--bundle", os.path.join(work, "rank0", "bundle",
                                                "bundle.out"),
                       "--rerun_bundle"], "continue_reconstruction")):
        if name == "cached":
            # Both ranks start with the checkpoint rank 0 wrote.
            cache = runs["fresh"][0][3]
            shutil.rmtree(work)
            for r in range(2):
                os.makedirs(os.path.join(work, f"rank{r}"))
                with open(os.path.join(work, f"rank{r}",
                                       "constraints.txt"), "wb") as f:
                    f.write(cache)
        runs[name] = ranks(2).run(_bundler_job, work, base + extra, keep)
        (rc0, r0, files0, _), (rc1, r1, files_1, kept1) = runs[name]
        assert rc0 == rc1 == 0, name
        assert len(r0["order"]) >= 3 and r0["points"] > 0, name
        assert r0["sharded_bas"] == r1["sharded_bas"] > 0, name
        assert r0["order"] == r1["order"], name
        np.testing.assert_array_equal(r0["cams"], r1["cams"], err_msg=name)
        np.testing.assert_array_equal(r0["R"], r1["R"], err_msg=name)
        assert r0["points"] == r1["points"], name
        assert {"constraints.txt", "bundle/bundle.out"} <= set(files0), name
        if name == "fresh":
            assert files_1 == [] and kept1 is None
        else:
            assert files_1 == ["constraints.txt"] and kept1 == cache, name
    fresh, cached = runs["fresh"][0][1], runs["cached"][0][1]
    assert fresh["order"] == cached["order"]
    np.testing.assert_array_equal(fresh["cams"], cached["cams"])
