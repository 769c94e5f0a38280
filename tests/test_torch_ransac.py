"""The port's verification estimators against the JAX package's, in f64 on
the CPU, with the JAX package's RANSAC draw injected as the port's sample
indices.  Tolerances: inlier masks identical; F and H within 1e-9
(max abs difference after scaling each to unit Frobenius norm); small
linear algebra within 1e-12 relative."""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import Scene

from bundler_sfm_tpu.ops import fmatrix as JF
from bundler_sfm_tpu.ops import homography as JH
from bundler_sfm_tpu.ops import linalg_small as JL
from bundler_sfm_tpu.ops import ransac as JR
from bundler_sfm_tpu.ops import svd_utils as JS
from bundler_sfm_tpu_torch.ops import fmatrix as TF
from bundler_sfm_tpu_torch.ops import homography as TH
from bundler_sfm_tpu_torch.ops import linalg_small as TL
from bundler_sfm_tpu_torch.ops import ransac as TR
from bundler_sfm_tpu_torch.ops import svd_utils as TS

KEY = jax.random.PRNGKey(7)


def pad2(x, n):
    out = np.zeros((n, x.shape[1]), dtype=np.float64)
    out[:len(x)] = x
    return out


def corrupt(rng, xy, frac, scale=80.0):
    xy = xy.copy()
    n_bad = int(len(xy) * frac)
    bad = rng.choice(len(xy), n_bad, replace=False)
    xy[bad] += rng.normal(size=(n_bad, 2)) * scale
    return xy, bad


def unit(M):
    M = np.asarray(M, np.float64)
    return M / np.linalg.norm(M)


def t(x):
    return torch.from_numpy(np.array(x, np.float64))


def test_small_linalg_matches_jax(rng):
    A = rng.normal(size=(5, 8, 8))
    A = A @ np.swapaxes(A, 1, 2) + 8 * np.eye(8)
    b = rng.normal(size=(5, 8))
    want = np.stack([np.asarray(JL.cholesky_solve(jnp.asarray(a), jnp.asarray(v)))
                     for a, v in zip(A, b)])
    got = TL.cholesky_solve(t(A), t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    M = rng.normal(size=(6, 3, 3))
    want = np.stack([np.asarray(JL.inv3(jnp.asarray(m))) for m in M])
    np.testing.assert_allclose(TL.inv3(t(M)).numpy(), want, rtol=1e-12)


def test_svd_small_matches_jax(rng):
    F = rng.normal(size=(64, 3, 3))
    F[:8, :, 2] = F[:8, :, 0] + F[:8, :, 1]     # rank 2
    jU, js, jVt = (np.asarray(x) for x in JS.svd_small(jnp.asarray(F)))
    tU, ts, tVt = (x.numpy() for x in TS.svd_small(t(F)))
    # Singular values via eigh of AᵀA: ~sqrt(eps)·σ₁ absolute accuracy for
    # the (near-)zero one of a rank-2 matrix (svd_utils docstring), so
    # the two packages' roundings agree to that level there.
    np.testing.assert_allclose(ts, js, rtol=1e-9,
                               atol=1e-7 * float(js[:, 0].max()))
    # Rank-2 projections (what the estimators use) agree.
    want = np.stack([np.asarray(JF._closest_rank2(jnp.asarray(f), False))
                     for f in F])
    got = TF._closest_rank2(t(F), False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_hartley_normalize_matches_jax(rng):
    pts = rng.uniform(-300, 300, (40, 2))
    mask = rng.random(40) < 0.7
    jp, jT = JR.hartley_normalize(jnp.asarray(pts), jnp.asarray(mask))
    tp, tT = TR.hartley_normalize(t(pts), torch.from_numpy(mask))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-13)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=1e-13)


def _fmatrix_problem(rng):
    sc = Scene(rng, num_cams=2, num_pts=300, noise=0.2)
    x1, x2 = sc.obs[0], sc.obs[1]
    x2, _ = corrupt(rng, x2, 0.3)
    return pad2(x1, 512), pad2(x2, 512), len(x1)


def test_fit_fmatrix_linear_matches_jax(rng):
    x1, x2, n = _fmatrix_problem(rng)
    mask = (np.arange(512) < n) & (rng.random(512) < 0.5)
    want = JF.fit_fmatrix_linear(jnp.asarray(x2), jnp.asarray(x1),
                                 jnp.asarray(mask), False)
    got = TF.fit_fmatrix_linear(t(x2), t(x1), torch.from_numpy(mask), False)
    assert np.abs(unit(want) - unit(got)).max() < 1e-9


@pytest.mark.parametrize("rounds", [512, 2048])
def test_fmatrix_ransac_matches_jax(rng, rounds):
    x1, x2, n = _fmatrix_problem(rng)
    F, inl, cnt = JF.estimate_fmatrix_ransac(
        KEY, jnp.asarray(x1), jnp.asarray(x2), jnp.int32(n),
        jnp.float64(9.0), num_rounds=rounds)
    s = np.asarray(JR.sample_indices(KEY, rounds, 8, jnp.int32(n), 512))
    tF, tinl, tcnt = TF.estimate_fmatrix_ransac(
        torch.from_numpy(s[None]).long(), t(x1[None]), t(x2[None]),
        torch.tensor([n]), 9.0)
    np.testing.assert_array_equal(np.asarray(inl), tinl[0].numpy())
    assert int(cnt) == int(tcnt[0])
    assert np.abs(unit(F) - unit(tF[0])).max() < 1e-9


def test_homography_ransac_matches_jax(rng):
    H_true = np.array([[1.1, 0.02, 5.0], [-0.03, 0.95, -7.0],
                       [1e-4, -2e-5, 1.0]])
    p1 = rng.uniform(-300, 300, (200, 2))
    ph = np.concatenate([p1, np.ones((200, 1))], axis=1) @ H_true.T
    p2, _ = corrupt(rng, ph[:, :2] / ph[:, 2:3], 0.25)
    P1, P2 = pad2(p1, 256), pad2(p2, 256)
    H, inl, cnt = JH.estimate_homography_ransac(
        KEY, jnp.asarray(P1), jnp.asarray(P2), jnp.int32(200),
        jnp.float64(6.0), num_rounds=256)
    s = np.asarray(JR.sample_indices(KEY, 256, 4, jnp.int32(200), 256))
    tH, tinl, tcnt = TH.estimate_homography_ransac(
        torch.from_numpy(s[None]).long(), t(P1[None]), t(P2[None]),
        torch.tensor([200]), 6.0)
    np.testing.assert_array_equal(np.asarray(inl), tinl[0].numpy())
    assert int(cnt) == int(tcnt[0]) > 140
    assert np.abs(unit(H) - unit(tH[0])).max() < 1e-9
    d = TH.homography_transfer_dist(tH[0], t(p1), t(ph[:, :2] / ph[:, 2:3]))
    np.testing.assert_allclose(
        d.numpy(), np.asarray(JH.homography_transfer_dist(
            jnp.asarray(H), jnp.asarray(p1),
            jnp.asarray(ph[:, :2] / ph[:, 2:3]))), atol=1e-9)


def test_batched_estimators_equal_one_by_one(rng):
    """A batch of problems gives each problem's single-problem result."""
    probs = [_fmatrix_problem(rng) for _ in range(3)]
    g = torch.Generator().manual_seed(0)
    n = torch.tensor([p[2] for p in probs])
    s = TR.sample_indices(g, 256, 8, n, 512)
    x1 = t(np.stack([p[0] for p in probs]))
    x2 = t(np.stack([p[1] for p in probs]))
    F, inl, cnt = TF.estimate_fmatrix_ransac(s, x1, x2, n, 9.0)
    for b in range(3):
        F1, inl1, cnt1 = TF.estimate_fmatrix_ransac(
            s[b:b + 1], x1[b:b + 1], x2[b:b + 1], n[b:b + 1], 9.0)
        assert torch.equal(inl[b], inl1[0]) and int(cnt[b]) == int(cnt1[0])
        assert np.abs(unit(F[b]) - unit(F1[0])).max() < 1e-12


def test_sample_indices_distinct_and_valid():
    g = torch.Generator().manual_seed(3)
    n = torch.tensor([8, 20, 500])
    s = TR.sample_indices(g, 4096, 8, n, 512)
    assert s.shape == (3, 4096, 8)
    for b in range(3):
        assert int(s[b].min()) >= 0 and int(s[b].max()) < int(n[b])
        srt = torch.sort(s[b], -1).values
        assert bool((srt[:, 1:] != srt[:, :-1]).all())
    # Every valid index is drawn, at a roughly uniform rate.
    hist = torch.bincount(s[2].reshape(-1), minlength=500).double()
    assert hist.min() > 0.5 * hist.mean() and hist.max() < 1.5 * hist.mean()


def test_run_ransac_finds_homography_inliers(rng):
    H_true = np.array([[0.9, 0.1, 3.0], [-0.05, 1.05, -2.0],
                       [2e-4, 1e-4, 1.0]])
    p1 = rng.uniform(-200, 200, (120, 2))
    ph = np.concatenate([p1, np.ones((120, 1))], axis=1) @ H_true.T
    p2, bad = corrupt(rng, ph[:, :2] / ph[:, 2:3], 0.3)
    g = torch.Generator().manual_seed(1)
    s = TR.sample_indices(g, 128, 4, torch.tensor([120]), 120)

    def fit(s1, s2):
        return TH.fit_homography_dlt(s1, s2, torch.ones(s1.shape[:-1],
                                                        dtype=torch.bool))

    def resid(H, a, b):
        return TH.homography_transfer_dist(H, a[:, None], b[:, None])

    H, inl, cnt = TR.run_ransac(s, fit, resid, t(p1[None]), t(p2[None]),
                                torch.tensor([120]), 6.0)
    # Noise-free inliers: the best model is exact, so the inlier set is
    # every point within 6 px of the true homography.
    want = np.linalg.norm(p2 - ph[:, :2] / ph[:, 2:3], axis=1) < 6.0
    assert want.sum() >= 120 - len(bad)
    np.testing.assert_array_equal(inl[0].numpy(), want)
    assert int(cnt[0]) == want.sum()
