"""The port's 2D similarity fit and MotionRigid RANSAC (`ops/horn.py`)
against the JAX package's, on the CPU in f64, with the JAX package's RANSAC
draw passed in as the port's samples.

Tolerances: the closed-form fit and the transfer distances within 1e-12
relative; the RANSAC fit gives the same inlier mask and count and a model
within 1e-10 (the scene is checked to keep every transfer distance at
least 1e-9 from the threshold).  The assertions of
`tests/test_extras.py::test_similarity_ransac` run as a port case too.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundler_sfm_tpu.ops import horn as JH
from bundler_sfm_tpu.ops import ransac as JR
from bundler_sfm_tpu_torch.ops import horn as TH


def t(x):
    return torch.from_numpy(np.array(x, np.float64))


def similarity_scene(rng, n=80, n_out=15, pad=128):
    theta, s = 0.3, 1.4
    R = s * np.array([[np.cos(theta), -np.sin(theta)],
                      [np.sin(theta), np.cos(theta)]])
    p1 = rng.uniform(-100, 100, (n, 2))
    p2 = p1 @ R.T + np.array([5.0, -3.0])
    p2 += rng.normal(size=p2.shape) * 0.3
    p2[:n_out] += rng.normal(size=(n_out, 2)) * 50
    a, b = np.zeros((pad, 2)), np.zeros((pad, 2))
    a[:n], b[:n] = p1, p2
    return a, b


def test_fit_similarity_matches_jax(rng):
    p1, p2 = similarity_scene(rng)
    mask = np.arange(128) < 80
    mask[3] = False
    want = np.asarray(JH.fit_similarity_2d(jnp.asarray(p1), jnp.asarray(p2),
                                           jnp.asarray(mask)))
    got = TH.fit_similarity_2d(t(p1), t(p2), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # Batched over a leading dimension.
    both = TH.fit_similarity_2d(t(np.stack([p1, p2])), t(np.stack([p2, p1])),
                                torch.from_numpy(np.stack([mask, mask])))
    np.testing.assert_allclose(both[0].numpy(), got, rtol=1e-15)
    d_want = np.asarray(JH.similarity_transfer_dist(
        jnp.asarray(want), jnp.asarray(p1), jnp.asarray(p2)))
    d_got = TH.similarity_transfer_dist(t(want), t(p1), t(p2)).numpy()
    np.testing.assert_allclose(d_got, d_want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed,n_valid", [(0, 80), (5, 61)])
def test_similarity_ransac_matches_jax(rng, seed, n_valid):
    p1, p2 = similarity_scene(rng)
    key = jax.random.PRNGKey(seed)
    jM, jinl, jcnt = JH.estimate_similarity_ransac(
        key, jnp.asarray(p1), jnp.asarray(p2), jnp.int32(n_valid),
        jnp.float64(2.0), num_rounds=128)
    samples = np.array(JR.sample_indices(key, 128, 3, jnp.int32(n_valid),
                                         128))
    M, inl, cnt = TH.estimate_similarity_ransac(
        p1, p2, n_valid, 2.0, num_rounds=128, samples=samples, device="cpu")
    d = np.asarray(JH.similarity_transfer_dist(jM, jnp.asarray(p1),
                                               jnp.asarray(p2)))[:n_valid]
    assert np.abs(d - 2.0).min() > 1e-9
    assert int(cnt) == int(jcnt)
    assert np.array_equal(inl.numpy(), np.asarray(jinl))
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), atol=1e-10)
    # tests/test_extras.py: the inliers' transfer error and count.
    dist = TH.similarity_transfer_dist(M, t(p1[15:80]), t(p2[15:80]))
    assert float(dist.median()) < 0.5
    assert int(cnt) >= 60 * n_valid // 80


def test_similarity_ransac_own_draw(rng):
    """Without samples the port draws from a generator seeded with `seed`:
    the same draw for the same seed, another for another seed."""
    p1, p2 = similarity_scene(rng)
    runs = [TH.estimate_similarity_ransac(p1, p2, 80, 2.0, seed=s,
                                          device="cpu") for s in (3, 3, 4)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    for M, inl, cnt in runs:
        assert int(cnt) >= 60 and not inl[80:].any()
        np.testing.assert_allclose(M[:2, :2].numpy(), 1.4 * np.array(
            [[np.cos(0.3), -np.sin(0.3)], [np.sin(0.3), np.cos(0.3)]]),
            atol=1e-2)
