"""The port's inverse radial distortion (`ops/projection.py`:
`invert_distortion`, `undistort_normalized`) against the JAX package's on
the CPU in f64.

Tolerances: the fitted coefficients within 1e-10 of the JAX package's
(relative to the largest, per case); undistorted points within 1e-12 of
the JAX package's on the same coefficients; the round trip of
`tests/test_geometry_core.py::test_invert_distortion_roundtrip` within
its 2e-4.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundler_sfm_tpu.ops import projection as J

from bundler_sfm_tpu_torch.ops import projection as T

# (k1, k2, f, width, height)
CASES = {
    "roundtrip": (-0.08, 0.03, 700.0, 640, 480),
    "barrel": (-0.2, 0.05, 500.0, 1024, 768),
    "pincushion": (0.05, 0.01, 900.0, 640, 480),
    "none": (0.0, 0.0, 700.0, 640, 480),
}


@pytest.mark.parametrize("case", list(CASES))
def test_invert_distortion_matches_jax(case):
    args = CASES[case]
    want = np.asarray(J.invert_distortion(*args))
    got = T.invert_distortion(*args, device="cpu").numpy()
    assert got.shape == want.shape == (6,)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("case", list(CASES))
def test_undistort_normalized_matches_jax(case):
    k_inv = np.asarray(J.invert_distortion(*CASES[case]))
    u = np.random.default_rng(0).uniform(-0.4, 0.4, (64, 2))
    want = np.asarray(J.undistort_normalized(jnp.asarray(u),
                                             jnp.asarray(k_inv)))
    got = T.undistort_normalized(torch.as_tensor(u),
                                 torch.as_tensor(k_inv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_invert_distortion_roundtrip():
    """tests/test_geometry_core.py's round trip through the port."""
    f, k1, k2 = 700.0, -0.08, 0.03
    k_inv = T.invert_distortion(k1, k2, f, 640, 480, device="cpu")
    u = torch.tensor([[0.1, 0.05], [0.3, -0.2], [0.0, 0.35]],
                     dtype=torch.float64)
    rsq = (u * u).sum(1)
    u_dist = u * (1.0 + k1 * rsq + k2 * rsq * rsq)[:, None]
    assert torch.allclose(T.undistort_normalized(u_dist, k_inv), u,
                          rtol=0, atol=2e-4)
