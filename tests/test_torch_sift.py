"""The port's DoG-SIFT against the JAX package's, on the CPU.

Both run f32 convolutions and transcendental functions whose rounding
differs between XLA:CPU and PyTorch, and the detector thresholds and the
orientation peaks sit on those sums, so agreement is measured, not exact.
Measured on this host (seeded inputs below):
  * 128x128 blob image: 23 of 23 JAX keys have a port key at the same
    position, scale and orientation within 1e-3 (largest difference
    1.1e-4); descriptors identical.
  * 160x120 rendered view: 241 keys each; 240 of 241 JAX keys have a port
    key within 1e-3 (one key's orientation histogram peak flips, 0.15
    rad); descriptors of the agreeing keys differ by at most 1 (of 255).
The tests require: key counts within 1%, >= 97% of JAX keys agreeing
within 1e-3 (px for x, y, scale; rad for orientation), and agreeing keys'
descriptors within 1.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_sift import make_blob_image

from bundler_sfm_tpu.features import sift as JS
from bundler_sfm_tpu_torch.features import sift as TS


def agreement(ji, jd, ti, td, tol=1e-3):
    """(share of JAX keys with a port key within tol, largest descriptor
    difference over those pairs)."""
    hits, worst = 0, 0
    for k in range(len(ji)):
        dpos = np.abs(ti[:, :3] - ji[k, :3]).max(1)
        dori = np.abs(np.angle(np.exp(1j * (ti[:, 3] - ji[k, 3]))))
        cand = np.nonzero((dpos <= tol) & (dori <= tol))[0]
        if len(cand):
            hits += 1
            dd = np.abs(td[cand].astype(int) - jd[k].astype(int)).max(1)
            worst = max(worst, int(dd.min()))
    return hits / max(len(ji), 1), worst


def _rendered_view():
    import tempfile
    from bundler_sfm_tpu_torch.features.sift import load_grayscale
    from bundler_sfm_tpu_torch.utils.render_scene import render_box_room
    with tempfile.TemporaryDirectory() as d:
        render_box_room(d, n=3, W=160, H=120, f=140.0, sheet_size=512)
        return load_grayscale(f"{d}/img0000.jpg")


@pytest.mark.parametrize("which", ["blobs", "rendered"])
def test_extract_sift_agrees_with_jax(which):
    if which == "blobs":
        img, _ = make_blob_image(np.random.default_rng(0), size=128,
                                 n_blobs=8)
        k = 512
    else:
        img, k = _rendered_view(), 1024
    ji, jd = JS.extract_sift(img, max_keys_total=k)
    ti, td = TS.extract_sift(img, max_keys_total=k, device="cpu")
    assert ti.dtype == np.float32 and td.dtype == np.uint8
    assert td.shape == (len(ti), 128) and len(ji) > 20
    assert abs(len(ti) - len(ji)) <= 0.01 * len(ji)
    share, worst = agreement(ji, jd, ti, td)
    assert share >= (1.0 if which == "blobs" else 0.97), share
    assert worst <= (0 if which == "blobs" else 1), worst


def test_batch_equals_single_images(rng):
    imgs = [make_blob_image(rng, size=96)[0] for _ in range(2)]
    imgs.append(make_blob_image(rng, size=96)[0][:, :80].copy())
    batch = TS.extract_sift_batch(imgs, max_keys_total=256, device="cpu")
    for im, (bi, bd) in zip(imgs, batch):
        si, sd = TS.extract_sift(im, max_keys_total=256, device="cpu")
        np.testing.assert_array_equal(bi, si)
        np.testing.assert_array_equal(bd, sd)


def test_pyramid_agrees_with_jax(rng):
    img = rng.uniform(0, 1, (64, 72)).astype(np.float32)
    jb = np.asarray(JS._blur(jnp.asarray(img), 1.7))
    tb = TS._blur(torch.from_numpy(img)[None], 1.7)[0].numpy()
    np.testing.assert_allclose(tb, jb, atol=1e-6)
    jg, jdog, jmag, jori = (np.asarray(x) for x in JS.build_octave(
        jnp.asarray(img)))
    tg, tdog, tmag, tori = (x[0].numpy() for x in TS.build_octave(
        torch.from_numpy(img)[None]))
    np.testing.assert_allclose(tg, jg, atol=1e-6)
    np.testing.assert_allclose(tdog, jdog, atol=1e-6)
    np.testing.assert_allclose(tmag, jmag, atol=1e-6)
    # Orientation where the gradient is not vanishing.
    big = jmag > 1e-3
    np.testing.assert_allclose(tori[big], jori[big], atol=1e-4)


def test_top_k_ties_like_lax(rng):
    score = rng.integers(0, 4, (3, 500)).astype(np.float32) * 0.25
    vals, idx = TS._top_k_first(torch.from_numpy(score), 64)
    jv, ji = jax.lax.top_k(jnp.asarray(score), 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_orientation_and_descriptor_agree_with_jax(rng):
    N = 16
    m = rng.uniform(0, 0.2, (N, 32, 32)).astype(np.float32)
    o = rng.uniform(-np.pi, np.pi, (N, 32, 32)).astype(np.float32)
    sig = rng.uniform(1.6, 4.0, N).astype(np.float32)
    fx = rng.uniform(-0.5, 0.5, N).astype(np.float32)
    fy = rng.uniform(-0.5, 0.5, N).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    jh = np.stack([np.asarray(JS.orientation_hist(
        jnp.asarray(m[k]), jnp.asarray(o[k]), 0.0, 0.0, jnp.float32(sig[k])))
        for k in range(N)])
    th_ = TS.orientation_hist(torch.from_numpy(m), torch.from_numpy(o),
                              torch.from_numpy(sig)).numpy()
    np.testing.assert_allclose(th_, jh, rtol=1e-5, atol=1e-6)
    jd = np.stack([np.asarray(JS.descriptor(
        jnp.asarray(m[k]), jnp.asarray(o[k]), jnp.float32(fx[k]),
        jnp.float32(fy[k]), jnp.float32(sig[k]), jnp.float32(th[k])))
        for k in range(N)])
    td = TS.descriptor(*(torch.from_numpy(x) for x in (m, o, fx, fy, sig,
                                                       th))).numpy()
    assert np.abs(td - jd).max() <= 1
