"""The refine LM kernel (`csrc/refine_lm.cu` through `ops/lm_cuda.py`)
against the plain version (`ops/lm.py::camera_refine_batch_plain`, run on
CPU copies of the same tensors) on seeded problems made with numpy.  They
skip on a host without CUDA.  On the card (which has no JAX, so the
repository's conftest is left out):

    python -m pytest tests/test_torch_refine_cuda.py --noconftest -q

Tolerances (f64): a single LM step (max_iters 1) within 1e-10 of each
lane's largest camera entry (the closed-form Jacobian against jacfwd's, the
same solve, sums in another order); whole runs within 1e-8, cameras
relative to each lane's largest entry and R absolute (the JAX package's
bound for the same function).  Iteration counts are equal while no lane
has stopped (max_iters 3).  Past that they are not compared: the LM stops
once an accepted step gains less than ~100 ulp of the cost, and where that
happens is decided by rounding, so two summation orders stop a lane up to
~10 iterations apart at the same minimum.

This file imports nothing of JAX or of the JAX package.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import numpy as np
import pytest
import torch

from bundler_sfm_tpu_torch.ops import lm
from bundler_sfm_tpu_torch.ops import lm_cuda
from bundler_sfm_tpu_torch.utils import get_telemetry
from tests.synthetic import Scene, random_rotation

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _problem(seed, sizes, noise=0.4, outliers=0.0, w=0.0, k1=-0.03):
    """Lanes of one padded batch: lane b sees sizes[b] points of its own
    scene (about 5 % of them masked out), the rest padding of ones; the
    starting cameras are perturbed from the truth, with rotation offset w
    (radians, in the camera's w) and a focal 0.95-1.05 of the truth.
    Returns the numpy inputs of camera_refine_batch in order."""
    rng = np.random.default_rng(seed)
    B, N = len(sizes), max(sizes)
    cam0 = np.zeros((B, 9))
    R0 = np.zeros((B, 3, 3))
    pts = np.ones((B, N, 3))
    projs = np.ones((B, N, 2))
    mask = np.zeros((B, N), bool)
    for b, n in enumerate(sizes):
        sc = Scene(rng, num_cams=1, num_pts=n, noise=noise, k1=k1)
        R0[b] = random_rotation(rng, 0.02) @ sc.R[0]
        cam0[b, 0:3] = sc.centers[0] + rng.normal(size=3) * 0.05
        cam0[b, 3:6] = rng.normal(size=3) * w
        cam0[b, 6] = sc.f[0] * rng.uniform(0.95, 1.05)
        pts[b, :n] = sc.points
        xy = sc.obs[0].copy()
        bad = rng.random(n) < outliers
        xy[bad] += rng.normal(size=(int(bad.sum()), 2)) * 40.0
        projs[b, :n] = xy
        mask[b, :n] = rng.random(n) < 0.95
        mask[b, :min(n, 6)] = True
    return cam0, R0, pts, projs, mask


def _tensors(arrays, device):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _close(got, want, rel, what):
    """Per lane: |got - want| <= rel * (the lane's largest |want|)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    scale = np.abs(w).reshape(len(w), -1).max(1)
    err = np.abs(g - w).reshape(len(w), -1).max(1)
    assert (err <= rel * np.maximum(scale, 1e-300)).all(), \
        f"{what}: {err / np.maximum(scale, 1e-300)}"


def _both(arrays, cuda, **kw):
    """(kernel outputs, plain outputs on CPU copies) of one call."""
    got = lm.camera_refine_batch(*_tensors(arrays, cuda), **kw)
    torch.cuda.synchronize()
    want = lm.camera_refine_batch_plain(*_tensors(arrays, "cpu"), **kw)
    return got, want


SIZES = {1: [9000], 3: [6, 700, 1500], 17: [6 + 530 * b for b in range(17)]}


@pytest.mark.parametrize("B", sorted(SIZES))
@pytest.mark.parametrize("adjust_focal,estimate_distortion,prior", [
    (True, False, False), (True, True, True), (False, True, False),
    (False, False, True)], ids=["focal", "focal-dist-prior", "dist",
                                "fixed-prior"])
def test_kernel_matches_plain(cuda, B, adjust_focal, estimate_distortion,
                              prior):
    arrays = _problem(B, SIZES[B])
    fc = np.full(B, 700.0) if prior else np.zeros(B)
    fw = np.full(B, 1e-4) if prior else np.zeros(B)
    fw[::2] *= 1e6
    active = np.arange(B) % 3 != 1 if B > 1 else np.ones(B, bool)
    kw = dict(adjust_focal=adjust_focal,
              estimate_distortion=estimate_distortion,
              focal_constraint=torch.from_numpy(fc),
              focal_weight=torch.from_numpy(fw), distortion_weight=100.0)
    for max_iters, rel in ((3, 1e-10), (50, 1e-8)):
        for act in (None, torch.from_numpy(active)):
            kw_d = {k: v.to(cuda) if torch.is_tensor(v) else v
                    for k, v in kw.items()}
            got = lm.camera_refine_batch(
                *_tensors(arrays, cuda), max_iters=max_iters,
                active=None if act is None else act.to(cuda), **kw_d)
            want = lm.camera_refine_batch_plain(
                *_tensors(arrays, "cpu"), max_iters=max_iters, active=act,
                **kw)
            what = f"max_iters {max_iters}, active {act}"
            _close(got[0], want[0], rel, f"cam, {what}")
            _close(got[1], want[1], rel * 10, f"R, {what}")
            _close(got[2][:, None], want[2][:, None], 1e-9, f"cost, {what}")
            it_g, it_w = got[3].cpu().numpy(), want[3].cpu().numpy()
            on = np.ones(B, bool) if act is None else act.numpy()
            assert (it_g[~on] == 0).all() and (it_w[~on] == 0).all()
            assert ((it_g[on] >= 1) & (it_g[on] <= max_iters)).all(), it_g
            if max_iters == 3:
                assert (it_w[on] == 3).all(), "a lane stopped within 3"
                np.testing.assert_array_equal(it_g, it_w)
            if act is not None:   # lanes outside active come back as given
                cam0, R0 = _tensors(arrays[:2], "cpu")
                assert torch.equal(got[0][~act.to(cuda)].cpu(), cam0[~act])
                assert torch.equal(got[1][~act.to(cuda)].cpu(), R0[~act])


@pytest.mark.parametrize("w", [0.0, 0.05], ids=["w0", "w"])
def test_one_step_checks_the_jacobian(cuda, w):
    """One LM iteration (max_iters 1) from a start with w = 0 (the series
    branch of the rotation) and w != 0, every parameter free and both
    penalties on: the step is J's, so the cameras agree only if the
    kernel's closed-form Jacobian agrees with jacfwd's; every lane must
    accept its step."""
    arrays = _problem(7, [40, 300, 2000, 6], w=w)
    if w == 0.0:
        assert not arrays[0][:, 3:6].any()
    kw = dict(adjust_focal=True, estimate_distortion=True,
              focal_constraint=700.0, focal_weight=1e-2,
              distortion_weight=100.0, max_iters=1)
    got, want = _both(arrays, cuda, **kw)
    assert (want[0][:, [0, 1, 2, 6, 7, 8]] !=
            torch.from_numpy(arrays[0])[:, [0, 1, 2, 6, 7, 8]]).any(1).all()
    _close(got[0], want[0], 1e-10, "cam")
    _close(got[1], want[1], 1e-10, "R")
    _close(got[2][:, None], want[2][:, None], 1e-12, "cost")


def test_trim_matches_plain_with_outliers(cuda, monkeypatch):
    """camera_refine_trim_batch with 20 % gross outliers: the same inlier
    masks, cameras within 1e-8; refine_lm_iters counted once a call at
    the trim's existing reads, refine_lm_launches once a kernel call."""
    sizes = [6 + 530 * b for b in range(17)]
    arrays = _problem(3, sizes, outliers=0.2)
    B = len(sizes)
    fc = torch.full((B,), 700.0, dtype=torch.float64)
    fw = torch.full((B,), 1e-4, dtype=torch.float64)
    calls, iters = [], []
    real = lm.camera_refine_batch

    def counting(*a, **k):
        out = real(*a, **k)
        calls.append(out[0].device.type)
        iters.append(int(out[3].max()))
        return out
    monkeypatch.setattr(lm, "camera_refine_batch", counting)
    tel = get_telemetry()
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        tel.reset()
        calls.clear()
        iters.clear()
        before = lm_cuda.LAUNCHES["refine_lm"]
        outs[dev.type] = lm.camera_refine_trim_batch(
            *_tensors(arrays, dev), True, True, fc.to(dev), fw.to(dev),
            100.0, 50, 1e-3, 2.0, 8.0, 16.0)
        n_calls = len(calls)
        assert n_calls >= 2
        assert tel.counters["refine_lm_iters"] == sum(iters)
        if dev.type == "cuda":
            assert lm_cuda.LAUNCHES["refine_lm"] - before == n_calls
            assert tel.counters["refine_lm_launches"] == n_calls
        else:
            assert lm_cuda.LAUNCHES["refine_lm"] == before
            assert "refine_lm_launches" not in tel.counters
    tel.reset()
    (gc, gR, gm), (wc, wR, wm) = outs["cuda"], outs["cpu"]
    np.testing.assert_array_equal(gm.cpu().numpy(), wm.numpy())
    assert 0 < int(wm.sum()) < int(torch.from_numpy(arrays[4]).sum())
    _close(gc, wc, 1e-8, "cam")
    _close(gR, wR, 1e-7, "R")


def test_two_launches_bit_identical(cuda):
    arrays = _problem(11, [9000, 4000, 6, 2500])
    ins = _tensors(arrays, cuda)
    kw = dict(adjust_focal=True, estimate_distortion=True,
              focal_constraint=700.0, focal_weight=1e-4)
    a = lm.camera_refine_batch(*ins, **kw)
    b = lm.camera_refine_batch(*ins, **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_launch_count_and_input_checks(cuda):
    arrays = _problem(5, [100, 200])
    ins = _tensors(arrays, cuda)
    before = lm_cuda.LAUNCHES["refine_lm"]
    for _ in range(3):
        lm.camera_refine_batch(*ins)
    assert lm_cuda.LAUNCHES["refine_lm"] - before == 3
    f32 = [t.float() if t.dtype == torch.float64 else t for t in ins]
    with pytest.raises(ValueError, match="float64"):
        lm.camera_refine_batch(*f32)
    with pytest.raises(ValueError, match="shape"):
        lm.camera_refine_batch(ins[0], ins[1], ins[2][:, :50], *ins[3:])
    assert lm_cuda.LAUNCHES["refine_lm"] - before == 3
