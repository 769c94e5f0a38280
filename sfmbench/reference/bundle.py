"""A `bundle.out` (v0.3) judged against the scene it was made from.

Bundler's camera model (`bundle.out` format, README "Output format"): a
world point X maps to P = R·X + t, p = -P.xy / P.z, and the image point
(centred, y up) is f · (1 + k1·|p|² + k2·|p|⁴) · p; a camera written as
zeros is not registered.  The scores:

  reproj_px   mean distance between each observation in the file and its
              point's projection through its camera
  ate_rel     RMS camera-centre error after the best similarity onto the
              ground truth, over the ground truth's RMS spread (a frozen
              copy of the program's `similarity_ate`)
and, of each, the worst camera.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def read_bundle(path: str) -> Dict[str, np.ndarray]:
    """Cameras (f, k1, k2 [n], R [n,3,3], t [n,3]), points [m,3] and the
    observations (point, camera, x, y) of a v0.3 bundle file."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    if lines and lines[0].startswith("#"):
        lines = lines[1:]
    ncam, npt = (int(v) for v in lines[0].split())
    cam = np.array(" ".join(lines[1:1 + 5 * ncam]).split(), np.float64
                   ).reshape(ncam, 15)
    body = lines[1 + 5 * ncam:]
    pts = np.zeros((npt, 3))
    obs = []
    for p in range(npt):
        pts[p] = [float(v) for v in body[3 * p].split()]
        views = body[3 * p + 2].split()
        nv = int(views[0])
        v = np.array(views[1:1 + 4 * nv], np.float64).reshape(nv, 4)
        obs.append(np.column_stack([np.full(nv, p), v[:, 0], v[:, 2],
                                    v[:, 3]]))
    obs = np.concatenate(obs) if obs else np.zeros((0, 4))
    return {"f": cam[:, 0], "k1": cam[:, 1], "k2": cam[:, 2],
            "R": cam[:, 3:12].reshape(ncam, 3, 3), "t": cam[:, 12:15],
            "points": pts, "obs": obs}


def registered(b) -> np.ndarray:
    return b["f"] != 0.0


def centers(b) -> np.ndarray:
    """Camera centres -Rᵀ·t."""
    return -np.einsum("nji,nj->ni", b["R"], b["t"])


def reprojection_errors(b) -> np.ndarray:
    obs = b["obs"]
    p = obs[:, 0].astype(int)
    c = obs[:, 1].astype(int)
    P = np.einsum("nij,nj->ni", b["R"][c], b["points"][p]) + b["t"][c]
    uv = -P[:, :2] / P[:, 2:3]
    r2 = (uv * uv).sum(1)
    scale = b["f"][c] * (1.0 + b["k1"][c] * r2 + b["k2"][c] * r2 * r2)
    return np.hypot(scale * uv[:, 0] - obs[:, 2], scale * uv[:, 1] - obs[:, 3])


def similarity(est: np.ndarray, gt: np.ndarray):
    """(s, R, mu_est, mu_gt) of the best similarity gt ≈ mu_gt + s·R·(est -
    mu_est), and the RMS residual over the RMS spread of gt (`ate_rel`);
    the arithmetic of the program's `similarity_ate`, frozen here."""
    A, B = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    muA, muB = A.mean(0), B.mean(0)
    A0, B0 = A - muA, B - muB
    U, S, Vt = np.linalg.svd(B0.T @ A0)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = (S * np.diag(D)).sum() / (A0 ** 2).sum()
    res = B0 - s * A0 @ R.T
    spread = np.sqrt((B0 ** 2).sum(1).mean())
    ate = float(np.sqrt((res ** 2).sum(1).mean()) / max(spread, 1e-12))
    return s, R, muA, muB, ate


def score(path: str, gt_centers: np.ndarray) -> Dict[str, float]:
    """The numbers for one `bundle.out`: registered cameras, points, the
    mean reprojection error (`reproj_px`) and the worst camera's mean
    (`reproj_cam_max_px`), `ate_rel` and the worst camera's centre error
    over the same spread (`ate_max_rel`); NaN where the file holds too
    little to say."""
    b = read_bundle(path)
    reg = registered(b)
    nan = float("nan")
    out = {"cameras": int(reg.sum()), "points": int(len(b["points"])),
           "reproj_px": nan, "reproj_cam_max_px": nan, "ate_rel": nan,
           "ate_max_rel": nan}
    if len(b["obs"]):
        err = reprojection_errors(b)
        cam = b["obs"][:, 1].astype(int)
        out["reproj_px"] = float(err.mean())
        out["reproj_cam_max_px"] = float(max(
            err[cam == c].mean() for c in np.unique(cam)))
    if reg.sum() >= 3:
        idx = np.nonzero(reg)[0]
        gt = np.asarray(gt_centers, np.float64)[idx]
        est = centers(b)[idx]
        s, R, muA, muB, ate = similarity(est, gt)
        spread = np.sqrt(((gt - gt.mean(0)) ** 2).sum(1).mean())
        moved = muB + s * (est - muA) @ R.T
        out["ate_rel"] = ate
        out["ate_max_rel"] = float(
            np.linalg.norm(moved - gt, axis=1).max() / spread)
    return out
