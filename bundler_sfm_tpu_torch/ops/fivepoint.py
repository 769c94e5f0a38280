"""Nistér 5-point essential-matrix minimal solver, batched over RANSAC
samples — port of `bundler_sfm_tpu/ops/fivepoint.py`.

Replaces `lib/5point/5point.c` (nullspace basis, constraint system,
`compute_pose_ransac` `:606`) by Nistér's reduction to one degree-10
polynomial, kept from the JAX package for parity even though the card has
a complex eigensolver:

  1. null space of the 5×9 epipolar constraint matrix: E = x·B0 + y·B1 + z·B2 + B3
  2. the 10 cubic constraints det(E) = 0, 2·E·Eᵀ·E − tr(E·Eᵀ)·E = 0 over
     the 20 monomials of degree ≤ 3 in (x, y, z)
  3. Gauss-Jordan on the 10 pivot monomials, then the row pairs
     (x²z, x²), (y²z, y²), (xyz, xy) combine into B(z)·[x, y, 1]ᵀ = 0
  4. det B(z), a degree-10 polynomial, solved by Durand-Kerner (80 fixed
     iterations, complex numbers carried as real pairs)
  5. x, y from the null vector of B(z₀), one E per real root.

Inputs are NEGATED normalized ray coords, as in `compute_pose_ransac`.  The
RANSAC draw is an input (`samples`).
"""

from __future__ import annotations

import math

import torch

from bundler_sfm_tpu_torch.ops.essential import (
    decompose_essential_multipt, ematrix_to_fmatrix,
)
from bundler_sfm_tpu_torch.ops.fmatrix import fmatrix_residual
from bundler_sfm_tpu_torch.ops.linalg_small import lu_solve
from bundler_sfm_tpu_torch.ops.svd_utils import nullspace_rows

# Monomial bookkeeping (static).  Degree <= 1 basis of E's entries over
# [x, y, z, 1]; degree <= 2 monomials (10); degree <= 3 monomials (20),
# ordered so the first 10 are the Gauss-Jordan pivots and the last 10
# factor as {x, y, 1} × z-polynomials.
_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_DEG2 = sorted({tuple(map(sum, zip(a, b)))
                for a in _DEG1 for b in _DEG1}, reverse=True)
_DEG3_FIRST = [(3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
               (0, 2, 1), (1, 1, 1), (2, 0, 0), (0, 2, 0), (1, 1, 0)]
_DEG3_LAST = [(1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
              (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]
_DEG3 = _DEG3_FIRST + _DEG3_LAST
_DEG2_IDX = {m: i for i, m in enumerate(_DEG2)}
_DEG3_IDX = {m: i for i, m in enumerate(_DEG3)}
_MUL11 = [(i, j, _DEG2_IDX[tuple(map(sum, zip(a, b)))])
          for i, a in enumerate(_DEG1) for j, b in enumerate(_DEG1)]
_MUL21 = [(i, j, _DEG3_IDX[tuple(map(sum, zip(a, b)))])
          for i, a in enumerate(_DEG2) for j, b in enumerate(_DEG1)
          if tuple(map(sum, zip(a, b))) in _DEG3_IDX]


def _polyprod(p, q, table, n_out):
    """Product of polynomials p [..., a], q [..., b] over the monomial
    table; terms accumulate in table order."""
    out = [None] * n_out
    for i, j, k in table:
        t = p[..., i] * q[..., j]
        out[k] = t if out[k] is None else out[k] + t
    zero = torch.zeros_like(p[..., 0])
    return torch.stack([zero if o is None else o for o in out], -1)


def _mul11(p, q):
    """deg1 [.., 4] × deg1 [.., 4] -> deg2 [.., 10]."""
    return _polyprod(p, q, _MUL11, 10)


def _mul21(p, q):
    """deg2 [.., 10] × deg1 [.., 4] -> deg3 [.., 20]."""
    return _polyprod(p, q, _MUL21, 20)


def _nullspace_basis(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Ray coords [..., 5, 2] each -> E basis [..., 4, 3, 3] with
    q2ᵀ E q1 = 0 for the five correspondences."""
    h1 = torch.cat([q1, torch.ones_like(q1[..., :1])], -1)
    h2 = torch.cat([q2, torch.ones_like(q2[..., :1])], -1)
    Q = (h2[..., :, None] * h1[..., None, :]).flatten(-2)       # [..., 5, 9]
    return nullspace_rows(Q, 4).unflatten(-1, (3, 3))


def _constraint_matrix(B: torch.Tensor) -> torch.Tensor:
    """Basis [..., 4, 3, 3] -> M [..., 10, 20] over the DEG3 monomials.
    Row 0: det(E) = 0.  Rows 1-9: 2·E·Eᵀ·E − tr(E·Eᵀ)·E = 0."""
    Ee = B.movedim(-3, -1)                                       # [..., 3,3,4]
    det = None
    for perm, sign in (((0, 1, 2), 1), ((1, 2, 0), 1), ((2, 0, 1), 1),
                       ((0, 2, 1), -1), ((2, 1, 0), -1), ((1, 0, 2), -1)):
        p2 = _mul11(Ee[..., 0, perm[0], :], Ee[..., 1, perm[1], :])
        t = sign * _mul21(p2, Ee[..., 2, perm[2], :])
        det = t if det is None else det + t
    EEt = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc = None
            for k in range(3):
                t = _mul11(Ee[..., i, k, :], Ee[..., j, k, :])
                acc = t if acc is None else acc + t
            EEt[i][j] = acc
    trace = EEt[0][0] + EEt[1][1] + EEt[2][2]
    rows = [det]
    for i in range(3):
        for j in range(3):
            acc = None
            for k in range(3):
                t = 2.0 * _mul21(EEt[i][k], Ee[..., k, j, :])
                acc = t if acc is None else acc + t
            rows.append(acc - _mul21(trace, Ee[..., i, j, :]))
    return torch.stack(rows, -2)


def _z_poly_system(M: torch.Tensor) -> torch.Tensor:
    """Gauss-Jordan + row combination -> Bz [..., 3, 3, 11]: the
    z-polynomial coefficients (low to high) of B(z)·[x, y, 1]ᵀ = 0."""
    tail = lu_solve(M[..., :10], M[..., 10:])                   # [..., 10, 10]

    def zpolys(t):
        # x group over (xz², xz, x), y group likewise, 1 over (z³, z², z, 1).
        return (torch.stack([t[..., 2], t[..., 1], t[..., 0]], -1),
                torch.stack([t[..., 5], t[..., 4], t[..., 3]], -1),
                torch.stack([t[..., 9], t[..., 8], t[..., 7], t[..., 6]], -1))

    def row_combo(rz_idx, r_idx):
        """eq(pivot with z) − z·eq(pivot) as a row of z-polynomials."""
        cols = []
        for p1, p2 in zip(zpolys(tail[..., rz_idx, :]),
                          zpolys(tail[..., r_idx, :])):
            n = p1.shape[-1]
            zero = torch.zeros_like(p1[..., :1])
            combo = torch.cat([p1, zero], -1) - torch.cat([zero, p2], -1)
            cols.append(torch.cat([combo, p1.new_zeros(p1.shape[:-1]
                                                       + (10 - n,))], -1))
        return torch.stack(cols, -2)
    # Pivots: [x³, y³, x²y, xy², x²z, y²z, xyz, x², y², xy].
    return torch.stack([row_combo(4, 7), row_combo(5, 8), row_combo(6, 9)],
                       -3)


def _polymul(a, b, out_len=11):
    """Truncated product of z-polynomials a [..., la], b [..., lb]."""
    la, lb = a.shape[-1], b.shape[-1]
    full = a.new_zeros(a.shape[:-1] + (la + lb - 1,))
    for i in range(la):
        full[..., i:i + lb] += a[..., i:i + 1] * b
    if full.shape[-1] >= out_len:
        return full[..., :out_len]
    return torch.cat([full, full.new_zeros(full.shape[:-1]
                                           + (out_len - full.shape[-1],))], -1)


def _det_poly(Bz: torch.Tensor) -> torch.Tensor:
    """det of the 3×3 polynomial matrix [..., 3, 3, 11] -> [..., 11]."""
    def m2(r1, c1, r2, c2):
        return (_polymul(Bz[..., r1, c1, :], Bz[..., r2, c2, :])
                - _polymul(Bz[..., r1, c2, :], Bz[..., r2, c1, :]))
    return (_polymul(Bz[..., 0, 0, :], m2(1, 1, 2, 2))
            - _polymul(Bz[..., 0, 1, :], m2(1, 0, 2, 2))
            + _polymul(Bz[..., 0, 2, :], m2(1, 0, 2, 1)))


def _durand_kerner(coeffs: torch.Tensor, iters: int = 80):
    """All roots of degree-10 real polynomials (coeffs low->high
    [..., 11]) as (real [..., 10], imag [..., 10])."""
    lead = coeffs[..., 10]
    lead = torch.where(lead.abs() < 1e-30, torch.full_like(lead, 1e-30),
                       lead)
    cn = coeffs / lead[..., None]

    def horner(zr, zi):
        vr = torch.zeros_like(zr)
        vi = torch.zeros_like(zi)
        for k in range(10, -1, -1):
            vr, vi = vr * zr - vi * zi + cn[..., k, None], vr * zi + vi * zr
        return vr, vi

    k = torch.arange(10, dtype=coeffs.dtype, device=coeffs.device)
    radius = torch.sqrt(1.0 + cn[..., :10].abs().amax(-1))
    theta = 2.0 * math.pi * (k + 0.35) / 10.0
    zr = radius[..., None] * torch.cos(theta)
    zi = radius[..., None] * torch.sin(theta)
    eye10 = torch.eye(10, dtype=torch.bool, device=coeffs.device)
    for _ in range(iters):
        pr, pi = horner(zr, zi)
        dr = torch.where(eye10, 1.0, zr[..., :, None] - zr[..., None, :])
        di = torch.where(eye10, 0.0, zi[..., :, None] - zi[..., None, :])
        nr, ni = dr[..., 0], di[..., 0]
        for i in range(1, 10):
            nr, ni = (nr * dr[..., i] - ni * di[..., i],
                      nr * di[..., i] + ni * dr[..., i])
        mag = nr * nr + ni * ni
        bad = mag < 1e-60
        nr = torch.where(bad, 1e-30, nr)
        ni = torch.where(bad, 0.0, ni)
        mag = torch.where(bad, 1e-60, mag)
        zr_new = zr - (pr * nr + pi * ni) / mag
        zi_new = zi - (pi * nr - pr * ni) / mag
        ok = torch.isfinite(zr_new) & torch.isfinite(zi_new)
        zr = torch.where(ok, zr_new, zr)
        zi = torch.where(ok, zi_new, zi)
    return zr, zi


def _eval_poly(p, z0):
    """Horner evaluation of p [..., n] (low to high) at z0 [...]."""
    val = torch.zeros_like(z0)
    for k in range(p.shape[-1] - 1, -1, -1):
        val = val * z0 + p[..., k]
    return val


def generate_ematrix_hypotheses(q1: torch.Tensor, q2: torch.Tensor):
    """Five correspondences per sample (ray coords [..., 5, 2] each) ->
    (E [..., 10, 3, 3], valid [..., 10]); complex roots are masked out."""
    basis = _nullspace_basis(q1, q2)                             # [..., 4,3,3]
    Bz = _z_poly_system(_constraint_matrix(basis))               # [..., 3,3,11]
    zr, zi = _durand_kerner(_det_poly(Bz))                       # [..., 10]
    real_ok = zi.abs() < 1e-6 * (1.0 + zr.abs())
    # B(z0) per root; its null vector from the best-conditioned row pair.
    B0 = _eval_poly(Bz[..., None, :, :, :], zr[..., None, None])  # [..,10,3,3]
    cross = torch.linalg.cross
    v1 = cross(B0[..., 0, :], B0[..., 1, :], dim=-1)
    v2 = cross(B0[..., 0, :], B0[..., 2, :], dim=-1)
    v3 = cross(B0[..., 1, :], B0[..., 2, :], dim=-1)
    n1, n2, n3 = (torch.linalg.norm(v, dim=-1) for v in (v1, v2, v3))
    v = torch.where((n1 >= torch.maximum(n2, n3))[..., None], v1,
                    torch.where((n2 >= n3)[..., None], v2, v3))
    denom = torch.where(v[..., 2].abs() < 1e-30, 1e-30, v[..., 2])
    x = v[..., 0] / denom
    y = v[..., 1] / denom
    b = basis[..., None, :, :, :]
    E = (x[..., None, None] * b[..., 0, :, :] + y[..., None, None] * b[..., 1, :, :]
         + zr[..., None, None] * b[..., 2, :, :] + b[..., 3, :, :])
    norm = torch.linalg.norm(E.flatten(-2), dim=-1)
    E = E / torch.where(norm < 1e-30, 1.0, norm)[..., None, None]
    finite = torch.isfinite(E).all(-1).all(-1)
    return E, real_ok & finite


def compute_pose_ransac_5pt(samples, x1, x2, n_valid, f1, f2, threshold_px):
    """`compute_pose_ransac` (`lib/5point/5point.c:606`) for one image pair.

    samples [R, 5] round draws; x1/x2 [N, 2] centered PIXEL coords;
    threshold_px on the symmetric epipolar residual in pixels (squared, as
    `evaluate_Ematrix` compares).  Returns (E_ray best, num_inliers,
    inlier_mask); ties in the count go to the first hypothesis."""
    N = x1.shape[0]
    q1 = -x1 / f1
    q2 = -x2 / f2
    Es, ok = generate_ematrix_hypotheses(q1[samples], q2[samples])
    Es = Es.flatten(0, 1)                                        # [R*10,3,3]
    ok = ok.flatten()
    F = ematrix_to_fmatrix(Es, f1, f2)
    valid = torch.arange(N, device=x1.device) < n_valid
    r = fmatrix_residual(F, x2, x1)                              # [R*10, N]
    inl = valid & torch.isfinite(r) & (r < threshold_px * threshold_px)
    counts = torch.where(ok, inl.sum(-1), -1)
    best = torch.argmax(counts)
    return Es[best], counts[best], inl[best]


def estimate_pose_5point(samples, x1, x2, n_valid, f1, f2, threshold_px):
    """`EstimatePose5Point` (`src/Epipolar.cpp:87-114`): 5-point RANSAC,
    then (R, t) by multi-point cheirality voting.
    Returns (R, t, num_inliers, ok)."""
    E, cnt, inl = compute_pose_ransac_5pt(samples, x1, x2, n_valid, f1, f2,
                                          threshold_px)
    mask = (torch.arange(x1.shape[0], device=x1.device) < n_valid) & inl
    R, t, ok = decompose_essential_multipt(E, -x1 / f1, -x2 / f2, mask)
    return R, t, cnt, ok & (cnt > 0)
