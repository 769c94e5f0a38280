"""Fundamental / essential matrix estimation — batched 8-point RANSAC;
port of `bundler_sfm_tpu/ops/fmatrix.py` (`fmatrix_residual`,
`_closest_rank2`, `fit_fmatrix_linear`, `estimate_fmatrix_ransac`,
`refine_fmatrix_nonlinear`, `estimate_ematrix`).

Reference: `lib/imagelib/fmatrix.c` driven by `src/Epipolar.cpp:118-237`.
The residual is the reference's symmetric epipolar distance
(`fmatrix.c:63-88`):

    e(F; r, l) = (rᵀ F l)² · (1/|F l|²_xy + 1/|Fᵀ r|²_xy)

Convention: image-2 points are "r", image-1 points are "l", and the
returned F satisfies x2ᵀ F x1 = 0.  Every function is batched over a
leading problem dimension but the two single-pair functions at the end;
the RANSAC draw is an input (`samples`).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from bundler_sfm_tpu_torch.ops.essential import ematrix_to_fmatrix
from bundler_sfm_tpu_torch.ops.linalg_small import cholesky_solve
from bundler_sfm_tpu_torch.ops.ransac import gather_rows, hartley_normalize
from bundler_sfm_tpu_torch.ops.svd_utils import svd_small


def fmatrix_residual(F: torch.Tensor, r: torch.Tensor, l: torch.Tensor
                     ) -> torch.Tensor:
    """Symmetric epipolar residual.  F [..., 3, 3]; r, l [..., N, 2]
    inhomogeneous points (z=1 implied), broadcasting against F's leading
    dims.  Returns [..., N].  Written per component, so scoring R
    hypotheses against N points makes [.., R, N] temporaries only."""
    f = [[F[..., i, j, None] for j in range(3)] for i in range(3)]
    l0, l1 = l[..., 0], l[..., 1]
    r0, r1 = r[..., 0], r[..., 1]
    Fl0 = f[0][0] * l0 + f[0][1] * l1 + f[0][2]
    Fl1 = f[1][0] * l0 + f[1][1] * l1 + f[1][2]
    Fl2 = f[2][0] * l0 + f[2][1] * l1 + f[2][2]
    Ftr0 = r0 * f[0][0] + r1 * f[1][0] + f[2][0]
    Ftr1 = r0 * f[0][1] + r1 * f[1][1] + f[2][1]
    pt = r0 * Fl0 + r1 * Fl1 + Fl2
    d1 = Fl0 ** 2 + Fl1 ** 2
    d2 = Ftr0 ** 2 + Ftr1 ** 2
    return (1.0 / torch.clamp(d1, min=1e-300)
            + 1.0 / torch.clamp(d2, min=1e-300)) * pt * pt


def _closest_rank2(F: torch.Tensor, essential: bool) -> torch.Tensor:
    """Rank-2 projection U·diag(σ₁,σ₂,0)·Vᵀ; for essential also force equal
    singular values (reference `closest_rank2_matrix` /
    `closest_rank2_matrix_ssv`).  Keeps the JAX package's recompose formula:
    its F(I − v₃v₃ᵀ) variant rounded differently near the inlier threshold
    and shifted surviving match sets."""
    U, S, Vt = svd_small(F)
    zero = torch.zeros_like(S[..., 0])
    if essential:
        sm = 0.5 * (S[..., 0] + S[..., 1])
        S2 = torch.stack([sm, sm, zero], -1)
    else:
        S2 = torch.stack([S[..., 0], S[..., 1], zero], -1)
    return (U * S2[..., None, :]) @ Vt


def _with_unit_h33(X: torch.Tensor) -> torch.Tensor:
    """[..., 8] solution -> [..., 3, 3] matrix with entry (2, 2) = 1."""
    return torch.cat([X, torch.ones_like(X[..., :1])], -1).reshape(
        X.shape[:-1] + (3, 3))


def fit_fmatrix_linear(r: torch.Tensor, l: torch.Tensor, mask: torch.Tensor,
                       essential: bool) -> torch.Tensor:
    """Normalized (weighted) 8-point fit.  r, l [..., N, 2]; mask [..., N]
    selects rows.  Mirrors `estimate_fmatrix_linear`: Hartley
    normalization, inhomogeneous solve with F33=1, un-normalize, rank-2
    projection."""
    w = mask.to(r.dtype)
    rn, Tr = hartley_normalize(r, mask)
    ln, Tl = hartley_normalize(l, mask)
    u, v = ln[..., 0], ln[..., 1]
    up, vp = rn[..., 0], rn[..., 1]
    A = torch.stack([u * up, v * up, up, u * vp, v * vp, vp, u, v], -1)
    b = -torch.ones_like(u)
    Aw = A * w[..., None]
    eye = torch.eye(8, dtype=r.dtype, device=r.device)
    AtA = Aw.transpose(-1, -2) @ A + 1e-12 * eye
    Atb = (Aw.transpose(-1, -2) @ b[..., None])[..., 0]
    Fn = _with_unit_h33(cholesky_solve(AtA, Atb))
    F = Tr.transpose(-1, -2) @ Fn @ Tl
    return _closest_rank2(F, essential)


def estimate_fmatrix_ransac(samples: torch.Tensor, x1: torch.Tensor,
                            x2: torch.Tensor, n_valid: torch.Tensor,
                            threshold: float, essential: bool = False):
    """RANSAC F (or E) for a batch of padded correspondence sets.

    samples [B, R, 8] round draws; x1/x2 [B, N, 2] image-1 / image-2
    points; n_valid [B].  Threshold on the symmetric epipolar residual
    (reference: 9.0, NOT squared — `src/BundlerApp.h:63`).
    Returns (F [B,3,3], inlier_mask [B,N], num_inliers [B]) with
    x2ᵀ F x1 = 0.

    Hypothesis stage as in the JAX package: Hartley normalization over all
    valid correspondences, each round's 9×9 normal matrix summed from its
    8 samples' outer products, a batched 8×8 Cholesky, rank-2 projection,
    one [B, R, N] scoring pass, argmax (first round on ties), then an
    inlier-weighted linear refit kept when it explains at least as many
    points."""
    B, N, _ = x1.shape
    dtype = x1.dtype
    valid = torch.arange(N, device=x1.device) < n_valid[:, None]
    rn, Tr = hartley_normalize(x2, valid)
    ln, Tl = hartley_normalize(x1, valid)
    u, v = ln[..., 0], ln[..., 1]
    up, vp = rn[..., 0], rn[..., 1]
    a = torch.stack([u * up, v * up, up, u * vp, v * vp, vp, u, v,
                     torch.ones_like(u)], -1)                     # [B,N,9]
    s = gather_rows(a, samples)                                   # [B,R,8,9]
    M = s.transpose(-1, -2) @ s                                   # [B,R,9,9]
    AtA = M[..., :8, :8] + 1e-12 * torch.eye(8, dtype=dtype, device=x1.device)
    Atb = -M[..., :8, 8]
    Fn = _with_unit_h33(cholesky_solve(AtA, Atb))                 # [B,R,3,3]
    Fh = Tr.transpose(-1, -2)[:, None] @ Fn @ Tl[:, None]
    Fh = _closest_rank2(Fh, essential)
    resid = fmatrix_residual(Fh, x2[:, None], x1[:, None])        # [B,R,N]
    ok = torch.isfinite(resid) & (resid < threshold) & valid[:, None, :]
    del resid
    counts = ok.sum(-1)
    best = torch.argmax(counts, dim=-1)
    rows = torch.arange(B, device=x1.device)
    F = Fh[rows, best]
    inl = ok[rows, best]
    cnt = counts[rows, best]
    # Refit on the inliers of the best model; keep whichever model
    # explains more points (the refit can regress on small inlier sets).
    F2 = fit_fmatrix_linear(x2, x1, inl, essential)
    r2 = fmatrix_residual(F2, x2, x1)
    inl2 = valid & torch.isfinite(r2) & (r2 < threshold)
    n2 = inl2.sum(-1)
    better = n2 >= cnt
    F_out = torch.where(better[:, None, None], F2, F)
    inl_out = torch.where(better[:, None], inl2, inl)
    return F_out, inl_out, torch.maximum(n2, cnt)


def refine_fmatrix_nonlinear(F0: torch.Tensor, x1: torch.Tensor,
                             x2: torch.Tensor, mask: torch.Tensor,
                             num_iters: int = 10) -> torch.Tensor:
    """Gauss-Newton polish of one F [3, 3] on its inliers, minimizing the
    symmetric epipolar residual (role of `refine_fmatrix_nonlinear_matches`,
    `lib/imagelib/fmatrix.h:63-77`): x1/x2 [N, 2], mask [N].  F is kept
    unit-norm, a step is kept only when it lowers the cost, and the result
    is projected to rank 2.  The Jacobian is forward-mode AD of the
    residual, as in the JAX package."""
    w = mask.to(F0.dtype)
    eye = torch.eye(9, dtype=F0.dtype, device=F0.device)

    def residuals(fvec):
        r = fmatrix_residual(fvec.reshape(3, 3), x2, x1)
        return torch.sqrt(torch.clamp(r, min=1e-300)) * w

    fvec = F0.reshape(9)
    fvec = fvec / torch.clamp(torch.linalg.norm(fvec), min=1e-12)
    for _ in range(num_iters):
        J = jacfwd(residuals)(fvec)                                # [N, 9]
        r = residuals(fvec)
        delta = cholesky_solve(J.T @ J + 1e-9 * eye, J.T @ r)
        fnew = fvec - delta
        fnew = fnew / torch.clamp(torch.linalg.norm(fnew), min=1e-12)
        improved = (residuals(fnew) ** 2).sum() < (r ** 2).sum()
        fvec = torch.where(improved, fnew, fvec)
    return _closest_rank2(fvec.reshape(3, 3), essential=False)


def estimate_ematrix(samples: torch.Tensor, x1: torch.Tensor,
                     x2: torch.Tensor, n_valid: int, f1: float, f2: float,
                     threshold_px_sq: float):
    """Essential matrix of one image pair from pixel coords and known
    focals (`EstimateEMatrix`, `src/Epipolar.cpp:37-83`).

    samples [R, 8] round draws; x1/x2 [N, 2] centered pixel coords.  The
    points are NEGATED into ray coordinates (-x/f, the 5-point path's sign
    flip) and run through essential-constrained F RANSAC with the pixel
    threshold scaled by (0.5·(f1 + f2))², so the returned E acts on rays
    and decomposes directly into the bundler-convention pose.  Returns
    (E_ray [3, 3], F_pixel [3, 3], inliers [N], count)."""
    scale = 0.5 * (f1 + f2)
    E, inl, cnt = estimate_fmatrix_ransac(
        samples[None], (-x1 / f1)[None], (-x2 / f2)[None],
        torch.tensor([n_valid], device=x1.device),
        threshold_px_sq / (scale * scale), essential=True)
    return E[0], ematrix_to_fmatrix(E[0], f1, f2), inl[0], cnt[0]
