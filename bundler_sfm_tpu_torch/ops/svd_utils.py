"""Small-matrix SVD built on symmetric eigendecomposition — port of
`bundler_sfm_tpu/ops/svd_utils.py` (`eigh3x3`, `svd_small`,
`nullspace_rows`).

The 3×3 case keeps the JAX package's closed form (Cardano eigenvalues,
cross-product eigenvectors), so F-matrix rank projections round the same
way on both packages: `ops/fmatrix.py::_closest_rank2` records that a
different but algebraically equal formula shifted inlier sets.

    AᵀA = V S² Vᵀ;   U = A V S⁻¹
"""

from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def eigh3x3(A: torch.Tensor):
    """Closed-form symmetric 3×3 eigendecomposition [..., 3, 3], eigenvalues
    ascending.  Eigenvectors for each λ come from the pair of rows of
    (A−λI) with the largest cross product; the middle vector is rebuilt
    orthogonal as v_max × v_min."""
    dtype = A.dtype
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    safe_p = torch.clamp(p, min=1e-30)
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detB / (2.0 * safe_p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = 2.0943951023931953
    lmax = q + 2.0 * p * torch.cos(phi)
    lmin = q + 2.0 * p * torch.cos(phi + two_pi_3)
    lmid = 3.0 * q - lmax - lmin
    w = torch.stack([lmin, lmid, lmax], dim=-1)

    eye = torch.eye(3, dtype=dtype, device=A.device)

    def eigvec(lam):
        B = A - lam[..., None, None] * eye
        r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
        c01 = _cross(r0, r1)
        c02 = _cross(r0, r2)
        c12 = _cross(r1, r2)
        n01 = (c01 * c01).sum(-1)
        n02 = (c02 * c02).sum(-1)
        n12 = (c12 * c12).sum(-1)
        v = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                        torch.where((n02 >= n12)[..., None], c02, c12))
        nv = torch.sqrt((v * v).sum(-1, keepdim=True))
        # Degenerate (isotropic): any unit vector is an eigenvector.
        fallback = eye[0].expand(v.shape)
        return torch.where(nv > 1e-30, v / torch.clamp(nv, min=1e-30), fallback)

    v_min = eigvec(lmin)
    v_max = eigvec(lmax)
    # Re-orthogonalize the extremes and rebuild the middle.
    v_max = v_max - (v_max * v_min).sum(-1, keepdim=True) * v_min
    nmax = torch.sqrt((v_max * v_max).sum(-1, keepdim=True))
    alt = _cross(v_min, eye[0].expand(v_min.shape))
    alt_n = torch.sqrt((alt * alt).sum(-1, keepdim=True))
    alt2 = _cross(v_min, eye[1].expand(v_min.shape))
    alt = torch.where(alt_n > 1e-6, alt,
                      alt2 / torch.clamp(torch.sqrt(
                          (alt2 * alt2).sum(-1, keepdim=True)), min=1e-30))
    v_max = torch.where(nmax > 1e-30, v_max / torch.clamp(nmax, min=1e-30), alt)
    v_mid = _cross(v_max, v_min)
    V = torch.stack([v_min, v_mid, v_max], dim=-1)          # columns
    return w, V


def svd_small(A: torch.Tensor):
    """Thin SVD of small [..., m, 3] matrices via eigh3x3(AᵀA); singular
    values DESCENDING.  Returns (U [..., m, 3], s [..., 3], Vt [..., 3, 3])."""
    AtA = A.transpose(-1, -2) @ A
    w, V = eigh3x3(AtA)
    w = w.flip(-1)
    V = V.flip(-1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    U = A @ V / torch.clamp(s[..., None, :], min=1e-30)
    return U, s, V.transpose(-1, -2)


def nullspace_rows(A: torch.Tensor, k: int) -> torch.Tensor:
    """The k right-singular vectors of A [..., m, n] with the SMALLEST
    singular values, as rows [..., k, n], from the eigenvectors of AᵀA
    (ascending).  Where those singular values are (near) zero the returned
    rows are one orthonormal basis of the null space; which one depends on
    the eigensolver, so callers must use only the space they span."""
    AtA = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(AtA)
    return V[..., :k].transpose(-1, -2)
