"""Small dense linear algebra, batched over leading dimensions — port of
`bundler_sfm_tpu/ops/linalg_small.py` (`cholesky_solve`, `inv3`, `solve3`,
`lu_solve`, `qr3`).

The systems solved here are symmetric positive definite by construction
(Hartley-normalized normal equations with a ridge), so a pivot-free
Cholesky with the JAX package's clamp on the pivot is used: the same
formula on every device, and it never raises on a degenerate RANSAC sample
(it returns a non-finite model, which scoring rejects).
"""

from __future__ import annotations

import torch


def cholesky_unrolled(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of small SPD matrices [..., n, n] (no pivoting;
    callers ridge the matrix)."""
    n = A.shape[-1]
    tiny = torch.finfo(A.dtype).tiny
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[..., j, j]
        if j:
            s = s - (L[..., j, :j] ** 2).sum(-1)
        d = torch.sqrt(torch.clamp(s, min=tiny))
        L[..., j, j] = d
        if j + 1 < n:
            below = A[..., j + 1:, j]
            if j:
                below = below - (L[..., j + 1:, :j] @ L[..., j, :j, None])[..., 0]
            L[..., j + 1:, j] = below / d[..., None]
    return L


def cholesky_substitute(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the lower Cholesky factor L [..., n, n] of A;
    b [..., n]."""
    n = L.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        yi = b[..., i]
        if i:
            yi = yi - (L[..., i, :i] * y[..., :i]).sum(-1)
        y[..., i] = yi / L[..., i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        xi = y[..., i]
        if i + 1 < n:
            xi = xi - (L[..., i + 1:, i] * x[..., i + 1:]).sum(-1)
        x[..., i] = xi / L[..., i, i]
    return x


def cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small SPD A [..., n, n], b [..., n]."""
    return cholesky_substitute(cholesky_unrolled(A), b)


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of general 3×3 matrices [..., 3, 3]."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    adj = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)], -2)
    det = a * adj[..., 0, 0] + b * adj[..., 1, 0] + c * adj[..., 2, 0]
    tiny = torch.finfo(A.dtype).tiny
    det = torch.where(det.abs() < tiny, torch.full_like(det, tiny), det)
    return adj / det[..., None, None]


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve general 3×3 systems A [..., 3, 3] x = b [..., 3] through the
    adjugate inverse (the JAX package's Cramer form)."""
    return (inv3(A) @ b[..., None])[..., 0]


def lu_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve general A [..., n, n] X = B [..., n, k] with partial pivoting.
    The JAX package unrolls this for the TPU's missing f64 LU; here it is
    LAPACK / cuSOLVER's LU."""
    return torch.linalg.solve(A, B)


def qr3(A: torch.Tensor):
    """QR of nonsingular 3×3 matrices [..., 3, 3] by modified Gram-Schmidt:
    (Q, R) with R upper-triangular and diag(R) > 0 — the JAX package's sign
    convention, which `rotations.rq3` relies on."""
    a0, a1, a2 = A[..., :, 0], A[..., :, 1], A[..., :, 2]

    def dot(x, y):
        return (x * y).sum(-1)
    r00 = torch.sqrt(dot(a0, a0))
    q0 = a0 / r00[..., None]
    r01 = dot(q0, a1)
    u1 = a1 - r01[..., None] * q0
    r11 = torch.sqrt(dot(u1, u1))
    q1 = u1 / r11[..., None]
    r02 = dot(q0, a2)
    r12 = dot(q1, a2)
    u2 = a2 - r02[..., None] * q0 - r12[..., None] * q1
    r22 = torch.sqrt(dot(u2, u2))
    q2 = u2 / r22[..., None]
    Q = torch.stack([q0, q1, q2], -1)
    z = torch.zeros_like(r00)
    R = torch.stack([torch.stack([r00, r01, r02], -1),
                     torch.stack([z, r11, r12], -1),
                     torch.stack([z, z, r22], -1)], -2)
    return Q, R
