"""Small dense linear algebra, batched over leading dimensions — port of
`bundler_sfm_tpu/ops/linalg_small.py` (`cholesky_solve`, `inv3`).

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
