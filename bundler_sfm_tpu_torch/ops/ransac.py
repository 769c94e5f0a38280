"""Batched fixed-round RANSAC machinery — port of
`bundler_sfm_tpu/ops/ransac.py`.

The reference runs RANSAC as a sequential hypothesize-score loop per pair
(`lib/imagelib/fmatrix.c`, `src/Register.cpp:82-144`).  Here every
hypothesis of every problem in a batch is fit and scored at once.

The sample draw is an input: `sample_indices` draws distinct valid indices
per round from a `torch.Generator`, and every fit/score function takes the
drawn indices, so a caller (or a test) can hand in another draw — the JAX
package's `jax.random` stream cannot be reproduced by torch.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch


def sample_indices(generator: torch.Generator, num_rounds: int,
                   sample_size: int, n_valid: torch.Tensor, n_pad: int
                   ) -> torch.Tensor:
    """[B, num_rounds, sample_size] distinct indices drawn uniformly from
    [0, n_valid[b]) (requires n_valid >= sample_size; `n_pad` bounds them).

    Floyd's subset sampling, vectorized over problems and rounds: step j
    draws t uniform in [0, n - k + j] and takes t, or n - k + j if t was
    already taken — a uniformly random k-subset with no rejection loop and
    no [rounds, n_pad] noise tensor."""
    device = n_valid.device
    n = torch.clamp(n_valid.to(torch.int64), max=n_pad)[:, None]     # [B, 1]
    B = n.shape[0]
    picks = []
    for j in range(sample_size):
        top = n - sample_size + j                                     # [B, 1]
        u = torch.rand((B, num_rounds), generator=generator,
                       dtype=torch.float64, device=device)
        t = torch.minimum((u * (top + 1)).to(torch.int64), top)
        if picks:
            taken = (torch.stack(picks, -1) == t[..., None]).any(-1)
            t = torch.where(taken, top.expand_as(t), t)
        picks.append(t)
    return torch.stack(picks, -1)


def gather_rows(x: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """x [B, N, d], samples [B, R, k] -> [B, R, k, d]."""
    B, R, k = samples.shape
    idx = samples.reshape(B, R * k, 1).expand(B, R * k, x.shape[-1])
    return torch.gather(x, 1, idx).reshape(B, R, k, x.shape[-1])


def run_ransac(
    samples: torch.Tensor,     # [B, R, k] sample indices
    fit_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    residual_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                          torch.Tensor],
    x1: torch.Tensor,          # [B, N, d1] padded observations (side 1)
    x2: torch.Tensor,          # [B, N, d2] padded observations (side 2)
    n_valid: torch.Tensor,     # [B] live entries
    threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generic batched RANSAC.

    fit_fn(s1 [B,R,k,d1], s2 [B,R,k,d2]) -> models [B, R, ...]
    residual_fn(models, x1, x2)           -> [B, R, N] residuals
    Returns (best_model [B, ...], inlier_mask [B, N] bool, num_inliers [B]).
    Ties in the inlier count go to the first round, as `jnp.argmax`."""
    N = x1.shape[1]
    models = fit_fn(gather_rows(x1, samples), gather_rows(x2, samples))
    resid = residual_fn(models, x1, x2)
    valid = torch.arange(N, device=x1.device) < n_valid[:, None]
    ok = torch.isfinite(resid) & (resid < threshold) & valid[:, None, :]
    counts = ok.sum(-1)
    best = torch.argmax(counts, dim=-1)
    rows = torch.arange(len(best), device=best.device)
    return models[rows, best], ok[rows, best], counts[rows, best]


def hartley_normalize(pts: torch.Tensor, mask: torch.Tensor):
    """Isotropic normalization used by the reference's estimators
    (`lib/imagelib/fmatrix.c estimate_fmatrix_linear`): subtract the
    centroid of the masked points, scale their mean |p - c| to sqrt(2).
    pts [..., N, 2], mask [..., N].  Returns (pts_norm [..., N, 2],
    T [..., 3, 3])."""
    w = mask.to(pts.dtype)
    count = torch.clamp(w.sum(-1), min=1.0)
    c = (pts * w[..., None]).sum(-2) / count[..., None]
    d = torch.sqrt(((pts - c[..., None, :]) ** 2).sum(-1) + 1e-300)
    mean_d = (d * w).sum(-1) / count
    scale = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-12)
    pn = (pts - c[..., None, :]) * scale[..., None, None]
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * c[..., 0]], -1),
        torch.stack([zero, scale, -scale * c[..., 1]], -1),
        torch.stack([zero, zero, one], -1)], -2)
    return pn, T
