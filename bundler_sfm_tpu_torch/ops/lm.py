"""Small dense LM: single-camera refinement, batched over candidate
cameras — port of `bundler_sfm_tpu/ops/lm.py`.

Replaces `camera_refine` (`lib/sfm-driver/sfm.c:1006-1190`, minpack lmdif):
refine one camera's pose (+ optionally focal / distortion) against fixed 3D
points, with the reference's focal prior and distortion shrink as penalty
residuals (`sfm.c:1088-1160`).

The JAX package vmaps one LM while-loop per camera.  Here the cameras of a
registration round are lanes of one call.  On CUDA tensors the call is one
launch of a hand-written kernel (`ops/lm_cuda.py`, `csrc/refine_lm.cu`)
that runs each lane's whole LM on the device.  On the CPU it is the plain
version, `camera_refine_batch_plain`: one batched tensor program whose
every iteration runs all lanes, with a per-lane `active` mask that keeps a
lane's state once its own loop would have stopped, so each lane ends
exactly where its own loop ends; the host reads one flag per iteration
(any lane active).  Both return each lane's iteration count;
`camera_refine_trim_batch` adds the largest of each call to counter
`refine_lm_iters` (the lockstep iterations) at the host read each trim
pass already makes.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacfwd, vmap

from bundler_sfm_tpu_torch.ops import lm_cuda
from bundler_sfm_tpu_torch.ops.ba import F_SCALE, K_SCALE
from bundler_sfm_tpu_torch.ops.linalg_small import cholesky_solve
from bundler_sfm_tpu_torch.ops.projection import project_one
from bundler_sfm_tpu_torch.ops.rotations import rot_update
from bundler_sfm_tpu_torch.utils import counter

CNP = 9


def _residuals(cam, R0, points, projs, mask, fc, fw, dw):
    """One lane: masked reprojection residuals [2N] + 3 penalties."""
    r = torch.where(mask[:, None], project_one(cam, R0, points) - projs, 0.0)
    pen = torch.stack([torch.sqrt(fw) * (cam[6] - fc),
                       torch.sqrt(dw) * cam[7], torch.sqrt(dw) * cam[8]])
    return torch.cat([r.reshape(-1), pen])


_res_batch = vmap(_residuals, in_dims=(0, 0, 0, 0, 0, 0, 0, None))
_jac_batch = vmap(jacfwd(_residuals), in_dims=(0, 0, 0, 0, 0, 0, 0, None))


def _sel(m, new, old):
    return torch.where(m.reshape(m.shape + (1,) * (new.dim() - 1)), new, old)


def camera_refine_batch(
    cam0: torch.Tensor,        # [B,9] (c, w=0, f, k1, k2)
    R0: torch.Tensor,          # [B,3,3]
    points: torch.Tensor,      # [B,N,3] fixed
    projs: torch.Tensor,       # [B,N,2]
    mask: torch.Tensor,        # [B,N] bool
    adjust_focal: bool = True,
    estimate_distortion: bool = False,
    focal_constraint=0.0,      # [B] target focal (0 = none)
    focal_weight=0.0,          # [B]
    distortion_weight: float = 1.0e2,
    max_iters: int = 50,
    tau: float = 1e-3,
    active=None,               # [B] bool: lanes to refine (default all)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """LM refinement of each lane's camera; returns (cam [B,9] with w
    folded, R [B,3,3], cost [B], iterations int32 [B]: each lane's LM
    iterations, 0 outside `active`).  Lanes outside `active` come back as
    given.  CUDA tensors (float64 only) run `lm_cuda.refine_lm`, one
    launch; others the plain version."""
    args = (cam0, R0, points, projs, mask, adjust_focal, estimate_distortion,
            focal_constraint, focal_weight, distortion_weight, max_iters, tau,
            active)
    if cam0.device.type == "cuda":
        return lm_cuda.refine_lm(*args)
    return camera_refine_batch_plain(*args)


def camera_refine_batch_plain(
    cam0: torch.Tensor,        # [B,9] (c, w=0, f, k1, k2)
    R0: torch.Tensor,          # [B,3,3]
    points: torch.Tensor,      # [B,N,3] fixed
    projs: torch.Tensor,       # [B,N,2]
    mask: torch.Tensor,        # [B,N] bool
    adjust_focal: bool = True,
    estimate_distortion: bool = False,
    focal_constraint=0.0,      # [B] target focal (0 = none)
    focal_weight=0.0,          # [B]
    distortion_weight: float = 1.0e2,
    max_iters: int = 50,
    tau: float = 1e-3,
    active=None,               # [B] bool: lanes to refine (default all)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`camera_refine_batch` as a lockstep tensor loop: returns (cam [B,9]
    with w folded, R [B,3,3], cost [B], iterations int32 [B]).  Lanes
    outside `active` come back as given.  LM runs in the scaled space
    q = s∘x (F_SCALE, K_SCALE) and stops a lane once an accepted step
    improves its cost by less than ~100 ulp (the JAX package's
    relative-cost test), on a tiny gradient or step, or when mu passes
    1e30."""
    B = cam0.shape[0]
    dtype, dev = cam0.dtype, cam0.device
    pmask = torch.ones(CNP, dtype=dtype, device=dev)
    if not adjust_focal:
        pmask[6] = 0.0
    if not estimate_distortion:
        pmask[7:9] = 0.0
    fc = torch.as_tensor(focal_constraint, dtype=dtype, device=dev).expand(B)
    fw = torch.as_tensor(focal_weight, dtype=dtype, device=dev).expand(B)
    dw = torch.tensor(distortion_weight if estimate_distortion else 0.0,
                      dtype=dtype, device=dev)
    inv_s = torch.tensor([1, 1, 1, 1, 1, 1, 1 / F_SCALE, 1 / K_SCALE,
                          1 / K_SCALE], dtype=dtype, device=dev)
    tiny = torch.finfo(dtype).eps
    eye = torch.eye(CNP, dtype=dtype, device=dev)
    args = (R0, points, projs, mask, fc, fw)

    def cost_of(cam):
        r = _res_batch(cam, *args, dw)
        return 0.5 * (r * r).sum(-1)

    J0 = _jac_batch(cam0, *args, dw) * (pmask * inv_s)
    mu = tau * torch.clamp(torch.diagonal(
        J0.transpose(-1, -2) @ J0, dim1=-2, dim2=-1).amax(-1), min=1.0)
    nu = torch.full_like(mu, 2.0)
    cost = cost_of(cam0)
    cam = cam0
    done = torch.zeros(B, dtype=torch.bool, device=dev) if active is None \
        else ~active
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        iters += (~done).int()
        J = _jac_batch(cam, *args, dw) * (pmask * inv_s)
        r = _res_batch(cam, *args, dw)
        Jt = J.transpose(-1, -2)
        g = (Jt @ r[..., None])[..., 0]
        H = Jt @ J + torch.diag(1.0 - pmask)
        delta = -cholesky_solve(H + mu[:, None, None] * eye, g) * pmask
        cam_new = cam + delta * inv_s
        new_cost = cost_of(cam_new)
        pred = 0.5 * (delta * (mu[:, None] * delta - g)).sum(-1)
        rho = (cost - new_cost) / torch.clamp(pred, min=1e-300)
        accept = new_cost < cost
        mu_next = torch.where(accept, mu * torch.clamp(
            1.0 - (2 * rho - 1) ** 3, min=1.0 / 3.0), mu * nu)
        nu_next = torch.where(accept, 2.0, nu * 2.0)
        converged = accept & ((cost - new_cost) <= 1e2 * tiny * cost)
        stop = converged | (g.abs().amax(-1) < 1e-12) \
            | (torch.linalg.norm(delta, dim=-1) < 1e-14) | (mu_next > 1e30)
        live = ~done
        cam = _sel(live & accept, cam_new, cam)
        cost = _sel(live & accept, new_cost, cost)
        mu = _sel(live, mu_next, mu)
        nu = _sel(live, nu_next, nu)
        done = done | stop
    R = rot_update(R0, cam[:, 3:6])
    cam = torch.cat([cam[:, :3], torch.zeros_like(cam[:, 3:6]), cam[:, 6:]],
                    1)
    if active is not None:
        cam = _sel(active, cam, cam0)
        R = _sel(active, R, R0)
    return cam, R, cost, iters


def _most(iters: torch.Tensor) -> torch.Tensor:
    """The largest iteration count of a call (0 for no lane), int64 on the
    call's device."""
    return iters.amax().long() if iters.numel() else \
        torch.zeros((), dtype=torch.int64, device=iters.device)


def camera_refine_trim_batch(
    cam0, R0, points, projs, mask0, adjust_focal=True,
    estimate_distortion=False, focal_constraint=0.0, focal_weight=0.0,
    distortion_weight=1.0e2, max_iters=50, tau=1e-3, num_stddev=2.0,
    thr_min=8.0, thr_max=16.0, trim_iters=20):
    """`RefineCameraParameters` (src/Bundle.cpp:2535-2694) for a batch of
    cameras: one LM pass with focal fixed, then repeat {LM refine, drop
    observations with reprojection error above
    clamp(1.2·num_stddev·p95, thr_min, thr_max)} until each lane's inlier set
    is stable.  Returns (cam [B,9], R [B,3,3], final inlier mask [B,N])."""
    kw = dict(estimate_distortion=estimate_distortion,
              focal_constraint=focal_constraint, focal_weight=focal_weight,
              distortion_weight=distortion_weight, max_iters=max_iters,
              tau=tau)
    cam, R, _, iters = camera_refine_batch(cam0, R0, points, projs, mask0,
                                           False, **kw)
    pending = _most(iters)
    mask = mask0
    done = ~mask0.any(-1)
    for _ in range(trim_iters):
        active = ~done & mask.any(-1)
        # The pass's one host read: whether a lane is left, and the
        # iterations of the LM just run.
        go, ran = torch.stack([active.any().long(), pending]).tolist()
        pending = None
        if ran:
            counter("refine_lm_iters", ran)
        if not go:
            break
        cam1, R1, _, iters = camera_refine_batch(
            cam, R, points, projs, mask, adjust_focal, active=active, **kw)
        pending = _most(iters)
        pred = project_one(cam1[:, None], R1[:, None], points)
        errs = torch.sqrt(((pred - projs) ** 2).sum(-1))
        n = mask.sum(-1)
        srt = torch.sort(torch.where(mask, errs, torch.inf), -1).values
        k95 = torch.minimum(torch.clamp(
            torch.round(0.95 * n.to(errs.dtype)).long(), min=0), n - 1)
        med = srt.gather(1, torch.clamp(k95, min=0)[:, None])[:, 0]
        thr = torch.clamp(1.2 * num_stddev * med, thr_min, thr_max)
        keep = mask & (errs < thr[:, None])
        stable = (keep == mask).all(-1) | ~keep.any(-1)
        cam = _sel(active, cam1, cam)
        R = _sel(active, R1, R)
        mask = _sel(active, keep, mask)
        done = done | (active & stable)
    if pending is not None:     # the passes ran out after a refine
        ran = int(pending)
        if ran:
            counter("refine_lm_iters", ran)
    return cam, R, mask
