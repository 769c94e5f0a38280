"""The new-camera refine LM as one hand-written CUDA launch a call
(`csrc/refine_lm.cu`).

`ops/lm.py::camera_refine_batch` hands CUDA tensors here; its plain
version (`camera_refine_batch_plain`, the same module) runs the same LM as
a lockstep tensor loop on the CPU.  The kernel replaces no Pallas kernel:
the JAX package vmaps a `lax.while_loop`.  It runs each lane's whole LM on
one CTA, with no host read and no launch between iterations; the source
note says what bounds it (latency) and what the design does about that.

`refine_lm` counts its launches in `LAUNCHES["refine_lm"]` and in the
telemetry counter `refine_lm_launches`.  The library is built with `nvcc`
at first use into `build/kernels/` (`csrc_build.py`), as the 2-NN
kernels are.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from bundler_sfm_tpu_torch.csrc_build import build
from bundler_sfm_tpu_torch.utils import counter

SOURCE = "refine_lm.cu"
LAUNCHES = {"refine_lm": 0}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build(SOURCE))
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        # cam0, R0, X, P, mask, fc, fw, active, B, N, adjust_focal, free_k,
        # dw, max_iters, tau, cam, R, cost, iters, stream
        lib.refine_lm_f64.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, d,
                                      i, d, p, p, p, p, p]
        lib.refine_lm_f64.restype = i
        _lib = lib
    return _lib


def refine_lm(cam0: torch.Tensor, R0: torch.Tensor, points: torch.Tensor,
              projs: torch.Tensor, mask: torch.Tensor, adjust_focal: bool,
              estimate_distortion: bool, focal_constraint, focal_weight,
              distortion_weight: float, max_iters: int, tau: float,
              active=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """`camera_refine_batch` on CUDA float64 tensors in one launch: returns
    (cam [B,9], R [B,3,3], cost [B], iterations int32 [B]), each lane's
    iteration count 0 outside `active`.  Raises on another device or
    dtype, or on shapes that do not agree."""
    B = cam0.shape[0]
    dev = cam0.device
    if dev.type != "cuda":
        raise ValueError(f"refine_lm: needs CUDA tensors, got {dev}")
    N = points.shape[1] if points.dim() == 3 else -1
    shapes = ((cam0, (B, 9)), (R0, (B, 3, 3)), (points, (B, N, 3)),
              (projs, (B, N, 2)), (mask, (B, N)))
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"refine_lm: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != dev:
            raise ValueError(f"refine_lm: a tensor on {t.device}, cam0 on "
                             f"{dev}")
    for t in (cam0, R0, points, projs):
        if t.dtype != torch.float64:
            raise ValueError(f"refine_lm: the refine runs in float64, got "
                             f"{t.dtype}")
    if mask.dtype != torch.bool:
        raise ValueError(f"refine_lm: mask must be bool, got {mask.dtype}")
    fc = torch.as_tensor(focal_constraint, dtype=torch.float64,
                         device=dev).expand(B).contiguous()
    fw = torch.as_tensor(focal_weight, dtype=torch.float64,
                         device=dev).expand(B).contiguous()
    act = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
           else active.to(device=dev, dtype=torch.bool).contiguous())
    ins = [t.contiguous() for t in (cam0, R0, points, projs, mask)]
    cam = torch.empty_like(ins[0])
    R = torch.empty_like(ins[1])
    cost = torch.empty(B, dtype=torch.float64, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return cam, R, cost, iters
    dw = float(distortion_weight) if estimate_distortion else 0.0
    err = _load().refine_lm_f64(
        *(t.data_ptr() for t in ins), fc.data_ptr(), fw.data_ptr(),
        act.data_ptr(), B, N, int(bool(adjust_focal)),
        int(bool(estimate_distortion)), dw, int(max_iters), float(tau),
        cam.data_ptr(), R.data_ptr(), cost.data_ptr(), iters.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"refine_lm: launch failed (cudaError {err})")
    LAUNCHES["refine_lm"] += 1
    counter("refine_lm_launches")
    return cam, R, cost, iters
