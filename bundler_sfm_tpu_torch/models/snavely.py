"""The Snavely camera model in its three parameterizations — port of
`bundler_sfm_tpu/models/snavely.py`.

All variants share the projection p = R(X − c); (xp,yp) = −p.xy/p.z;
r² = xp² + yp²; distortion = 1 + k1·r² + k2·r⁴; pred = f·distortion·(xp,yp)
(`include/snavely_reprojection_error.h:53-96`).  Every `project` is torch
ops without data-dependent branches, batched over leading dimensions of
params / aux / X, and differentiates with `torch.func.jacfwd` for the BA
Jacobians.

- SnavelyModel: the framework-internal layout [c(3), w(3), f, k1, k2] with
  R = exp([w]ₓ)·R0 (the sfm-driver increment, `lib/sfm-driver/sfm.c:77`);
  this is what ops/ba.py optimizes.
- SnavelyQuaternionModel: the Ceres quaternion variant
  (`include/snavely_reprojection_error.h:103-151`): params
  [q(4), t(3), f, k1, k2], p = R(q)·X + t with an UNNORMALIZED quaternion
  (normalization folded into the rotation), matching
  QuaternionRotatePoint semantics.
- KnownIntrinsicsModel: f/k frozen (camera_params_t.known_intrinsics,
  `lib/sfm-driver/sfm.h:43-46`) — projection takes K as aux and only
  (c, w) vary.
"""

from __future__ import annotations

import torch

from bundler_sfm_tpu_torch.ops.projection import project_one
from bundler_sfm_tpu_torch.ops.rotations import rot_update


def _distort(u, f, k1, k2):
    rsq = (u[..., 0] * u[..., 0] + u[..., 1] * u[..., 1]) / (f * f)
    return u * (1.0 + k1 * rsq + k2 * rsq * rsq)[..., None]


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    """v (a number or a tensor) as a tensor of ref's dtype and device."""
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


class SnavelyModel:
    """params [..., 9] = [c(3), w(3), f, k1, k2]; aux = R0 [..., 3, 3]."""
    name = "snavely"
    num_params = 9

    @staticmethod
    def project(params, R0, X):
        return project_one(params, R0, X)

    @staticmethod
    def pack(center, w, f, k1, k2):
        c = torch.as_tensor(center, dtype=torch.float64)
        return torch.cat([c, _like(w, c),
                          torch.stack([_like(v, c) for v in (f, k1, k2)])])

    @staticmethod
    def rotation(params, R0):
        return rot_update(R0, params[..., 3:6])


class SnavelyQuaternionModel:
    """params [..., 12] = [q(4) unnormalized, t(3), f, k1, k2]; aux unused.

    Note this variant carries t (translation), not the camera center —
    exactly the Ceres block layout
    (`include/snavely_reprojection_error.h:110-127`).
    """
    name = "snavely_quaternion"
    num_params = 12

    @staticmethod
    def rotation(params, aux=None):
        q = params[..., 0:4]
        n = (q * q).sum(-1)
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        # Unnormalized-quaternion rotation: scale by 2/|q|² (the
        # QuaternionRotatePoint trick).
        s = 2.0 / torch.clamp(n, min=1e-30)
        return torch.stack([
            torch.stack([1 - s * (y * y + z * z), s * (x * y - w * z),
                         s * (x * z + w * y)], -1),
            torch.stack([s * (x * y + w * z), 1 - s * (x * x + z * z),
                         s * (y * z - w * x)], -1),
            torch.stack([s * (x * z - w * y), s * (y * z + w * x),
                         1 - s * (x * x + y * y)], -1)], -2)

    @staticmethod
    def project(params, aux, X):
        R = SnavelyQuaternionModel.rotation(params)
        p = (R @ X[..., None])[..., 0] + params[..., 4:7]
        f = params[..., 7]
        u = -f[..., None] * p[..., 0:2] / p[..., 2:3]
        return _distort(u, f, params[..., 8], params[..., 9])

    @staticmethod
    def from_rt(R, t, f, k1=0.0, k2=0.0):
        """Quaternion from a rotation matrix [3, 3] (w>0 branch; adequate
        for well-conditioned R) + the Ceres block layout.  The branch loses
        precision as R nears a half turn (1 + trace -> 0); for such R take
        the quaternion from `models.camera._quat_from_matrix` (Shepperd)."""
        R = torch.as_tensor(R, dtype=torch.float64)
        tr = R[0, 0] + R[1, 1] + R[2, 2]
        w = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) / 2.0
        x = (R[2, 1] - R[1, 2]) / (4.0 * w)
        y = (R[0, 2] - R[2, 0]) / (4.0 * w)
        z = (R[1, 0] - R[0, 1]) / (4.0 * w)
        return torch.cat([torch.stack([w, x, y, z]), _like(t, R),
                          torch.stack([_like(v, R) for v in (f, k1, k2)])])


class KnownIntrinsicsModel:
    """params [..., 6] = [c(3), w(3)]; aux = (R0, f, k1, k2): only the pose
    varies (camera_params_t.known_intrinsics, `lib/sfm-driver/sfm.h:43`)."""
    name = "known_intrinsics"
    num_params = 6

    @staticmethod
    def project(params, aux, X):
        R0, f, k1, k2 = aux
        fk = torch.stack([_like(v, params).expand(params.shape[:-1])
                          for v in (f, k1, k2)], -1)
        return project_one(torch.cat([params, fk], -1), R0, X)

    @staticmethod
    def rotation(params, aux):
        return rot_update(aux[0], params[..., 3:6])
