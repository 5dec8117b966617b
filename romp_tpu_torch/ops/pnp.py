"""Differentiable PnP: a batched Levenberg-Marquardt pose solver
(counterpart of `romp_tpu/ops/pnp.py`).

The deterministic core of the reference's vendored EProPnP solver
(`trace/lib/epropnp/`: `LMSolver:22`, `EProPnP6DoF:263`, the optional
camera estimation of TRACE's training): 6-DoF or 4-DoF reprojection LM
with a fixed number of iterations, damped normal equations and the
trust-region gate that keeps only improving steps. Rotation is axis-angle.
The loop is unrolled in Python, so autograd differentiates through it, as
JAX differentiates through its `fori_loop`. The Jacobian is forward-mode
(`torch.func.jacfwd` under `torch.func.vmap`), as JAX's `jacfwd` under
`vmap`. Everything stays on the inputs' device and dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from romp_tpu_torch.ops.rotations import axis_angle_to_matrix


class PnPResult(NamedTuple):
    rotation_aa: torch.Tensor    # (B, 3)
    translation: torch.Tensor    # (B, 3)
    cost: torch.Tensor           # (B,) final mean squared reprojection error


def _project(pts3d, aa, t, f, c):
    R = axis_angle_to_matrix(aa)                       # (B, 3, 3)
    p = torch.einsum("bij,bnj->bni", R, pts3d) + t[:, None]
    # jnp.maximum: a tie passes half the gradient to each side
    z = torch.maximum(p[..., 2], torch.full_like(p[..., 2], 1e-6))
    return p[..., :2] / z[..., None] * f + c, z


def _residuals(params, pts3d, pts2d, w, f, c):
    aa, t = params[..., :3], params[..., 3:6]
    proj, _ = _project(pts3d, aa, t, f, c)
    return ((proj - pts2d) * w[..., None]).reshape(params.shape[0], -1)


def lm_pnp(pts3d: torch.Tensor, pts2d: torch.Tensor, weights: torch.Tensor,
           focal: float, center: torch.Tensor,
           init_aa: Optional[torch.Tensor] = None,
           init_t: Optional[torch.Tensor] = None,
           iters: int = 10, damping: float = 1e-3,
           dof: int = 6) -> PnPResult:
    """Solve camera pose from (B, N, 3) points / (B, N, 2) pixels with
    (B, N) weights; center (2,).

    dof=6: full rotation + translation; dof=4: yaw (about y) + translation
    (the reference's EProPnP4DoF case: the other rotation components stay
    at their initial values).
    """
    B = pts3d.shape[0]
    kw = dict(dtype=pts3d.dtype, device=pts3d.device)
    center = torch.as_tensor(center, **kw)
    if init_aa is None:
        init_aa = torch.zeros((B, 3), **kw)
    if init_t is None:
        init_t = torch.cat([torch.zeros((B, 2), **kw),
                            torch.full((B, 1), 5.0, **kw)], -1)
    params = torch.cat([init_aa, init_t], -1)
    mask = (torch.tensor([0.0, 1.0, 0.0, 1.0, 1.0, 1.0], **kw) if dof == 4
            else torch.ones(6, **kw))
    eye = torch.eye(6, **kw)

    def res_fn(p):
        return _residuals(p, pts3d, pts2d, weights, focal, center)

    def single(p, x3, x2, w):
        return _residuals(p[None], x3[None], x2[None], w[None], focal,
                          center)[0]

    jac = torch.func.vmap(torch.func.jacfwd(single))
    for _ in range(iters):
        r = res_fn(params)                                    # (B, 2N)
        Jb = jac(params, pts3d, pts2d, weights) * mask        # (B, 2N, 6)
        JtJ = torch.einsum("bni,bnj->bij", Jb, Jb)
        Jtr = torch.einsum("bni,bn->bi", Jb, r)
        step = torch.linalg.solve(JtJ + damping * eye, Jtr[..., None])[..., 0]
        new = params - step * mask
        # accept only improving steps (the LM trust-region gate)
        better = ((res_fn(new) ** 2).sum(-1) < (r ** 2).sum(-1))[:, None]
        params = torch.where(better, new, params)

    r = res_fn(params)
    nvalid = torch.clamp((weights > 0).sum(-1), min=1)
    cost = (r ** 2).sum(-1) / nvalid
    return PnPResult(params[..., :3], params[..., 3:6], cost)


def estimate_camera_pnp(joints3d: torch.Tensor, joints2d_px: torch.Tensor,
                        conf: torch.Tensor, focal: float = 548.0,
                        img_size: float = 512.0,
                        iters: int = 10) -> PnPResult:
    """6-DoF LM from SMPL joints to detected 2D joints (the optional
    camera-estimation path of TRACE)."""
    c = torch.tensor([img_size / 2.0, img_size / 2.0], dtype=joints3d.dtype,
                     device=joints3d.device)
    return lm_pnp(joints3d, joints2d_px, conf, focal, c, iters=iters)
