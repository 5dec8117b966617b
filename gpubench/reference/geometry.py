"""Rotations, the center-map parse and the cameras, plain.

Rotations follow the published ROMP / BEV code: 6D -> matrix by
Gram-Schmidt (columns b1, b2, b1 x b2), matrix -> axis-angle through the
quaternion (the kornia-style four-case choice on the transpose; NaNs to 0),
Rodrigues with the angle ||aa + 1e-8||.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

INVALID_TRANS = -1.0


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    shape = aa.shape[:-1]
    aa = aa.reshape(-1, 3)
    angle = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)
    axis = aa / angle
    cos, sin = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    rx, ry, rz = axis.unbind(-1)
    z = torch.zeros_like(rx)
    k = torch.stack([z, -rz, ry, rz, z, -rx, -ry, rx, z], -1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    outer = axis[:, :, None] * axis[:, None, :]
    return (eye + sin * k + (1.0 - cos) * (outer - eye)).reshape(*shape, 3, 3)


def rot6d_to_matrix(x: torch.Tensor) -> torch.Tensor:
    shape = x.shape[:-1]
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[..., 0], x[..., 1]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=1e-6)
    u = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = u / torch.linalg.norm(u, dim=-1, keepdim=True).clamp(min=1e-6)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1).reshape(*shape, 3, 3)


def matrix_to_axis_angle(r: torch.Tensor) -> torch.Tensor:
    shape = r.shape[:-2]
    m = r.reshape(-1, 3, 3).transpose(-1, -2)
    m00, m01, m02 = m[:, 0].unbind(-1)
    m10, m11, m12 = m[:, 1].unbind(-1)
    m20, m21, m22 = m[:, 2].unbind(-1)
    t0 = 1.0 + m00 - m11 - m22
    t1 = 1.0 - m00 + m11 - m22
    t2 = 1.0 - m00 - m11 + m22
    t3 = 1.0 + m00 + m11 + m22
    q0 = torch.stack([m12 - m21, t0, m01 + m10, m20 + m02], -1)
    q1 = torch.stack([m20 - m02, m01 + m10, t1, m12 + m21], -1)
    q2 = torch.stack([m01 - m10, m20 + m02, m12 + m21, t2], -1)
    q3 = torch.stack([t3, m12 - m21, m20 - m02, m01 - m10], -1)
    d2, d0d1, d0nd1 = m22 < 1e-6, m00 > m11, m00 < -m11
    c0, c1, c2 = d2 & d0d1, d2 & ~d0d1, ~d2 & d0nd1
    q = torch.where(c0[:, None], q0, torch.where(
        c1[:, None], q1, torch.where(c2[:, None], q2, q3)))
    t = torch.where(c0, t0, torch.where(c1, t1, torch.where(c2, t2, t3)))
    q = q * (0.5 / torch.sqrt(t))[:, None]
    v = q[:, 1:]
    sin_sq = (v * v).sum(-1)
    sin_t, cos_t = torch.sqrt(sin_sq), q[:, 0]
    two_theta = 2.0 * torch.where(cos_t < 0.0, torch.atan2(-sin_t, -cos_t),
                                  torch.atan2(sin_t, cos_t))
    k = torch.where(sin_sq > 0.0, two_theta / torch.where(
        sin_t > 0.0, sin_t, torch.ones_like(sin_t)), torch.full_like(sin_t, 2.0))
    return torch.nan_to_num(v * k[:, None]).reshape(*shape, 3)


def rot6d_to_axis_angle(x: torch.Tensor) -> torch.Tensor:
    """(..., J*6) -> (..., J*3)."""
    shape = x.shape[:-1]
    j = x.shape[-1] // 6
    r = rot6d_to_matrix(x.reshape(*shape, j, 6))
    return matrix_to_axis_angle(r).reshape(*shape, j * 3)


def thetas_from_6d(p6d: torch.Tensor) -> torch.Tensor:
    """(..., 132) 6D pose of 22 joints -> (..., 72) axis-angle with the two
    hand joints zero, as both models return it."""
    return torch.cat([rot6d_to_axis_angle(p6d[..., :6]),
                      rot6d_to_axis_angle(p6d[..., 6:]),
                      p6d.new_zeros(p6d.shape[:-1] + (6,))], dim=-1)


def nms(center: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Cells equal to their window's max keep their value, the rest 0.
    center (B, H, W) or (B, D, H, W): a 2D or 3D window."""
    pool = F.max_pool2d if center.dim() == 3 else F.max_pool3d
    pooled = pool(center[:, None], window, 1, (window - 1) // 2)[:, 0]
    return torch.where(center == pooled, center, torch.zeros_like(center))


def weak_perspective(points: torch.Tensor, cam: torch.Tensor,
                     keep_z: bool = False) -> torch.Tensor:
    """points (N, P, 3), cam (N, 3) = (s, tx, ty)."""
    xy = points[..., :2] * cam[:, None, 0:1] + cam[:, None, 1:3]
    return torch.cat([xy, points[..., 2:3]], -1) if keep_z else xy


def lstsq_system(j3d: torch.Tensor, j2d: torch.Tensor, w: torch.Tensor,
                 focal: float, size: float, min_points: int = 4):
    """The 3x3 normal equations A t = b of the camera translation t that
    minimizes sum_i w_i |f (X_i + t_x) - (u_i - c) (Z_i + t_z)|^2 (and the
    same in y), and which persons have `min_points` weighted joints.
    j3d (N, P, 3), j2d (N, P, 2) pixels, w (N, P) in {0, 1}."""
    cx = cy = size / 2.0
    x, y, z = j3d.unbind(-1)
    u, v = j2d.unbind(-1)
    zero, fcol = torch.zeros_like(u), torch.full_like(u, focal)
    q = torch.cat([torch.stack([fcol, zero, cx - u], -1),
                   torch.stack([zero, fcol, cy - v], -1)], 1)
    rhs = torch.cat([(u - cx) * z - focal * x, (v - cy) * z - focal * y], 1)
    ww = torch.cat([w, w], 1)
    a = torch.einsum("nki,nk,nkj->nij", q, ww, q)
    b = torch.einsum("nki,nk,nk->ni", q, ww, rhs)
    return a, b, w.sum(-1) >= min_points


def translation_lstsq(j3d: torch.Tensor, j2d: torch.Tensor, w: torch.Tensor,
                      focal: float, size: float,
                      min_points: int = 4) -> torch.Tensor:
    """The solution of `lstsq_system`; persons with fewer than `min_points`
    weighted joints get INVALID_TRANS."""
    a, b, valid = lstsq_system(j3d, j2d, w, focal, size, min_points)
    a = a + (~valid).float()[:, None, None] * torch.eye(3, device=a.device)
    t = torch.linalg.solve(a, b[..., None])[..., 0]
    return torch.where(valid[:, None], t, torch.full_like(t, INVALID_TRANS))


def perspective(points: torch.Tensor, trans: torch.Tensor, focal: float,
                size: float) -> torch.Tensor:
    """Pinhole projection of (N, P, 3) offset by (N, 3), in [-1, 1] units
    (depth clamped at 1e-6, as published)."""
    p = points + trans[:, None]
    z = p[..., 2].clamp(min=1e-6)
    return torch.stack([p[..., 0] / z, p[..., 1] / z], -1) * (
        focal / (size / 2.0))
