"""Batched 3D rotation conversions (counterpart of `romp_tpu/ops/rotations.py`).

Same formulas and quirks as the JAX package, which matches the reference:
the angle of an axis-angle vector is ||aa + 1e-8||, 6D -> matrix is
Gram-Schmidt with columns [b1 b2 b1xb2], matrix -> axis-angle goes through
the branch-free kornia-style quaternion with NaNs flushed to 0. Every
function takes arbitrary leading batch dims.
"""
from __future__ import annotations

import torch


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    batch_shape = aa.shape[:-1]
    aa = aa.reshape(-1, 3)
    angle = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)   # (N, 1)
    axis = aa / angle
    cos = torch.cos(angle)[..., None]                            # (N, 1, 1)
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[:, 0], axis[:, 1], axis[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=-1).reshape(-1, 3, 3)
    # for a unit axis r, K^2 = r r^T - I: R = I + sin K + (1-cos)(r r^T - I)
    outer = axis[:, :, None] * axis[:, None, :]
    ident = torch.eye(3, dtype=aa.dtype, device=aa.device)
    rot = ident + sin * K + (1.0 - cos) * (outer - ident)
    return rot.reshape(*batch_shape, 3, 3)


def rot6d_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) read as a (3, 2) column pair -> (..., 3, 3), Gram-Schmidt
    with the max(norm, 1e-6) clamp of F.normalize."""
    batch_shape = x.shape[:-1]
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[..., 0], x[..., 1]

    def _normalize(v):
        n = torch.linalg.norm(v, dim=-1, keepdim=True)
        return v / torch.clamp(n, min=1e-6)

    b1 = _normalize(a1)
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    rot = torch.stack([b1, b2, b3], dim=-1)                      # columns
    return rot.reshape(*batch_shape, 3, 3)


def matrix_to_quaternion(R: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) quaternion (w, x, y, z), the 4-case algorithm
    selected branch-free (it works on the transpose, as the reference)."""
    batch_shape = R.shape[:-2]
    m = R.reshape(-1, 3, 3).transpose(-1, -2)
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m20, m21, m22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]

    mask_d2 = m22 < eps
    mask_d0_d1 = m00 > m11
    mask_d0_nd1 = m00 < -m11

    t0 = 1.0 + m00 - m11 - m22
    q0 = torch.stack([m12 - m21, t0, m01 + m10, m20 + m02], dim=-1)
    t1 = 1.0 - m00 + m11 - m22
    q1 = torch.stack([m20 - m02, m01 + m10, t1, m12 + m21], dim=-1)
    t2 = 1.0 - m00 - m11 + m22
    q2 = torch.stack([m01 - m10, m20 + m02, m12 + m21, t2], dim=-1)
    t3 = 1.0 + m00 + m11 + m22
    q3 = torch.stack([t3, m12 - m21, m20 - m02, m01 - m10], dim=-1)

    c0 = mask_d2 & mask_d0_d1
    c1 = mask_d2 & ~mask_d0_d1
    c2 = ~mask_d2 & mask_d0_nd1
    q = torch.where(c0[:, None], q0, torch.where(
        c1[:, None], q1, torch.where(c2[:, None], q2, q3)))
    t = torch.where(c0, t0, torch.where(c1, t1, torch.where(c2, t2, t3)))
    q = q * (0.5 / torch.sqrt(t))[:, None]
    return q.reshape(*batch_shape, 4)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z) -> (..., 3) axis-angle (Ceres-style;
    k = 2 where sin(theta) == 0; NaNs flushed to 0, `rotations.py:131`)."""
    q1, q2, q3 = q[..., 1], q[..., 2], q[..., 3]
    sin_sq = q1 * q1 + q2 * q2 + q3 * q3
    sin_theta = torch.sqrt(sin_sq)
    cos_theta = q[..., 0]
    two_theta = 2.0 * torch.where(
        cos_theta < 0.0,
        torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta))
    k_pos = two_theta / torch.where(sin_theta > 0.0, sin_theta,
                                    torch.ones_like(sin_theta))
    k = torch.where(sin_sq > 0.0, k_pos, torch.full_like(k_pos, 2.0))
    aa = torch.stack([q1 * k, q2 * k, q3 * k], dim=-1)
    return torch.nan_to_num(aa)


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3), via the quaternion."""
    return quaternion_to_axis_angle(matrix_to_quaternion(R))


def rot6d_to_axis_angle(x: torch.Tensor) -> torch.Tensor:
    """(..., J*6) flat 6D rotations -> (..., J*3) flat axis-angle."""
    batch_shape = x.shape[:-1]
    n_joint = x.shape[-1] // 6
    R = rot6d_to_matrix(x.reshape(*batch_shape, n_joint, 6))
    return matrix_to_axis_angle(R).reshape(*batch_shape, n_joint * 3)
