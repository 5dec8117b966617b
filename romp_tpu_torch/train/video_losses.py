"""TRACE's temporal / video training losses, masked fixed-(N, T)
formulations (counterpart of `romp_tpu/train/video_losses.py`).

Parity targets (`trace/lib/loss_funcs/video_loss.py`):
- quaternion world-rotation loss (:36-60)
- world-translation consistency between frame pairs (:101-128, :251-266)
- temporal shape consistency across a trajectory (:193-208)
- 3D motion-offset supervision from GT trajectories (:389-400)
- velocity / acceleration error (:210-226)

Every loss takes (N, T, ...) per-track clip tensors and (N, T) validity
masks.
"""
from __future__ import annotations

import torch

from romp_tpu_torch.ops.rotations import (
    axis_angle_to_matrix, matrix_to_quaternion,
)


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """A norm with a finite gradient at 0 (a plain norm backpropagates NaN
    at exactly-zero differences, which masked and diagonal pairs have)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-12)


def _pair_mask(valid: torch.Tensor) -> torch.Tensor:
    """(N, T) -> (N, T, T) mask of valid frame pairs, diagonal removed."""
    T = valid.shape[1]
    m = valid[:, :, None] & valid[:, None, :]
    return m & ~torch.eye(T, dtype=torch.bool, device=valid.device)[None]


def _abs_clip(d: torch.Tensor, hi: float = 1.0 - 1e-7) -> torch.Tensor:
    """jnp.clip(jnp.abs(d), 0, hi) with JAX's gradient: |.| passes 1 at 0,
    and where a bound equals its input half the gradient passes (jnp.clip's
    maximum / minimum); torch.abs and torch.clamp pass 0 and all of it."""
    d = torch.where(d >= 0, d, -d)
    return torch.minimum(torch.maximum(d, torch.zeros_like(d)),
                         torch.full_like(d, hi))


def quaternion_angle_loss(pred_aa: torch.Tensor, gt_aa: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """The geodesic angle between predicted and GT rotations (axis-angle,
    (..., 3)), weighted by w (...): 2 acos(|<q1, q2>|), sign-invariant, with
    |<q1, q2>| clipped to [0, 1 - 1e-7] before acos, with JAX's gradient
    at the clip (`_abs_clip`: near-equal rotations meet the f32 bound)."""
    qp = matrix_to_quaternion(axis_angle_to_matrix(pred_aa))
    qg = matrix_to_quaternion(axis_angle_to_matrix(gt_aa))
    ang = 2.0 * torch.arccos(_abs_clip(torch.sum(qp * qg, dim=-1)))
    return torch.sum(ang * w) / (torch.sum(w) + 1e-6)


def world_trans_consistency_loss(pred_trans: torch.Tensor,
                                 gt_trans: torch.Tensor,
                                 valid: torch.Tensor) -> torch.Tensor:
    """For every valid frame pair (i, j) of a track the predicted
    displacement matches the GT one (supervising differences removes the
    arbitrary world origin)."""
    pm = _pair_mask(valid).to(pred_trans.dtype)
    dp = pred_trans[:, :, None] - pred_trans[:, None, :]
    dg = gt_trans[:, :, None] - gt_trans[:, None, :]
    err = _safe_norm(dp - dg)
    return torch.sum(err * pm) / (torch.sum(pm) + 1e-6)


def temporal_shape_consistency_loss(pred_betas: torch.Tensor,
                                    valid: torch.Tensor) -> torch.Tensor:
    """A subject's betas should not change across the clip."""
    pm = _pair_mask(valid).to(pred_betas.dtype)
    d = _safe_norm(pred_betas[:, :, None] - pred_betas[:, None, :])
    return torch.sum(d * pm) / (torch.sum(pm) + 1e-6)


def motion_offset3d_loss(pred_offsets: torch.Tensor, traj3d_gt: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Predicted previous-to-current 3D motion offsets against the GT
    trajectory's differences; frame 0 has no previous frame and is left
    out."""
    gt_off = traj3d_gt[:, 1:] - traj3d_gt[:, :-1]
    w = (valid[:, 1:] & valid[:, :-1]).to(pred_offsets.dtype)
    err = _safe_norm(pred_offsets[:, 1:] - gt_off)
    return torch.sum(err * w) / (torch.sum(w) + 1e-6)


def vel_acc_error(gt_seq: torch.Tensor, pred_seq: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Velocity and acceleration discrepancy, each averaged over the frames
    where all its terms are valid."""
    def vel(x):
        return x[:, 1:] - x[:, :-1]

    def acc(x):
        return x[:, 2:] - 2 * x[:, 1:-1] + x[:, :-2]

    wv = (valid[:, 1:] & valid[:, :-1]).to(pred_seq.dtype)
    v_err = _safe_norm(vel(pred_seq) - vel(gt_seq))
    l_v = torch.sum(v_err * wv) / (torch.sum(wv) + 1e-6)
    wa = (valid[:, 2:] & valid[:, 1:-1] & valid[:, :-2]).to(pred_seq.dtype)
    a_err = _safe_norm(acc(pred_seq) - acc(gt_seq))
    l_a = torch.sum(a_err * wa) / (torch.sum(wa) + 1e-6)
    return l_v + l_a
