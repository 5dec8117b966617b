"""Training losses, masked fixed-K formulations (counterpart of
`romp_tpu/train/losses.py`).

Reference semantics: CenterNet focal loss on the center heatmaps
(`romp/lib/loss_funcs/maps_loss.py:18-75`), visible-masked 2D keypoint L2,
hip-aligned MPJPE and Procrustes-aligned PA-MPJPE
(`romp/lib/loss_funcs/keypoints_loss.py`,
`romp/lib/evaluation/evaluation_matrix.py:252`), SMPL parameter losses
(`romp/lib/loss_funcs/params_loss.py:22`, `calc_loss.py:115-150`). Every
loss takes a (B*K,) validity weight so that shapes stay fixed, and returns a
scalar weighted mean. With `group` (a data-parallel step), the mean is
over the global batch: numerator and denominator are summed over the ranks
(`parallel/mesh.py`), so every rank computes the same value.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from romp_tpu_torch.ops.rotations import axis_angle_to_matrix
from romp_tpu_torch.parallel.mesh import global_ratio, global_sum, group_size

# PCA-variance weighting of betas (`calc_loss.py:34`)
SHAPE_PCA_WEIGHT = (1.0, 0.64, 0.32, 0.32, 0.16, 0.16, 0.16, 0.16, 0.16, 0.16)
# hip joints of the 54-joint set, MPJPE's alignment (`calc_loss.py:33`);
# consecutive, so a slice (a list index would upload the list every call)
ALIGN_SLICE = slice(45, 47)


@functools.lru_cache(maxsize=None)
def _pca_weight(device, dtype) -> torch.Tensor:
    """SHAPE_PCA_WEIGHT on a device, uploaded once (not every step)."""
    return torch.tensor(SHAPE_PCA_WEIGHT, dtype=dtype, device=device)


def _wmean(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
           group=None) -> torch.Tensor:
    return global_ratio(torch.sum(x * w), torch.sum(w), eps, group)


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """A norm with a finite gradient at exactly-zero differences."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-12)


def focal_heatmap_loss(pred: torch.Tensor, gt: torch.Tensor,
                       group=None) -> torch.Tensor:
    """CenterNet focal loss over every non-batch axis, normalized by each
    image's positive count, averaged over the images (of all ranks of
    `group`: each holds as many)."""
    pred = pred.reshape(pred.shape[0], -1)
    gt = gt.reshape(gt.shape[0], -1)
    pos = (gt == 1.0).to(pred.dtype)
    neg = (gt < 1.0).to(pred.dtype)
    neg_w = (1.0 - gt) ** 4
    p = torch.clamp(pred, 1e-3, 1.0 - 1e-3)
    pos_loss = torch.sum(torch.log(p) * (1.0 - pred) ** 2 * pos, dim=-1)
    neg_loss = torch.sum(torch.log(1.0 - p) * pred ** 2 * neg_w * neg, dim=-1)
    num_pos = torch.sum(pos, dim=-1)
    per_img = torch.where(num_pos > 0,
                          -(pos_loss + neg_loss) / (num_pos + 1e-4),
                          -neg_loss)
    if group is None:
        return per_img.mean()
    return global_sum(per_img.sum(), group) / (
        per_img.shape[0] * group_size(group))


def kp2d_l2_loss(gt: torch.Tensor, pred: torch.Tensor,
                 person_w: torch.Tensor, group=None) -> torch.Tensor:
    """gt, pred (N, J, 2) in [-1, 1], invisible joints of gt < -1.99."""
    vis = (gt > -1.99).all(dim=-1).to(pred.dtype)
    d = _safe_norm(pred - gt)
    per_person = torch.sum(d * vis, dim=-1) / (torch.sum(vis, dim=-1) + 1e-6)
    return _wmean(per_person, person_w, group=group)


def mpjpe_loss(gt: torch.Tensor, pred: torch.Tensor,
               person_w: torch.Tensor, group=None) -> torch.Tensor:
    """Hip-midpoint-aligned mean per-joint error; gt's invalid joints are
    exactly -2."""
    def _align(x):
        return x - x[:, ALIGN_SLICE].mean(dim=1, keepdim=True)

    valid_j = (gt != -2.0).any(dim=-1).to(pred.dtype)
    d = _safe_norm(_align(pred) - _align(gt))
    per_person = torch.sum(d * valid_j, -1) / (torch.sum(valid_j, -1) + 1e-6)
    return _wmean(per_person, person_w, group=group)


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinants of (N, 3, 3), by cofactors (no solver call)."""
    return (m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
            - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
            + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0]))


def procrustes_align(gt: torch.Tensor, pred: torch.Tensor,
                     joint_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched similarity transform of pred (N, J, 3) onto gt, solved on the
    joint-weighted point sets. A person with fewer than 3 valid joints goes
    through a fixed well-conditioned matrix instead of its K, before the
    SVD, so that its (weighted-out) gradient is exactly zero and never NaN.
    So does a person whose K is not finite (a NaN input, whose step the
    optimizer rejects): LAPACK's SVD raises on it where JAX's returns NaN."""
    if joint_w is None:
        joint_w = torch.ones(gt.shape[:2], dtype=gt.dtype, device=gt.device)
    wn = (joint_w / (torch.sum(joint_w, dim=1, keepdim=True) + 1e-8))[..., None]
    mu_g = torch.sum(gt * wn, dim=1, keepdim=True)
    mu_p = torch.sum(pred * wn, dim=1, keepdim=True)
    X = ((gt - mu_g) * wn).transpose(1, 2)
    Y = (pred - mu_p).transpose(1, 2)
    Yw = ((pred - mu_p) * wn).transpose(1, 2)
    var_p = torch.sum(Y * Yw, dim=(1, 2))
    K = X @ Y.transpose(1, 2)
    ok = (torch.sum(joint_w, dim=1) >= 3) & torch.isfinite(K).all(dim=(1, 2))
    # diag(1, 2, 3), made on the device (a list would be a host copy)
    fixed = torch.diag(torch.arange(1, 4, dtype=K.dtype, device=K.device))
    K = torch.where(ok[:, None, None], K, fixed[None])
    var_p = torch.where(ok, var_p, torch.ones_like(var_p))
    U, _, Vh = torch.linalg.svd(K)
    det = _det3(U @ Vh)
    Z = torch.diag_embed(torch.stack(
        [torch.ones_like(det), torch.ones_like(det), det], dim=-1))
    R = U @ Z @ Vh
    scale = (torch.diagonal(R @ K.transpose(1, 2), dim1=1, dim2=2).sum(-1)
             / (var_p + 1e-8))[:, None, None]
    t = mu_g.transpose(1, 2) - scale * (R @ mu_p.transpose(1, 2))
    aligned = scale * (R @ pred.transpose(1, 2)) + t
    return aligned.transpose(1, 2)


def pampjpe_loss(gt: torch.Tensor, pred: torch.Tensor,
                 person_w: torch.Tensor, group=None) -> torch.Tensor:
    """Procrustes-aligned MPJPE; invalid joints (gt == -2) are out of the
    solve and the mean, persons with fewer than 3 valid joints out of the
    batch mean."""
    valid_j = (gt != -2.0).any(dim=-1).to(pred.dtype)
    aligned = procrustes_align(gt, pred, valid_j)
    d = _safe_norm(aligned - gt)
    per_person = torch.sum(d * valid_j, -1) / (torch.sum(valid_j, -1) + 1e-6)
    person_w = person_w * (torch.sum(valid_j, -1) >= 3).to(pred.dtype)
    return _wmean(per_person, person_w, group=group)


def pose_l2_loss(gt_aa: torch.Tensor, pred_aa: torch.Tensor,
                 person_w: torch.Tensor, group=None) -> torch.Tensor:
    """L2 between the rotation matrices of axis-angle poses (N, J*3)."""
    N = gt_aa.shape[0]
    Rg = axis_angle_to_matrix(gt_aa.reshape(N, -1, 3))
    Rp = axis_angle_to_matrix(pred_aa.reshape(N, -1, 3))
    d = torch.sqrt(torch.sum((Rg - Rp) ** 2, dim=(-2, -1)) + 1e-12).mean(-1)
    return _wmean(d, person_w, group=group)


def shape_loss(gt_betas: Optional[torch.Tensor], pred_betas: torch.Tensor,
               person_w: torch.Tensor,
               has_gt: Optional[torch.Tensor] = None,
               group=None) -> torch.Tensor:
    """PCA-weighted shape supervision, and an L2 regularizer for persons
    without betas (`calc_loss.py:136-143`); both divided by 20."""
    reg = torch.mean(pred_betas[:, :10] ** 2, dim=-1) / 20.0
    if gt_betas is None:
        return _wmean(reg, person_w, group=group)
    has_gt = torch.ones_like(person_w) if has_gt is None else has_gt
    pca = _pca_weight(pred_betas.device, pred_betas.dtype)
    sup = torch.linalg.norm((gt_betas[:, :10] - pred_betas[:, :10]) * pca,
                            dim=-1) / 20.0
    return _wmean(torch.where(has_gt > 0, sup, reg), person_w, group=group)
