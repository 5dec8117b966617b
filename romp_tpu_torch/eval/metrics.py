"""Evaluation metrics — the reference's evaluation matrix, batched on torch
tensors (counterpart of `romp_tpu/eval/metrics.py`).

Parity targets (`romp/lib/evaluation/evaluation_matrix.py`):
- MPJPE / PA-MPJPE (batch Procrustes, :252) in millimeters
- PVE (per-vertex error, :105)
- PCK@thresh / AUC
- acceleration error (temporal second differences)
Relative-Human metrics (`simple_romp/evaluation/eval_Relative_Human.py:61-141`):
- PCRD (pairwise correct relative depth) and age-group accuracy.

The tensor metrics run on their inputs' device and dtype; `ate`,
`relative_depth_accuracy` and `age_group_accuracy` are host numpy.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from romp_tpu_torch.train.losses import procrustes_align

M2MM = 1000.0


def mpjpe(gt: torch.Tensor, pred: torch.Tensor,
          align_inds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """(N, J, 3) -> (N,) mean per-joint error in mm."""
    if align_inds is not None:
        idx = list(align_inds)
        gt = gt - gt[:, idx].mean(1, keepdim=True)
        pred = pred - pred[:, idx].mean(1, keepdim=True)
    return torch.linalg.norm(pred - gt, dim=-1).mean(-1) * M2MM


def pa_mpjpe(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """(N, J, 3) -> (N,) Procrustes-aligned MPJPE in mm."""
    aligned = procrustes_align(gt, pred)
    return torch.linalg.norm(aligned - gt, dim=-1).mean(-1) * M2MM


def pve(gt_verts: torch.Tensor, pred_verts: torch.Tensor) -> torch.Tensor:
    """(N, V, 3) -> (N,) per-vertex error in mm (root-aligned by caller)."""
    return torch.linalg.norm(pred_verts - gt_verts, dim=-1).mean(-1) * M2MM


def pck(gt: torch.Tensor, pred: torch.Tensor, thresh_mm: float = 150.0
        ) -> torch.Tensor:
    """Percentage of correct 3D keypoints under thresh (per sample)."""
    d = torch.linalg.norm(pred - gt, dim=-1) * M2MM
    return (d < thresh_mm).to(gt.dtype).mean(-1)


def auc(gt: torch.Tensor, pred: torch.Tensor, max_mm: float = 200.0,
        steps: int = 20) -> torch.Tensor:
    """Area under the PCK curve over [0, max_mm]."""
    ths = torch.linspace(max_mm / steps, max_mm, steps, dtype=gt.dtype,
                         device=gt.device)
    d = torch.linalg.norm(pred - gt, dim=-1)[..., None] * M2MM
    return (d < ths).to(gt.dtype).mean(dim=(-2, -1))


def acceleration_error(gt_seq: torch.Tensor,
                       pred_seq: torch.Tensor) -> torch.Tensor:
    """Temporal acceleration error (mm/frame^2) over (T, J, 3) sequences."""
    def acc(x):
        return x[2:] - 2 * x[1:-1] + x[:-2]

    return torch.linalg.norm(acc(pred_seq) - acc(gt_seq),
                             dim=-1).mean() * M2MM


def ate(gt_traj: np.ndarray, pred_traj: np.ndarray,
        align: bool = True) -> float:
    """Absolute Trajectory Error (meters) for world-frame trajectories —
    the DynaCam protocol metric (`trace2/evaluation/dynacam_evaluation/
    evalute_ate.py`): optional rigid (Umeyama) alignment of the predicted
    trajectory to GT, then RMSE of positions.

    gt_traj/pred_traj: (T, 3).
    """
    gt = np.asarray(gt_traj, np.float64)
    pr = np.asarray(pred_traj, np.float64)
    if align and len(gt) >= 3:
        mu_g, mu_p = gt.mean(0), pr.mean(0)
        H = (pr - mu_p).T @ (gt - mu_g)
        U, S, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        D = np.diag([1.0, 1.0, d])
        R = Vt.T @ D @ U.T
        var_p = ((pr - mu_p) ** 2).sum()
        s = (S * np.diag(D)).sum() / var_p if var_p > 0 else 1.0
        pr = s * (R @ (pr - mu_p).T).T + mu_g
    return float(np.sqrt(((pr - gt) ** 2).sum(-1).mean()))


def relative_depth_accuracy(pred_depths: np.ndarray, gt_ordering: np.ndarray,
                            eq_thresh: float = 0.2) -> float:
    """PCRD: fraction of annotated person pairs whose predicted depth order
    matches the ground-truth ordinal relation.

    gt_ordering: (P, P) matrix with 1 if i closer than j, -1 if farther,
    0 if equal-depth, NaN if unannotated
    (`simple_romp/evaluation/eval_Relative_Human.py:61-108` semantics).
    """
    P = len(pred_depths)
    correct, total = 0, 0
    for i in range(P):
        for j in range(i + 1, P):
            rel = gt_ordering[i, j]
            if np.isnan(rel):
                continue
            total += 1
            d = pred_depths[i] - pred_depths[j]
            if rel == 0:
                correct += int(abs(d) < eq_thresh)
            elif rel == 1:
                correct += int(d < 0)
            else:
                correct += int(d > 0)
    return correct / total if total else float("nan")


def age_group_accuracy(pred_kid_offsets: np.ndarray,
                       gt_age_groups: np.ndarray) -> Dict[str, float]:
    """Age classification from the 11th beta (kid offset): groups
    adult/teen/kid/baby by thresholds as the BEV evaluation does."""
    ths = [0.25, 0.5, 0.75]
    pred_groups = np.digitize(np.clip(pred_kid_offsets, 0, 1), ths)
    out = {}
    for gid, name in enumerate(["adult", "teen", "kid", "baby"]):
        m = gt_age_groups == gid
        out[name] = float((pred_groups[m] == gid).mean()) if m.any() \
            else float("nan")
    return out


def evaluate_matched_pairs(gt_j3d: np.ndarray, pred_j3d: np.ndarray,
                           gt_verts: Optional[np.ndarray] = None,
                           pred_verts: Optional[np.ndarray] = None,
                           align_inds: Sequence[int] = (45, 46),
                           device="cpu") -> Dict[str, float]:
    """Standard protocol summary over matched GT/pred person pairs, scored
    on `device` in the arrays' own dtype. It is host-side scoring, called
    once a checkpoint, so the CPU is the default."""
    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    gt_j, pr_j = dev(gt_j3d), dev(pred_j3d)
    res = {
        "mpjpe": float(mpjpe(gt_j, pr_j, align_inds).mean()),
        "pampjpe": float(pa_mpjpe(gt_j, pr_j).mean()),
        "pck": float(pck(gt_j, pr_j).mean() * 100.0),
        "auc": float(auc(gt_j, pr_j).mean() * 100.0),
    }
    if gt_verts is not None and pred_verts is not None:
        res["pve"] = float(pve(dev(gt_verts), dev(pred_verts)).mean())
    return res
