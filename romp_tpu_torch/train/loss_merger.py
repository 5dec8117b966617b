"""Task-grouped loss merger with per-loss clamping and the det-only
schedule (counterpart of `romp_tpu/train/loss_merger.py`).

Parity: `romp/lib/loss_funcs/learnable_loss.py:16-68`: NaN losses drop out
of the sum (:52); a loss above `loss_thresh` is scaled to the threshold and
keeps a scaled gradient (:53-56); "new training" optimizes only the
detection losses, the 3D centermap's divided by 1000 (:45-47); task sums
are reported beside the per-loss values (:59-66).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

# loss key -> task group (`learnable_loss.py:20-28`)
LOSS_GROUPS: Dict[str, Tuple[str, ...]] = {
    "det": ("centermap", "centermap3d"),
    "reg": ("mpjpe", "pampjpe", "kp2d", "pose", "shape", "cam", "prior",
            "heatmap", "ae"),
    "rel": ("rage", "rdepth"),
}
_ALL_GROUPED = tuple(k for keys in LOSS_GROUPS.values() for k in keys)


def clamp_loss(v: torch.Tensor, loss_thresh: float) -> torch.Tensor:
    """A non-finite loss contributes 0; one above the threshold is scaled
    down to it, with its gradient scaled alike."""
    safe = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
    mag = safe.detach().abs()
    scale = torch.where(mag > loss_thresh, loss_thresh / (mag + 1e-12),
                        torch.ones_like(mag))
    return safe * scale


def merge_losses(loss_dict: Dict[str, torch.Tensor],
                 loss_thresh: float = 1000.0, new_training: bool = False,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, metrics): the clamped per-loss values, task_det / task_reg /
    task_rel / task_others sums, and "total"."""
    clamped = {k: clamp_loss(v, loss_thresh) for k, v in loss_dict.items()}
    if new_training:
        active = {k: (v / 1000.0 if k == "centermap3d" else v)
                  for k, v in clamped.items() if k in LOSS_GROUPS["det"]}
    else:
        active = clamped
    total = (sum(active.values()) if active
             else torch.zeros(()))
    metrics: Dict[str, torch.Tensor] = dict(clamped)
    for group, keys in LOSS_GROUPS.items():
        members = [clamped[k] for k in keys if k in clamped]
        if members:
            metrics[f"task_{group}"] = sum(members)
    others = [v for k, v in clamped.items() if k not in _ALL_GROUPED]
    if others:
        metrics["task_others"] = sum(others)
    metrics["total"] = total
    return total, metrics
