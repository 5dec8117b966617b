"""BEV's relative supervision: ordinal depth, age groups, kid-shape offsets
(counterpart of `romp_tpu/train/relative_losses.py`).

Parity: `romp/lib/loss_funcs/relative_loss.py`, the piecewise
depth-ordering loss over annotated person pairs (:46-95), the age-group
hinge on the kid offset (the 11th beta) and the direct kid-offset
regression. All masked fixed-(B, P) formulations.

Where JAX's `jnp.clip` / `jnp.maximum` meet their bound, half the gradient
passes; `torch.clamp` passes all of it. So the bounds here are
`torch.maximum` / `torch.minimum` against tensors, which split at a tie as
JAX does. `jax.nn.softplus` is `logaddexp(x, 0)` (torch's `softplus`
returns x itself above its threshold of 20).
"""
from __future__ import annotations

import functools

import torch

# Age groups: adult=0, teen=1, kid=2, baby=3; the kid-offset bin edges.
AGE_THRESHOLDS = (0.25, 0.5, 0.75)


@functools.lru_cache(maxsize=None)
def _age_edges(device, dtype) -> torch.Tensor:
    """The age bins' edges on a device, uploaded once."""
    return torch.tensor((0.0, *AGE_THRESHOLDS, 1.0), dtype=dtype,
                        device=device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip, with its gradient at the bounds."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def relative_depth_loss(pred_depths: torch.Tensor, depth_ids: torch.Tensor,
                        mask: torch.Tensor,
                        dist_thresh: float = 0.3) -> torch.Tensor:
    """Piecewise ordinal depth loss (`relative_losses.py:17-48`).

    pred_depths (B, P); depth_ids (B, P) integer ordinal depth layers, -1
    where unannotated; mask (B, P) person validity. For each annotated pair
    (i, j), i < j in the fixed slots:
      same layer   -> (d_i - d_j)^2
      i closer     -> softplus(d_i - d_j) once it violates the margin
      i farther    -> softplus(d_j - d_i) once it violates the margin
    The differences are clipped to +-50 first, so that an extreme
    (mis-)predicted depth gives no inf in a branch that is not selected.
    """
    P = pred_depths.shape[1]
    valid = mask & (depth_ids >= 0)
    upper = torch.triu(torch.ones((P, P), dtype=torch.bool,
                                  device=mask.device), diagonal=1)
    pair_valid = valid[:, :, None] & valid[:, None, :] & upper[None]
    dd = pred_depths[:, :, None] - pred_depths[:, None, :]     # d_i - d_j
    did = (depth_ids[:, :, None] - depth_ids[:, None, :]).to(dd.dtype)

    eq = pair_valid & (did == 0)
    closer = pair_valid & (did < 0) & ((dd - did * dist_thresh) > 0)
    farther = pair_valid & (did > 0) & ((dd - did * dist_thresh) < 0)

    ddc = _clip(dd, -50.0, 50.0)
    zero = torch.zeros_like(ddc)
    loss = (torch.where(eq, ddc ** 2, zero)
            + torch.where(closer, _softplus(ddc), zero)
            + torch.where(farther, _softplus(-ddc), zero))
    n = torch.sum(eq | closer | farther).to(loss.dtype)
    return torch.sum(loss) / (n + 1e-6)


def age_group_loss(kid_offsets: torch.Tensor, age_gts: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Hinge the predicted kid offset (11th beta) into its annotated age
    bin (`relative_losses.py:51-67`): age_gts (B, P) in {0..3}, -1 where
    unannotated; the squared distance to the bin's interval."""
    edges = _age_edges(kid_offsets.device, kid_offsets.dtype)
    valid = mask & (age_gts >= 0)
    a = age_gts.clamp(0, 3).long()
    lo, hi = edges[a], edges[a + 1]
    zero = torch.zeros_like(kid_offsets)
    below = torch.maximum(lo - kid_offsets, zero)
    above = torch.maximum(kid_offsets - hi, zero)
    per = (below + above) ** 2
    return torch.sum(torch.where(valid, per, zero)) / (
        torch.sum(valid).to(per.dtype) + 1e-6)


def kid_offset_loss(kid_offsets: torch.Tensor, gt_offsets: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Direct supervision where kid-shape offsets are annotated (>= 0)."""
    valid = mask & (gt_offsets >= 0)
    per = (kid_offsets - gt_offsets) ** 2
    return torch.sum(torch.where(valid, per, torch.zeros_like(per))) / (
        torch.sum(valid).to(per.dtype) + 1e-6)
