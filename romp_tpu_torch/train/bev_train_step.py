"""BEV's training step: 3D-centermap supervision and the relative losses
(counterpart of `romp_tpu/train/bev_train_step.py`).

Reference flow (`romp/lib/models/bev_model.py`, `result_parser.py:97`
match_params_new for model_version > 4, `calc_loss.py`): forward the BEV
maps, build the GT 3D center maps (the depth bin from each person's camera
scale through the depth anchors), sample the cams and parameters at the GT
3D centers, run SMPL+A, and supervise with the 3D and front-view focal
losses, the keypoint and parameter losses, a cam L2 at the GT centers and
BEV's relative depth and age losses. Fixed (B, P) persons with masks, as
ROMP's step.

The optimizer is ROMP's (`train_step.py`: optax's apply_if_finite(chain(
clip_by_global_norm, adamw)) over one flat buffer, in place). As in JAX,
and unlike ROMP's step:
- the BatchNorm statistics are committed whether or not the gradient was
  finite (`bev_train_step.py:206`), and the metrics have no grads_finite;
- the activations stay in f32 (JAX builds BEV's ParamStore with the
  compute dtype only, `:67-68`): `base.act_dtype` is ignored;
- nothing is recomputed in the backward (no remat).
SMPL+A runs the adult and the infant model on every person, so a step
launches the skinning kernel twice forward and twice backward.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from romp_tpu_torch.models.bev import (
    BevNet, bev_forward_maps, bev_regress_params, cam_to_depth_bin,
)
from romp_tpu_torch.models.layers import opts_from_names
from romp_tpu_torch.ops.centermap import CenterDetections3D
from romp_tpu_torch.ops.projection import perspective_projection
from romp_tpu_torch.pipeline.bev_pipeline import (
    FOCAL_LENGTH_BEV, TAN_FOV_HALF, unpack_bev_params,
)
from romp_tpu_torch.smpl.body_model import SmplModel, smpla_forward
from romp_tpu_torch.train import losses
from romp_tpu_torch.train.centermap_gt import generate_centermap3d
from romp_tpu_torch.train.loss_merger import merge_losses
from romp_tpu_torch.train.priors import GmmPrior, gmm_prior_loss
from romp_tpu_torch.train.relative_losses import (
    age_group_loss, kid_offset_loss, relative_depth_loss,
)
from romp_tpu_torch.train.train_step import (
    TrainConfig, TrainState, init_train_state, make_synthetic_batch, run_step,
)

DEPTH_FLOOR = 0.05     # the training-safe depth fence (`:98-111`)


@dataclasses.dataclass(frozen=True)
class BevTrainConfig:
    """The JAX package's BevTrainConfig: same fields and defaults. `base`
    carries the optimizer, the ROMP loss weights and the compute dtype."""

    base: TrainConfig = TrainConfig()
    centermap3d_weight: float = 1.0
    rdepth_weight: float = 10.0
    rage_weight: float = 2.0
    # the cam L2 at the GT centers (the reference's Cam loss): it anchors
    # the scale s, whose perspective depth 1/(s*tan + eps) is singular
    cam_weight: float = 100.0
    input_size: int = 512
    backbone: str = "hrnet32"


def bev_train_config(cfg) -> BevTrainConfig:
    """The step's BevTrainConfig from the config tree (`configs/v6_bev.yml`
    and overrides): ROMP's TrainConfig from it (`trainer.train_config`) as
    `base`, the input size and the backbone."""
    from romp_tpu_torch.train.trainer import train_config

    return BevTrainConfig(base=train_config(cfg),
                          input_size=cfg.model.input_size,
                          backbone=cfg.model.backbone)


def bev_compute_losses(net: BevNet, batch: Dict[str, torch.Tensor],
                       smpl_adult: SmplModel, smpl_baby: SmplModel,
                       cfg: BevTrainConfig, prior: Optional[GmmPrior] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward and composite loss (`bev_train_step.py:56-167`): (total,
    metrics). The net runs in its current mode (train mode for training).
    The batch is ROMP's schema (`train_step.compute_losses`) plus:
      person_scales  (B, P) GT weak-perspective scale (the depth-anchor bin)
      depth_ids      (B, P) int ordinal depth layer, -1 unannotated
      age_gts        (B, P) int age group, -1 unannotated
      kid_offsets_gt (B, P) float in [0, 1], -1 unannotated
      betas_gt       (B, P, 11)
    """
    base = cfg.base
    opts = opts_from_names(base.compute_dtype)
    maps = bev_forward_maps(net, batch["image"], opts)
    mask = batch["person_mask"]
    B, P = mask.shape
    S = maps.center_maps_fv.shape[1]

    # GT 3D center bins: the depth from each person's scale by the anchors
    centers = batch["person_centers"]
    cz = cam_to_depth_bin(batch["person_scales"], net.anchors).to(torch.int32)
    cx = torch.clamp(torch.floor((centers[..., 0] + 1) / 2 * S), 0,
                     S - 1).to(torch.int32)
    cy = torch.clamp(torch.floor((centers[..., 1] + 1) / 2 * S), 0,
                     S - 1).to(torch.int32)
    czyx = torch.stack([cz, cy, cx], -1)
    with torch.no_grad():
        centermap3d_gt = generate_centermap3d(
            czyx, mask, map_size=S, depth_size=maps.center_maps_3d.shape[1],
            dtype=maps.center_maps_3d.dtype)

    det = CenterDetections3D(
        flat_inds=cy * S + cx, zyx=czyx.to(maps.cam_maps_3d.dtype),
        scores=torch.ones((B, P), device=mask.device), mask=mask)
    out = unpack_bev_params(bev_regress_params(net, maps, det))

    def flat(a):
        return a.reshape(B * P, *a.shape[2:])

    dt = out["cam"].dtype
    w = flat(mask).to(dt)
    betas, thetas = flat(out["smpl_betas"]), flat(out["smpl_thetas"])
    _, joints = smpla_forward(smpl_adult, smpl_baby, betas, thetas)
    # the training-safe depth (`:98-111`): the denominator fenced at 0.05,
    # so that the pole of 1 / (s * tan + eps) cannot pull the scale on;
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    camf = flat(out["cam"])
    denom = camf[..., 0] * TAN_FOV_HALF + 1e-3
    depth = (1.0 / torch.maximum(denom, torch.full_like(denom, DEPTH_FLOOR))
             )[..., None]
    cam_trans = torch.cat(
        [torch.stack([camf[..., 2], camf[..., 1]], -1) * depth * TAN_FOV_HALF,
         depth], dim=-1)
    # the 512-calibrated focal length, scaled with the input size
    pj2d = perspective_projection(
        joints, cam_trans, focal_length=FOCAL_LENGTH_BEV * cfg.input_size
        / 512.0, img_size=cfg.input_size)

    kp3d_w = w * flat(batch["kp3d_mask"]).to(dt)
    pose_w = w * flat(batch["pose_mask"]).to(dt)
    kp2d_w = (w * flat(batch["kp2d_mask"]).to(dt) if "kp2d_mask" in batch
              else w)
    cam_gt = torch.stack([batch["person_scales"], centers[..., 1],
                          centers[..., 0]], -1)
    maskf = mask.to(dt)
    kid = out["smpl_betas"][..., 10]
    loss_dict = {
        "centermap3d": cfg.centermap3d_weight * losses.focal_heatmap_loss(
            maps.center_maps_3d, centermap3d_gt),
        "centermap": base.centermap_weight * losses.focal_heatmap_loss(
            maps.center_maps_fv[..., 0], centermap3d_gt.amax(dim=1)),
        "kp2d": base.kp2d_weight * losses.kp2d_l2_loss(
            flat(batch["kp2d_gt"]), pj2d[:, :54], kp2d_w),
        "mpjpe": base.mpjpe_weight * losses.mpjpe_loss(
            flat(batch["kp3d_gt"]), joints[:, :54], kp3d_w),
        "pose": base.pose_weight * losses.pose_l2_loss(
            flat(batch["pose_gt"]), thetas[:, :66], pose_w),
        "shape": base.shape_weight * losses.shape_loss(
            flat(batch["betas_gt"])[:, :10], betas[:, :10], w,
            flat(batch["betas_mask"]).to(dt)),
        "cam": cfg.cam_weight * (
            torch.sum(torch.sum((out["cam"] - cam_gt) ** 2, -1) * maskf)
            / torch.clamp(torch.sum(mask), min=1)),
        "rdepth": cfg.rdepth_weight * relative_depth_loss(
            cam_trans.reshape(B, P, 3)[..., 2], batch["depth_ids"], mask),
        "rage": cfg.rage_weight * (
            age_group_loss(kid, batch["age_gts"], mask)
            + 2.0 * kid_offset_loss(kid, batch["kid_offsets_gt"], mask)),
    }
    if prior is not None and base.prior_weight > 0:
        loss_dict["prior"] = base.prior_weight * gmm_prior_loss(
            prior, thetas[:, 3:66], w)
    return merge_losses(loss_dict, base.loss_thresh, base.new_training)


def bev_init_train_state(net: BevNet, cfg: BevTrainConfig) -> TrainState:
    """A fresh optimizer state over the BEV net's parameters (on its
    device); its BatchNorm statistics are the state's `bn_state`."""
    return init_train_state(net, cfg.base)


def bev_train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   smpl_adult: SmplModel, smpl_baby: SmplModel,
                   cfg: BevTrainConfig, prior: Optional[GmmPrior] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place (`bev_train_step.py:170-207`). Returns the
    state and the metrics (0-dim device tensors: the clamped losses, task
    sums and total). The BatchNorm statistics take the step's updates
    whether or not the gradient was finite, as JAX's step commits them."""
    _, metrics = run_step(
        state, lambda net: bev_compute_losses(net, batch, smpl_adult,
                                              smpl_baby, cfg, prior),
        cfg.base, gate_bn=False)
    return state, metrics


def make_bev_synthetic_batch(seed: int, batch_size: int, num_person: int = 3,
                             input_size: int = 512, device="cuda"
                             ) -> Dict[str, torch.Tensor]:
    """A random well-formed BEV training batch, made on `device` from seeded
    torch.Generators (the JAX package's distributions, other numbers): the
    ROMP batch plus the person scales, depth layers, age groups, kid
    offsets and an 11th beta of 0."""
    batch = make_synthetic_batch(seed, batch_size, num_person, input_size,
                                 device)
    g = torch.Generator(device=device).manual_seed(seed + 7)
    B, P = batch_size, num_person

    def uniform(lo, hi):
        return torch.rand((B, P), generator=g, device=device) * (hi - lo) + lo

    def randint(hi):
        return torch.randint(0, hi, (B, P), generator=g, device=device)

    batch.update({
        "person_scales": uniform(0.2, 3.0),
        "depth_ids": randint(3),
        "age_gts": randint(4),
        "kid_offsets_gt": uniform(0.0, 1.0),
        "betas_gt": torch.cat([batch["betas_gt"],
                               torch.zeros((B, P, 1), device=device)], -1),
    })
    return batch
