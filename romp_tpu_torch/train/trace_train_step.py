"""TRACE's training step: the temporal head on frozen image features
(counterpart of `romp_tpu/train/trace_train_step.py`).

Reference flow (`trace/train_video.py:10-258`): the image backbone is frozen
(its features are computed per clip beforehand); only the temporal head
trains, supervised with GT 2D / 3D trajectories: the 3D centermap's focal
loss, motion offsets against GT trajectory differences, trajectory pose and
shape losses, world-translation consistency and temporal shape consistency
(`video_losses.py`).

Batch schema (the JAX package's, channels last; one clip a sample):
  feature_maps   (B, T+1, H, W, 32) frozen-backbone features (frame 0: the
                 previous clip's last frame)
  flows          (B, T, H, W, 2)
  traj_czyx      (B, N, T, 3) int GT trajectory bins (z, y, x)
  traj_valid     (B, N, T) bool
  traj3d_gt      (B, N, T, 3) GT camera-space positions
  world_trans_gt (B, N, T, 3); world_grot_gt (B, N, T, 3) axis-angle
  pose_gt        (B, N, T, 66); betas_gt (B, N, T, 11)

JAX `vmap`s one clip's losses over the batch, so each train-mode BatchNorm
normalizes over ONE clip's frames, and the running-statistics updates are
averaged over clips, as are the losses before `merge_losses`. Here the head
runs clip by clip, each clip recording its own BatchNorm updates into its
own dict (`record_bn_updates`, turned on and off around the clip); the
per-clip losses are averaged, merged, and one backward runs through all
clips. Each clip is a `torch.utils.checkpoint` region: the backward keeps
the clip's inputs and recomputes its forward, one clip at a time (the same
function; the recomputed clip records into the same dict, finds its
statistics recorded and records nothing). One clip of the recipe (10
frames, 128x128 maps, 64 depth bins) keeps about 19 GB of activations
(`chip_smoke.py` phase 6 on an H100), so its 6 clips would not fit the
card's 80 GB without it.

Data parallel (`group`, `parallel/mesh.py`): each rank holds whole clips
of the global batch, so each clip's losses and BatchNorm statistics stay
on its rank; the means over clips are over all ranks' clips (one
collective each for the losses and the BatchNorm updates), and the flat
gradient is all-reduced once: every rank takes the one-process step on
the global batch.

The optimizer is ROMP's (`train_step.py`: optax's apply_if_finite(chain(
clip_by_global_norm, adamw))) over the head's parameters, in place on one
flat buffer. Unlike ROMP's step, the BatchNorm statistics are committed
unconditionally, finite gradient or not (`trace_train_step.py:188`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from romp_tpu_torch.models.layers import opts_from_names, record_bn_updates
from romp_tpu_torch.models.trace import (
    TraceNet, trace_forward_maps, trace_regress_trajectory,
    trace_regress_trans,
)
from romp_tpu_torch.ops.centermap import sample_maps_at
from romp_tpu_torch.ops.rotations import rot6d_to_axis_angle
from romp_tpu_torch.parallel.mesh import (
    all_reduce_grad, global_sum, group_size,
)
from romp_tpu_torch.pipeline.romp_pipeline import precision_flags
from romp_tpu_torch.pipeline.trace_pipeline import _sample3d
from romp_tpu_torch.train import losses
from romp_tpu_torch.train.centermap_gt import generate_centermap3d
from romp_tpu_torch.train.loss_merger import merge_losses
from romp_tpu_torch.train.priors import GmmPrior, gmm_prior_loss
from romp_tpu_torch.train.train_step import (
    TrainState, init_train_state, optimizer_update,
)
from romp_tpu_torch.train.video_losses import (
    motion_offset3d_loss, quaternion_angle_loss,
    temporal_shape_consistency_loss, world_trans_consistency_loss,
)

# the per-clip inputs, in the order a clip's function takes them
CLIP_KEYS = ("feature_maps", "flows", "traj_czyx", "traj_valid", "pose_gt",
             "betas_gt", "traj3d_gt", "world_trans_gt", "world_grot_gt")


@dataclasses.dataclass(frozen=True)
class TraceTrainConfig:
    """The JAX package's TraceTrainConfig: same fields and defaults."""

    lr: float = 1e-4
    lr_milestones: Tuple[int, ...] = ()   # MultiStepLR steps (romp/base.py:70)
    lr_decay: float = 0.1
    warmup_steps: int = 0
    weight_decay: float = 1e-6
    grad_clip: float = 3.0
    centermap3d_weight: float = 1.0
    motion_weight: float = 40.0
    pose_weight: float = 80.0
    shape_weight: float = 6.0
    world_trans_weight: float = 50.0
    world_grot_weight: float = 40.0
    temp_shape_weight: float = 10.0
    prior_weight: float = 1.6
    loss_thresh: float = 1000.0
    compute_dtype: str = "float32"


def trace_init_train_state(net: TraceNet,
                           cfg: TraceTrainConfig) -> TrainState:
    """A fresh optimizer state over the head's parameters (on its device):
    the trainable ones and the BatchNorm statistics of `net`, a TraceNet
    built without its image backbone (the JAX package's `tparams`)."""
    if getattr(net, "backbone", None) is not None:
        raise ValueError("trace_init_train_state: the image backbone is "
                         "frozen; pass the head alone (TraceNet(None))")
    return init_train_state(net, cfg)


def _clip_losses(net: TraceNet, cfg: TraceTrainConfig,
                 prior: Optional[GmmPrior], fm, fl, czyx, valid, pose_gt,
                 betas_gt, traj3d_gt, wtrans_gt, wgrot_gt
                 ) -> Dict[str, torch.Tensor]:
    """One clip's weighted losses (`trace_train_step.py:99-164`). fm (T+1,
    H, W, 32), fl (T, H, W, 2), the GT (N, T, ...)."""
    T = fm.shape[0] - 1
    N = valid.shape[0]
    opts = opts_from_names(cfg.compute_dtype)
    maps, _ = trace_forward_maps(
        net, fm.permute(0, 3, 1, 2).contiguous(),
        fl.permute(0, 3, 1, 2).contiguous(), None, T, opts)
    D, H = maps.center_maps_3d.shape[1], maps.center_maps_3d.shape[2]

    zyx_t = czyx.transpose(0, 1)                       # (T, N, 3)
    with torch.no_grad():
        c3d_gt = generate_centermap3d(zyx_t, valid.T, map_size=H,
                                      depth_size=D,
                                      dtype=maps.center_maps_3d.dtype)
    loss_cm = losses.focal_heatmap_loss(maps.center_maps_3d, c3d_gt)

    # per-trajectory samples of the maps: motion offsets and features
    motion = _sample3d(maps.motion_maps_3d, zyx_t).transpose(0, 1)
    cams_init = _sample3d(maps.cam_maps_3d, zyx_t).transpose(0, 1)
    yx_flat = zyx_t[..., 1] * H + zyx_t[..., 2]
    feats = sample_maps_at(maps.mesh_feature_maps, yx_flat).transpose(0, 1)
    cam_motion = sample_maps_at(maps.cam_motion_maps, yx_flat).transpose(0, 1)
    cam_rot = sample_maps_at(maps.cam_rot_maps, yx_flat).transpose(0, 1)

    params_pred = trace_regress_trajectory(net, feats)     # (N, T, 159)
    normed_cams = trace_regress_trans(net, cams_init, feats)

    w = valid.to(params_pred.dtype).reshape(-1)
    pose_pred = rot6d_to_axis_angle(
        params_pred[..., 6:132].reshape(N * T, -1))        # (N*T, 63)
    loss_pose = losses.pose_l2_loss(pose_gt[..., 3:].reshape(N * T, 63),
                                    pose_pred, w)
    loss_shape = losses.shape_loss(
        betas_gt.reshape(N * T, -1)[:, :10],
        params_pred[..., 138:148].reshape(N * T, 10), w)
    loss_motion = motion_offset3d_loss(motion, traj3d_gt, valid)
    # world positions: the first frame's cam plus the summed cam motions
    world_pred = normed_cams[:, :1] + torch.cumsum(cam_motion, dim=1)
    loss_wtrans = world_trans_consistency_loss(world_pred, wtrans_gt, valid)
    wgrot_pred = rot6d_to_axis_angle(
        (cam_rot + params_pred[..., 6:12]).reshape(N * T, 6)
    ).reshape(N, T, 3)
    loss_wgrot = quaternion_angle_loss(wgrot_pred, wgrot_gt,
                                       w.reshape(N, T))
    loss_tshape = temporal_shape_consistency_loss(
        params_pred[..., 138:149], valid)

    m = {
        "centermap3d": cfg.centermap3d_weight * loss_cm,
        "motion": cfg.motion_weight * loss_motion,
        "pose": cfg.pose_weight * loss_pose,
        "shape": cfg.shape_weight * loss_shape,
        "world_trans": cfg.world_trans_weight * loss_wtrans,
        "world_grot": cfg.world_grot_weight * loss_wgrot,
        "temp_shape": cfg.temp_shape_weight * loss_tshape,
    }
    if prior is not None and cfg.prior_weight > 0:
        m["prior"] = cfg.prior_weight * gmm_prior_loss(prior, pose_pred, w)
    return m


def _recorded_clip_losses(net: TraceNet, updates: Dict[str, torch.Tensor],
                          *args) -> Dict[str, torch.Tensor]:
    """`_clip_losses` with the clip's BatchNorm updates recorded into
    `updates`, and the recording detached again after the clip."""
    record_bn_updates(net, into=updates)
    try:
        return _clip_losses(net, *args)
    finally:
        record_bn_updates(net, on=False)


def _clip_mean(per_clip, group) -> Dict[str, torch.Tensor]:
    """The mean of each entry of the per-clip dicts over the clips, those
    of every rank of `group` included (one collective)."""
    names = list(per_clip[0])
    stacked = [torch.stack([m[k] for m in per_clip]) for k in names]
    if group is None:
        return {k: v.mean(0) for k, v in zip(names, stacked)}
    sums = global_sum(torch.cat([v.sum(0).reshape(-1) for v in stacked]),
                      group) / (len(per_clip) * group_size(group))
    out, offset = {}, 0
    for k, v in zip(names, stacked):
        n = v[0].numel()
        out[k] = sums[offset:offset + n].view(v.shape[1:])
        offset += n
    return out


def trace_compute_losses(net: TraceNet, batch: Dict[str, torch.Tensor],
                         cfg: TraceTrainConfig,
                         prior: Optional[GmmPrior] = None, group=None
                         ) -> Tuple[torch.Tensor, Tuple[
                             Dict[str, torch.Tensor],
                             Dict[str, torch.Tensor]]]:
    """(total, (BatchNorm updates, metrics)), as JAX's
    `trace_compute_losses`: each clip's losses and BatchNorm updates, both
    averaged over the clips (all ranks' clips with `group`), the losses
    then merged (`merge_losses`). The head runs in its current mode (train
    mode for training)."""
    per_clip, updates = [], []
    for b in range(batch["feature_maps"].shape[0]):
        updates.append({})
        args = [net, updates[-1], cfg, prior,
                *(batch[k][b] for k in CLIP_KEYS)]
        per_clip.append(
            checkpoint(_recorded_clip_losses, *args, use_reentrant=False,
                       preserve_rng_state=False)
            if torch.is_grad_enabled() else _recorded_clip_losses(*args))
    loss_dict = _clip_mean(per_clip, group)
    with torch.no_grad():
        bn_updates = _clip_mean(updates, group)
    total, metrics = merge_losses(loss_dict, cfg.loss_thresh)
    return total, (bn_updates, metrics)


def trace_train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                     cfg: TraceTrainConfig, prior: Optional[GmmPrior] = None,
                     group=None
                     ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One AdamW step of the head, in place (`trace_train_step.py:178-
    189`). Returns the state and the metrics (0-dim device tensors: the
    clamped losses, task sums and total). The BatchNorm statistics take the
    clips' averaged updates whether or not the gradient was finite. With
    `group`, `batch` is this rank's clips of the global batch."""
    net = state.net.train()
    params = [dict(net.named_parameters())[k] for k in state.names]
    with (precision_flags(cfg) if state.flat.is_cuda
          else contextlib.nullcontext()):
        total, (bn_updates, metrics) = trace_compute_losses(
            net, batch, cfg, prior, group)
        grads = torch.autograd.grad(total, params, allow_unused=True)
    grad = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for p, g in zip(params, grads)])
    optimizer_update(state, all_reduce_grad(grad, group), cfg)
    with torch.no_grad():
        state.bn_flat.copy_(torch.cat([bn_updates.get(k, v).reshape(-1)
                                       for k, v in state.bn_state.items()]))
    state.step += 1
    return state, {k: v.detach() for k, v in metrics.items()}


def make_trace_synthetic_batch(seed: int, batch_size: int = 1,
                               num_tracks: int = 2, clip_len: int = 2,
                               map_size: int = 128, device="cuda"
                               ) -> Dict[str, torch.Tensor]:
    """A random well-formed TRACE training batch, made on `device` from a
    seeded torch.Generator (the JAX package's distributions, other
    numbers)."""
    g = torch.Generator(device=device).manual_seed(seed)
    B, N, T, S = batch_size, num_tracks, clip_len, map_size

    def randint(hi):
        return torch.randint(0, hi, (B, N, T), generator=g, device=device)

    def normal(shape, std=1.0):
        return torch.randn(shape, generator=g, device=device) * std

    czyx = torch.stack([randint(64), randint(S), randint(S)], -1)
    return {
        "feature_maps": normal((B, T + 1, S, S, 32), 0.3),
        "flows": normal((B, T, S, S, 2)),
        "traj_czyx": czyx.to(torch.int32),
        "traj_valid": torch.ones((B, N, T), dtype=torch.bool, device=device),
        "traj3d_gt": normal((B, N, T, 3)),
        "world_trans_gt": normal((B, N, T, 3)),
        "world_grot_gt": normal((B, N, T, 3), 0.5),
        "pose_gt": normal((B, N, T, 66), 0.3),
        "betas_gt": normal((B, N, T, 11), 0.5),
    }
