"""ROMP training step, matching-mode supervision (counterpart of
`romp_tpu/train/train_step.py`).

Reference flow (`romp/train.py:37-54`, `result_parser.py:33`
matching_forward): forward the net, sample the parameter maps at the
ground-truth centers, run SMPL, compute the composite loss
(`calc_loss.py:25`), step AdamW. Each image carries up to P ground-truth
persons with a validity mask, so every shape is fixed.

One step on one device, or on each rank of a data-parallel group
(`group`, `parallel/mesh.py`): each rank holds its rows of the global
batch, the BatchNorm statistics and the losses are the global batch's,
and the flat gradient is all-reduced once, so every rank takes the
one-process step on the whole batch. What the JAX package leaves to optax
is written out as tensor ops that compute what optax computes, on the
device and with no host sync:
- `apply_if_finite(chain(clip_by_global_norm(grad_clip), adamw(lr,
  weight_decay)), 10000)`: a step with a non-finite gradient leaves the
  parameters, both moments, the inner counts and the BatchNorm statistics
  as they were (`state.step` still advances), unless 10000 such steps come
  in a row;
- `clip_by_global_norm` scales by max / |g| only when |g| >= max, with no
  epsilon (torch's `clip_grad_norm_` adds 1e-6 and always scales);
- Adam with bias correction, eps = 1e-8 outside the square root, then the
  decoupled decay lr * wd * p added to the update;
- the learning-rate schedule (`make_lr_schedule`) reads its own count,
  which advances on accepted steps only.
The trainable parameters are views into one flat buffer (`TrainState.flat`,
in sorted name order, optax's leaf order), as are the moments, so the update
is a few passes over flat tensors; the parameters and BatchNorm buffers of
the net are updated in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from romp_tpu_torch.models.layers import (
    at_least_f32, opts_from_names, record_bn_updates,
)
from romp_tpu_torch.models.romp import RompNet
from romp_tpu_torch.ops.centermap import parse_centermap2d, sample_maps_at
from romp_tpu_torch.ops.projection import weak_perspective_projection
from romp_tpu_torch.parallel.mesh import (
    all_reduce_grad, check_replicas, global_sums, replicate_tree,
)
from romp_tpu_torch.pipeline.romp_pipeline import (
    precision_flags, unpack_params,
)
from romp_tpu_torch.smpl.body_model import SmplModel, smpl_forward
from romp_tpu_torch.train import losses
from romp_tpu_torch.train.centermap_gt import generate_centermap, person_radius
from romp_tpu_torch.train.loss_merger import merge_losses
from romp_tpu_torch.train.priors import GmmPrior, angle_prior, gmm_prior_loss

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 10000   # apply_if_finite's, `train_step.py:125`
INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig: same fields and defaults
    (`romp/lib/config.py`, configs/v1.yml)."""

    lr: float = 3e-4
    lr_milestones: Tuple[int, ...] = ()   # MultiStepLR boundaries, in steps
    lr_decay: float = 0.1
    warmup_steps: int = 0                 # linear warmup from 0; 0 = off
    weight_decay: float = 1e-6
    grad_clip: float = 3.0
    centermap_weight: float = 1.0
    kp2d_weight: float = 400.0
    mpjpe_weight: float = 200.0
    pampjpe_weight: float = 360.0
    pose_weight: float = 80.0
    shape_weight: float = 6.0
    prior_weight: float = 1.6              # GMM pose prior (configs/v1.yml:45)
    angle_prior_weight: float = 0.0
    loss_thresh: float = 1000.0            # per-loss clamp
    new_training: bool = False             # det-only warmup
    compute_dtype: str = "float32"
    act_dtype: str = "float32"             # bfloat16: bf16 activations
    remat: str = "stage"                   # "stage" | "net" | "none"
    cam_scale_base: float = 1.1
    match_pred_centers: bool = False       # matching_forward refinement
    match_radius: float = 3.0              # map-pixel match gate
    backbone: str = "hrnet32"

    def __post_init__(self):
        if self.act_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"act_dtype {self.act_dtype!r}")
        if self.remat not in ("stage", "net", "none"):
            raise ValueError(f"remat {self.remat!r}")


def is_bn_stat(name: str) -> bool:
    return name.endswith("running_mean") or name.endswith("running_var")


def split_params(params: Dict[str, torch.Tensor]):
    """A flat state dict -> (trainable, BatchNorm statistics); BatchNorm's
    `num_batches_tracked` counters (which JAX has not) go to neither."""
    trainable = {k: v for k, v in params.items()
                 if not is_bn_stat(k) and not k.endswith("num_batches_tracked")}
    bn_state = {k: v for k, v in params.items() if is_bn_stat(k)}
    return trainable, bn_state


def make_lr_schedule(lr: float, milestones: Tuple[int, ...] = (),
                     decay: float = 0.1, warmup_steps: int = 0
                     ) -> Union[float, Callable[[torch.Tensor], torch.Tensor]]:
    """MultiStepLR(milestones, decay) and an optional linear warmup, as a
    function of the schedule's count (`romp/base.py:70`); a plain float
    when both are off."""
    if not milestones and not warmup_steps:
        return lr

    def schedule(count: torch.Tensor) -> torch.Tensor:
        # scalars only: no host-to-device copy on the step's path
        scale = torch.full((), lr, dtype=torch.float32, device=count.device)
        if milestones:
            passed = sum((count >= m).float() for m in milestones)
            scale = scale * torch.pow(decay, passed)
        if warmup_steps:
            scale = scale * torch.clamp(
                (count + 1).float() / warmup_steps, max=1.0)
        return scale

    return schedule


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < INT32_MAX, count + 1, count)


@dataclasses.dataclass
class OptState:
    """optax's `apply_if_finite(chain(clip, adamw))` state, leaf for leaf:
    notfinite_count, last_finite, total_notfinite, Adam's count, mu and nu
    (flat, in the parameters' sorted name order) and, with a schedule, its
    count. Scalars are 0-dim device tensors."""

    notfinite_count: torch.Tensor
    last_finite: torch.Tensor
    total_notfinite: torch.Tensor
    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    schedule_count: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(numel: int, device, schedule: bool,
              dtype: torch.dtype = torch.float32) -> "OptState":
        def i32():
            return torch.zeros((), dtype=torch.int32, device=device)
        return OptState(
            i32(), torch.ones((), dtype=torch.bool, device=device), i32(),
            i32(), torch.zeros(numel, dtype=dtype, device=device),
            torch.zeros(numel, dtype=dtype, device=device),
            i32() if schedule else None)


def _flatten_into(tensors: List[torch.Tensor], device) -> torch.Tensor:
    """One flat f32 buffer (f64 for an f64 net) holding the tensors'
    values, which become views into it (in place: the module sees the same
    tensors)."""
    dtype = functools.reduce(torch.promote_types,
                             (t.dtype for t in tensors), torch.float32)
    flat = torch.cat([torch.zeros(0, dtype=dtype, device=device)]
                     + [t.detach().reshape(-1).to(dtype) for t in tensors])
    offset = 0
    for t in tensors:
        n = t.numel()
        t.data = flat[offset:offset + n].view_as(t)
        offset += n
    return flat


@dataclasses.dataclass
class TrainState:
    """The trainable parameters, BatchNorm statistics, optimizer state and
    step of the JAX package's TrainState, held by a net (a RompNet here, a
    TRACE head in `trace_train_step.py`): `trainable` and `bn_state` are the
    net's own parameter and buffer tensors (views into `flat` and
    `bn_flat`, sorted by name), updated in place by the step."""

    net: nn.Module
    names: Tuple[str, ...]       # trainable, sorted
    bn_names: Tuple[str, ...]    # running statistics, sorted
    flat: torch.Tensor
    bn_flat: torch.Tensor
    opt_state: OptState
    step: torch.Tensor           # int32, advances on every step

    @property
    def trainable(self) -> Dict[str, torch.Tensor]:
        params = dict(self.net.named_parameters())
        return {k: params[k] for k in self.names}

    @property
    def bn_state(self) -> Dict[str, torch.Tensor]:
        bufs = dict(self.net.named_buffers())
        return {k: bufs[k] for k in self.bn_names}


def init_train_state(net: nn.Module, cfg: TrainConfig) -> TrainState:
    """A fresh optimizer state over the net's parameters (on its device).
    `cfg` is any step config with TrainConfig's optimizer fields (lr,
    lr_milestones, lr_decay, warmup_steps)."""
    params, bufs = split_params(net.state_dict(keep_vars=True))
    names, bn_names = tuple(sorted(params)), tuple(sorted(bufs))
    device = params[names[0]].device
    flat = _flatten_into([params[k] for k in names], device)
    bn_flat = _flatten_into([bufs[k] for k in bn_names], device)
    schedule = not isinstance(make_lr_schedule(
        cfg.lr, cfg.lr_milestones, cfg.lr_decay, cfg.warmup_steps), float)
    return TrainState(net, names, bn_names, flat, bn_flat,
                      OptState.zeros(flat.numel(), flat.device, schedule,
                                     flat.dtype),
                      torch.zeros((), dtype=torch.int32, device=flat.device))


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    opt = state.opt_state
    counters = [opt.notfinite_count, opt.last_finite, opt.total_notfinite,
                opt.count, opt.schedule_count]
    return [state.flat, state.bn_flat, opt.mu, opt.nu, state.step,
            *(c for c in counters if c is not None)]


def replicate_train_state(state: TrainState, group) -> None:
    """Every rank of `group` takes rank 0's parameters, BatchNorm
    statistics, optimizer state and step, in place (nothing with no
    group)."""
    replicate_tree(_state_tensors(state), group)


def check_train_state(state: TrainState, group) -> None:
    """Raise unless every rank of `group` holds bitwise the same state."""
    check_replicas(_state_tensors(state), group)


@torch.no_grad()
def optimizer_update(state: TrainState, grad: torch.Tensor,
                     cfg: TrainConfig) -> torch.Tensor:
    """optax's apply_if_finite(chain(clip_by_global_norm, adamw)) on the
    flat gradient, applied in place to `state.flat` and `state.opt_state`
    (`cfg`: any step config with TrainConfig's optimizer fields). Returns
    whether the gradient was finite (a 0-dim bool tensor)."""
    opt = state.opt_state
    finite = torch.isfinite(grad).all()
    notfinite = torch.where(finite, torch.zeros_like(opt.notfinite_count),
                            _safe_increment(opt.notfinite_count))
    accept = finite | (notfinite > MAX_CONSECUTIVE_ERRORS)
    # clip_by_global_norm: t, or (t / |g|) * max when |g| >= max
    g_norm = torch.linalg.vector_norm(grad)
    keep = g_norm < cfg.grad_clip
    g = (grad / torch.where(keep, torch.ones_like(g_norm), g_norm)
         * torch.where(keep, 1.0, cfg.grad_clip))
    # scale_by_adam
    mu = (1 - ADAM_B1) * g + ADAM_B1 * opt.mu
    nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * opt.nu
    count = _safe_increment(opt.count)
    mu_hat = mu / (1 - torch.pow(ADAM_B1, count.to(mu.dtype)))
    nu_hat = nu / (1 - torch.pow(ADAM_B2, count.to(mu.dtype)))
    update = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
    # add_decayed_weights, scale_by_learning_rate
    update = update + cfg.weight_decay * state.flat
    lr = make_lr_schedule(cfg.lr, cfg.lr_milestones, cfg.lr_decay,
                          cfg.warmup_steps)
    if opt.schedule_count is not None:
        lr = lr(opt.schedule_count)
        opt.schedule_count = torch.where(
            accept, _safe_increment(opt.schedule_count), opt.schedule_count)
    new_flat = state.flat + (-lr) * update
    state.flat.copy_(torch.where(accept, new_flat, state.flat))
    opt.mu = torch.where(accept, mu, opt.mu)
    opt.nu = torch.where(accept, nu, opt.nu)
    opt.count = torch.where(accept, count, opt.count)
    opt.notfinite_count = notfinite
    opt.last_finite = finite
    opt.total_notfinite = torch.where(finite, opt.total_notfinite,
                                      _safe_increment(opt.total_notfinite))
    return finite


def run_net_remat(net: RompNet, image: torch.Tensor, cfg: TrainConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ROMP net's forward under the remat policy (`train_step.py:
    131-178`). "stage": each segment (`RompNet.segments`) is a
    `torch.utils.checkpoint` region, so the backward keeps the segments'
    boundary tensors and recomputes one segment at a time; "net": one region
    for the whole net; "none": no recompute. A recomputed BatchNorm finds its
    statistics recorded and records nothing. With bf16 activations the
    segments' boundary tensors are bf16. Returns (center_maps,
    params_maps), channels-last, in the activation dtype."""
    opts = opts_from_names(cfg.compute_dtype, cfg.act_dtype, train=True)
    if cfg.remat == "stage":
        xs = [image]
        for seg in net.segments(opts):
            xs = checkpoint(seg, *xs, use_reentrant=False,
                            preserve_rng_state=False)
        return xs[0], xs[1]
    if cfg.remat == "net":
        return checkpoint(net, image, opts, use_reentrant=False,
                          preserve_rng_state=False)
    return net(image, opts)


def compute_losses(net: RompNet, batch: Dict[str, torch.Tensor],
                   smpl: SmplModel, cfg: TrainConfig,
                   prior: Optional[GmmPrior] = None, group=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward and composite loss (`train_step.py:181-291`): (total,
    metrics). The net runs in its current mode (train mode for training);
    the batch schema is the JAX package's (all fixed-shape, on the net's
    device): image (B, S, S, 3) RGB in [0, 255]; person_centers (B, P, 2)
    in [-1, 1]; person_bbox_hw (B, P, 2); person_mask (B, P); kp2d_gt
    (B, P, 54, 2); kp3d_gt (B, P, 54, 3); kp3d_mask, pose_mask, betas_mask
    (B, P); pose_gt (B, P, 66); betas_gt (B, P, 10); optionally kp2d_mask.
    The GT center maps and flat indices are made here, on the device.
    With `group`, every loss is the global batch's mean (the same value on
    every rank), and the merger clamps those."""
    center_maps, params_maps = run_net_remat(net, batch["image"], cfg)
    # loss math in f32 (`train_step.py:208-212`)
    center_maps = at_least_f32(center_maps)
    params_maps = at_least_f32(params_maps)

    B, P = batch["person_mask"].shape
    map_size = center_maps.shape[1]
    centers = batch["person_centers"]
    radii = person_radius(batch["person_bbox_hw"], map_size)
    centermap_gt = generate_centermap(centers, radii, batch["person_mask"],
                                      map_size)
    cx = torch.clamp(torch.floor((centers[..., 0] + 1) / 2 * map_size), 0,
                     map_size - 1).to(torch.int32)
    cy = torch.clamp(torch.floor((centers[..., 1] + 1) / 2 * map_size), 0,
                     map_size - 1).to(torch.int32)
    person_inds = cy * map_size + cx

    if cfg.match_pred_centers:
        # supervise each GT person at its nearest predicted peak within
        # match_radius (`result_parser.py:97,190`), else at its GT center
        det = parse_centermap2d(center_maps[..., 0].detach(), P, -1e9)
        d = torch.linalg.norm(
            det.yx[:, None, :, :]
            - torch.stack([cy, cx], -1)[:, :, None, :].float(), dim=-1)
        best_d, best = torch.min(d, dim=-1)
        matched = torch.gather(det.flat_inds, 1, best)
        person_inds = torch.where(best_d <= cfg.match_radius, matched,
                                  person_inds)

    params_pred = sample_maps_at(params_maps, person_inds)
    out = unpack_params(params_pred, cfg.cam_scale_base)

    def flat(a):
        return a.reshape(B * P, *a.shape[2:])

    w = flat(batch["person_mask"]).float()
    thetas = flat(out["smpl_thetas"])
    verts, joints = smpl_forward(smpl, flat(out["smpl_betas"]), thetas)
    pj2d = weak_perspective_projection(joints, flat(out["cam"]))
    kp3d_w = w * flat(batch["kp3d_mask"]).float()
    pose_w = w * flat(batch["pose_mask"]).float()
    # bbox-only persons supervise the centermap only
    kp2d_w = (w * flat(batch["kp2d_mask"]).float() if "kp2d_mask" in batch
              else w)
    kp3d_gt = flat(batch["kp3d_gt"])

    loss_dict = {
        "centermap": cfg.centermap_weight * losses.focal_heatmap_loss(
            center_maps[..., 0], centermap_gt, group),
        "kp2d": cfg.kp2d_weight * losses.kp2d_l2_loss(
            flat(batch["kp2d_gt"]), pj2d[:, :54], kp2d_w, group),
        "mpjpe": cfg.mpjpe_weight * losses.mpjpe_loss(
            kp3d_gt, joints[:, :54], kp3d_w, group),
        "pampjpe": cfg.pampjpe_weight * losses.pampjpe_loss(
            kp3d_gt[:, :24], joints[:, :24], kp3d_w, group),
        "pose": cfg.pose_weight * losses.pose_l2_loss(
            flat(batch["pose_gt"]), thetas[:, :66], pose_w, group),
        "shape": cfg.shape_weight * losses.shape_loss(
            flat(batch["betas_gt"]), out["smpl_betas"].reshape(B * P, -1),
            w, flat(batch["betas_mask"]).float(), group),
    }
    if prior is not None and cfg.prior_weight > 0:
        loss_dict["prior"] = cfg.prior_weight * gmm_prior_loss(
            prior, thetas[:, 3:66], w, group=group)
        if cfg.angle_prior_weight > 0:
            num, den = global_sums(torch.sum(angle_prior(thetas) * w),
                                   torch.sum(w), group=group)
            loss_dict["prior"] = loss_dict["prior"] + (
                cfg.angle_prior_weight * num / (den + 1e-6))
    return merge_losses(loss_dict, cfg.loss_thresh, cfg.new_training)


def run_step(state: TrainState, losses_fn: Callable[[nn.Module], Tuple[
        torch.Tensor, Dict[str, torch.Tensor]]], cfg,
             gate_bn: bool, group=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One AdamW step of `state.net`, in place: `losses_fn(net)` gives
    (total, metrics), run with the net in train mode and its BatchNorms
    recording their updates; `cfg` is any step config with TrainConfig's
    optimizer fields and `compute_dtype`. The BatchNorm statistics take
    the recorded updates, only when the gradient was finite if `gate_bn`
    (ROMP's and pretraining's rule) or always (BEV's, as JAX's steps do).
    With `group` (a data-parallel step; `losses_fn` then computes global
    losses), the BatchNorm statistics are the global batch's and the
    gradient is all-reduced before the update.
    Returns (whether the gradient was finite, the detached metrics)."""
    net = state.net.train()
    params = [dict(net.named_parameters())[k] for k in state.names]
    updates = record_bn_updates(net, group=group)
    try:
        with (precision_flags(cfg) if state.flat.is_cuda
              else contextlib.nullcontext()):
            total, metrics = losses_fn(net)
            grads = torch.autograd.grad(total, params, allow_unused=True)
    finally:
        record_bn_updates(net, on=False)
    grad = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for p, g in zip(params, grads)])
    finite = optimizer_update(state, all_reduce_grad(grad, group), cfg)
    with torch.no_grad():
        # every train-mode BatchNorm recorded its update
        bn_new = torch.cat([updates.get(k, v).reshape(-1)
                            for k, v in state.bn_state.items()])
        state.bn_flat.copy_(torch.where(finite, bn_new, state.bn_flat)
                            if gate_bn else bn_new)
    state.step += 1
    return finite, {k: v.detach() for k, v in metrics.items()}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               smpl: SmplModel, cfg: TrainConfig,
               prior: Optional[GmmPrior] = None, group=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place (`train_step.py:294-322`). Returns the state
    and the metrics (0-dim device tensors: the clamped losses, task sums,
    total, grads_finite). BatchNorm statistics follow the step's skip rule.
    With `group`, `batch` is this rank's rows of the global batch, and the
    step is the global batch's on every rank."""
    finite, metrics = run_step(
        state, lambda net: compute_losses(net, batch, smpl, cfg, prior,
                                          group), cfg,
        gate_bn=True, group=group)
    metrics["grads_finite"] = finite.float()
    return state, metrics


def make_synthetic_batch(seed: int, batch_size: int, num_person: int = 4,
                         input_size: int = 512, device="cuda"
                         ) -> Dict[str, torch.Tensor]:
    """A random well-formed training batch, made on `device` from a seeded
    torch.Generator (the JAX package's distributions, other numbers)."""
    g = torch.Generator(device=device).manual_seed(seed)
    B, P = batch_size, num_person

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device) * std

    ones = torch.ones((B, P), dtype=torch.bool, device=device)
    return {
        "image": uniform((B, input_size, input_size, 3), 0.0, 255.0),
        "person_centers": uniform((B, P, 2), -0.9, 0.9),
        "person_bbox_hw": torch.full((B, P, 2), 0.5, device=device),
        "person_mask": ones,
        "kp2d_gt": uniform((B, P, 54, 2), -1.0, 1.0),
        "kp3d_gt": normal((B, P, 54, 3), 0.3),
        "kp3d_mask": ones.clone(),
        "pose_gt": normal((B, P, 66), 0.3),
        "pose_mask": ones.clone(),
        "betas_gt": normal((B, P, 10), 0.5),
        "betas_mask": ones.clone(),
    }
