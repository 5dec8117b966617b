"""2D-pose backbone pretraining: the net, its losses and step, and its
launcher (counterpart of `romp_tpu/train/pretrain.py`).

    python -m romp_tpu_torch.train.pretrain --config configs/pretrain.yml \
        [--data_root data] [--max_steps N] [--GPU N] [mesh.n_devices=N]

(`mesh.n_devices` and `mesh.multihost` start or join data-parallel ranks as
for `romp_tpu_torch.train.launch`.)

The reference's pretrain entry (`romp/pretrain.py:1-208`, launched by
`scripts/pretrain.sh` with `configs/pretrain.yml`) trains the backbone
bottom-up on 2D pose alone, with joint heatmaps, associative-embedding
tags and the person-center map, before the 3D stages load the pretrained
backbone. The keypoint / tag head is an extra ROMP-style conv head
(`pretrain_head.kp_ae`) beside the regular center head (`final_layers.2`)
on the backbone and CoordConv trunk, so its state-dict keys are the JAX
package's flat names and the result loads into ROMP's trainer
(`train.resume=<pretrain_last.npz> train.fine_tune=true`: the backbone and
center head are taken, the extra head is left out).

As in the JAX package, the heatmaps cover the whole SMPL_ALL_54 joint set
with per-joint visibility (invalid = -2 annotations), not COCO-17.

The optimizer is ROMP's (`train_step.py`: optax's apply_if_finite(chain(
clip_by_global_norm, adamw)), in place on one flat buffer); the BatchNorm
statistics are committed only when every gradient is finite (`pretrain.py:
148-163`), and the metrics have `grads_finite`. No remat, no chain kernel
(train mode runs the branches unfused): this path launches no kernel of
the port's.
"""
from __future__ import annotations

import dataclasses
import itertools
import sys
from typing import Dict, Tuple

import torch
import torch.nn as nn

from romp_tpu_torch.models.hrnet import hrnet32
from romp_tpu_torch.models.layers import (
    F32, Conv2d, ConvTranspose2d, LayerOpts, at_least_f32, he_normal_,
    opts_from_names,
)
from romp_tpu_torch.models.resnet import OUT_CHANNELS, ResNet50
from romp_tpu_torch.models.romp import Head, coord_maps
from romp_tpu_torch.train import losses
from romp_tpu_torch.train.centermap_gt import generate_centermap, person_radius
from romp_tpu_torch.train.heatmap_ae import (
    ae_loss, generate_joint_heatmaps, heatmap_mse_loss,
)
from romp_tpu_torch.train.train_step import (
    TrainState, init_train_state, run_step,
)

NUM_JOINTS = 54
BATCH_KEYS = ("image", "kp2d_gt", "person_centers", "person_bbox_hw",
              "person_mask")


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """The JAX package's PretrainConfig: same fields and defaults."""

    lr: float = 3e-4
    lr_milestones: Tuple[int, ...] = ()
    lr_decay: float = 0.1
    warmup_steps: int = 0
    weight_decay: float = 1e-6
    grad_clip: float = 3.0
    heatmap_weight: float = 100.0      # MSE on unit-peak gaussians is tiny
    ae_weight: float = 1.0             # pull + push
    centermap_weight: float = 1.0
    heatmap_sigma: float = 2.0
    num_joints: int = NUM_JOINTS
    compute_dtype: str = "float32"
    backbone: str = "hrnet32"


class PretrainNet(nn.Module):
    """`pretrain_forward` (`pretrain.py:65-88`): the backbone (HRNet-W32 for
    "hrnet32", ResNet-50 for any other name, as JAX's branch reads), then
    CoordConv, then two ROMP heads: `pretrain_head.kp_ae` (2J channels:
    the heatmaps, then the tags) and the center head `final_layers.2`."""

    def __init__(self, backbone: str = "hrnet32",
                 num_joints: int = NUM_JOINTS):
        super().__init__()
        self.hrnet = backbone == "hrnet32"
        if self.hrnet:
            self.backbone, in_ch = hrnet32(backbone), 32 + 2
        else:
            self.backbone, in_ch = ResNet50(), OUT_CHANNELS + 2
        self.num_joints = num_joints
        self.pretrain_head = nn.ModuleDict(
            {"kp_ae": Head(in_ch, 2 * num_joints)})
        # indices 0 and 1 hold no parameters: only ROMP's center head
        self.final_layers = nn.ModuleList([nn.Identity(), nn.Identity(),
                                           Head(in_ch, 1)])

    def features(self, image: torch.Tensor,
                 opts: LayerOpts = F32) -> torch.Tensor:
        """(B, S, S, 3) RGB in [0, 255] -> backbone features, NCHW."""
        if not self.hrnet:
            return self.backbone(image, opts)
        x = ((at_least_f32(image) / 255.0) * 2.0 - 1.0).permute(0, 3, 1, 2)
        return self.backbone(x.contiguous(), opts)

    def heads(self, feat: torch.Tensor, opts: LayerOpts = F32
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """CoordConv and the two heads on backbone features: (heat (B, S,
        S, J), tags (B, S, S, J), center (B, S, S, 1)), channels-last."""
        cm = coord_maps(feat.shape[2], feat.dtype, feat.device)
        feat = torch.cat([feat, cm.expand(feat.shape[0], -1, -1, -1)], dim=1)
        J = self.num_joints
        kp_ae = self.pretrain_head["kp_ae"](feat, opts).permute(0, 2, 3, 1)
        center = self.final_layers[2](feat, opts).permute(0, 2, 3, 1)
        return kp_ae[..., :J], kp_ae[..., J:], center

    def forward(self, image: torch.Tensor, opts: LayerOpts = F32
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.heads(self.features(image, opts), opts)


def init_pretrain_params(generator: torch.Generator,
                         cfg: PretrainConfig = PretrainConfig()
                         ) -> Dict[str, torch.Tensor]:
    """A fresh seeded state dict, initialized by the JAX package's rule
    (`layers.py:80-91`, as `init_romp_params`): conv weights He-normal over
    fan_in, conv biases 0, BatchNorm weight 1, bias 0, mean 0, var 1."""
    net = PretrainNet(cfg.backbone, cfg.num_joints)
    for m in net.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            he_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return net.state_dict()


def init_pretrain_state(net: PretrainNet, cfg: PretrainConfig) -> TrainState:
    """A fresh optimizer state over the net's parameters (on its device)."""
    return init_train_state(net, cfg)


def pretrain_losses(net: PretrainNet, batch: Dict[str, torch.Tensor],
                    cfg: PretrainConfig, group=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, metrics) (`pretrain.py:111-145`). batch: image (B, S, S, 3)
    in [0, 255]; kp2d_gt (B, P, J, 2) in [-1, 1], invalid = -2;
    person_centers (B, P, 2); person_bbox_hw (B, P, 2); person_mask (B, P).
    The maps are cast to f32 (kept f64 on an f64 net) before the losses.
    With `group`, each loss is the global batch's mean."""
    heat, tags, center = net(batch["image"],
                             opts_from_names(cfg.compute_dtype))
    heat, tags, center = (at_least_f32(t) for t in (heat, tags, center))
    mask = batch["person_mask"]
    kp2d = batch["kp2d_gt"][..., :cfg.num_joints, :]
    vis = torch.all(kp2d > -1.99, dim=-1) & mask[..., None]   # (B, P, J)
    S = heat.shape[1]
    with torch.no_grad():
        heat_gt = generate_joint_heatmaps(kp2d.to(heat.dtype), vis, S,
                                          cfg.heatmap_sigma)
        radii = person_radius(batch["person_bbox_hw"], S)
        center_gt = generate_centermap(batch["person_centers"], radii, mask,
                                       S)
    pull, push = ae_loss(tags, kp2d, vis, mask, group)
    loss_dict = {
        "heatmap": cfg.heatmap_weight * heatmap_mse_loss(heat, heat_gt,
                                                         group),
        "AE": cfg.ae_weight * (pull + push),
        "centermap": cfg.centermap_weight * losses.focal_heatmap_loss(
            center[..., 0], center_gt, group),
    }
    total = sum(loss_dict.values())
    return total, {**loss_dict, "total": total}


def pretrain_step(state: TrainState, batch: Dict[str, torch.Tensor],
                  cfg: PretrainConfig, group=None
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place (`pretrain.py:148-163`). Returns the state
    and the metrics (0-dim device tensors: the losses, total and
    grads_finite). The BatchNorm statistics follow the step's skip rule.
    With `group`, `batch` is this rank's rows of the global batch, and the
    step is the global batch's on every rank."""
    finite, metrics = run_step(
        state, lambda net: pretrain_losses(net, batch, cfg, group), cfg,
        gate_bn=True, group=group)
    metrics["grads_finite"] = finite.to(metrics["total"].dtype)
    return state, metrics


def make_synthetic_pretrain_batch(seed: int, batch_size: int,
                                  num_person: int = 4, input_size: int = 64,
                                  device="cuda") -> Dict[str, torch.Tensor]:
    """A random well-formed pretraining batch, made on `device` from a
    seeded torch.Generator (the JAX package's distributions, other
    numbers)."""
    g = torch.Generator(device=device).manual_seed(seed)
    B, P = batch_size, num_person

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    return {
        "image": uniform((B, input_size, input_size, 3), 0.0, 255.0),
        "kp2d_gt": uniform((B, P, NUM_JOINTS, 2), -0.9, 0.9),
        "person_centers": uniform((B, P, 2), -0.9, 0.9),
        "person_bbox_hw": torch.full((B, P, 2), 0.5, device=device),
        "person_mask": torch.ones((B, P), dtype=torch.bool, device=device),
    }


def pretrain_config(cfg) -> PretrainConfig:
    """The step's PretrainConfig from the config tree (`pretrain.py:
    202-206`)."""
    return PretrainConfig(
        lr=cfg.train.lr, lr_milestones=tuple(cfg.train.lr_milestones),
        lr_decay=cfg.train.lr_decay, warmup_steps=cfg.train.warmup_steps,
        weight_decay=cfg.train.weight_decay, grad_clip=cfg.train.grad_clip,
        compute_dtype=cfg.train.compute_dtype, backbone=cfg.model.backbone)


def main(input_args=None) -> int:
    """The pretrain launcher (`pretrain.py:182-268`): the same annotation
    packs as the trainer (2D-only datasets suffice; the 3D fields are not
    read), `--GPU N` (default 0) trains on `cuda:N`, `--GPU -1` on the CPU;
    `mesh.n_devices=N` trains in N processes of this host, each on its rows
    of the global batch (`parallel/mesh.py`). Rank 0 writes
    pretrain_log.jsonl (each step's metrics, read one step late) and
    pretrain_last.npz (the trainer's checkpoint format) under
    train.checkpoint_dir."""
    import argparse
    import json
    import os
    import os.path as osp
    import time

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--data_root", type=str, default="data")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--GPU", type=int, default=0,
                        help="card index; -1 trains on the CPU")
    parser.add_argument("overrides", nargs="*")
    argv = list(sys.argv[1:] if input_args is None else input_args)
    args = parser.parse_intermixed_args(argv)

    from romp_tpu_torch.config import dump_config, load_config
    from romp_tpu_torch.parallel.mesh import (
        finalize_distributed, initialize_from_config, launch_ranks,
        process_index, shard_batch,
    )
    from romp_tpu_torch.train.data.dataset import batch_iterator
    from romp_tpu_torch.train.launch import build_datasets, rank_device
    from romp_tpu_torch.train.train_step import (
        check_train_state, replicate_train_state,
    )
    from romp_tpu_torch.train.trainer import batch_to_device, save_train_state

    cfg = load_config(args.config, overrides=args.overrides)
    rc = launch_ranks(cfg.mesh, "romp_tpu_torch.train.pretrain", argv)
    if rc is not None:
        return rc
    cfg.data_root = args.data_root
    device = rank_device(cfg, args.GPU)
    group = initialize_from_config(cfg.mesh, device)
    is_main = process_index() == 0
    os.makedirs(cfg.train.checkpoint_dir, exist_ok=True)
    if is_main:
        dump_config(cfg, f"{cfg.train.checkpoint_dir}/active_config.yml")

    pcfg = pretrain_config(cfg)
    net = PretrainNet(pcfg.backbone, pcfg.num_joints)
    net.load_state_dict(init_pretrain_params(
        torch.Generator().manual_seed(cfg.train.seed), pcfg))
    state = init_pretrain_state(net.to(device), pcfg)
    replicate_train_state(state, group)
    mixed = build_datasets(cfg)
    log_path = osp.join(cfg.train.checkpoint_dir, "pretrain_log.jsonl")
    t0 = time.time()
    names = None
    step0 = int(state.step)
    n_done = 0
    pending = None

    def consume(packed, step, i):
        if step % cfg.train.log_every == 0 and is_main:
            rec = {"step": step, **dict(zip(names, packed.cpu().tolist())),
                   "steps_per_sec": round((i + 1) / (time.time() - t0), 3)}
            with open(log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    # packed metrics, read one step late (as Trainer.fit): one copy to the
    # host a step, and the device does not wait for the host's logging;
    # every rank draws the same global batches and keeps its rows
    try:
        for i, batch in enumerate(itertools.islice(
                batch_iterator(mixed, cfg.train.batch_size,
                               seed=cfg.train.seed), args.max_steps)):
            batch = batch_to_device(
                shard_batch({k: batch[k] for k in BATCH_KEYS}), device)
            _, m = pretrain_step(state, batch, pcfg, group)
            if names is None:
                names = tuple(sorted(m))
            packed = torch.stack([m[k].float() for k in names])
            n_done += 1
            if pending is not None:
                consume(*pending)
            pending = (packed, step0 + n_done, i)
        if pending is not None:
            consume(*pending)
        check_train_state(state, group)
        if is_main:
            save_train_state(osp.join(cfg.train.checkpoint_dir,
                                      "pretrain_last.npz"), state)
    finally:
        if cfg.mesh.multihost:
            finalize_distributed()
    print(f"pretrain finished at step {step0 + n_done}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
