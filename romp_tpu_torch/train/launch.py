"""Training launcher: config -> datasets -> Trainer.fit, or TRACE's video
training (counterpart of `romp_tpu/train/launch.py`).

    python -m romp_tpu_torch.train.launch --data_root data --max_steps 100 \
        train.batch_size=64 model.backbone=resnet50
    python -m romp_tpu_torch.train.launch --config configs/trace.yml \
        --data_root data

ROMP's packs are <data_root>/<name>.npz annotation records
(`romp_tpu_torch/train/data/dataset.py` converters and `save_pack`);
TRACE's are video packs (`train/data/video_dataset.py` converters and
`save_video_pack`). `--GPU N` (default 0) trains on `cuda:N` and raises
when that card does not exist; `--GPU -1` trains on the CPU.
`model.version=bev` is refused, as the JAX launcher has no BEV branch:
BEV trains through `train/bev_train_step.py`'s step functions. 2D-pose
pretraining has its own launcher, `romp_tpu_torch.train.pretrain`.

Data parallel (`parallel/mesh.py`; `train.batch_size` is the global
batch, which the ranks split evenly):
    # N processes on this host, rank r on cuda:r (--GPU -1: on the CPU)
    python -m romp_tpu_torch.train.launch --data_root data mesh.n_devices=N
    # one rank of a job over several hosts, on every host
    python -m romp_tpu_torch.train.launch --data_root data \
        mesh.multihost=true mesh.coordinator=HOST0:PORT \
        mesh.num_processes=W mesh.process_id=R
A rank of a multihost job trains on cuda:(R mod the host's cards). Every
rank draws the same global batches from the same seed and keeps its rows
(TRACE: whole clips; only its own clips go through the frozen backbone and
RAFT). With several `train.num_workers`, each rank's loader interleaves
its workers' batches in its own order, so the ranks split different
global batches of the same stream: each sample is still used once. Only
rank 0 writes the logs and checkpoints.
"""
from __future__ import annotations

import argparse
import itertools
import os.path as osp
import sys

BEV_NOT_PORTED = (
    "model.version={}: the launcher trains ROMP and TRACE, as the JAX "
    "launcher does (it has no BEV branch); BEV trains through the step "
    "functions of romp_tpu_torch/train/bev_train_step.py (bev_init_train_"
    "state, bev_train_step; see ROADMAP)")


def build_datasets(cfg):
    """The configured dataset mix from <data_root>/<name>.npz packs. A
    missing pack is skipped with its sampling probability (JAX's
    `build_datasets` keeps every probability, so a skipped pack shifts them
    onto the wrong packs or fails the sampler); probabilities that do not
    name one per dataset (a recipe's `sample_prob` after a `data.datasets=`
    override) are not used: the packs are sampled by size."""
    from romp_tpu_torch.train.data.augment import AugmentConfig
    from romp_tpu_torch.train.data.dataset import (
        MixedDataset, SingleDataset, load_pack,
    )

    aug = AugmentConfig(input_size=cfg.model.input_size,
                        flip_prob=cfg.data.flip_prob,
                        rot_factor=cfg.data.rot_aug,
                        color_jitter=cfg.data.color_jitter,
                        occlusion_prob=cfg.data.synthetic_occlusion_prob)
    datasets, probs = [], []
    data_root = getattr(cfg, "data_root", "data")
    given = tuple(cfg.data.sample_probs)
    for i, name in enumerate(cfg.data.datasets):
        pack = osp.join(data_root, f"{name}.npz")
        if not osp.exists(pack):
            print(f"WARNING: missing annotation pack {pack}; skipping",
                  file=sys.stderr)
            continue
        datasets.append(SingleDataset(load_pack(pack), name, aug,
                                      num_person=cfg.data.num_person))
        if len(given) == len(cfg.data.datasets):
            probs.append(given[i])
    if not datasets:
        raise FileNotFoundError(
            "no annotation packs found; convert datasets first "
            "(romp_tpu_torch/train/data/dataset.py converters)")
    return MixedDataset(datasets, probs or None)


def rank_device(cfg, gpu: int):
    """This process's device: a rank of a multihost job takes
    `local_device(mesh.process_id)` (the CPU for `--GPU -1`), one process
    the card `--GPU` names."""
    from romp_tpu_torch.cli.common import device_from_flag
    from romp_tpu_torch.parallel.mesh import local_device

    if cfg.mesh.multihost:
        return local_device(cfg.mesh.process_id, cpu=gpu < 0)
    return device_from_flag(gpu)


def trace_train_config(cfg):
    """The TRACE step's TraceTrainConfig from the config tree (as
    `launch.py:147-157`)."""
    from romp_tpu_torch.train.trace_train_step import TraceTrainConfig

    tc = cfg.trace
    return TraceTrainConfig(
        lr=cfg.train.lr, lr_milestones=tuple(cfg.train.lr_milestones),
        lr_decay=cfg.train.lr_decay, warmup_steps=cfg.train.warmup_steps,
        weight_decay=cfg.train.weight_decay, grad_clip=cfg.train.grad_clip,
        centermap3d_weight=tc.centermap3d_weight,
        motion_weight=tc.motion_weight, pose_weight=tc.pose_weight,
        shape_weight=tc.shape_weight,
        world_trans_weight=tc.world_trans_weight,
        world_grot_weight=tc.world_grot_weight,
        temp_shape_weight=tc.temp_shape_weight,
        compute_dtype=cfg.train.compute_dtype)


def run_trace_training(cfg, args, device) -> int:
    """TRACE video training (`launch.py:47-211`): the frozen image backbone
    and the trainable temporal head, on `device` (one rank of a
    data-parallel job under `cfg.mesh`: its clips of each global batch).
    Consumes video packs <data_root>/<name>.npz written by
    `video_dataset.save_video_pack`."""
    import json
    import os
    import time

    import torch

    from romp_tpu_torch.cli.common import load_checkpoint_flexible
    from romp_tpu_torch.models.romp import RompNet, init_romp_params
    from romp_tpu_torch.models.trace import (
        TraceNet, backbone_features, init_trace_params,
    )
    from romp_tpu_torch.models.layers import opts_from_names
    from romp_tpu_torch.parallel.mesh import (
        group_size, initialize_from_config, process_index,
    )
    from romp_tpu_torch.pipeline.romp_pipeline import precision_flags
    from romp_tpu_torch.train.data.video_dataset import (
        ClipDataset, clip_batch_iterator, load_video_pack,
    )
    from romp_tpu_torch.train.train_step import (
        check_train_state, replicate_train_state,
    )
    from romp_tpu_torch.train.trace_train_step import (
        trace_init_train_state, trace_train_step,
    )
    from romp_tpu_torch.train.trainer import save_train_state

    group = initialize_from_config(cfg.mesh, device)
    is_main = process_index() == 0
    tc = cfg.trace
    seqs = []
    for name in cfg.data.datasets:
        pack = osp.join(cfg.data_root, f"{name}.npz")
        if not osp.exists(pack):
            print(f"WARNING: missing video pack {pack}; skipping",
                  file=sys.stderr)
            continue
        seqs.extend(load_video_pack(pack))
    if not seqs:
        raise FileNotFoundError(
            "no video packs found; convert sequences first "
            "(romp_tpu_torch/train/data/video_dataset.py converters + "
            "save_video_pack)")
    ds = ClipDataset(seqs, clip_length=tc.clip_length,
                     max_tracks=tc.max_tracks,
                     input_size=cfg.model.input_size,
                     dynamic_aug_prob=tc.dynamic_aug_prob,
                     tracking_aug_prob=tc.tracking_aug_prob,
                     changing_ratio=tc.changing_ratio)

    # the frozen image backbone (the reference's separate pretrained image
    # model, `trace/train_video.py:47-65`): ROMP's, in eval mode
    gen = torch.Generator().manual_seed(cfg.train.seed)
    if tc.backbone_ckpt and osp.exists(tc.backbone_ckpt):
        bparams = load_checkpoint_flexible(
            tc.backbone_ckpt,
            lambda g: init_romp_params(g, cfg.model.backbone))
    else:
        print("WARNING: no frozen-backbone checkpoint (trace.backbone_ckpt)"
              " — random-init features", file=sys.stderr)
        bparams = init_romp_params(gen, cfg.model.backbone)
    image_net = RompNet(cfg.model.backbone)
    image_net.load_state_dict(bparams)
    image_net = image_net.to(device).eval().requires_grad_(False)
    opts = opts_from_names(cfg.train.compute_dtype)

    def feature_fn(frames):
        return backbone_features(image_net.backbone, frames, opts)

    flow_fn = None
    if tc.use_optical_flow and tc.raft_model_path \
            and osp.exists(tc.raft_model_path):
        from romp_tpu_torch.models.raft import (
            filter_raft_state_dict, make_trace_flow_fn,
        )
        from romp_tpu_torch.utils.checkpoint import load_torch_checkpoint

        flow_fn = make_trace_flow_fn(
            filter_raft_state_dict(load_torch_checkpoint(
                tc.raft_model_path)),
            out_size=cfg.model.input_size // 4,
            flow_input_size=cfg.model.input_size, device=device)
    elif tc.use_optical_flow:
        print("WARNING: trace.use_optical_flow set but no RAFT weights — "
              "training with zero flow", file=sys.stderr)

    map_size = cfg.model.input_size // 4
    ttcfg = trace_train_config(cfg)
    head = TraceNet(None, map_size)
    head.load_state_dict(init_trace_params(
        gen, clip_length=tc.clip_length, map_size=map_size, backbone=None))
    state = trace_init_train_state(head.to(device), ttcfg)
    replicate_train_state(state, group)
    # this rank's clips of each global batch
    per_rank = cfg.train.batch_size // group_size(group)
    if per_rank * group_size(group) != cfg.train.batch_size:
        raise ValueError(f"train.batch_size {cfg.train.batch_size} does not "
                         f"split over {group_size(group)} ranks")
    rows = slice(process_index() * per_rank,
                 (process_index() + 1) * per_rank)

    # packed metrics, read one step late (as Trainer.fit): one copy to the
    # host a step, and the device does not wait for the host's logging
    names = None
    os.makedirs(cfg.train.checkpoint_dir, exist_ok=True)
    log_path = osp.join(cfg.train.checkpoint_dir, "trace_train_log.jsonl")
    t0 = time.time()

    def make_iter(seed):
        return clip_batch_iterator(ds, feature_fn, flow_fn=flow_fn,
                                   batch_size=cfg.train.batch_size,
                                   seed=seed, device=device, rows=rows)

    last = {}
    step0 = int(state.step)
    n_done = 0
    pending = None

    def consume(packed, step, i):
        nonlocal last
        last = dict(zip(names, packed.cpu().tolist()))
        if step % cfg.train.log_every == 0 and is_main:
            rec = {"step": step, **last,
                   "steps_per_sec": round((i + 1) / (time.time() - t0), 3)}
            with open(log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    # the precision flags are global to the process: set once for the
    # whole run, so that the loader's worker threads (the backbone's
    # features) and the steps all run under them, and no thread's exit
    # restores cuDNN's TF32 default in the middle of another's step
    with precision_flags(cfg.train):
        if cfg.train.num_workers > 0:
            from romp_tpu_torch.train.data.loader import PrefetchLoader

            it = PrefetchLoader(make_iter,
                                num_workers=cfg.train.num_workers,
                                prefetch=cfg.train.prefetch_batches,
                                seed=cfg.train.seed)
        else:
            it = make_iter(cfg.train.seed)
        try:
            # islice: the loader builds no batch beyond max_steps
            for i, batch in enumerate(itertools.islice(it, args.max_steps)):
                _, m = trace_train_step(state, batch, ttcfg, group=group)
                if names is None:
                    names = tuple(sorted(m))
                packed = torch.stack([m[k].float() for k in names])
                n_done += 1
                if pending is not None:
                    consume(*pending)
                pending = (packed, step0 + n_done, i)
            if pending is not None:
                consume(*pending)
        finally:
            if hasattr(it, "close"):
                it.close()
    check_train_state(state, group)
    if is_main:
        save_train_state(osp.join(cfg.train.checkpoint_dir,
                                  "trace_last.npz"), state)
    print(f"trace training finished: {last}")
    return 0


def main(input_args=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--data_root", type=str, default="data")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--smpl_path", type=str, default=None)
    parser.add_argument("--GPU", type=int, default=0,
                        help="card index; -1 trains on the CPU")
    parser.add_argument("overrides", nargs="*",
                        help="dotted config overrides, e.g. train.lr=1e-4")
    argv = list(sys.argv[1:] if input_args is None else input_args)
    args = parser.parse_intermixed_args(argv)

    from romp_tpu_torch.config import dump_config, load_config
    from romp_tpu_torch.parallel.mesh import finalize_distributed, launch_ranks

    cfg = load_config(args.config, overrides=args.overrides)
    if cfg.model.version not in ("romp", "trace"):
        raise NotImplementedError(BEV_NOT_PORTED.format(cfg.model.version))
    rc = launch_ranks(cfg.mesh, "romp_tpu_torch.train.launch", argv)
    if rc is not None:
        return rc
    cfg.data_root = args.data_root
    device = rank_device(cfg, args.GPU)
    if not cfg.mesh.process_id:
        dump_config(cfg, f"{cfg.train.checkpoint_dir}/active_config.yml")
    try:
        return _train(cfg, args, device)
    finally:
        if cfg.mesh.multihost:
            finalize_distributed()


def _train(cfg, args, device) -> int:
    """ROMP through the Trainer, or TRACE's video training, on `device`."""
    from romp_tpu_torch.cli.common import load_smpl_assets_flexible
    from romp_tpu_torch.smpl.body_model import SmplModel
    from romp_tpu_torch.train.data.dataset import batch_iterator
    from romp_tpu_torch.train.trainer import Trainer

    if cfg.model.version == "trace":
        return run_trace_training(cfg, args, device)

    assets = load_smpl_assets_flexible(args.smpl_path or cfg.smpl_assets)
    smpl = SmplModel(assets, device)
    mixed = build_datasets(cfg)
    trainer = Trainer(cfg, smpl, device=device)
    if cfg.train.num_workers > 0:
        # batch assembly on worker threads, overlapped with device steps
        from romp_tpu_torch.train.data.loader import PrefetchLoader

        batches = PrefetchLoader(
            lambda seed: batch_iterator(mixed, cfg.train.batch_size,
                                        seed=seed),
            num_workers=cfg.train.num_workers,
            prefetch=cfg.train.prefetch_batches, seed=cfg.train.seed)
    else:
        batches = batch_iterator(mixed, cfg.train.batch_size,
                                 seed=cfg.train.seed)
    try:
        metrics = trainer.fit(batches, max_steps=args.max_steps)
    finally:
        if hasattr(batches, "close"):
            batches.close()
    print(f"finished: {metrics}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
