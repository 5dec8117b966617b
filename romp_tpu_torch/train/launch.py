"""Training launcher: config -> datasets -> Trainer.fit (counterpart of
`romp_tpu/train/launch.py`, ROMP's training).

    python -m romp_tpu_torch.train.launch --data_root data --max_steps 100 \
        train.batch_size=64 model.backbone=resnet50

Packs are <data_root>/<name>.npz annotation records
(`romp_tpu_torch/train/data/dataset.py` converters and `save_pack`).
`--GPU N` (default 0) trains on `cuda:N` and raises when that card does not
exist; `--GPU -1` trains on the CPU. `model.version=bev` and `trace` are
not ported yet (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

import argparse
import os.path as osp
import sys

BEV_TRACE_NOT_PORTED = (
    "model.version={}: the port trains ROMP only so far; TRACE training "
    "(with the deform backward) and BEV training are ROADMAP queue 1 item "
    "5, next in order")


def build_datasets(cfg):
    """The configured dataset mix from <data_root>/<name>.npz packs."""
    from romp_tpu_torch.train.data.augment import AugmentConfig
    from romp_tpu_torch.train.data.dataset import (
        MixedDataset, SingleDataset, load_pack,
    )

    aug = AugmentConfig(input_size=cfg.model.input_size,
                        flip_prob=cfg.data.flip_prob,
                        rot_factor=cfg.data.rot_aug,
                        color_jitter=cfg.data.color_jitter,
                        occlusion_prob=cfg.data.synthetic_occlusion_prob)
    datasets = []
    data_root = getattr(cfg, "data_root", "data")
    for name in cfg.data.datasets:
        pack = osp.join(data_root, f"{name}.npz")
        if not osp.exists(pack):
            print(f"WARNING: missing annotation pack {pack}; skipping",
                  file=sys.stderr)
            continue
        datasets.append(SingleDataset(load_pack(pack), name, aug,
                                      num_person=cfg.data.num_person))
    if not datasets:
        raise FileNotFoundError(
            "no annotation packs found; convert datasets first "
            "(romp_tpu_torch/train/data/dataset.py converters)")
    probs = cfg.data.sample_probs if len(cfg.data.sample_probs) else None
    return MixedDataset(datasets, probs)


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
    args = parser.parse_args(input_args)

    from romp_tpu_torch.cli.common import (
        device_from_flag, load_smpl_assets_flexible,
    )
    from romp_tpu_torch.config import dump_config, load_config
    from romp_tpu_torch.smpl.body_model import SmplModel
    from romp_tpu_torch.train.data.dataset import batch_iterator
    from romp_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config, overrides=args.overrides)
    if cfg.model.version != "romp":
        raise NotImplementedError(
            BEV_TRACE_NOT_PORTED.format(cfg.model.version))
    cfg.data_root = args.data_root
    device = device_from_flag(args.GPU)
    dump_config(cfg, f"{cfg.train.checkpoint_dir}/active_config.yml")

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
