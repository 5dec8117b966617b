"""Training configuration: typed dataclass tree + YAML overlay + CLI dots.

The port's copy of the JAX package's numpy-only
`romp_tpu/config.py`, so that the port imports nothing of that
package.

Replaces the reference's ~120-flag argparse + YAML + import-time global
singleton (`romp/lib/config.py:28-283`, a documented pain point — SURVEY.md
§8) with an explicit, picklable config object:

    cfg = load_config("configs/v1.yml", overrides=["train.lr=1e-4"])

YAML files may carry the reference's `ARGS:` section (flat keys mapped onto
the tree by name for checkpoint-recipe compatibility), a `loss_weight:`
section (-> cfg.loss.<name>_weight), and `sample_prob:` (-> dataset mix).
The active config can be dumped (`dump_config`) for out-of-process readers,
like the reference's active_configs/ yaml snapshots.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class ModelConfig:
    backbone: str = "hrnet32"            # hrnet32 | resnet50
    version: str = "romp"                # romp | bev | trace
    input_size: int = 512
    centermap_size: int = 64
    max_person: int = 64
    centermap_conf_thresh: float = 0.25
    cam_scale_base: float = 1.1


@dataclasses.dataclass
class LossConfig:
    centermap_weight: float = 1.0
    kp2d_weight: float = 400.0
    mpjpe_weight: float = 200.0
    pampjpe_weight: float = 360.0
    pose_weight: float = 80.0
    shape_weight: float = 6.0
    prior_weight: float = 1.6
    prior_path: Optional[str] = None     # gmm_08.pkl / packed npz; None =
    # synthetic GMM (the reference asset isn't redistributable)
    loss_thresh: float = 1000.0          # per-loss clamp (learnable_loss.py:50)


@dataclasses.dataclass
class DataConfig:
    datasets: Tuple[str, ...] = ("h36m", "coco", "mpii")
    sample_probs: Tuple[float, ...] = ()
    num_person: int = 8                  # fixed GT-person capacity per image
    shuffle_buffer: int = 1024
    rot_aug: float = 30.0
    flip_prob: float = 0.5
    color_jitter: float = 0.2
    synthetic_occlusion_prob: float = 0.0


@dataclasses.dataclass
class TrainConfigFull:
    lr: float = 3e-4
    lr_milestones: Tuple[int, ...] = ()  # MultiStepLR boundaries in STEPS
    lr_decay: float = 0.1                # --adjust_lr_factor default
    weight_decay: float = 1e-6
    grad_clip: float = 3.0
    batch_size: int = 64
    epochs: int = 120
    warmup_steps: int = 0                # linear warmup; 0 = off
    compute_dtype: str = "bfloat16"
    act_dtype: str = "float32"           # bfloat16 = low-memory fast path
    remat: str = "stage"                 # stage | net | none
    seed: int = 0
    test_interval: int = 2000            # val cadence (romp/train.py:115)
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 5
    log_every: int = 50
    tensorboard: bool = True             # event files under ckpt_dir/tb
    fine_tune: bool = False
    resume: Optional[str] = None
    num_workers: int = 0                 # batch-assembly worker threads
    prefetch_batches: int = 4            # bounded host-side batch queue


@dataclasses.dataclass
class TraceSectionConfig:
    """TRACE video-training knobs (`trace/configs/trace.yml` ARGS)."""

    clip_length: int = 8                 # temp_clip_length (ref: 10)
    max_tracks: int = 8                  # max supervised subjects per clip
    dynamic_aug_prob: float = 0.8        # dynamic_augment_ratio
    tracking_aug_prob: float = 0.6       # dynamic_aug_tracking_ratio
    changing_ratio: float = 0.2          # dynamic_changing_ratio
    use_optical_flow: bool = False       # RAFT flow during training
    raft_model_path: Optional[str] = None
    backbone_ckpt: Optional[str] = None  # frozen image-backbone weights
    # loss weights (TraceTrainConfig fields; ref trace.yml loss_weight)
    centermap3d_weight: float = 1.0
    motion_weight: float = 40.0
    pose_weight: float = 80.0
    shape_weight: float = 6.0
    world_trans_weight: float = 50.0
    world_grot_weight: float = 40.0
    temp_shape_weight: float = 10.0


@dataclasses.dataclass
class MeshConfig:
    """Data parallelism (`parallel/mesh.py`), the JAX package's fields. One
    process drives one device; `train.batch_size` is the global batch.
    n_devices: N > 1 trains in N processes of one host, started by the
    launcher, rank r on cuda:r (on the CPU for --GPU -1); None or 1, one
    process. multihost: this process is rank `process_id` of
    `num_processes`, meeting at `coordinator` ("host:port", rank 0 listens;
    or "file:///path", a FileStore) on cuda:(process_id mod the host's
    cards). data_axis: the JAX mesh's axis name, kept for the config
    files."""
    n_devices: Optional[int] = None
    data_axis: str = "data"
    multihost: bool = False
    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfigFull = dataclasses.field(
        default_factory=TrainConfigFull)
    trace: TraceSectionConfig = dataclasses.field(
        default_factory=TraceSectionConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    tab: str = "romp_tpu"
    smpl_assets: Optional[str] = None


# Flat ARGS-key -> dotted path mapping for reference-yaml compatibility
# (`romp/lib/config.py` flag names).
_REF_KEY_MAP = {
    "lr": "train.lr",
    "adjust_lr_factor": "train.lr_decay",
    "batch_size": "train.batch_size",
    "epoch": "train.epochs",
    "fine_tune": "train.fine_tune",
    "input_size": "model.input_size",
    "centermap_size": "model.centermap_size",
    "centermap_conf_thresh": "model.centermap_conf_thresh",
    "backbone": "model.backbone",
    "max_person": "model.max_person",
    "tab": "tab",
    "model_version": "model.version",
    # TRACE video-training flags (`trace/configs/trace.yml` ARGS names)
    "temp_clip_length": "trace.clip_length",
    "dynamic_augment_ratio": "trace.dynamic_aug_prob",
    "dynamic_aug_tracking_ratio": "trace.tracking_aug_prob",
    "dynamic_changing_ratio": "trace.changing_ratio",
    "use_optical_flow": "trace.use_optical_flow",
    "max_supervise_num": "trace.max_tracks",
}

# reference trace.yml loss_weight names -> trace.<name>_weight fields
_TRACE_LOSS_MAP = {
    "CenterMap_3D": "centermap3d",
    "motion_offsets3D": "motion",
    "Pose": "pose",
    "Shape": "shape",
    "world_trans": "world_trans",
    "world_grots": "world_grot",
    "temp_shape_consist": "temp_shape",
}


def _set_dotted(cfg: Config, dotted: str, value) -> bool:
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            return False
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        return False
    cur = getattr(obj, leaf)
    if cur is None and isinstance(value, str):
        # Optional[...] fields give no type to coerce to; YAML-parse the
        # override so "2" -> 2, "true" -> True, paths stay strings
        import yaml

        try:
            value = yaml.safe_load(value)
        except Exception:
            pass
        setattr(obj, leaf, value)
        return True
    if isinstance(cur, bool):
        value = value in (True, "True", "true", "1", 1)
    elif isinstance(cur, int) and not isinstance(value, bool):
        value = int(float(value))
    elif isinstance(cur, float):
        value = float(value)
    elif isinstance(cur, tuple) and isinstance(value, (list, tuple)):
        value = tuple(value)
    elif isinstance(cur, tuple) and isinstance(value, str):
        # CLI override form: data.datasets=h36m,coco / train.lr_milestones=1,2
        items = tuple(v.strip() for v in value.split(",") if v.strip())
        elem = cur[0] if cur else None
        if isinstance(elem, bool):
            items = tuple(v in ("True", "true", "1") for v in items)
        elif isinstance(elem, int):
            items = tuple(int(float(v)) for v in items)
        elif isinstance(elem, float):
            items = tuple(float(v) for v in items)
        elif elem is None:
            # empty default (e.g. lr_milestones=()): numbers if they parse
            try:
                items = tuple(int(float(v)) if float(v) == int(float(v))
                              else float(v) for v in items)
            except ValueError:
                pass
        value = items
    setattr(obj, leaf, value)
    return True


def load_config(yaml_path: Optional[str] = None,
                overrides: Sequence[str] = ()) -> Config:
    cfg = Config()
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            doc = yaml.safe_load(f) or {}
        # reference-style sections
        for key, val in (doc.get("ARGS") or {}).items():
            dotted = _REF_KEY_MAP.get(key, key)
            if not _set_dotted(cfg, dotted, val):
                _set_dotted(cfg, f"train.{key}", val) or \
                    _set_dotted(cfg, f"model.{key}", val)
        for name, w in (doc.get("loss_weight") or {}).items():
            _set_dotted(cfg, f"loss.{name}_weight", w) or _set_dotted(
                cfg, f"trace.{_TRACE_LOSS_MAP.get(name, name)}_weight", w)
        sp = doc.get("sample_prob") or {}
        if sp:
            cfg.data.datasets = tuple(sp.keys())
            cfg.data.sample_probs = tuple(float(v) for v in sp.values())
        # native nested sections
        for section in ("model", "loss", "data", "train", "trace", "mesh"):
            for key, val in (doc.get(section) or {}).items():
                _set_dotted(cfg, f"{section}.{key}", val)
    for ov in overrides:
        dotted, _, val = ov.partition("=")
        if not _set_dotted(cfg, dotted, val):
            raise KeyError(f"unknown config key {dotted!r}")
    return cfg


def dump_config(cfg: Config, path: str) -> None:
    import yaml

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
