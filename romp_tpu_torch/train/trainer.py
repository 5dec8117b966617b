"""Training loop: the steps, validation-gated checkpoints (counterpart
of `romp_tpu/train/trainer.py`).

Reference behaviour kept (`romp/train.py:7-150`, `romp/base.py:29-193`):
non-finite steps are skipped and counted (the step rejects them on the
device; the host logs them a step later), validation every
`test_interval` steps keeps the best checkpoint, rotating step snapshots,
a moving-average loss log (`train_log.jsonl`) and TensorBoard curves,
resume and fine-tune.

One process on one device, or one rank of a data-parallel job
(`parallel/mesh.py`, the JAX package's mesh): `mesh.multihost=true` with
`mesh.coordinator`, `mesh.num_processes` and `mesh.process_id` joins this
process as that rank (the launcher starts `mesh.n_devices` such processes
on one host). Each rank takes rank 0's state, is fed the same global
batches and steps on its rows of each (`shard_batch`); the step makes the
global batch's update on every rank. Only rank 0 writes the log,
TensorBoard and checkpoints (the JAX trainer's `_is_main`).

Checkpoints are the port's own `.npz` of named arrays: `p::<name>`
parameters and `b::<name>` BatchNorm statistics (torch layouts), `mu::` /
`nu::<name>` Adam's moments, `o::<counter>` the optimizer's counters, and
`step`. `utils/checkpoint.py::train_state_from_jax` reads the JAX
package's archives.
"""
from __future__ import annotations

import itertools
import json
import os
import os.path as osp
import sys
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from romp_tpu_torch.config import Config
from romp_tpu_torch.models.romp import RompNet, init_romp_params
from romp_tpu_torch.parallel.mesh import (
    initialize_from_config, process_index, shard_batch,
)
from romp_tpu_torch.smpl.body_model import SmplModel
from romp_tpu_torch.train.priors import GmmPrior
from romp_tpu_torch.train.train_step import (
    TrainConfig, TrainState, check_train_state, init_train_state,
    replicate_train_state, train_step,
)

COUNTERS = ("notfinite_count", "last_finite", "total_notfinite", "count",
            "schedule_count")


def _unflatten(flat: torch.Tensor, tensors: Dict[str, torch.Tensor]):
    """flat -> {name: view shaped like tensors[name]}, in the dict's order."""
    out, offset = {}, 0
    for k, t in tensors.items():
        out[k] = flat[offset:offset + t.numel()].view_as(t)
        offset += t.numel()
    return out


def save_train_state(path: str, state: TrainState) -> None:
    arrays = {}
    for prefix, tensors in (("p", state.trainable), ("b", state.bn_state),
                            ("mu", _unflatten(state.opt_state.mu,
                                              state.trainable)),
                            ("nu", _unflatten(state.opt_state.nu,
                                              state.trainable))):
        for k, v in tensors.items():
            arrays[f"{prefix}::{k}"] = v.detach().cpu().numpy()
    for name in COUNTERS:
        v = getattr(state.opt_state, name)
        if v is not None:
            arrays[f"o::{name}"] = v.cpu().numpy()
    arrays["step"] = state.step.cpu().numpy()
    np.savez(path, **arrays)


@torch.no_grad()
def load_train_state(path: str, state: TrainState,
                     weights_only: bool = False) -> TrainState:
    """Fill `state` in place from a `save_train_state` archive: parameters
    and BatchNorm statistics, and unless `weights_only`, the optimizer
    state and the step. With `weights_only` (fine-tuning) the archive may
    hold another net's weights, as the reference's `copy_state_dict` takes
    them: each tensor it holds under the same name and shape is copied, the
    rest keep their values (a 2D-pose pretraining checkpoint gives the
    backbone and the center head), and what was left out is reported."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    dev = state.flat.device
    left = []
    for prefix, tensors in (("p", state.trainable), ("b", state.bn_state)):
        for k, t in tensors.items():
            a = arrays.get(f"{prefix}::{k}")
            if a is None or (weights_only and a.shape != tuple(t.shape)):
                if not weights_only:
                    raise KeyError(f"{path}: no {prefix}::{k}")
                left.append(k)
                continue
            t.copy_(torch.from_numpy(np.asarray(a)))
    if weights_only:
        if left:
            print(f"fine-tune from {path}: {len(left)} tensors not in it "
                  f"keep their init (first: {left[0]})", file=sys.stderr)
        return state
    opt = state.opt_state
    for prefix, flat in (("mu", opt.mu), ("nu", opt.nu)):
        for k, t in _unflatten(flat, state.trainable).items():
            t.copy_(torch.from_numpy(np.asarray(arrays[f"{prefix}::{k}"])))
    for name in COUNTERS:
        if getattr(opt, name) is not None:
            setattr(opt, name, torch.as_tensor(
                np.asarray(arrays[f"o::{name}"])).to(dev))
    state.step = torch.as_tensor(np.asarray(arrays["step"]),
                                 dtype=torch.int32).to(dev)
    return state


def train_config(cfg: Config) -> TrainConfig:
    """The step's TrainConfig from the config tree (as `trainer.py:80-100`)."""
    return TrainConfig(
        lr=cfg.train.lr, lr_milestones=tuple(cfg.train.lr_milestones),
        lr_decay=cfg.train.lr_decay, warmup_steps=cfg.train.warmup_steps,
        weight_decay=cfg.train.weight_decay, grad_clip=cfg.train.grad_clip,
        centermap_weight=cfg.loss.centermap_weight,
        kp2d_weight=cfg.loss.kp2d_weight, mpjpe_weight=cfg.loss.mpjpe_weight,
        pampjpe_weight=cfg.loss.pampjpe_weight,
        pose_weight=cfg.loss.pose_weight, shape_weight=cfg.loss.shape_weight,
        prior_weight=cfg.loss.prior_weight, loss_thresh=cfg.loss.loss_thresh,
        compute_dtype=cfg.train.compute_dtype, act_dtype=cfg.train.act_dtype,
        remat=cfg.train.remat, cam_scale_base=cfg.model.cam_scale_base,
        backbone=cfg.model.backbone)


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) on `device`; host arrays go
    through pinned memory, so the copies do not hold the host."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.device.type == "cpu" and torch.device(device).type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


class Trainer:
    """Bring your own batch iterator (dicts in `compute_losses`' schema,
    numpy or tensors; in a data-parallel job, the global batches, the same
    on every rank). Runs on `device` ("cuda" unless the caller passes
    "cpu"; a rank's own device in a data-parallel job)."""

    def __init__(self, cfg: Config, smpl: SmplModel,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 eval_fn: Optional[Callable[[TrainState], Dict[str, float]]]
                 = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        # the group the steps reduce over (None: one process); rank-0-only
        # logging and checkpoints (`trainer.py:151`)
        self.group = initialize_from_config(cfg.mesh, self.device)
        self._is_main = process_index() == 0
        self.smpl = smpl
        self.eval_fn = eval_fn
        self.tcfg = train_config(cfg)
        # the GMM pose prior: the packed reference asset when configured,
        # else the seeded synthetic GMM (`calc_loss.py:151-155`)
        self.prior = None
        if self.tcfg.prior_weight > 0:
            path = cfg.loss.prior_path
            self.prior = (GmmPrior.load(path) if path
                          else GmmPrior.synthetic()).to(self.device)
        if params is None:
            params = init_romp_params(
                torch.Generator().manual_seed(cfg.train.seed),
                cfg.model.backbone)
        net = RompNet(cfg.model.backbone)
        net.load_state_dict(params)
        self.state = init_train_state(net.to(self.device), self.tcfg)
        if cfg.train.resume and self._is_main:
            # fine-tune: weights and BN statistics, a fresh optimizer and
            # step (`romp/lib/utils/train_utils.py:15-66`); else all of it
            load_train_state(cfg.train.resume, self.state,
                             weights_only=cfg.train.fine_tune)
        replicate_train_state(self.state, self.group)
        self.best_val = float("inf")
        self._metric_names = None
        os.makedirs(cfg.train.checkpoint_dir, exist_ok=True)
        self._log_path = osp.join(cfg.train.checkpoint_dir, "train_log.jsonl")
        self.tb = None
        if cfg.train.tensorboard and self._is_main:
            from romp_tpu_torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(osp.join(cfg.train.checkpoint_dir, "tb"))

    def step(self, batch: Dict) -> torch.Tensor:
        """One train step on a batch; the metrics as ONE packed f32 device
        tensor in `self._metric_names` order (sorted)."""
        _, m = train_step(self.state,
                          batch_to_device(shard_batch(batch), self.device),
                          self.smpl, self.tcfg, self.prior, self.group)
        if self._metric_names is None:
            self._metric_names = tuple(sorted(m))
        return torch.stack([m[k].float() for k in self._metric_names])

    def _log(self, record: Dict) -> None:
        if not self._is_main:
            return
        with open(self._log_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.tb is not None and "step" in record:
            scalars = {k: v for k, v in record.items()
                       if isinstance(v, (int, float)) and k != "step"}
            flat_val = {f"val/{k}": v
                        for k, v in record.get("val", {}).items()
                        if isinstance(v, (int, float))}
            if scalars or flat_val:
                self.tb.add_scalars({**scalars, **flat_val},
                                    int(record["step"]))

    def _save_snapshot(self, step: int) -> None:
        """The newest `train.keep_checkpoints` step snapshots."""
        keep = self.cfg.train.keep_checkpoints
        if keep <= 0 or not self._is_main:
            return
        ckdir = self.cfg.train.checkpoint_dir
        save_train_state(osp.join(ckdir, f"step_{step:08d}.npz"), self.state)
        snaps = sorted(f for f in os.listdir(ckdir)
                       if f.startswith("step_") and f.endswith(".npz"))
        for old in snaps[:-keep]:
            os.remove(osp.join(ckdir, old))

    def log_image_grid(self, tag: str, images, step: int) -> None:
        if self.tb is not None:
            self.tb.add_image_grid(tag, np.asarray(images), step)

    def fit(self, batches: Iterator[Dict], max_steps: Optional[int] = None
            ) -> Dict[str, float]:
        """Pipelined loop (`trainer.py:185-292`): step k is enqueued before
        step k-1's packed metrics are fetched (one copy to the host a step),
        so the device does not wait for the host's logging. Non-finite
        steps were already rejected on the device; the host counts them."""
        cfg = self.cfg.train
        running: Dict[str, float] = {}
        n_skipped = 0
        t0 = time.time()
        last_metrics: Dict[str, float] = {}
        step0 = int(self.state.step)
        n_done = 0

        def consume(packed: torch.Tensor, step: int) -> None:
            nonlocal n_skipped, last_metrics
            m = dict(zip(self._metric_names, packed.cpu().tolist()))
            if (not np.isfinite(m["total"])
                    or m.get("grads_finite", 1.0) < 0.5):
                n_skipped += 1
                self._log({"step": step, "event": "nan_skip"})
                return
            last_metrics = m
            for k, v in m.items():
                running[k] = 0.9 * running.get(k, v) + 0.1 * v
            if step % cfg.log_every == 0:
                rate = n_done / (time.time() - t0)
                self._log({"step": step, "loss": running.get("total"),
                           "steps_per_sec": round(rate, 3), **running})
            if cfg.test_interval and step % cfg.test_interval == 0 \
                    and self.eval_fn is not None:
                val = self.eval_fn(self.state)
                self._log({"step": step, "val": val})
                key = val.get("pampjpe", val.get("total", 0.0))
                if key < self.best_val:
                    self.best_val = key
                    if self._is_main:
                        save_train_state(
                            osp.join(cfg.checkpoint_dir, "best.npz"),
                            self.state)

        pending = None                 # (packed metrics, step)
        # islice: a run of max_steps steps asks for no batch beyond them
        for batch in itertools.islice(batches, max_steps):
            packed = self.step(batch)
            n_done += 1
            step = step0 + n_done
            if pending is not None:
                consume(*pending)
                pending = None
            if cfg.test_interval and step % cfg.test_interval == 0:
                # eval / snapshot due: they see the state at exactly `step`
                consume(packed, step)
                self._save_snapshot(step)
            else:
                pending = (packed, step)
        if pending is not None:
            consume(*pending)
        check_train_state(self.state, self.group)
        if self._is_main:
            save_train_state(osp.join(cfg.checkpoint_dir, "last.npz"),
                             self.state)
        last_metrics["skipped"] = n_skipped
        return last_metrics
