"""Weight bridge between the JAX package's flat dict and the port's modules.

Both use the reference torch state_dict keys. The JAX package stores conv
kernels channels-last (`romp_tpu/utils/checkpoint.py:31-38`): 2D HWIO, 3D
DHWIO, 1D LIO; and it drops BatchNorm's `num_batches_tracked` (`:28`). The
port's modules use torch's OIHW / OIDHW / OIL and have that counter. 2-D
Linear and Embedding weights are stored as torch stores them.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


# conv kernel ndim -> the transpose from the JAX layout to torch's
_TO_TORCH = {3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _fill_batch_counters(state: Dict[str, torch.Tensor]) -> None:
    """Add the `num_batches_tracked` of every BatchNorm that lacks one (the
    flat dict has none; inference never reads it)."""
    for key in [k for k in state if k.endswith(".running_mean")]:
        counter = key[:-len("running_mean")] + "num_batches_tracked"
        state.setdefault(counter, torch.tensor(0, dtype=torch.long))


def state_dict_from_jax(params: Mapping[str, "np.ndarray"]
                        ) -> Dict[str, torch.Tensor]:
    """JAX flat dict -> port state dict: a `.weight` of 4 dims HWIO -> OIHW,
    of 5 dims DHWIO -> OIDHW, of 3 dims LIO -> OIL; all else passed through
    as f32, BatchNorm counters filled in."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in params.items():
        arr = np.asarray(val, dtype=np.float32)
        if key.endswith(".weight") and arr.ndim in _TO_TORCH:
            arr = arr.transpose(*_TO_TORCH[arr.ndim])
        out[key] = torch.tensor(arr)   # a contiguous, writable copy
    _fill_batch_counters(out)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A released `.pkl` / `.pth` checkpoint (already OIHW): unwrap a
    `state_dict` entry, strip DataParallel's `module.` prefix
    (`romp_tpu/utils/checkpoint.py:50-53`)."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    state = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in state.items()}
    _fill_batch_counters(state)
    return state


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    """The JAX package's native `.npz` flat dict (HWIO), bridged."""
    with np.load(path) as data:
        return state_dict_from_jax({k: data[k] for k in data.files})


def train_state_from_jax(npz, cfg, device="cpu"):
    """The JAX package's `save_train_state` archive (a path or a mapping of
    arrays; `romp_tpu/train/trainer.py:34-44`) as the port's TrainState for
    the TrainConfig `cfg`, on `device`.

    The archive holds `p::<name>` parameters and `b::<name>` BatchNorm
    statistics (JAX layouts), `step`, and optax's state leaves `o::<i>` in
    its tree order: apply_if_finite's notfinite_count, last_finite and
    total_notfinite; scale_by_adam's count, then mu and nu (each a dict,
    in sorted key order); then the learning-rate schedule's count when the
    config has a schedule."""
    from romp_tpu_torch.models.romp import RompNet
    from romp_tpu_torch.train.train_step import init_train_state

    return _train_state_from_jax(npz, RompNet(cfg.backbone), cfg, device,
                                 init_train_state)


def trace_train_state_from_jax(npz, cfg, device="cpu", map_size=128):
    """The JAX package's TRACE `trace_last.npz` (`save_train_state` of a
    TraceTrainState: the head's parameters, its BatchNorm statistics and
    the same optimizer leaves as ROMP's) as the port's TRACE train state
    for the TraceTrainConfig `cfg`, on `device`: a TraceNet head without
    its image backbone, `map_size` sizing its BV convs as in
    `init_trace_params`."""
    from romp_tpu_torch.models.trace import TraceNet
    from romp_tpu_torch.train.trace_train_step import trace_init_train_state

    return _train_state_from_jax(npz, TraceNet(None, map_size), cfg, device,
                                 trace_init_train_state)


def bev_train_state_from_jax(npz, cfg, device="cpu"):
    """The JAX package's BEV train state (`save_train_state` of a
    BevTrainState: the net's parameters, its BatchNorm statistics and the
    same optimizer leaves as ROMP's) as the port's BEV train state for the
    BevTrainConfig `cfg`, on `device`: a BevNet of `cfg.backbone` whose BV
    convs are sized for `cfg.input_size`, as `init_bev_params` sizes them."""
    from romp_tpu_torch.models.bev import BevNet
    from romp_tpu_torch.train.bev_train_step import bev_init_train_state

    return _train_state_from_jax(
        npz, BevNet(cfg.backbone, cfg.input_size // 4), cfg, device,
        bev_init_train_state)


def pretrain_state_from_jax(npz, cfg, device="cpu"):
    """The JAX package's `pretrain_last.npz` (`save_train_state` of a
    PretrainState) as the port's pretraining state for the PretrainConfig
    `cfg`, on `device`: a PretrainNet of `cfg.backbone` and
    `cfg.num_joints`."""
    from romp_tpu_torch.train.pretrain import PretrainNet, init_pretrain_state

    return _train_state_from_jax(
        npz, PretrainNet(cfg.backbone, cfg.num_joints), cfg, device,
        init_pretrain_state)


def _train_state_from_jax(npz, net, cfg, device, init_state):
    if isinstance(npz, str):
        with np.load(npz) as data:
            npz = {k: data[k] for k in data.files}
    params = {k[3:]: v for k, v in npz.items() if k.startswith(("p::", "b::"))}
    net.load_state_dict(state_dict_from_jax(params))
    state = init_state(net.to(device), cfg)
    names = state.names
    leaves = [npz[f"o::{i}"] for i in range(len(
        [k for k in npz if k.startswith("o::")]))]
    opt = state.opt_state
    has_schedule = opt.schedule_count is not None
    if len(leaves) != 4 + 2 * len(names) + has_schedule:
        raise ValueError(f"{len(leaves)} optimizer leaves for "
                         f"{len(names)} parameters (schedule: {has_schedule})")

    def scalar(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    opt.notfinite_count = scalar(leaves[0], torch.int32)
    opt.last_finite = scalar(leaves[1], torch.bool)
    opt.total_notfinite = scalar(leaves[2], torch.int32)
    opt.count = scalar(leaves[3], torch.int32)
    for flat, part in ((opt.mu, leaves[4:4 + len(names)]),
                       (opt.nu, leaves[4 + len(names):4 + 2 * len(names)])):
        moments = state_dict_from_jax(dict(zip(names, part)))
        flat.copy_(torch.cat([moments[k].reshape(-1) for k in names]))
    if has_schedule:
        opt.schedule_count = scalar(leaves[-1], torch.int32)
    state.step = scalar(npz["step"], torch.int32)
    return state
