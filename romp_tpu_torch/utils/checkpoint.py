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
