"""Shared CLI plumbing of the port: flags, device, checkpoint and asset
resolution (the port's copy of `romp_tpu/cli/common.py`, without jax).

Flag surface matches `simple_romp/romp/main.py:17-62` / `bev/main.py:27-90`
(same names/defaults) with one conscious fix: the reference's --calc_smpl /
--render_mesh / --crowd use `action='store_false'` so passing the flag
DISABLES the feature (SURVEY.md §8); here flags use explicit
BooleanOptionalAction semantics (--calc_smpl / --no-calc_smpl) with the same
defaults, so reference-style invocations that omit the flags behave
identically.
"""
from __future__ import annotations

import argparse
import os.path as osp
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

DEFAULT_HOME = osp.join(osp.expanduser("~"), ".romp")


def add_common_flags(parser: argparse.ArgumentParser, tool: str):
    parser.add_argument("-m", "--mode", type=str, default="image",
                        help="image | video | webcam")
    parser.add_argument("-i", "--input", type=str, default=None)
    parser.add_argument("-o", "--save_path", type=str,
                        default=osp.join(osp.expanduser("~"),
                                         f"{tool.upper()}_results"))
    parser.add_argument("--GPU", type=int, default=0,
                        help="CUDA device index; -1 runs on the CPU")
    parser.add_argument("-t", "--temporal_optimize", action="store_true")
    parser.add_argument("--show_largest", action="store_true")
    parser.add_argument("-sc", "--smooth_coeff", type=float, default=3.0)
    parser.add_argument("--calc_smpl", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--render_mesh",
                        action=argparse.BooleanOptionalAction, default=False)
    parser.add_argument("--renderer", type=str, default="sim3dr")
    parser.add_argument("--show", action="store_true")
    parser.add_argument("--save_video", action="store_true")
    parser.add_argument("--frame_rate", type=int, default=24)
    parser.add_argument("--webcam_id", type=int, default=0)
    parser.add_argument("--max_person", type=int, default=64,
                        help="fixed per-image person capacity")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--transfer_dtype", type=str, default="float16",
                        choices=["float32", "float16"],
                        help="dtype per-vertex outputs are fetched in; "
                             "float16 halves the device->host transfer "
                             "(sub-mm quantization)")
    # live result streaming (reference: webcam_blender.sh ->
    # romp/lib/visualization/socket_utils.py Results_sender): any client
    # (e.g. the Blender addon, `python -m romp_tpu_torch.vis.socket_server`)
    # receives per-frame SMPL params over TCP.
    parser.add_argument("--fetch_person", type=int, default=0,
                        help="fetch only the top-N most-confident person "
                             "slots from the device (0 = all max_person "
                             "slots). The batch-1 result download scales "
                             "with the slot count")
    parser.add_argument("--socket_stream", action="store_true",
                        help="broadcast per-frame SMPL results over TCP "
                             "(Blender live-mocap / remote vis clients)")
    parser.add_argument("--socket_port", type=int, default=9999)


def device_from_flag(gpu: int) -> torch.device:
    """`--GPU` as the reference reads it: N -> cuda:N, -1 -> cpu. Never
    falls back to the CPU when the card is missing."""
    if gpu < 0:
        return torch.device("cpu")
    if not torch.cuda.is_available() or gpu >= torch.cuda.device_count():
        raise RuntimeError(
            f"--GPU {gpu} asks for cuda:{gpu}, which this machine does not "
            "have; pass --GPU -1 to run on the CPU")
    return torch.device("cuda", gpu)


def load_checkpoint_flexible(path: str, init_fn: Callable[
        [torch.Generator], Dict[str, torch.Tensor]],
        ) -> Dict[str, torch.Tensor]:
    """A released `.pkl`/`.pth` (torch layout), or the JAX package's `.npz`
    flat dict (bridged). Falls back to `init_fn(generator seeded 0)` with a
    loud warning when the file is missing (lets the pipeline run end to end
    without released weights)."""
    from romp_tpu_torch.utils.checkpoint import (
        load_params_npz, load_torch_checkpoint,
    )

    if path and osp.exists(path):
        if path.endswith(".npz"):
            return load_params_npz(path)
        return load_torch_checkpoint(path)
    print(f"WARNING: checkpoint {path!r} not found — using random init. "
          "A released checkpoint loads as it is.", file=sys.stderr)
    return init_fn(torch.Generator().manual_seed(0))


def load_smpl_assets_flexible(path: Optional[str], num_betas: int = 10,
                              seed: int = 0):
    """SmplAssets from our .npz, a reference packed .pth (via torch), an
    official SMPL .pkl, or synthetic fallback."""
    from romp_tpu_torch.smpl.assets import (
        SmplAssets, pack_official_smpl, synthetic_assets,
    )

    if path and osp.exists(path):
        if path.endswith(".npz"):
            return SmplAssets.load(path)
        if path.endswith(".pkl"):
            return pack_official_smpl(path)
        # reference packed torch dict
        d = torch.load(path, map_location="cpu", weights_only=False)
        np_d = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
                for k, v in d.items()}
        key = ("smpla_shapedirs" if num_betas == 11 and
               "smpla_shapedirs" in np_d else "shapedirs")
        parents = np_d["kintree_table"].astype(np.int32)
        if parents.ndim == 2:
            parents = parents[0]
        parents = parents.copy()
        parents[0] = -1
        V = np_d["v_template"].shape[0]
        posedirs = np_d["posedirs"]
        if posedirs.shape[0] != 207:
            posedirs = posedirs.reshape(V * 3, -1).T
        return SmplAssets(
            v_template=np_d["v_template"].astype(np.float32),
            shapedirs=np_d[key].astype(np.float32)[:, :, :num_betas],
            posedirs=posedirs.astype(np.float32),
            J_regressor=np_d["J_regressor"].astype(np.float32),
            parents=parents,
            lbs_weights=np_d["weights"].astype(np.float32),
            faces=np_d["f"].astype(np.int32),
            extra_joints_idxs=np_d["extra_joints_index"].astype(np.int32),
            J_regressor_extra9=np_d["J_regressor_extra9"].astype(np.float32),
            J_regressor_h36m17=np_d["J_regressor_h36m17"].astype(np.float32),
        )
    print(f"WARNING: SMPL assets {path!r} not found — using synthetic "
          "placeholder geometry (outputs are NOT valid human meshes). "
          "Prepare the official model files with "
          "`romp_torch.prepare_smpl` (python -m "
          "romp_tpu_torch.tools.prepare_smpl).",
          file=sys.stderr)
    return synthetic_assets(seed=seed, num_betas=num_betas)
