"""SMPL-family model asset handling.

The reference preprocesses official SMPL/SMIL pickle releases into flat tensor
dicts stored in ~/.romp (`simple_romp/romp/pack_smpl_info.py:56`,
`simple_romp/bev/pack_smil_info.py:56`). We do the same but store a plain
`.npz` (no torch dependency); the port's `SmplModel` holds them as buffers.
A copy of the JAX package's numpy-only module, so that the port imports
nothing of that package.

Key quantities (SMPL neutral):
- V=6890 vertices, J=24 joints, F=13776 faces
- shapedirs: (V, 3, NB) with NB=10 (SMPL) or 11 (SMPL+A: last dir blends
  toward the infant template)
- posedirs packed as (207, V*3) — i.e. already reshaped+transposed, matching
  the packed layout the reference stores (`simple_romp/romp/smpl.py:55-56`)
- J_regressor: (24, V); extra regressors: (9, V) and (17, V)
- extra_joints_idxs: 21 vertex indices picked as face/feet/hand joints
- parents (kintree): (24,) with parents[0] == -1 (stored as 0xffffffff in the
  official release; normalized to -1 here)

A synthetic-asset generator is provided so unit tests can validate the whole
LBS pipeline against the torch reference without the (license-gated) official
model files.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import numpy as np

NUM_VERTS = 6890
NUM_JOINTS = 24
NUM_FACES = 13776
NUM_EXTRA21 = 21
NUM_EXTRA9 = 9
NUM_H36M17 = 17
NUM_JOINTS54 = NUM_JOINTS + NUM_EXTRA21 + NUM_EXTRA9 + NUM_H36M17  # 71 rows; first 54 used

# Standard SMPL kinematic tree (kintree_table[0] of the official release).
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 20, 21],
    dtype=np.int32,
)

# Vertex ids for the 21 extra face/feet/hand joints, in the order the
# reference selects them (`simple_romp/romp/pack_smpl_info.py` VERTEX_IDS):
# nose, reye, leye, rear, lear, LBigToe, LSmallToe, LHeel, RBigToe,
# RSmallToe, RHeel, lthumb, lindex, lmiddle, lring, lpinky, rthumb, rindex,
# rmiddle, rring, rpinky.
SMPL_EXTRA21_VERTEX_IDS = np.array(
    [332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624, 6787,
     2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905, 6016, 6133],
    dtype=np.int32,
)

DEFAULT_ASSET_DIR = os.path.expanduser("~/.romp_tpu")


@dataclasses.dataclass(frozen=True)
class SmplAssets:
    """Frozen container of SMPL model tensors (numpy; cast lazily by users)."""

    v_template: np.ndarray        # (V, 3)
    shapedirs: np.ndarray         # (V, 3, NB)
    posedirs: np.ndarray          # (207, V*3)
    J_regressor: np.ndarray       # (J, V)
    parents: np.ndarray           # (J,) int32, parents[0] == -1
    lbs_weights: np.ndarray       # (V, J)
    faces: np.ndarray             # (F, 3) int32
    extra_joints_idxs: np.ndarray  # (21,) int32
    J_regressor_extra9: np.ndarray  # (9, V)
    J_regressor_h36m17: np.ndarray  # (17, V)

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    def astype(self, dtype) -> "SmplAssets":
        cast = {
            f.name: getattr(self, f.name).astype(dtype)
            if np.issubdtype(getattr(self, f.name).dtype, np.floating)
            else getattr(self, f.name)
            for f in dataclasses.fields(self)
        }
        return SmplAssets(**cast)

    def save(self, path: str) -> None:
        np.savez_compressed(path, **dataclasses.asdict(self))

    @staticmethod
    def load(path: str) -> "SmplAssets":
        data = np.load(path)
        return SmplAssets(**{k: data[k] for k in data.files})


def pack_official_smpl(pkl_path: str, extra9_path: Optional[str] = None,
                       h36m17_path: Optional[str] = None) -> SmplAssets:
    """Pack an official SMPL pickle into SmplAssets.

    Mirrors what `romp.prepare_smpl` does (`simple_romp/romp/pack_smpl_info.py`):
    flatten shapedirs/posedirs, extract J_regressor (may be scipy sparse),
    normalize the kintree, select extra vertex joints. Extra 9/17-joint
    regressors ship as separate npz files in the reference's download bundle;
    zeros are substituted when absent (they only affect joints 45..70).
    """
    with open(pkl_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    def _dense(x):
        return np.asarray(x.todense()) if hasattr(x, "todense") else np.asarray(x)

    v_template = np.asarray(data["v_template"], dtype=np.float32)
    shapedirs = np.asarray(data["shapedirs"], dtype=np.float32)[:, :, :10]
    posedirs = np.asarray(data["posedirs"], dtype=np.float32)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T.copy()  # (207, V*3)
    J_regressor = _dense(data["J_regressor"]).astype(np.float32)
    parents = np.asarray(data["kintree_table"])[0].astype(np.int64)
    parents = parents.astype(np.int32)
    parents[0] = -1
    weights = np.asarray(data["weights"], dtype=np.float32)
    faces = np.asarray(data["f"], dtype=np.int32)

    nverts = v_template.shape[0]
    extra9 = (np.load(extra9_path) if extra9_path
              else np.zeros((NUM_EXTRA9, nverts), np.float32))
    h36m17 = (np.load(h36m17_path) if h36m17_path
              else np.zeros((NUM_H36M17, nverts), np.float32))

    return SmplAssets(
        v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
        J_regressor=J_regressor, parents=parents, lbs_weights=weights,
        faces=faces, extra_joints_idxs=SMPL_EXTRA21_VERTEX_IDS,
        J_regressor_extra9=np.asarray(extra9, np.float32),
        J_regressor_h36m17=np.asarray(h36m17, np.float32),
    )


def synthetic_assets(seed: int = 0, num_betas: int = 10,
                     num_verts: int = NUM_VERTS) -> SmplAssets:
    """Structured random SMPL-like assets for tests and benchmarks.

    Uses the real kinematic tree and realistic magnitudes so that LBS math
    (including the kinematic chain and pose blend shapes) is exercised
    identically to the real model.
    """
    rng = np.random.RandomState(seed)
    V, J = num_verts, NUM_JOINTS
    v_template = rng.randn(V, 3).astype(np.float32) * 0.3
    shapedirs = (rng.randn(V, 3, num_betas) * 0.01).astype(np.float32)
    posedirs = (rng.randn(207, V * 3) * 0.001).astype(np.float32)

    # Joint regressor: softmax-ish sparse rows summing to 1.
    J_regressor = np.zeros((J, V), np.float32)
    for j in range(J):
        idx = rng.choice(V, size=8, replace=False)
        w = rng.rand(8).astype(np.float32)
        J_regressor[j, idx] = w / w.sum()

    # Skinning weights: each vertex influenced by <=4 joints, rows sum to 1.
    lbs_weights = np.zeros((V, J), np.float32)
    for v in range(0, V, 1):
        idx = rng.choice(J, size=4, replace=False)
        w = rng.rand(4).astype(np.float32)
        lbs_weights[v, idx] = w / w.sum()

    faces = rng.randint(0, V, size=(NUM_FACES, 3)).astype(np.int32)
    extra_idx = rng.choice(V, size=NUM_EXTRA21, replace=False).astype(np.int32)

    def _reg(n):
        r = np.zeros((n, V), np.float32)
        for j in range(n):
            idx = rng.choice(V, size=6, replace=False)
            w = rng.rand(6).astype(np.float32)
            r[j, idx] = w / w.sum()
        return r

    return SmplAssets(
        v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
        J_regressor=J_regressor, parents=SMPL_PARENTS.copy(),
        lbs_weights=lbs_weights, faces=faces, extra_joints_idxs=extra_idx,
        J_regressor_extra9=_reg(NUM_EXTRA9), J_regressor_h36m17=_reg(NUM_H36M17),
    )


def to_reference_pth_dict(assets: SmplAssets):
    """Torch tensor dict in the layout `simple_romp/romp/smpl.py:41-59` loads.

    Used by parity tests to drive the reference SMPL class with the same
    numbers as ours. Imports torch lazily (test-only dependency path).
    """
    import torch

    parents = assets.parents.astype(np.int64).copy()
    parents[0] = 0  # reference indexes parents[1:] only; keep 0 valid
    return {
        "v_template": torch.from_numpy(assets.v_template),
        "shapedirs": torch.from_numpy(assets.shapedirs),
        "posedirs": torch.from_numpy(assets.posedirs),
        "J_regressor": torch.from_numpy(assets.J_regressor),
        "kintree_table": torch.from_numpy(parents),
        "weights": torch.from_numpy(assets.lbs_weights),
        "f": torch.from_numpy(assets.faces.astype(np.int64)),
        "extra_joints_index": torch.from_numpy(
            assets.extra_joints_idxs.astype(np.int64)),
        "J_regressor_extra9": torch.from_numpy(assets.J_regressor_extra9),
        "J_regressor_h36m17": torch.from_numpy(assets.J_regressor_h36m17),
    }
