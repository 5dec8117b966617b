"""SMPL-family extras: generic LBS for SMPL-X / FLAME / MANO (counterpart
of `romp_tpu/smpl/family.py`).

The reference's models are `trace/lib/smpl_family/smplx.py` (SMPL-X: SMPL
with expression blend shapes and regressed extra joints), `flame.py`
(FLAME head: 5 joints, shape + expression blend shapes, a barycentric
landmark embedding) and `mano.py` (an empty stub there; here a working
MANO forward with its optional PCA pose space).

One generic forward (`family_forward`) serves all three: the models differ
only in their shapes (J joints, V vertices, blend-shape count). It runs
the port's kinematic chain (`body_model._rigid_chain`) and skins with a
plain einsum, as JAX leaves it to XLA: the skinning kernel is fixed at the
SMPL's 24 joints, and these models have 55, 5 or 16. The asset side
(`FamilyAssets`, the official-file packers, the synthetic assets) is numpy
only, a copy of the JAX package's, so that the port imports nothing of it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from romp_tpu_torch.ops.rotations import axis_angle_to_matrix
from romp_tpu_torch.smpl.body_model import _rigid_chain


@dataclasses.dataclass(frozen=True)
class FamilyAssets:
    """Numpy tensors of any SMPL-family model (layout-only conversion from
    the official files; no behavior)."""

    v_template: np.ndarray        # (V, 3)
    shapedirs: np.ndarray         # (V, 3, NB) shape (+expression) dirs
    posedirs: np.ndarray          # ((J-1)*9, V*3)
    J_regressor: np.ndarray       # (J, V)
    parents: np.ndarray           # (J,) int32, parents[0] == -1
    lbs_weights: np.ndarray       # (V, J)
    faces: np.ndarray             # (F, 3) int32
    # FLAME/SMPL-X landmark embedding (optional)
    lmk_faces_idx: Optional[np.ndarray] = None   # (L,) int32
    lmk_bary_coords: Optional[np.ndarray] = None  # (L, 3)
    # MANO PCA pose space (optional): components (NC, 45), mean (45,)
    hands_components: Optional[np.ndarray] = None
    hands_mean: Optional[np.ndarray] = None

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, **{k: v for k, v in dataclasses.asdict(self).items()
                     if v is not None})

    @staticmethod
    def load(path: str) -> "FamilyAssets":
        with np.load(path) as data:
            return FamilyAssets(**{k: data[k] for k in data.files})


class FamilyModel(nn.Module):
    """A FamilyAssets' tensors as buffers on one device, plus the static
    kinematic tree (and its non-root parents as a device index, which the
    chain gathers with)."""

    def __init__(self, assets: FamilyAssets, device="cpu",
                 dtype=torch.float32):
        super().__init__()
        V = assets.v_template.shape[0]

        def buf(name, arr, dt=dtype):
            if arr is not None:
                arr = torch.as_tensor(np.asarray(arr), dtype=dt,
                                      device=device).contiguous()
            self.register_buffer(name, arr)

        buf("v_template", assets.v_template)                      # (V, 3)
        buf("shapedirs_flat", assets.shapedirs.reshape(V * 3, -1).T)
        buf("posedirs", assets.posedirs)                 # ((J-1)*9, V*3)
        buf("J_regressor", assets.J_regressor)                   # (J, V)
        buf("lbs_weights", assets.lbs_weights)                   # (V, J)
        buf("faces", assets.faces, torch.int32)                  # (F, 3)
        buf("lmk_faces_idx", assets.lmk_faces_idx, torch.int32)
        buf("lmk_bary_coords", assets.lmk_bary_coords)
        buf("hands_components", assets.hands_components)
        buf("hands_mean", assets.hands_mean)
        self.parents = tuple(int(p) for p in np.asarray(assets.parents))
        self.register_buffer("parent_index", torch.tensor(
            self.parents[1:], dtype=torch.long, device=device),
            persistent=False)

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def num_betas(self) -> int:
        return self.shapedirs_flat.shape[0]


def family_forward(model: FamilyModel, betas: torch.Tensor,
                   pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generic SMPL-family LBS.

    betas: (B, NB) shape (+expression) coefficients; pose: (B, J*3)
    axis-angle. Returns (verts (B, V, 3), joints (B, J, 3)). The same steps
    as `body_model.smpl_forward`, generic in J and V.
    """
    B = betas.shape[0]
    V = model.v_template.shape[0]
    J = model.num_joints

    v_shaped_flat = model.v_template.reshape(-1) + betas @ model.shapedirs_flat
    vsT = v_shaped_flat.reshape(B, V, 3).transpose(1, 2)
    joints_rest = torch.einsum("bcv,jv->bjc", vsT, model.J_regressor)

    rot_mats = axis_angle_to_matrix(pose.reshape(B, J, 3))
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, (J - 1) * 9)
    v_posed = (v_shaped_flat + pose_feature @ model.posedirs).reshape(B, V, 3)

    posed_joints, A = _rigid_chain(rot_mats, joints_rest, model.parents,
                                   model.parent_index)

    # skinning: each vertex's 4x4 blended from the (V, J) weights, plain
    # einsums (J is 5-55 here; the kernel takes SMPL's 24 only)
    T = torch.einsum("vj,bjmn->bvmn", model.lbs_weights, A)
    vh = torch.cat([v_posed, v_posed.new_ones((B, V, 1))], -1)
    verts = torch.einsum("bvmn,bvn->bvm", T, vh)[..., :3]
    return verts, posed_joints


def vertices_to_landmarks(verts: torch.Tensor, faces: torch.Tensor,
                          lmk_faces_idx: torch.Tensor,
                          lmk_bary_coords: torch.Tensor) -> torch.Tensor:
    """Barycentric landmark embedding (`flame.py` vertices2landmarks /
    smplx.lbs): verts (B, V, 3) -> (B, L, 3)."""
    tri = faces[lmk_faces_idx.long()].long()             # (L, 3) vertex ids
    pts = verts[:, tri]                                  # (B, L, 3verts, 3)
    return torch.einsum("blvc,lv->blc", pts, lmk_bary_coords)


def mano_pose_from_pca(model: FamilyModel, global_orient: torch.Tensor,
                       pca_coeffs: torch.Tensor) -> torch.Tensor:
    """MANO's PCA pose space -> the full (B, 16*3) axis-angle: hand pose =
    mean + coeffs @ components (the official MANO parameterization)."""
    hand = model.hands_mean + pca_coeffs @ model.hands_components[
        :pca_coeffs.shape[-1]]
    return torch.cat([global_orient, hand], dim=-1)


# ------------------------------------------------------------- packers ---

def _dense(x) -> np.ndarray:
    """scipy-sparse / chumpy tolerant densify (official model files mix
    formats)."""
    if hasattr(x, "toarray"):
        x = x.toarray()
    if hasattr(x, "r"):          # chumpy
        x = x.r
    return np.asarray(x)


def _pack_common(data: dict, num_betas: int, num_expression: int,
                 shape_space: int) -> dict:
    """Shared official-layout unpack: shapedirs hold `shape_space` shape
    columns then expression columns (SMPL-X/FLAME convention)."""
    shapedirs = _dense(data["shapedirs"]).astype(np.float32)
    cols = [shapedirs[..., :num_betas]]
    if num_expression:
        cols.append(shapedirs[..., shape_space:shape_space + num_expression])
    shapedirs = np.concatenate(cols, -1)
    V = shapedirs.shape[0]
    posedirs = _dense(data["posedirs"]).astype(np.float32)
    if posedirs.ndim == 3:       # (V, 3, P) official -> (P, V*3)
        posedirs = posedirs.reshape(V * 3, -1).T
    parents = _dense(data["kintree_table"]).astype(np.int64)[0]
    parents[0] = -1
    return {
        "v_template": _dense(data["v_template"]).astype(np.float32),
        "shapedirs": shapedirs,
        "posedirs": np.ascontiguousarray(posedirs),
        "J_regressor": _dense(data["J_regressor"]).astype(np.float32),
        "parents": parents.astype(np.int32),
        "lbs_weights": _dense(data["weights"]).astype(np.float32),
        "faces": _dense(data["f"]).astype(np.int32),
    }


def pack_official_smplx(path: str, num_betas: int = 10,
                        num_expression: int = 10) -> FamilyAssets:
    """Official SMPL-X npz/pkl -> FamilyAssets (55 joints, 10475 verts;
    shapedirs = 300 shape + 100 expression columns)."""
    data = _load_model_file(path)
    out = _pack_common(data, num_betas, num_expression, shape_space=300)
    for k_src, k_dst in (("lmk_faces_idx", "lmk_faces_idx"),
                         ("lmk_bary_coords", "lmk_bary_coords")):
        if k_src in data:
            out[k_dst] = _dense(data[k_src]).astype(
                np.int32 if "idx" in k_src else np.float32)
    return FamilyAssets(**out)


def pack_official_flame(path: str, num_betas: int = 100,
                        num_expression: int = 50) -> FamilyAssets:
    """Official FLAME pkl -> FamilyAssets (5 joints: global/neck/jaw/eyes;
    300 shape + 100 expression columns — `flame.py:36-66`)."""
    data = _load_model_file(path)
    out = _pack_common(data, num_betas, num_expression, shape_space=300)
    for k in ("lmk_faces_idx", "lmk_bary_coords"):
        src = data.get(k, data.get("static_lmk_faces_idx"
                                   if "idx" in k else
                                   "static_lmk_bary_coords"))
        if src is not None:
            out[k] = _dense(src).astype(
                np.int32 if "idx" in k else np.float32)
    return FamilyAssets(**out)


def pack_official_mano(path: str, num_betas: int = 10) -> FamilyAssets:
    """Official MANO pkl -> FamilyAssets (16 joints, 778 verts, PCA pose
    space kept for mano_pose_from_pca)."""
    data = _load_model_file(path)
    out = _pack_common(data, num_betas, 0, shape_space=10)
    if "hands_components" in data:
        out["hands_components"] = _dense(
            data["hands_components"]).astype(np.float32)
        out["hands_mean"] = _dense(data["hands_mean"]).astype(np.float32)
    return FamilyAssets(**out)


def _load_model_file(path: str) -> dict:
    """An official model file: `.npz`, else a pickle (the licensed
    releases the user downloaded; unpickling runs the file's code)."""
    if path.endswith(".npz"):
        return dict(np.load(path, allow_pickle=True))
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


# -------------------------------------------------------- synthetic ------

_FAMILY_SHAPES = {
    # name: (V, J, landmark count)
    "smplx": (10475, 55, 51),
    "flame": (5023, 5, 51),
    "mano": (778, 16, 0),
}


def synthetic_family_assets(kind: str, seed: int = 0, num_betas: int = 10,
                            scale: float = 1.0) -> FamilyAssets:
    """Structured random assets with the real model's shapes (the official
    files are licence-gated; the LBS math is shape-generic). The same
    arrays as the JAX package's for the same arguments."""
    V, J, L = _FAMILY_SHAPES[kind]
    rng = np.random.RandomState(seed)
    parents = np.full(J, -1, np.int32)
    for j in range(1, J):
        parents[j] = rng.randint(0, j)
    J_regressor = np.zeros((J, V), np.float32)
    for j in range(J):
        idx = rng.choice(V, size=8, replace=False)
        w = rng.rand(8).astype(np.float32)
        J_regressor[j, idx] = w / w.sum()
    lbs_weights = np.zeros((V, J), np.float32)
    for v in range(V):
        idx = rng.choice(J, size=min(4, J), replace=False)
        w = rng.rand(len(idx)).astype(np.float32)
        lbs_weights[v, idx] = w / w.sum()
    faces = rng.randint(0, V, size=(2 * V, 3)).astype(np.int32)
    extra = {}
    if L:
        extra["lmk_faces_idx"] = rng.randint(
            0, len(faces), size=L).astype(np.int32)
        bary = rng.rand(L, 3).astype(np.float32)
        extra["lmk_bary_coords"] = bary / bary.sum(-1, keepdims=True)
    if kind == "mano":
        extra["hands_components"] = (rng.randn(45, 45) * 0.1
                                     ).astype(np.float32)
        extra["hands_mean"] = (rng.randn(45) * 0.05).astype(np.float32)
    return FamilyAssets(
        v_template=(rng.randn(V, 3) * 0.1 * scale).astype(np.float32),
        shapedirs=(rng.randn(V, 3, num_betas) * 0.01).astype(np.float32),
        posedirs=(rng.randn((J - 1) * 9, V * 3) * 0.001).astype(np.float32),
        J_regressor=J_regressor, parents=parents, lbs_weights=lbs_weights,
        faces=faces, **extra)
