"""SMPL body model forward (counterpart of `romp_tpu/smpl/body_model.py`).

Shape blend shapes -> joint regression -> Rodrigues + pose blend shapes ->
the 24-joint kinematic chain -> linear blend skinning (the skinning kernel,
`romp_tpu_torch/ops/lbs.py`) -> the 71-row joint set. V-sized
intermediates keep V as the trailing dim, the layout the skinning kernel
reads. `smpla_forward` is SMPL+A (adult + infant), which TRACE runs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

# re-exported so that a user of the port imports it from here
from romp_tpu_torch.smpl.assets import (  # noqa: F401
    SmplAssets, synthetic_assets,
)
from romp_tpu_torch.ops.lbs import skinning
from romp_tpu_torch.ops.rotations import axis_angle_to_matrix


class SmplModel(nn.Module):
    """The SmplAssets tensors as buffers on one device, plus the static
    kinematic tree."""

    def __init__(self, assets: SmplAssets, device="cpu"):
        super().__init__()
        V = assets.v_template.shape[0]

        def buf(name, arr, dt=torch.float32):
            self.register_buffer(
                name, torch.as_tensor(np.asarray(arr), dtype=dt,
                                      device=device).contiguous())

        buf("v_template", assets.v_template)                      # (V, 3)
        buf("shapedirs", assets.shapedirs.reshape(V * 3, -1))    # (V*3, NB)
        buf("posedirs", assets.posedirs)                         # (207, V*3)
        buf("J_regressor", assets.J_regressor)                   # (J, V)
        buf("lbs_weights", assets.lbs_weights)                   # (V, J)
        buf("extra_joints_idxs", assets.extra_joints_idxs, torch.long)
        buf("J_regressor_extra9", assets.J_regressor_extra9)     # (9, V)
        buf("J_regressor_h36m17", assets.J_regressor_h36m17)     # (17, V)
        buf("faces", assets.faces, torch.int32)                  # (F, 3)
        self.parents = tuple(int(p) for p in np.asarray(assets.parents))
        # the non-root joints' parents as an index on the model's device:
        # indexing a CUDA tensor with a Python list uploads the list, a host
        # sync on every call
        self.register_buffer("parent_index", torch.tensor(
            self.parents[1:], dtype=torch.long, device=device),
            persistent=False)

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]


def _rigid_chain(rot_mats: torch.Tensor, joints: torch.Tensor,
                 parents: Tuple[int, ...], parent_index: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose per-joint local transforms along the kinematic tree
    (24 unrolled 4x4 products, `body_model.py:84-110`).

    rot_mats: (B, J, 3, 3); joints: (B, J, 3) rest-pose joints; parents and
    parent_index (parents[1:] on the device) the tree. Returns the posed
    joints (B, J, 3) and rest-pose-compensated transforms A (B, J, 4, 4).
    """
    B, J = joints.shape[:2]
    rel = joints.clone()
    rel[:, 1:] -= joints[:, parent_index]
    T = torch.zeros((B, J, 4, 4), dtype=rot_mats.dtype, device=rot_mats.device)
    T[:, :, :3, :3] = rot_mats
    T[:, :, :3, 3] = rel
    T[:, :, 3, 3] = 1.0

    chain = [T[:, 0]]
    for j in range(1, J):
        chain.append(chain[parents[j]] @ T[:, j])
    world = torch.stack(chain, dim=1)                        # (B, J, 4, 4)

    posed_joints = world[:, :, :3, 3]
    corr = torch.einsum("bjmn,bjn->bjm", world[:, :, :3, :3], joints)
    A = world.clone()
    A[:, :, :3, 3] -= corr
    return posed_joints, A


def smpl_forward(model: SmplModel, betas: torch.Tensor, pose: torch.Tensor,
                 root_align: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, NB) betas + (B, 72) axis-angle pose -> verts (B, 6890, 3) and
    joints (B, 71, 3): 24 SMPL + 21 vertex-picked + 9 extra + 17 H36M.

    root_align subtracts the mean of rows 45, 46 (`body_model.py:167-170`).
    """
    B = betas.shape[0]
    V = model.v_template.shape[0]
    J = model.num_joints

    v_shaped_flat = model.v_template.reshape(-1) + betas @ model.shapedirs.T
    vsT = v_shaped_flat.reshape(B, V, 3).transpose(1, 2)          # (B, 3, V)
    joints_rest = torch.einsum("bcv,jv->bjc", vsT, model.J_regressor)

    rot_mats = axis_angle_to_matrix(pose.reshape(B, J, 3))
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, (J - 1) * 9)
    v_posed_T = (v_shaped_flat + pose_feature @ model.posedirs
                 ).reshape(B, V, 3).transpose(1, 2).contiguous()  # (B, 3, V)

    posed_joints, A = _rigid_chain(rot_mats, joints_rest, model.parents,
                                   model.parent_index)

    A16 = A.reshape(B, J, 16).transpose(1, 2).contiguous()        # (B, 16, J)
    verts_T = skinning(A16, model.lbs_weights, v_posed_T)         # (B, 3, V)

    extra21 = verts_T[:, :, model.extra_joints_idxs].transpose(1, 2)
    extra9 = torch.einsum("bcv,jv->bjc", verts_T, model.J_regressor_extra9)
    h36m17 = torch.einsum("bcv,jv->bjc", verts_T, model.J_regressor_h36m17)
    joints = torch.cat([posed_joints, extra21, extra9, h36m17], dim=1)
    verts = verts_T.transpose(1, 2)                               # (B, V, 3)

    if root_align:
        root = joints[:, 45:47].mean(dim=1, keepdim=True)
        joints = joints - root
        verts = verts - root
    return verts, joints


def smpla_forward(adult: SmplModel, baby: SmplModel, betas: torch.Tensor,
                  pose: torch.Tensor, root_align: bool = True,
                  baby_thresh: float = 0.8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SMPL+A (`body_model.py:174-187`): both the adult (11-beta SMPL-A) and
    the infant (SMIL, 10 betas) model run on every person, and each person
    takes the infant's output where `betas[:, 10] > baby_thresh`. Two
    skinning launches."""
    v_a, j_a = smpl_forward(adult, betas, pose, root_align=root_align)
    v_b, j_b = smpl_forward(baby, betas[:, :10], pose, root_align=root_align)
    is_baby = (betas[:, 10] > baby_thresh)[:, None, None]
    return torch.where(is_baby, v_b, v_a), torch.where(is_baby, j_b, j_a)
