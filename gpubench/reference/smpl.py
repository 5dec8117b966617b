"""SMPL and SMPL+A (Loper et al. 2015; BEV's age blend), plain.

Shape blend shapes, the 24 rest joints, Rodrigues and pose blend shapes,
the kinematic chain, linear blend skinning by einsum (the whole 4x4
transform per vertex), then the 71 joint rows: 24 SMPL, 21 picked
vertices, 9 and 17 regressed. `arrays` is a dict of tensors with the keys
`gpubench/seeded.py::smpl_arrays` makes.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from gpubench.reference.geometry import axis_angle_to_matrix


def smpl(arrays: Dict[str, torch.Tensor], parents: Sequence[int],
         betas: torch.Tensor, thetas: torch.Tensor, root_align: bool = False
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """betas (N, NB), thetas (N, 72) -> verts (N, V, 3), joints (N, 71, 3)."""
    n = betas.shape[0]
    v_shaped = arrays["v_template"] + torch.einsum(
        "vcb,nb->nvc", arrays["shapedirs"], betas)
    j_rest = torch.einsum("jv,nvc->njc", arrays["J_regressor"], v_shaped)
    j = j_rest.shape[1]
    rot = axis_angle_to_matrix(thetas.reshape(n, j, 3))
    eye = torch.eye(3, device=betas.device)
    feat = (rot[:, 1:] - eye).reshape(n, -1)
    v_posed = v_shaped + (feat @ arrays["posedirs"]).reshape(n, -1, 3)

    local = torch.zeros((n, j, 4, 4), device=betas.device)
    local[:, :, :3, :3] = rot
    local[:, 0, :3, 3] = j_rest[:, 0]
    for k in range(1, j):
        local[:, k, :3, 3] = j_rest[:, k] - j_rest[:, parents[k]]
    local[:, :, 3, 3] = 1.0
    world = [local[:, 0]]
    for k in range(1, j):
        world.append(world[parents[k]] @ local[:, k])
    world = torch.stack(world, 1)
    posed_joints = world[:, :, :3, 3]
    a = world.clone()
    a[:, :, :3, 3] -= torch.einsum("njab,njb->nja", world[:, :, :3, :3],
                                   j_rest)
    t = torch.einsum("vj,njab->nvab", arrays["lbs_weights"], a)
    verts = (torch.einsum("nvab,nvb->nva", t[:, :, :3, :3], v_posed)
             + t[:, :, :3, 3])
    joints = torch.cat([
        posed_joints, verts[:, arrays["extra_joints_idxs"]],
        torch.einsum("kv,nvc->nkc", arrays["J_regressor_extra9"], verts),
        torch.einsum("kv,nvc->nkc", arrays["J_regressor_h36m17"], verts)], 1)
    if root_align:
        root = joints[:, 45:47].mean(1, keepdim=True)
        joints, verts = joints - root, verts - root
    return verts, joints


def smpla(adult: Dict[str, torch.Tensor], baby: Dict[str, torch.Tensor],
          parents: Sequence[int], betas: torch.Tensor, thetas: torch.Tensor,
          is_baby: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SMPL+A: the adult model (11 betas) or, where `is_baby`, the infant
    model (the first 10), both root-aligned."""
    va, ja = smpl(adult, parents, betas, thetas, root_align=True)
    vb, jb = smpl(baby, parents, betas[:, :10], thetas, root_align=True)
    m = is_baby[:, None, None]
    return torch.where(m, vb, va), torch.where(m, jb, ja)
