"""Skeleton format definitions + cross-format joint mapping.

The port's copy of the JAX package's numpy-only
`romp_tpu/train/data/skeletons.py`, so that the port imports nothing of that
package.

These are the standard public joint orderings of each dataset family
(`romp/lib/constants.py:20-160`); the canonical internal format is
SMPL_ALL_54 (24 SMPL + 30 extra). `joint_mapping(src, dst)` builds an index
map with -1 for missing joints; mapped arrays fill missing joints with the
invalid marker -2.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

SMPL_24 = {
    'Pelvis_SMPL': 0, 'L_Hip_SMPL': 1, 'R_Hip_SMPL': 2, 'Spine_SMPL': 3,
    'L_Knee': 4, 'R_Knee': 5, 'Thorax_SMPL': 6, 'L_Ankle': 7, 'R_Ankle': 8,
    'Thorax_up_SMPL': 9, 'L_Toe_SMPL': 10, 'R_Toe_SMPL': 11, 'Neck': 12,
    'L_Collar': 13, 'R_Collar': 14, 'Jaw': 15, 'L_Shoulder': 16,
    'R_Shoulder': 17, 'L_Elbow': 18, 'R_Elbow': 19, 'L_Wrist': 20,
    'R_Wrist': 21, 'L_Hand': 22, 'R_Hand': 23,
}

SMPL_EXTRA_30 = {
    'Nose': 24, 'R_Eye': 25, 'L_Eye': 26, 'R_Ear': 27, 'L_Ear': 28,
    'L_BigToe': 29, 'L_SmallToe': 30, 'L_Heel': 31, 'R_BigToe': 32,
    'R_SmallToe': 33, 'R_Heel': 34, 'L_Hand_thumb': 35, 'L_Hand_index': 36,
    'L_Hand_middle': 37, 'L_Hand_ring': 38, 'L_Hand_pinky': 39,
    'R_Hand_thumb': 40, 'R_Hand_index': 41, 'R_Hand_middle': 42,
    'R_Hand_ring': 43, 'R_Hand_pinky': 44, 'R_Hip': 45, 'L_Hip': 46,
    'Neck_LSP': 47, 'Head_top': 48, 'Pelvis': 49, 'Thorax_MPII': 50,
    'Spine_H36M': 51, 'Jaw_H36M': 52, 'Head': 53,
}

SMPL_ALL_54 = {**SMPL_24, **SMPL_EXTRA_30}

COCO_17 = {
    'Nose': 0, 'L_Eye': 1, 'R_Eye': 2, 'L_Ear': 3, 'R_Ear': 4,
    'L_Shoulder': 5, 'R_Shoulder': 6, 'L_Elbow': 7, 'R_Elbow': 8,
    'L_Wrist': 9, 'R_Wrist': 10, 'L_Hip': 11, 'R_Hip': 12, 'L_Knee': 13,
    'R_Knee': 14, 'L_Ankle': 15, 'R_Ankle': 16,
}

LSP_14 = {
    'R_Ankle': 0, 'R_Knee': 1, 'R_Hip': 2, 'L_Hip': 3, 'L_Knee': 4,
    'L_Ankle': 5, 'R_Wrist': 6, 'R_Elbow': 7, 'R_Shoulder': 8,
    'L_Shoulder': 9, 'L_Elbow': 10, 'L_Wrist': 11, 'Neck_LSP': 12,
    'Head_top': 13,
}

MPII_16 = {
    'R_Ankle': 0, 'R_Knee': 1, 'R_Hip': 2, 'L_Hip': 3, 'L_Knee': 4,
    'L_Ankle': 5, 'Pelvis': 6, 'Thorax_MPII': 7, 'Neck': 8, 'Head_top': 9,
    'R_Wrist': 10, 'R_Elbow': 11, 'R_Shoulder': 12, 'L_Shoulder': 13,
    'L_Elbow': 14, 'L_Wrist': 15,
}

H36M_17 = {
    'Pelvis': 0, 'R_Hip': 1, 'R_Knee': 2, 'R_Ankle': 3, 'L_Hip': 4,
    'L_Knee': 5, 'L_Ankle': 6, 'Spine_H36M': 7, 'Neck': 8, 'Jaw_H36M': 9,
    'Head': 10, 'L_Shoulder': 11, 'L_Elbow': 12, 'L_Wrist': 13,
    'R_Shoulder': 14, 'R_Elbow': 15, 'R_Wrist': 16,
}

MuPoTS_17 = {
    'Head_top': 0, 'Neck': 1, 'R_Shoulder': 2, 'R_Elbow': 3, 'R_Wrist': 4,
    'L_Shoulder': 5, 'L_Elbow': 6, 'L_Wrist': 7, 'R_Hip': 8, 'R_Knee': 9,
    'R_Ankle': 10, 'L_Hip': 11, 'L_Knee': 12, 'L_Ankle': 13, 'Pelvis': 14,
    'Thorax_MPII': 15, 'Head': 16,
}

COCO_18 = {
    'Nose': 0, 'Neck': 1, 'R_Shoulder': 2, 'R_Elbow': 3, 'R_Wrist': 4,
    'L_Shoulder': 5, 'L_Elbow': 6, 'L_Wrist': 7, 'R_Hip': 8, 'R_Knee': 9,
    'R_Ankle': 10, 'L_Hip': 11, 'L_Knee': 12, 'L_Ankle': 13, 'R_Eye': 14,
    'L_Eye': 15, 'R_Ear': 16, 'L_Ear': 17,
}

OpenPose_25 = {
    'Nose': 0, 'Neck': 1, 'R_Shoulder': 2, 'R_Elbow': 3, 'R_Wrist': 4,
    'L_Shoulder': 5, 'L_Elbow': 6, 'L_Wrist': 7, 'Pelvis': 8, 'R_Hip': 9,
    'R_Knee': 10, 'R_Ankle': 11, 'L_Hip': 12, 'L_Knee': 13, 'L_Ankle': 14,
    'R_Eye': 15, 'L_Eye': 16, 'R_Ear': 17, 'L_Ear': 18, 'L_BigToe': 19,
    'L_SmallToe': 20, 'L_Heel': 21, 'R_BigToe': 22, 'R_SmallToe': 23,
    'R_Heel': 24,
}

# MuCo-3DHP 21-joint order (`romp/lib/constants.py:111`).
MuCo_21 = {
    'Head_top': 0, 'R_Shoulder': 2, 'R_Elbow': 3, 'R_Wrist': 4,
    'L_Shoulder': 5, 'L_Elbow': 6, 'L_Wrist': 7, 'R_Hip': 8, 'R_Knee': 9,
    'R_Ankle': 10, 'L_Hip': 11, 'L_Knee': 12, 'L_Ankle': 13, 'Pelvis': 14,
    'Head': 16, 'R_Hand': 17, 'L_Hand': 18, 'R_BigToe': 19, 'L_BigToe': 20,
}

# MPI-INF-3DHP 28-joint mocap order (`romp/lib/constants.py:170`);
# named spine/collar joints have no SMPL54 counterpart and are dropped.
MPI_INF_28 = {
    'Pelvis': 4, 'Neck': 5, 'Head': 6, 'Head_top': 7, 'L_Shoulder': 9,
    'L_Elbow': 10, 'L_Wrist': 11, 'L_Hand': 12, 'R_Shoulder': 14,
    'R_Elbow': 15, 'R_Wrist': 16, 'R_Hand': 17, 'L_Hip': 18, 'L_Knee': 19,
    'L_Ankle': 20, 'L_SmallToe': 21, 'L_BigToe': 22, 'R_Hip': 23,
    'R_Knee': 24, 'R_Ankle': 25, 'R_SmallToe': 26, 'R_BigToe': 27,
}

# MPI-INF-3DHP official 17-joint test order (`constants.py` MPI_INF_TEST_17).
MPI_INF_TEST_17 = {
    'Neck_LSP': 1, 'R_Shoulder': 2, 'R_Elbow': 3, 'R_Wrist': 4,
    'L_Shoulder': 5, 'L_Elbow': 6, 'L_Wrist': 7, 'R_Hip': 8, 'R_Knee': 9,
    'R_Ankle': 10, 'L_Hip': 11, 'L_Knee': 12, 'L_Ankle': 13, 'Pelvis': 14,
}

# CMU Panoptic 19-joint order (`constants.py` Panoptic_19).
Panoptic_19 = {
    'Neck': 0, 'Nose': 1, 'Pelvis': 2, 'L_Shoulder': 3, 'L_Elbow': 4,
    'L_Wrist': 5, 'L_Hip': 6, 'L_Knee': 7, 'L_Ankle': 8, 'R_Shoulder': 9,
    'R_Elbow': 10, 'R_Wrist': 11, 'R_Hip': 12, 'R_Knee': 13, 'R_Ankle': 14,
    'L_Eye': 15, 'L_Ear': 16, 'R_Eye': 17, 'R_Ear': 18,
}

# PoseTrack(17/18/21) keypoint order (`constants.py` Posetrack_17; slots
# 2-4 are unused placeholder joints in the official format).
Posetrack_17 = {
    'Nose': 0, 'Neck': 1, 'L_Shoulder': 5, 'R_Shoulder': 6, 'L_Elbow': 7,
    'R_Elbow': 8, 'L_Wrist': 9, 'R_Wrist': 10, 'L_Hip': 11, 'R_Hip': 12,
    'L_Knee': 13, 'R_Knee': 14, 'L_Ankle': 15, 'R_Ankle': 16,
}

Crowdpose_14 = {
    'L_Shoulder': 0, 'R_Shoulder': 1, 'L_Elbow': 2, 'R_Elbow': 3,
    'L_Wrist': 4, 'R_Wrist': 5, 'L_Hip': 6, 'R_Hip': 7, 'L_Knee': 8,
    'R_Knee': 9, 'L_Ankle': 10, 'R_Ankle': 11, 'Head_top': 12,
    'Neck_LSP': 13,
}

# AI Challenger raw 14-joint order -> LSP_14 reindexing
# (`romp/lib/dataset/AICH.py:46` _ai_ch_to_lsp kp_map).
AICH_TO_LSP = np.array([8, 7, 6, 9, 10, 11, 2, 1, 0, 3, 4, 5, 13, 12])

FORMATS: Dict[str, Dict[str, int]] = {
    "smpl54": SMPL_ALL_54, "coco17": COCO_17, "coco18": COCO_18,
    "openpose25": OpenPose_25, "lsp14": LSP_14, "mpii16": MPII_16,
    "h36m17": H36M_17, "mupots17": MuPoTS_17, "smpl24": SMPL_24,
    "muco21": MuCo_21, "mpiinf28": MPI_INF_28,
    "mpiinf_test17": MPI_INF_TEST_17, "panoptic19": Panoptic_19,
    "posetrack17": Posetrack_17, "crowdpose14": Crowdpose_14,
}

INVALID = -2.0


def joint_mapping(src: Dict[str, int], dst: Dict[str, int]) -> np.ndarray:
    """Index map of length len(dst); -1 where dst joint missing in src."""
    mapping = np.full(len(dst), -1, np.int32)
    for name, di in dst.items():
        if name in src:
            mapping[di] = src[name]
    return mapping


def map_joints(kps: np.ndarray, mapping: np.ndarray) -> np.ndarray:
    """(N, J_src, D) -> (N, len(mapping), D), missing joints = INVALID."""
    out = np.full((*kps.shape[:-2], len(mapping), kps.shape[-1]), INVALID,
                  kps.dtype)
    valid = mapping >= 0
    out[..., valid, :] = kps[..., mapping[valid], :]
    return out


def _smpl54_flip_pairs() -> np.ndarray:
    """Left/right swap permutation of the 54-joint set, derived by name."""
    perm = np.arange(54)
    for name, idx in SMPL_ALL_54.items():
        if name.startswith("L_"):
            other = "R_" + name[2:]
            perm[idx] = SMPL_ALL_54[other]
            perm[SMPL_ALL_54[other]] = idx
    return perm


SMPL54_FLIP = _smpl54_flip_pairs()

# SMPL 24-joint left/right swap (for pose-parameter flipping).
SMPL24_FLIP = np.array(
    [0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16, 19, 18,
     21, 20, 23, 22], np.int32)


def flip_pose_params(pose: np.ndarray) -> np.ndarray:
    """Mirror SMPL axis-angle params (..., 72 or 66): swap left/right joints
    and negate the y/z components."""
    J = pose.shape[-1] // 3
    p = pose.reshape(*pose.shape[:-1], J, 3)[..., SMPL24_FLIP[:J], :].copy()
    p[..., 1] *= -1
    p[..., 2] *= -1
    return p.reshape(pose.shape)
