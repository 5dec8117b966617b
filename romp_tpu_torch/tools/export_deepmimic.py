"""Export SMPL motion to the DeepMimic humanoid3d motion format (the
port's numpy copy of `romp_tpu/tools/export_deepmimic.py`).

Counterpart of `trace/lib/utils/convert2deepmimic.py` (379 LoC): per-frame
SMPL 3D joint positions -> the 44-dof humanoid3d frame layout
(duration, root pos, root/chest/neck/hip/ankle/shoulder quaternions, 1-dof
knee/elbow angles), written as the {"Loop", "Frames"} JSON DeepMimic loads.

Fresh implementation: local bone frames are built from the same joint pairs
the reference uses, but the frame-superimposition rotation comes from one
Kabsch solve (the reference routes this through
transformations.superimposition_matrix + pyquaternion; neither ships here).

Usage:
    python -m romp_tpu_torch.tools.export_deepmimic results.npz out.json --fps 10
where results.npz holds per-frame 'joints' (T, >=24, 3) (the CLI saver
format), or call `smpl_joints_to_deepmimic` directly.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

# SMPL joint indices used to build the humanoid's local frames
# (SMPL_24: 0 pelvis, 1/2 l/r hip, 4/5 l/r knee, 6 spine1, 7/8 l/r ankle,
#  9 spine3, 12 neck, 15 head, 16/17 l/r shoulder, 18/19 l/r elbow,
#  20/21 l/r wrist)
FRAME_DOF = 44


def _to_mimic_space(joints: np.ndarray) -> np.ndarray:
    """SMPL camera coords -> DeepMimic space: y-up, feet on the ground.

    Rotate -90 deg about x (SMPL -y up -> mimic z), then lift so the lowest
    joint touches z=0 (SMPLPose_to_Hmu3dSpace semantics).
    """
    rot = np.array([[1.0, 0.0, 0.0],
                    [0.0, 0.0, 1.0],
                    [0.0, -1.0, 0.0]])
    out = joints @ rot.T
    out = out - np.array([0.0, 0.0, out[..., 2].min()])
    return out


def _axis_swap(v: np.ndarray) -> np.ndarray:
    """(x, y, z) -> (x, z, -y) (the reference's tr_vect)."""
    return np.stack([v[..., 0], v[..., 2], -v[..., 1]], -1)


def _kabsch_quat(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) of the rotation superimposing the source
    axis triad onto the destination one. src/dst are row-stacked (x, y, z)
    axis vectors; the solve follows the reference's column-point convention
    (transformations.superimposition_matrix on vstacked axes)."""
    a = src / np.maximum(np.linalg.norm(src, axis=-1, keepdims=True), 1e-9)
    b = dst / np.maximum(np.linalg.norm(dst, axis=-1, keepdims=True), 1e-9)
    H = a @ b.T                  # column points: sum of outer(a[:,j], b[:,j])
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    w = np.sqrt(max(0.0, 1.0 + np.trace(R))) / 2.0
    if w < 1e-6:
        # 180-degree case: take the dominant axis from R + I
        M = R + np.eye(3)
        axis = M[:, np.argmax(np.diag(M))]
        axis = axis / np.linalg.norm(axis)
        return np.array([0.0, *axis])
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return np.array([w, x, y, z])


def _angle(v1: np.ndarray, v2: np.ndarray) -> float:
    c = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-9)
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def joints_frame_to_mimic(frame: np.ndarray, duration: float) -> np.ndarray:
    """One frame of SMPL joints (24, 3) -> a 44-dof humanoid3d frame
    (coord_to_rot layout)."""
    f = _axis_swap(frame)
    ident = np.eye(3)

    def seg(child, parent):
        return f[child] - f[parent]

    root_y = seg(6, 0)
    root_z = seg(2, 1)
    root_x = np.cross(root_y, root_z)
    root = np.stack([root_x, root_y, root_z])

    chest_y = seg(9, 6)
    chest_z = seg(17, 16)
    chest_x = np.cross(chest_y, chest_z)
    chest = np.stack([chest_x, chest_y, chest_z])

    neck_y = seg(15, 9)
    neck_z = np.cross(f[15] - f[12], f[9] - f[12])
    neck = np.stack([np.cross(neck_y, neck_z), neck_y, neck_z])

    def hip(hip_i, knee_i):
        y = f[hip_i] - f[knee_i]
        z = np.cross(f[hip_i] - f[knee_i], f[knee_i + 3] - f[knee_i])
        return np.stack([np.cross(y, z), y, z])

    def shoulder(sh_i, el_i, wr_i):
        y = f[sh_i] - f[el_i]
        z = np.cross(f[wr_i] - f[el_i], f[sh_i] - f[el_i])
        return np.stack([np.cross(y, z), y, z])

    out = [np.array([duration]),
           _axis_swap(frame[0]) + np.array([0.5, 0.0, 0.0]),
           _kabsch_quat(root, ident),
           _kabsch_quat(chest, root),
           _kabsch_quat(neck, chest),
           _kabsch_quat(hip(2, 5), root),                       # right hip
           np.array([_angle(seg(2, 5), seg(8, 5)) - np.pi]),    # right knee
           np.array([1.0, 0.0, 0.0, 0.0]),                      # right ankle
           _kabsch_quat(shoulder(17, 19, 21), chest),
           np.array([np.pi - _angle(seg(17, 19), seg(21, 19))]),  # r elbow
           _kabsch_quat(hip(1, 4), root),                       # left hip
           np.array([_angle(seg(1, 4), seg(7, 4)) - np.pi]),    # left knee
           np.array([1.0, 0.0, 0.0, 0.0]),                      # left ankle
           _kabsch_quat(shoulder(16, 18, 20), chest),
           np.array([np.pi - _angle(seg(16, 18), seg(20, 18))])]  # l elbow
    flat = np.concatenate(out)
    assert flat.shape == (FRAME_DOF,)
    return flat


def smpl_joints_to_deepmimic(joints: np.ndarray, fps: float = 10.0,
                             loop: str = "none") -> Dict:
    """(T, 24, 3) SMPL joint positions -> DeepMimic motion dict."""
    joints = _to_mimic_space(np.asarray(joints, np.float64)[:, :24])
    dur = 1.0 / fps
    frames = np.stack([joints_frame_to_mimic(j, dur) for j in joints])
    return {"Loop": loop, "Frames": frames.tolist()}


def main(argv: Optional[list] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", help="npz with per-frame 'joints' (T, J, 3)")
    p.add_argument("output", help="DeepMimic motion json")
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--loop", default="none", choices=["none", "wrap"])
    args = p.parse_args(argv)

    data = np.load(args.input, allow_pickle=True)
    if "joints" in data.files:
        joints = np.asarray(data["joints"])
    else:
        results = data["results"].item()
        joints = np.asarray(results["joints"])
    doc = smpl_joints_to_deepmimic(joints, fps=args.fps, loop=args.loop)
    with open(args.output, "w") as fh:
        json.dump(doc, fh)
    print(f"wrote {len(doc['Frames'])} frames to {args.output}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
