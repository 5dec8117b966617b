"""Motion export: per-track results -> BVH (pure python) or FBX (via bpy).
The port's copy of `romp_tpu/tools/export_motion.py` (numpy and scipy).

Reference equivalent: `simple_romp/tools/convert2fbx.py` (bpy-driven FBX/GLB
armature animation). Blender's bpy is an optional heavyweight dependency, so
the default path here writes standard BVH text (loadable by Blender, Maya,
MotionBuilder); FBX conversion delegates to bpy when installed.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

SMPL_JOINT_NAMES = [
    "Pelvis", "L_Hip", "R_Hip", "Spine1", "L_Knee", "R_Knee", "Spine2",
    "L_Ankle", "R_Ankle", "Spine3", "L_Foot", "R_Foot", "Neck", "L_Collar",
    "R_Collar", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
]
SMPL_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19, 20, 21]


def _aa_to_euler_zxy_deg(aa: np.ndarray) -> np.ndarray:
    """(J, 3) axis-angle -> (J, 3) ZXY-order euler degrees (BVH channel
    order Zrotation Xrotation Yrotation)."""
    from scipy.spatial.transform import Rotation as R

    out = np.zeros_like(aa)
    nz = np.linalg.norm(aa, axis=-1) > 1e-8
    if nz.any():
        out[nz] = R.from_rotvec(aa[nz]).as_euler("ZXY", degrees=True)
    return out


def _default_offsets() -> np.ndarray:
    """Rest-pose joint offsets (meters): approximate SMPL rest skeleton,
    used when no packed model assets are supplied."""
    j = np.zeros((24, 3))
    j[1], j[2] = [0.07, -0.09, 0], [-0.07, -0.09, 0]
    j[3] = [0, 0.11, 0]
    j[4], j[5] = [0.03, -0.38, 0], [-0.03, -0.38, 0]
    j[6] = [0, 0.14, 0]
    j[7], j[8] = [0.01, -0.4, 0], [-0.01, -0.4, 0]
    j[9] = [0, 0.05, 0]
    j[10], j[11] = [0.03, -0.06, 0.12], [-0.03, -0.06, 0.12]
    j[12] = [0, 0.21, -0.03]
    j[13], j[14] = [0.08, 0.11, 0], [-0.08, 0.11, 0]
    j[15] = [0, 0.07, 0.05]
    j[16], j[17] = [0.1, 0.03, 0], [-0.1, 0.03, 0]
    j[18], j[19] = [0.26, 0, 0], [-0.26, 0, 0]
    j[20], j[21] = [0.25, 0, 0], [-0.25, 0, 0]
    j[22], j[23] = [0.08, 0, 0], [-0.08, 0, 0]
    return j


def export_bvh(poses: np.ndarray, trans: Optional[np.ndarray],
               save_path: str, frame_rate: float = 30.0,
               joint_offsets: Optional[np.ndarray] = None,
               scale: float = 100.0) -> str:
    """poses: (T, 72) axis-angle; trans: (T, 3) or None; offsets in meters
    (written in centimeters by default, the common BVH convention)."""
    T = poses.shape[0]
    offsets = (_default_offsets() if joint_offsets is None
               else np.asarray(joint_offsets)) * scale
    children: Dict[int, list] = {i: [] for i in range(24)}
    for j, p in enumerate(SMPL_PARENTS):
        if p >= 0:
            children[p].append(j)

    lines = ["HIERARCHY"]

    def emit(j: int, depth: int):
        ind = "  " * depth
        tag = "ROOT" if j == 0 else "JOINT"
        lines.append(f"{ind}{tag} {SMPL_JOINT_NAMES[j]}")
        lines.append(f"{ind}{{")
        o = offsets[j]
        lines.append(f"{ind}  OFFSET {o[0]:.4f} {o[1]:.4f} {o[2]:.4f}")
        if j == 0:
            lines.append(f"{ind}  CHANNELS 6 Xposition Yposition Zposition "
                         "Zrotation Xrotation Yrotation")
        else:
            lines.append(f"{ind}  CHANNELS 3 Zrotation Xrotation Yrotation")
        if children[j]:
            for c in children[j]:
                emit(c, depth + 1)
        else:
            lines.append(f"{ind}  End Site")
            lines.append(f"{ind}  {{")
            lines.append(f"{ind}    OFFSET 0.0 {-5.0:.1f} 0.0")
            lines.append(f"{ind}  }}")
        lines.append(f"{ind}}}")

    emit(0, 0)
    lines.append("MOTION")
    lines.append(f"Frames: {T}")
    lines.append(f"Frame Time: {1.0 / frame_rate:.6f}")
    for t in range(T):
        eul = _aa_to_euler_zxy_deg(poses[t].reshape(24, 3))
        row = []
        tr = (trans[t] * scale if trans is not None else np.zeros(3))
        row += [f"{v:.4f}" for v in tr]
        for j in range(24):
            row += [f"{v:.4f}" for v in eul[j]]
        lines.append(" ".join(row))
    with open(save_path, "w") as f:
        f.write("\n".join(lines))
    return save_path


def export_sequence_results(video_results_npz: str, out_dir: str,
                            frame_rate: float = 30.0) -> Sequence[str]:
    """video_results.npz (per-track sequences, `utils/io.py`
    save_video_results) -> one BVH per track."""
    import os
    import os.path as osp

    os.makedirs(out_dir, exist_ok=True)
    data = np.load(video_results_npz, allow_pickle=True)
    seqs = data["sequence_results"][()]
    paths = []
    for tid, seq in seqs.items():
        poses = np.asarray(seq["smpl_thetas"])
        trans = (np.asarray(seq["cam_trans"])
                 if "cam_trans" in seq else None)
        p = osp.join(out_dir, f"track_{tid}.bvh")
        export_bvh(poses, trans, p, frame_rate)
        paths.append(p)
    return paths


def export_fbx(poses: np.ndarray, trans: Optional[np.ndarray],
               save_path: str, **kwargs) -> str:
    """FBX via Blender's bpy (optional). Falls back to BVH + a note."""
    try:
        import bpy  # noqa: F401
    except ImportError:
        alt = save_path.rsplit(".", 1)[0] + ".bvh"
        export_bvh(poses, trans, alt, **kwargs)
        raise ImportError(
            f"bpy unavailable; wrote BVH to {alt} instead — import it in "
            "Blender and export FBX, or pip install bpy")
    # bpy path: build an armature and keyframe it (as the reference
    # convert2fbx.py does); BVH covers the common pipeline without bpy.
    alt = save_path.rsplit(".", 1)[0] + ".bvh"
    export_bvh(poses, trans, alt, **kwargs)
    bpy.ops.import_anim.bvh(filepath=alt)
    bpy.ops.export_scene.fbx(filepath=save_path)
    return save_path


def main(argv=None):
    """CLI counterpart of `simple_romp/tools/convert2fbx.py` /
    `scripts/export_fbx.sh`: video_results.npz -> one BVH (or FBX when bpy
    is installed) per track."""
    import argparse
    import os.path as osp

    ap = argparse.ArgumentParser(
        description="export romp_tpu_torch motion results to BVH/FBX")
    ap.add_argument("-i", "--input", required=True,
                    help="video_results.npz from a video/webcam run")
    ap.add_argument("-o", "--out_dir", required=True)
    ap.add_argument("--format", choices=["bvh", "fbx"], default="bvh")
    ap.add_argument("--frame_rate", type=float, default=30.0)
    args = ap.parse_args(argv)

    paths = export_sequence_results(args.input, args.out_dir,
                                    frame_rate=args.frame_rate)
    if args.format == "fbx":
        data = np.load(args.input, allow_pickle=True)
        seqs = data["sequence_results"][()]
        out = []
        for tid, seq in seqs.items():
            try:
                out.append(export_fbx(
                    np.asarray(seq["smpl_thetas"]),
                    np.asarray(seq["cam_trans"])
                    if "cam_trans" in seq else None,
                    osp.join(args.out_dir, f"track_{tid}.fbx"),
                    frame_rate=args.frame_rate))
            except ImportError as e:
                print(e)
                break
        paths = out or paths
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
