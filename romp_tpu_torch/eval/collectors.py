"""Collect THIRD-PARTY methods' 3DPW results into the official challenge
submission layout, so they can be scored by `pw3d_evaluate` side by side
with ours (a copy of `romp_tpu/eval/collectors.py`: the port imports
nothing of the JAX package).

Reference behaviour being matched (not copied):
  - `romp/lib/evaluation/collect_CRMH_3DPW_results.py:65-180` — per-frame
    detections (bbox + rotmat pose + betas + verts) matched to each GT
    subject by the nearest box center to the GT hip center of that frame.
  - `romp/lib/evaluation/collect_VIBE_3DPW_results.py:77-118` — per-track
    results matched once to GT subjects by the first-frame center
    ("tracking" mode), then streamed into the submission arrays.

Both paths funnel into `Pw3dSubmissionCollector` (`eval/protocols.py`),
which owns the official array layout, the neighbour-frame infill, and the
pkl writing — the reference re-implements that per collector; we don't.

All math is numpy on the host: these are offline file-format adapters,
never on the device path.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from .protocols import Pw3dSubmissionCollector

__all__ = [
    "rotmat_to_axis_angle",
    "gt_anchor_centers",
    "collect_frame_matched",
    "collect_track_matched",
    "collect_crmh_results",
    "collect_vibe_results",
]


def rotmat_to_axis_angle(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotation matrices -> (..., 3) axis-angle, numpy.

    Counterpart of the torch `transform_rot_representation` used by the
    reference collector (`collect_CRMH_3DPW_results.py:171`); goes through
    the wxyz quaternion for stability near the identity.
    """
    R = np.asarray(R, np.float64)
    m = R.reshape(-1, 3, 3)
    t = np.trace(m, axis1=1, axis2=2)
    q = np.zeros((m.shape[0], 4))
    # four Shepperd branches, picked per matrix by the largest pivot
    big = np.stack([t, m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]], 1)
    case = np.argmax(big, 1)
    for c in range(4):
        idx = np.where(case == c)[0]
        if idx.size == 0:
            continue
        a = m[idx]
        if c == 0:
            s = np.sqrt(np.maximum(t[idx] + 1.0, 1e-12)) * 2.0
            q[idx, 0] = 0.25 * s
            q[idx, 1] = (a[:, 2, 1] - a[:, 1, 2]) / s
            q[idx, 2] = (a[:, 0, 2] - a[:, 2, 0]) / s
            q[idx, 3] = (a[:, 1, 0] - a[:, 0, 1]) / s
        else:
            i = c - 1
            j, k = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(np.maximum(
                a[:, i, i] - a[:, j, j] - a[:, k, k] + 1.0, 1e-12)) * 2.0
            q[idx, 0] = (a[:, k, j] - a[:, j, k]) / s
            q[idx, 1 + i] = 0.25 * s
            q[idx, 1 + j] = (a[:, j, i] + a[:, i, j]) / s
            q[idx, 1 + k] = (a[:, k, i] + a[:, i, k]) / s
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # canonicalize to w >= 0 (q and -q are the same rotation) so the
    # recovered angle stays in the principal range [0, pi]
    q *= np.where(q[:, :1] < 0.0, -1.0, 1.0)
    # wxyz quaternion -> axis-angle
    w = np.clip(q[:, 0], -1.0, 1.0)
    angle = 2.0 * np.arccos(w)
    s = np.sqrt(np.maximum(1.0 - w * w, 1e-24))
    axis = q[:, 1:] / s[:, None]
    small = angle < 1e-6
    aa = np.where(small[:, None], q[:, 1:] * 2.0, axis * angle[:, None])
    return aa.reshape(R.shape[:-2] + (3,)).astype(np.float32)


def gt_anchor_centers(poses2d: Sequence[np.ndarray],
                      hip_joints: Sequence[int] = (8, 11),
                      conf_thresh: float = 0.0) -> np.ndarray:
    """GT matching anchors from raw 3DPW `poses2d` (per subject (N, 3, 18)):
    the mean hip position per frame, carrying the previous frame forward
    when the hips are unannotated (`collect_CRMH_3DPW_results.py:65-76`).
    Returns (subjects, frames, 2) xy.
    """
    out = []
    for p2d in poses2d:
        p2d = np.asarray(p2d, np.float32)          # (N, 3, 18)
        centers = []
        for pose in p2d[:, :, list(hip_joints)]:   # (3, |hips|)
            ok = pose[2] > conf_thresh
            c = (pose[:2][:, ok].mean(-1) if ok.any()
                 else np.array([np.nan, np.nan], np.float32))
            if np.isnan(c[0]):
                c = centers[-1] if centers else np.zeros(2, np.float32)
            centers.append(np.asarray(c, np.float32))
        out.append(np.stack(centers))
    return np.stack(out)


def _pose72(rec: Mapping[str, np.ndarray], idx) -> np.ndarray:
    """One person's (72,) axis-angle pose from either encoding."""
    if "pose" in rec and np.asarray(rec["pose"]).shape[-1] == 72:
        return np.asarray(rec["pose"])[idx].reshape(72)
    rot = np.asarray(rec["pose_rotmat"])[idx]      # (24, 3, 3)
    return rotmat_to_axis_angle(rot).reshape(72)


def collect_frame_matched(results: Mapping[str, Mapping[int, Optional[dict]]],
                          truth_dir: str, submit_dir: str,
                          joint_regressor: Optional[np.ndarray] = None,
                          ) -> Pw3dSubmissionCollector:
    """CRMH-style collection: `results[action][frame_id]` holds per-frame
    detections for ALL people ({'bbox_centers' or 'bbox', 'pose'/'pose_rotmat',
    'betas', 'joints24' or 'verts'}); each GT subject takes the detection
    whose center is nearest its hip anchor in that frame
    (`collect_CRMH_3DPW_results.py:137-180`).
    """
    import pickle

    col = Pw3dSubmissionCollector(truth_dir)
    anchors = _load_gt_anchors(truth_dir)
    for action, per_frame in results.items():
        if action not in col.layout:
            continue
        _, n_sub, _ = col.layout[action]
        gt_c = anchors[action]                     # (S, N, 2)
        for frame_id, rec in per_frame.items():
            if rec is None:
                continue
            centers = _pred_centers(rec)
            for s in range(n_sub):
                k = int(np.argmin(
                    np.linalg.norm(centers - gt_c[s, frame_id], axis=1)))
                col.add(action, int(frame_id), s,
                        _pose72(rec, k),
                        np.asarray(rec["betas"])[k].reshape(-1)[:10],
                        _person_joints24(rec, k, joint_regressor))
    col.write(submit_dir)
    return col


def collect_track_matched(results: Mapping[str, Mapping[int, dict]],
                          truth_dir: str, submit_dir: str,
                          joint_regressor: Optional[np.ndarray] = None,
                          ) -> Pw3dSubmissionCollector:
    """VIBE-style collection: `results[action][track_id]` holds ONE track
    ({'frame_ids', 'bbox_centers' or 'bboxes', 'pose'/'pose_rotmat', 'betas',
    'joints24' or 'verts'}); tracks are assigned to GT subjects once, by the
    first-frame center (`collect_VIBE_3DPW_results.py:77-88,108-118`),
    greedily nearest-first so two tracks never share a subject.
    """
    col = Pw3dSubmissionCollector(truth_dir)
    anchors = _load_gt_anchors(truth_dir)
    for action, tracks in results.items():
        if action not in col.layout:
            continue
        _, n_sub, _ = col.layout[action]
        gt_first = anchors[action][:, 0]           # (S, 2)
        track_ids = list(tracks.keys())
        firsts = np.stack([
            _pred_centers(tracks[t])[0] for t in track_ids])
        dist = np.linalg.norm(
            firsts[:, None] - gt_first[None], axis=-1)  # (T, S)
        assigned: Dict[int, int] = {}
        order = np.dstack(np.unravel_index(
            np.argsort(dist, axis=None), dist.shape))[0]
        used_t, used_s = set(), set()
        for t_i, s_i in order:
            if t_i in used_t or s_i in used_s:
                continue
            used_t.add(int(t_i))
            used_s.add(int(s_i))
            assigned[int(t_i)] = int(s_i)
        for t_i, s in assigned.items():
            rec = tracks[track_ids[t_i]]
            for idx, frame_id in enumerate(np.asarray(rec["frame_ids"])):
                col.add(action, int(frame_id), s,
                        _pose72(rec, idx),
                        np.asarray(rec["betas"])[idx].reshape(-1)[:10],
                        _person_joints24(rec, idx, joint_regressor))
    col.write(submit_dir)
    return col


def collect_crmh_results(npz_path: str, truth_dir: str, submit_dir: str,
                         joint_regressor: Optional[np.ndarray] = None
                         ) -> Pw3dSubmissionCollector:
    """Load a CRMH results dump (npz: {'results': {'<action>-image_<id>.jpg'
    -like keys or nested {action: {frame: rec}}}}) and collect it
    (`collect_CRMH_3DPW_results.py:100-135`)."""
    raw = np.load(npz_path, allow_pickle=True)["results"][()]
    nested: Dict[str, Dict[int, Optional[dict]]] = {}
    for key, rec in raw.items():
        if isinstance(rec, dict) and rec and all(
                isinstance(v, (int, np.integer)) for v in rec.keys()):
            nested[key] = rec                      # already {frame: rec}
            continue
        action, frame_name = key.split("-")
        frame_id = int(frame_name.replace("image_", "").split(".")[0])
        nested.setdefault(action, {})[frame_id] = rec
    return collect_frame_matched(nested, truth_dir, submit_dir,
                                 joint_regressor)


def collect_vibe_results(pkl_dir: str, truth_dir: str, submit_dir: str,
                         joint_regressor: Optional[np.ndarray] = None
                         ) -> Pw3dSubmissionCollector:
    """Load VIBE per-action track pickles (`<action>_output.pkl`, a dict
    {track_id: rec}) and collect them
    (`collect_VIBE_3DPW_results.py:77-88`)."""
    import glob
    import os.path as osp
    import pickle

    results: Dict[str, Dict[int, dict]] = {}
    for path in sorted(glob.glob(osp.join(pkl_dir, "*_output.pkl"))):
        action = osp.basename(path)[: -len("_output.pkl")]
        with open(path, "rb") as f:
            results[action] = pickle.load(f)
    return collect_track_matched(results, truth_dir, submit_dir,
                                 joint_regressor)


def _person_joints24(rec, idx, joint_regressor):
    if "joints24" in rec:
        return np.asarray(rec["joints24"])[idx].reshape(24, 3)
    if joint_regressor is None:
        raise ValueError("need joints24 in the results or a joint_regressor"
                         " to regress them from verts")
    verts = np.asarray(rec["verts"])[idx]          # (6890, 3)
    return (np.asarray(joint_regressor).T @ verts).reshape(24, 3)


def _pred_centers(rec) -> np.ndarray:
    """(K, 2) matching centers from a results record: given directly, or the
    mean corner of xyxy boxes (`collect_CRMH_3DPW_results.py:120-126`)."""
    if "bbox_centers" in rec:
        return np.asarray(rec["bbox_centers"], np.float32).reshape(-1, 2)
    boxes = np.asarray(rec.get("bboxes", rec.get("bbox")), np.float32)
    boxes = boxes.reshape(-1, 4)
    return (boxes[:, :2] + boxes[:, 2:]) / 2.0


def _load_gt_anchors(truth_dir: str) -> Dict[str, np.ndarray]:
    import glob
    import os.path as osp
    import pickle

    anchors = {}
    for split in ("train", "validation", "test"):
        for path in sorted(glob.glob(osp.join(truth_dir, split, "*.pkl"))):
            with open(path, "rb") as f:
                gt = pickle.load(f, encoding="latin1")
            anchors[osp.basename(path)[:-4]] = gt_anchor_centers(
                gt["poses2d"])
    return anchors


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Collect third-party 3DPW results into the official "
                    "challenge submission layout")
    ap.add_argument("method", choices=["crmh", "vibe"])
    ap.add_argument("--results", required=True,
                    help="CRMH npz dump / VIBE *_output.pkl directory")
    ap.add_argument("--truth", required=True, help="3DPW sequenceFiles dir")
    ap.add_argument("--out", required=True, help="submission output dir")
    ap.add_argument("--joint_regressor", default=None,
                    help="optional (6890, 24) .npy to regress joints from "
                         "verts when the dump lacks joints24")
    args = ap.parse_args(argv)
    reg = (np.load(args.joint_regressor)
           if args.joint_regressor else None)
    fn = collect_crmh_results if args.method == "crmh" \
        else collect_vibe_results
    fn(args.results, args.truth, args.out, reg)
    print(f"wrote submission to {args.out}")


if __name__ == "__main__":
    main()
