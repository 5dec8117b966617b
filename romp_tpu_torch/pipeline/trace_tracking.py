"""TRACE host-side temporal tracking: trajectory assembly + memory5D.

Behavioral equivalent of `simple_romp/trace2/models/TempTracker.py:238-486`
and `trace2/tracker/tracker3D.py`: per-frame 3D detections are associated
across the clip using predicted motion offsets (a detection's PREVIOUS-frame
position, cam - motion_offset, is matched against each track's last
position), trajectories are completed over the clip (missing frames flagged),
and per-track mesh features are gated by detection confidence against a
per-track memory ("memory5D") so occluded frames inherit the last confident
feature. Camera infilling interpolates occluded frames and OneEuro-smooths
each track.

All of this is tiny branchy host work over <= max_person tracks; device
tensors enter as numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from romp_tpu_torch.tracker.bytetrack3d import assign
from romp_tpu_torch.tracker.oneeuro import OneEuroFilter

TAN_FOV_HALF_TRACE = float(np.tan(np.radians(25.0)))  # FOV 50 deg


def trace_cam_to_trans(cams: np.ndarray) -> np.ndarray:
    """(s, ty, tx) -> (X, Y, depth), 50-degree FOV
    (`trace2/utils/utils.py` denormalize_cam_params_to_trans)."""
    depth = 1.0 / (cams[:, 0] * TAN_FOV_HALF_TRACE + 1e-3)
    xy = cams[:, [2, 1]] * depth[:, None] * TAN_FOV_HALF_TRACE
    return np.concatenate([xy, depth[:, None]], axis=1)


@dataclasses.dataclass
class SeqConfig:
    """Per-sequence tracking knobs (`trace2/utils/infer_settings.py:35-51`)."""

    tracker_det_thresh: float = 0.18
    tracker_match_thresh: float = 1.2
    first_frame_det_thresh: float = 0.3
    accept_new_dets: bool = True
    new_subject_det_thresh: float = 0.8
    time2forget: int = 0
    large_object_thresh: float = 0.13
    suppress_duplicate_thresh: float = 0.05
    motion_offset3D_norm_limit: float = 0.50
    feature_update_thresh: float = 0.05
    feature_inherent: bool = True
    occlusion_cam_inherent_or_interp: bool = False
    subject_num: int = -1
    smooth_pose_shape: bool = True
    smooth_pos_cam: bool = True
    pose_smooth_coef: float = 1.0


@dataclasses.dataclass
class Track3D:
    track_id: int
    pos: np.ndarray          # (3,) trans3D
    czyx: np.ndarray         # (3,) int
    missing: int = 0


class MotionOffsetTracker:
    """3D-center tracker guided by predicted motion offsets
    (`trace2/tracker/tracker3D.py:6`): greedy min-cost association between
    track positions and detections' back-projected previous positions, with
    optional first-frame subject locking."""

    def __init__(self, cfg: SeqConfig):
        self.cfg = cfg
        self.tracks: List[Track3D] = []
        self._next_id = 0
        self.frame_count = 0

    def update(self, trans_cur: np.ndarray, trans_prev: np.ndarray,
               scores: np.ndarray, czyxs: np.ndarray
               ) -> List[Tuple[int, int, bool]]:
        """Returns [(det_index, track_id, tracked_flag)]."""
        self.frame_count += 1
        cfg = self.cfg
        out = []
        if self.frame_count == 1 or not self.tracks:
            order = np.argsort(-scores)
            keep = [i for i in order
                    if scores[i] > cfg.first_frame_det_thresh]
            if cfg.subject_num > 0:
                keep = keep[:cfg.subject_num]
            for i in keep:
                self._next_id += 1
                self.tracks.append(Track3D(self._next_id, trans_cur[i],
                                           czyxs[i].copy()))
                out.append((i, self._next_id, True))
            return out

        cost = np.linalg.norm(
            np.stack([t.pos for t in self.tracks])[:, None]
            - trans_prev[None], axis=-1)
        matches, u_tracks, u_dets = assign(cost, cfg.tracker_match_thresh)
        matched_tracks = set()
        for ti, di in matches:
            if scores[di] < cfg.tracker_det_thresh:
                continue
            t = self.tracks[ti]
            t.pos = trans_cur[di]
            t.czyx = czyxs[di].copy()
            t.missing = 0
            matched_tracks.add(ti)
            out.append((di, t.track_id, True))
        for ti in range(len(self.tracks)):
            if ti not in matched_tracks:
                self.tracks[ti].missing += 1
        # expire
        if cfg.time2forget > 0:
            self.tracks = [t for t in self.tracks
                           if t.missing <= cfg.time2forget]
        # births
        if cfg.accept_new_dets and (
                cfg.subject_num <= 0 or len(self.tracks) < cfg.subject_num):
            matched_dets = {di for _, di in matches}
            for di in range(len(scores)):
                if di in matched_dets:
                    continue
                if scores[di] > cfg.new_subject_det_thresh:
                    self._next_id += 1
                    self.tracks.append(Track3D(self._next_id, trans_cur[di],
                                               czyxs[di].copy()))
                    out.append((di, self._next_id, True))
        return out


def _suppress_duplicate_dets(cams: np.ndarray, confs: np.ndarray,
                             thresh: float) -> np.ndarray:
    """Keep max-conf member of each near-identical cam cluster
    (`TempTracker.py:466-483`)."""
    N = len(cams)
    keep = np.ones(N, bool)
    for i in range(N):
        d = np.linalg.norm(cams - cams[i], axis=-1)
        dup = np.where((d < thresh))[0]
        if len(dup) > 1:
            best = dup[np.argmax(confs[dup])]
            for j in dup:
                if j != best:
                    keep[j] = False
    return keep


class Memory5D:
    """Per-track state: gated mesh feature, last cams, OneEuro filters
    (`TempTracker.py:382-400` + the smooth_* methods of TRACE_head)."""

    def __init__(self):
        self.feature: Dict[int, np.ndarray] = {}
        self.cams: Dict[int, np.ndarray] = {}
        self.cam_filter: Dict[int, OneEuroFilter] = {}
        self.pose_filter: Dict[int, OneEuroFilter] = {}
        self.world_cam_filter: Dict[int, OneEuroFilter] = {}
        self.grot_anchor: Dict[int, list] = {}


@dataclasses.dataclass
class ClipTrajectories:
    track_ids: np.ndarray       # (N,)
    czyxs: np.ndarray           # (N, T, 3) int
    frame_valid: np.ndarray     # (N, T) bool — detection present that frame
    det_confs: np.ndarray       # (N, T)
    tracked_flags: np.ndarray   # (N, T)
    inherent_flags: np.ndarray  # (N, T) bool — feature inherited from memory


def assemble_trajectories(det_czyxs: List[np.ndarray],
                          det_scores: List[np.ndarray],
                          det_cams: List[np.ndarray],
                          det_motions: List[np.ndarray],
                          cfg: SeqConfig,
                          tracker: Optional[MotionOffsetTracker] = None,
                          ) -> Tuple[Optional[ClipTrajectories],
                                     MotionOffsetTracker]:
    """Per-frame detections -> per-track clip trajectories.

    Equivalent of `perform_tracking` + `parse_tracking_ids`
    (`TempTracker.py:402-464,345-380`); lists are per frame of the clip.
    """
    if tracker is None:
        tracker = MotionOffsetTracker(cfg)
    T = len(det_czyxs)
    per_frame: List[List[Tuple[int, int, bool]]] = []
    for f in range(T):
        cams, scores = det_cams[f], det_scores[f]
        czyxs, motion = det_czyxs[f], det_motions[f]
        keep = cams[:, 0] > cfg.large_object_thresh
        cams, scores, czyxs, motion = (cams[keep], scores[keep], czyxs[keep],
                                       motion[keep])
        if len(cams):
            keep = _suppress_duplicate_dets(cams, scores,
                                            cfg.suppress_duplicate_thresh)
            cams, scores, czyxs, motion = (cams[keep], scores[keep],
                                           czyxs[keep], motion[keep])
        if not len(cams):
            per_frame.append([])
            continue
        motion = motion.copy()
        big = np.linalg.norm(motion, axis=-1) > cfg.motion_offset3D_norm_limit
        motion[big] = 0.0
        trans_cur = trace_cam_to_trans(cams)
        trans_prev = trace_cam_to_trans(cams - motion)
        assoc = tracker.update(trans_cur, trans_prev, scores, czyxs)
        per_frame.append([(di, tid, flag, scores[di], czyxs[di])
                          for di, tid, flag in assoc])

    all_ids = sorted({tid for fr in per_frame for _, tid, _, _, _ in fr})
    if not all_ids:
        return None, tracker
    N = len(all_ids)
    id_index = {tid: i for i, tid in enumerate(all_ids)}
    czyxs = np.zeros((N, T, 3), np.int32)
    valid = np.zeros((N, T), bool)
    confs = np.zeros((N, T), np.float32)
    flags = np.zeros((N, T), np.float32)
    for f, fr in enumerate(per_frame):
        for di, tid, flag, conf, czyx in fr:
            i = id_index[tid]
            czyxs[i, f] = czyx
            valid[i, f] = True
            confs[i, f] = conf
            flags[i, f] = float(flag)
    # Drop rarely-seen tracks (`parse_tracking_ids`: < min(T, 6) frames).
    seen = valid.sum(1)
    keep = seen >= min(T, 6)
    if not keep.any():
        keep = seen >= seen.max()
    return ClipTrajectories(
        np.asarray(all_ids)[keep], czyxs[keep], valid[keep], confs[keep],
        flags[keep], np.zeros_like(valid[keep])), tracker


def gate_features_with_memory(traj: ClipTrajectories, features: np.ndarray,
                              memory: Memory5D, cfg: SeqConfig) -> np.ndarray:
    """Confidence-gated feature update / inheritance
    (`prepare_complete_trajectory_features_withmemory`, TempTracker.py:238-320).
    features: (N, T, C) sampled at traj czyxs. Mutates traj.inherent_flags.
    """
    out = features.copy()
    for i, tid in enumerate(traj.track_ids):
        tid = int(tid)
        for f in range(features.shape[1]):
            inherent = True
            if traj.frame_valid[i, f]:
                good = (traj.det_confs[i, f] > cfg.feature_update_thresh
                        and traj.tracked_flags[i, f] > 0.99)
                if good:
                    memory.feature[tid] = out[i, f].copy()
                    inherent = False
                elif tid in memory.feature:
                    out[i, f] = memory.feature[tid]
            elif tid in memory.feature:
                out[i, f] = memory.feature[tid]
            traj.inherent_flags[i, f] = inherent
    return out


def infill_and_smooth_cams(traj: ClipTrajectories, cams: np.ndarray,
                           memory: Memory5D, cfg: SeqConfig) -> np.ndarray:
    """Interpolate occluded frames' cams and OneEuro-smooth per track
    (`infilling_cams_of_low_quality_dets`, TempTracker.py:160-236)."""
    out = cams.copy()
    N, T, _ = cams.shape
    for i, tid in enumerate(traj.track_ids):
        tid = int(tid)
        bad = traj.inherent_flags[i]
        good_ids = np.where(~bad)[0]
        for f in np.where(bad)[0]:
            fore = good_ids[good_ids < f]
            after = good_ids[good_ids > f]
            if len(fore) == 0:
                if tid in memory.cams:
                    out[i, f] = memory.cams[tid]
                continue
            if len(after) == 0:
                out[i, f] = out[i, good_ids[-1]]
                continue
            a, b = fore[-1], after[0]
            w = (f - a) / (b - a)
            out[i, f] = (1 - w) * out[i, a] + w * out[i, b]
        if len(good_ids):
            memory.cams[tid] = out[i, good_ids[-1]].copy()
        if cfg.smooth_pos_cam:
            if tid not in memory.cam_filter:
                memory.cam_filter[tid] = OneEuroFilter(
                    cfg.pose_smooth_coef, 0.7)
            for f in range(T):
                out[i, f] = memory.cam_filter[tid].process(out[i, f])
    return out


def smooth_pose_params(traj: ClipTrajectories, params: np.ndarray,
                       memory: Memory5D, cfg: SeqConfig,
                       rot_angle_thresh: float = 140.0) -> np.ndarray:
    """Jitter-rejecting global-rotation anchoring + OneEuro pose smoothing
    (`smooth_grots`, model.py:346-386). params: (N, T, D) with layout
    [cam grot 6D | pose 126 | betas 21] (i.e. params_pred[:, 6:]).

    Pure numpy — per-frame device ops here would each cost a device round
    trip."""

    def _r6_to_mat_np(x):
        a1, a2 = x.reshape(3, 2)[:, 0], x.reshape(3, 2)[:, 1]
        b1 = a1 / max(np.linalg.norm(a1), 1e-6)
        b2 = a2 - np.dot(b1, a2) * b1
        b2 = b2 / max(np.linalg.norm(b2), 1e-6)
        return np.stack([b1, b2, np.cross(b1, b2)], axis=-1)

    def angle_between6d(a, b):
        R = _r6_to_mat_np(a).T @ _r6_to_mat_np(b)
        cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
        return float(np.degrees(np.arccos(cos)))

    out = params.copy()
    for i, tid in enumerate(traj.track_ids):
        tid = int(tid)
        if tid not in memory.pose_filter:
            memory.pose_filter[tid] = OneEuroFilter(cfg.pose_smooth_coef, 0.7)
        for f in range(params.shape[1]):
            grot, rest = out[i, f, :6], out[i, f, 6:]
            if traj.inherent_flags[i, f]:
                if tid in memory.grot_anchor:
                    out[i, f, :6] = memory.grot_anchor[tid][0]
                    memory.grot_anchor[tid][1] = 0
                prev = memory.pose_filter[tid].x_filter.prev_raw
                if prev is not None:
                    out[i, f, 6:] = prev
            else:
                if tid in memory.grot_anchor:
                    diff = angle_between6d(grot, memory.grot_anchor[tid][0])
                    if diff > rot_angle_thresh and \
                            memory.grot_anchor[tid][1] <= 10:
                        out[i, f, :6] = memory.grot_anchor[tid][0]
                        memory.grot_anchor[tid][1] += 1
                    else:
                        memory.grot_anchor[tid] = [out[i, f, :6].copy(), 0]
                else:
                    memory.grot_anchor[tid] = [grot.copy(), 0]
                out[i, f, 6:] = memory.pose_filter[tid].process(rest)
    return out


def accumulate_world_cams(traj: ClipTrajectories, normed_cams: np.ndarray,
                          cam_motions: np.ndarray, memory: Memory5D,
                          init_world_cams: Dict[int, np.ndarray],
                          cfg: SeqConfig) -> np.ndarray:
    """World-frame camera accumulation + smoothing
    (`localization3D_inference`, model.py:277-344): world = init + cumsum of
    per-frame camera motions; init carried per track across clips."""
    N, T, _ = normed_cams.shape
    world = np.zeros_like(normed_cams)
    for i, tid in enumerate(traj.track_ids):
        tid = int(tid)
        init = init_world_cams.get(tid, normed_cams[i, 0])
        world[i] = init[None] + np.cumsum(cam_motions[i], axis=0)
        init_world_cams[tid] = world[i, -1].copy()
        if cfg.smooth_pos_cam:
            if tid not in memory.world_cam_filter:
                memory.world_cam_filter[tid] = OneEuroFilter(
                    cfg.pose_smooth_coef, 0.7)
            for f in range(T):
                world[i, f] = memory.world_cam_filter[tid].process(world[i, f])
    return world
