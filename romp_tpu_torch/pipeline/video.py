"""Video pipeline: batched device inference + host tracking/smoothing loop.

Mirrors the reference's temporal mode (`simple_romp/bev/main.py:260-287`
temporal_optimization; `simple_romp/romp/main.py:120-156`): per frame, the
device pipeline emits masked (K,) person tensors; the host associates persons
across frames with ByteTrack-3D and smooths each track's pose/shape/camera
with a OneEuro filter bank.

Frames are processed in device batches; only the tiny association /
smoothing loop runs per frame on the host. A copy of the JAX package's
numpy-only module, so that the port imports nothing of that package.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from romp_tpu_torch.tracker.bytetrack3d import ByteTracker3D
from romp_tpu_torch.tracker.oneeuro import create_filter_bank, smooth_results


class TemporalOptimizer:
    """Track + smooth a stream of per-frame masked outputs."""

    def __init__(self, det_thresh: float = 0.12, smooth_coeff: float = 3.0,
                 image_scale: float = 128.0, depth_scale: float = 30.0):
        self.tracker = ByteTracker3D(det_thresh=det_thresh,
                                     low_conf_det_thresh=0.05,
                                     track_buffer=60, match_thresh=300.0)
        self.smooth_coeff = smooth_coeff
        self.image_scale = image_scale
        self.depth_scale = depth_scale
        self.filters: Dict[int, dict] = {}

    def _tracking_points(self, cams: np.ndarray,
                         cam_trans: np.ndarray) -> np.ndarray:
        """(s, ty, tx) + trans -> (x, y, z, h) association space
        (`bev/main.py:272`): pixel-ish xy, scaled depth, scale as h."""
        return np.concatenate([
            (cams[:, [2, 1]] + 1.0) * self.image_scale,
            cam_trans[:, [2]] * self.depth_scale,
            cams[:, [0]] * self.image_scale / 2.0,
        ], axis=1)

    def __call__(self, frame_out: Dict[str, np.ndarray]
                 ) -> Optional[Dict[str, np.ndarray]]:
        """frame_out: one frame's outputs already filtered to valid persons
        (arrays with leading person dim). Returns outputs reordered to active
        tracks with 'track_ids' added and smoothed params, or None if no
        tracked person."""
        cams = frame_out["cam"]
        pts = self._tracking_points(cams, frame_out["cam_trans"])
        ids, inds = self.tracker.update(pts, frame_out["center_confs"])
        if not ids:
            return None
        out = {k: v[inds] for k, v in frame_out.items()
               if isinstance(v, np.ndarray) and v.ndim >= 1
               and v.shape[0] == cams.shape[0]}
        out["track_ids"] = np.asarray(ids, np.int32)

        for j, tid in enumerate(ids):
            if tid not in self.filters:
                self.filters[tid] = create_filter_bank(self.smooth_coeff)
            th, be, cam = smooth_results(
                self.filters[tid], out["smpl_thetas"][j],
                out["smpl_betas"][j], out["cam"][j])
            out["smpl_thetas"][j] = th
            out["smpl_betas"][j] = be
            out["cam"][j] = cam
        # prune stale filter state (reference caps the bank size)
        if len(self.filters) > 1000:
            self.filters.clear()
        return out


def filter_valid(out: Dict[str, np.ndarray], image_idx: int = 0
                 ) -> Dict[str, np.ndarray]:
    """Slice one image's outputs from a batched (B, K, ...) dict down to the
    valid persons only (host-side boundary from fixed-K device tensors)."""
    mask = np.asarray(out["mask"][image_idx])
    res = {}
    for k, v in out.items():
        if k == "mask":
            continue
        v = np.asarray(v)
        if v.ndim >= 2 and v.shape[0] > image_idx and v.shape[1] == mask.shape[0]:
            res[k] = v[image_idx][mask]
    return res


def collect_sequence_results(frame_results: List[Optional[Dict[str, np.ndarray]]]
                             ) -> Dict[int, Dict[str, list]]:
    """Group per-frame tracked results into per-track sequences, like
    `save_video_results` (`simple_romp/romp/utils.py:88-110`)."""
    seqs: Dict[int, Dict[str, list]] = {}
    for fid, fr in enumerate(frame_results):
        if fr is None or "track_ids" not in fr:
            continue
        for j, tid in enumerate(fr["track_ids"]):
            tid = int(tid)
            if tid not in seqs:
                seqs[tid] = {"frame_id": []}
            seqs[tid]["frame_id"].append(fid)
            for k, v in fr.items():
                if k == "track_ids":
                    continue
                seqs[tid].setdefault(k, []).append(v[j])
    return seqs
