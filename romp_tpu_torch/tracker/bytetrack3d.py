"""ByteTrack-style multi-person tracker over 3D body centers.

Algorithm parity with `simple_romp/tracker/byte_tracker_3dcenter.py:6-158`:
two-stage association — high-confidence detections matched against
(tracked + lost) tracks by 4D euclidean distance, then low-confidence
detections matched against the remaining tracked tracks at a looser
threshold; unconfirmed tracks get a third pass; unmatched high-confidence
detections start new tracks; lost tracks expire after `track_buffer` frames.
Duplicate tracked/lost pairs are resolved by track age.

Implementation differences (documented, not behavioral copies):
- assignment uses scipy's Hungarian solver with cost gating instead of
  lap.lapjv(cost_limit) — identical matches whenever the gated problem has a
  unique optimum;
- the Kalman filter lives in `romp_tpu_torch.tracker.kalman` as pure functions.

This is intentionally host-side numpy: tiny, branchy, state-heavy — the
wrong shape for a device program. Device outputs (masked (K,...) tensors) are
filtered to arrays before entering.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from romp_tpu_torch.tracker import kalman


def assign(cost: np.ndarray, thresh: float
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Min-cost assignment with gating: pairs costing > thresh are unmatched.

    Returns (matches (M, 2), unmatched_rows, unmatched_cols).
    """
    if cost.size == 0:
        return (np.empty((0, 2), int), np.arange(cost.shape[0]),
                np.arange(cost.shape[1]))
    from scipy.optimize import linear_sum_assignment

    gated = np.where(cost > thresh, thresh + 1e5, cost)
    rows, cols = linear_sum_assignment(gated)
    keep = cost[rows, cols] <= thresh
    matches = np.stack([rows[keep], cols[keep]], axis=1)
    um_r = np.setdiff1d(np.arange(cost.shape[0]), matches[:, 0])
    um_c = np.setdiff1d(np.arange(cost.shape[1]), matches[:, 1])
    return matches, um_r, um_c


class TrackState:
    NEW, TRACKED, LOST, REMOVED = range(4)


@dataclasses.dataclass
class Track:
    meas: np.ndarray                 # last (x, y, z, h) measurement
    score: float
    track_id: int = 0
    state: int = TrackState.NEW
    is_activated: bool = False
    mean: np.ndarray = None
    cov: np.ndarray = None
    start_frame: int = 0
    frame_id: int = 0

    @property
    def trans(self) -> np.ndarray:
        return self.meas.copy() if self.mean is None else self.mean[:4].copy()

    def predict(self):
        m = self.mean.copy()
        if self.state != TrackState.TRACKED:
            m[7] = 0.0  # freeze scale velocity while lost
        self.mean, self.cov = kalman.predict(m, self.cov)

    def correct(self, det: "Track", frame_id: int):
        self.mean, self.cov = kalman.update(self.mean, self.cov, det.meas)
        self.state = TrackState.TRACKED
        self.is_activated = True
        self.frame_id = frame_id
        self.score = det.score


class ByteTracker3D:
    """Drop-in behavioral equivalent of the reference Tracker."""

    def __init__(self, det_thresh: float = 0.12,
                 low_conf_det_thresh: float = 0.05, track_buffer: int = 60,
                 match_thresh: float = 300.0, frame_rate: int = 30):
        self.det_thresh = det_thresh
        self.low_thresh = low_conf_det_thresh
        self.match_thresh = match_thresh
        self.max_time_lost = int(frame_rate / 30.0 * track_buffer)
        self.dup_dist_thresh = 60.0
        self.frame_id = 0
        self._next_id = 0
        self.tracked: List[Track] = []
        self.lost: List[Track] = []

    def _new_id(self) -> int:
        self._next_id += 1
        return self._next_id

    @staticmethod
    def _dist(tracks: List[Track], dets: List[Track],
              dim: int = 4) -> np.ndarray:
        if not tracks or not dets:
            return np.zeros((len(tracks), len(dets)), np.float32)
        a = np.stack([t.trans[:dim] for t in tracks])
        b = np.stack([d.trans[:dim] for d in dets])
        return np.linalg.norm(a[:, None] - b[None], axis=2)

    def update(self, points: np.ndarray, scores: np.ndarray
               ) -> Tuple[List[int], List[int]]:
        """points: (N, 4) = (x, y, z, h); scores: (N,) detection confidences.

        Returns (track_ids, detection_indices) for currently-active tracks,
        like the reference's (tracked_ids, results_inds).
        """
        self.frame_id += 1
        high = scores > self.det_thresh
        low = (scores > self.low_thresh) & ~high
        dets = [Track(p.astype(np.float64), float(s))
                for p, s in zip(points[high], scores[high])]
        dets_low = [Track(p.astype(np.float64), float(s))
                    for p, s in zip(points[low], scores[low])]

        confirmed = [t for t in self.tracked if t.is_activated]
        unconfirmed = [t for t in self.tracked if not t.is_activated]

        # Stage 1: confirmed + lost vs high-confidence detections.
        pool = confirmed + [t for t in self.lost
                            if t.track_id not in
                            {c.track_id for c in confirmed}]
        for t in pool:
            t.predict()
        matches, u_track, u_det = assign(
            self._dist(pool, dets), self.match_thresh)
        activated, lost_now = [], []
        for ti, di in matches:
            t = pool[ti]
            t.correct(dets[di], self.frame_id)  # update or re-activate
            activated.append(t)

        # Stage 2: remaining TRACKED tracks vs low-confidence detections.
        remain = [pool[i] for i in u_track
                  if pool[i].state == TrackState.TRACKED]
        m2, u_track2, _ = assign(
            self._dist(remain, dets_low), self.match_thresh * 2)
        for ti, di in m2:
            remain[ti].correct(dets_low[di], self.frame_id)
            activated.append(remain[ti])
        for i in u_track2:
            t = remain[i]
            if t.state != TrackState.LOST:
                t.state = TrackState.LOST
                lost_now.append(t)

        # Stage 3: unconfirmed tracks vs leftover high-confidence detections.
        leftover = [dets[i] for i in u_det]
        m3, u_unconf, u_det3 = assign(
            self._dist(unconfirmed, leftover), self.match_thresh * 3)
        for ti, di in m3:
            unconfirmed[ti].correct(leftover[di], self.frame_id)
            activated.append(unconfirmed[ti])
        for i in u_unconf:
            unconfirmed[i].state = TrackState.REMOVED

        # Stage 4: births from unmatched high-confidence detections.
        for i in u_det3:
            d = leftover[i]
            if d.score < self.det_thresh:
                continue
            d.track_id = self._new_id()
            d.mean, d.cov = kalman.initiate(d.meas)
            d.state = TrackState.TRACKED
            d.is_activated = self.frame_id == 1
            d.start_frame = d.frame_id = self.frame_id
            activated.append(d)

        # Stage 5: expire stale lost tracks.
        self.lost = [t for t in self.lost + lost_now
                     if t.state == TrackState.LOST
                     and self.frame_id - t.frame_id <= self.max_time_lost]
        seen = set()
        self.tracked = []
        for t in (t for t in activated if t.state == TrackState.TRACKED):
            if t.track_id not in seen:
                seen.add(t.track_id)
                self.tracked.append(t)
        self.lost = [t for t in self.lost if t.track_id not in seen]
        self._prune_duplicates()

        active = [t for t in self.tracked if t.is_activated]
        if not active:
            return [], []
        # Map each active track to its nearest raw detection index.
        ids, inds = [], []
        for t in active:
            d = np.linalg.norm(points - t.trans[None, :4], axis=1)
            ids.append(int(t.track_id))
            inds.append(int(np.argmin(d)))
        return ids, inds

    def _prune_duplicates(self):
        """Resolve near-identical tracked/lost pairs by age
        (`byte_tracker_3dcenter.py:185-199`, xy-distance only)."""
        if not self.tracked or not self.lost:
            return
        d = self._dist(self.tracked, self.lost, dim=2)
        pairs = np.argwhere(d < self.dup_dist_thresh)
        drop_t, drop_l = set(), set()
        for p, q in pairs:
            age_t = self.tracked[p].frame_id - self.tracked[p].start_frame
            age_l = self.lost[q].frame_id - self.lost[q].start_frame
            if age_t > age_l:
                drop_l.add(q)
            else:
                drop_t.add(p)
        self.tracked = [t for i, t in enumerate(self.tracked)
                        if i not in drop_t]
        self.lost = [t for i, t in enumerate(self.lost) if i not in drop_l]
