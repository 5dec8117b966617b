"""Multi-object-tracking metrics: CLEAR (MOTA/MOTP), IDF1, HOTA (a copy of
`romp_tpu/eval/mot_metrics.py`).

Standalone implementation of the metrics the reference vendors via TrackEval
(`simple_romp/trace2/evaluation/TrackEval/`, used by
`evaluate_tracking.py`): CLEAR-MOT with carried matches, global ID-measures
(IDF1) via trajectory-level assignment, and HOTA averaged over similarity
thresholds with its DetA/AssA decomposition.

Inputs are per-frame detections {frame: (ids, positions)} for GT and
predictions plus a similarity function (default: thresholded euclidean on 3D
centers — the natural similarity for this framework's trackers; IoU boxes
can be plugged in the same way).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

Frame = Tuple[np.ndarray, np.ndarray]   # (ids (N,), positions (N, D))


def euclidean_similarity(gt_pos: np.ndarray, pr_pos: np.ndarray,
                         max_dist: float = 1.0) -> np.ndarray:
    """sim = max(0, 1 - dist / max_dist), shape (n_gt, n_pred)."""
    if len(gt_pos) == 0 or len(pr_pos) == 0:
        return np.zeros((len(gt_pos), len(pr_pos)))
    d = np.linalg.norm(gt_pos[:, None] - pr_pos[None], axis=-1)
    return np.maximum(0.0, 1.0 - d / max_dist)


def _frames_union(gt: Dict[int, Frame], pred: Dict[int, Frame]) -> List[int]:
    return sorted(set(gt) | set(pred))


def clear_mot(gt: Dict[int, Frame], pred: Dict[int, Frame],
              similarity: Callable = euclidean_similarity,
              sim_thresh: float = 0.5) -> Dict[str, float]:
    """CLEAR-MOT: carried matches frame to frame; MOTA/MOTP/IDSW/FP/FN."""
    matches: Dict[int, int] = {}   # gt_id -> pred_id carried over
    fp = fn = idsw = 0
    n_gt = 0
    sim_sum, n_match = 0.0, 0
    for f in _frames_union(gt, pred):
        gids, gpos = gt.get(f, (np.zeros(0, int), np.zeros((0, 3))))
        pids, ppos = pred.get(f, (np.zeros(0, int), np.zeros((0, 3))))
        n_gt += len(gids)
        sim = similarity(gpos, ppos)

        new_matches: Dict[int, int] = {}
        used_p = set()
        # keep previous matches still valid
        for gi, gid in enumerate(gids):
            pid = matches.get(gid)
            if pid is not None and pid in pids:
                pj = int(np.where(pids == pid)[0][0])
                if sim[gi, pj] >= sim_thresh:
                    new_matches[gid] = pid
                    used_p.add(pj)
                    sim_sum += sim[gi, pj]
                    n_match += 1
        # hungarian on the rest
        free_g = [i for i, gid in enumerate(gids) if gid not in new_matches]
        free_p = [j for j in range(len(pids)) if j not in used_p]
        if free_g and free_p:
            sub = sim[np.ix_(free_g, free_p)]
            rows, cols = linear_sum_assignment(-sub)
            for r, c in zip(rows, cols):
                if sub[r, c] < sim_thresh:
                    continue
                gid = gids[free_g[r]]
                pid = int(pids[free_p[c]])
                if gid in matches and matches[gid] != pid:
                    idsw += 1
                new_matches[gid] = pid
                used_p.add(free_p[c])
                sim_sum += sub[r, c]
                n_match += 1
        fn += len(gids) - len(new_matches)
        fp += len(pids) - len(used_p)
        matches.update(new_matches)
    mota = 1.0 - (fp + fn + idsw) / max(n_gt, 1)
    motp = sim_sum / max(n_match, 1)
    return {"mota": mota, "motp": motp, "idsw": idsw, "fp": fp, "fn": fn,
            "n_gt": n_gt}


def id_f1(gt: Dict[int, Frame], pred: Dict[int, Frame],
          similarity: Callable = euclidean_similarity,
          sim_thresh: float = 0.5) -> Dict[str, float]:
    """IDF1 via trajectory-level bipartite assignment of identities."""
    gt_ids = sorted({int(i) for f in gt.values() for i in f[0]})
    pr_ids = sorted({int(i) for f in pred.values() for i in f[0]})
    g_index = {g: i for i, g in enumerate(gt_ids)}
    p_index = {p: j for j, p in enumerate(pr_ids)}
    overlap = np.zeros((len(gt_ids), len(pr_ids)))
    gt_count = np.zeros(len(gt_ids))
    pr_count = np.zeros(len(pr_ids))
    for f in _frames_union(gt, pred):
        gids, gpos = gt.get(f, (np.zeros(0, int), np.zeros((0, 3))))
        pids, ppos = pred.get(f, (np.zeros(0, int), np.zeros((0, 3))))
        for i in gids:
            gt_count[g_index[int(i)]] += 1
        for j in pids:
            pr_count[p_index[int(j)]] += 1
        sim = similarity(gpos, ppos)
        for gi, gid in enumerate(gids):
            for pj, pid in enumerate(pids):
                if sim[gi, pj] >= sim_thresh:
                    overlap[g_index[int(gid)], p_index[int(pid)]] += 1
    if not gt_ids or not pr_ids:
        return {"idf1": 0.0, "idtp": 0, "idfp": int(pr_count.sum()),
                "idfn": int(gt_count.sum())}
    rows, cols = linear_sum_assignment(-overlap)
    idtp = overlap[rows, cols].sum()
    idfn = gt_count.sum() - idtp
    idfp = pr_count.sum() - idtp
    idf1 = 2 * idtp / max(2 * idtp + idfp + idfn, 1)
    return {"idf1": float(idf1), "idtp": int(idtp), "idfp": int(idfp),
            "idfn": int(idfn)}


def hota(gt: Dict[int, Frame], pred: Dict[int, Frame],
         similarity: Callable = euclidean_similarity,
         alphas: Optional[np.ndarray] = None) -> Dict[str, float]:
    """HOTA = mean over alpha of sqrt(DetA * AssA).

    Per alpha: per-frame hungarian matching (similarity >= alpha) gives TPs;
    AssA of each TP = TPA / (TPA + FNA + FPA) over its (gt_id, pred_id) pair.
    """
    if alphas is None:
        alphas = np.arange(0.05, 1.0, 0.05)
    hotas, detas, assas = [], [], []
    for alpha in alphas:
        tp_pairs: List[Tuple[int, int]] = []
        n_fn = n_fp = 0
        for f in _frames_union(gt, pred):
            gids, gpos = gt.get(f, (np.zeros(0, int), np.zeros((0, 3))))
            pids, ppos = pred.get(f, (np.zeros(0, int), np.zeros((0, 3))))
            sim = similarity(gpos, ppos)
            matched_g, matched_p = set(), set()
            if len(gids) and len(pids):
                rows, cols = linear_sum_assignment(-sim)
                for r, c in zip(rows, cols):
                    if sim[r, c] >= alpha:
                        tp_pairs.append((int(gids[r]), int(pids[c])))
                        matched_g.add(r)
                        matched_p.add(c)
            n_fn += len(gids) - len(matched_g)
            n_fp += len(pids) - len(matched_p)
        tp = len(tp_pairs)
        if tp + n_fn + n_fp == 0:
            continue
        deta = tp / (tp + n_fn + n_fp)
        # association accuracy
        if tp:
            pair_counts: Dict[Tuple[int, int], int] = {}
            gid_counts: Dict[int, int] = {}
            pid_counts: Dict[int, int] = {}
            for g, p in tp_pairs:
                pair_counts[(g, p)] = pair_counts.get((g, p), 0) + 1
                gid_counts[g] = gid_counts.get(g, 0) + 1
                pid_counts[p] = pid_counts.get(p, 0) + 1
            ass = 0.0
            for (g, p), tpa in pair_counts.items():
                fna = gid_counts[g] - tpa
                fpa = pid_counts[p] - tpa
                ass += tpa * (tpa / (tpa + fna + fpa))
            assa = ass / tp
        else:
            assa = 0.0
        detas.append(deta)
        assas.append(assa)
        hotas.append(np.sqrt(deta * assa))
    return {"hota": float(np.mean(hotas)) if hotas else 0.0,
            "deta": float(np.mean(detas)) if detas else 0.0,
            "assa": float(np.mean(assas)) if assas else 0.0}


def evaluate_tracking(gt: Dict[int, Frame], pred: Dict[int, Frame],
                      max_dist: float = 1.0) -> Dict[str, float]:
    sim = lambda a, b: euclidean_similarity(a, b, max_dist)
    out = {}
    out.update(clear_mot(gt, pred, sim))
    out.update(id_f1(gt, pred, sim))
    out.update(hota(gt, pred, sim))
    return out


# ------------------------------------------------------------- track-mAP --
# TrackEval's TrackMAP (`TrackEval/trackeval/metrics/track_map.py`):
# tracks are spatio-temporal tubes; IoU between two tracks is
# sum-of-frame-intersections / sum-of-frame-unions (missing frames count
# their full box toward the union, :350-398), matched greedily per IoU
# threshold and accumulated with the COCO 101-point AP (TAO protocol),
# including the TAO area/time track subsets.

TRACKMAP_AREA_RANGES = {"area_s": (0.0, 32.0 ** 2),
                        "area_m": (32.0 ** 2, 96.0 ** 2),
                        "area_l": (96.0 ** 2, 1e5 ** 2)}
TRACKMAP_TIME_RANGES = {"time_s": (0, 3), "time_m": (3, 10),
                        "time_l": (10, 1e5)}


def track_bbox_iou(dt_track: Dict[int, np.ndarray],
                   gt_track: Dict[int, np.ndarray]) -> float:
    """Spatio-temporal IoU of two (frame -> xywh box) tracks
    (`track_map.py:350` _compute_bb_track_iou)."""
    intersect = 0.0
    union = 0.0
    for f in set(gt_track) | set(dt_track):
        g = gt_track.get(f)
        d = dt_track.get(f)
        if d is not None and g is not None:
            dx, dy, dw, dh = d
            gx, gy, gw, gh = g
            w = max(min(dx + dw, gx + gw) - max(dx, gx), 0.0)
            h = max(min(dy + dh, gy + gh) - max(dy, gy), 0.0)
            i = w * h
            intersect += i
            union += dw * dh + gw * gh - i
        elif g is not None:
            union += g[2] * g[3]
        elif d is not None:
            union += d[2] * d[3]
    return intersect / union if union > 0 else 0.0


def track_map(sequences, iou_thrs=None) -> Dict[str, float]:
    """Track-mAP over sequences.

    sequences: list of dicts with
      gt_tracks: {tid: {frame: (x, y, w, h)}}
      dt_tracks: {tid: {frame: (x, y, w, h)}}
      dt_scores: {tid: float}
    Returns TrackAP (mean over IoU .5:.95), TrackAP50/75, and the TAO
    area/time subset APs.
    """
    from romp_tpu_torch.eval.keypoint_ap import IOU_THRS, evaluate_ap

    iou_thrs = IOU_THRS if iou_thrs is None else np.asarray(iou_thrs)
    buckets: Dict[str, list] = {"all": []}
    for name in list(TRACKMAP_AREA_RANGES) + list(TRACKMAP_TIME_RANGES):
        buckets[name] = []

    for seq in sequences:
        gt_ids = sorted(seq["gt_tracks"])
        dt_ids = sorted(seq["dt_tracks"])
        gts = [seq["gt_tracks"][i] for i in gt_ids]
        dts = [seq["dt_tracks"][i] for i in dt_ids]
        scores = np.asarray([seq["dt_scores"][i] for i in dt_ids],
                            np.float64)
        ious = np.zeros((len(dts), len(gts)))
        for i, d in enumerate(dts):
            for j, g in enumerate(gts):
                ious[i, j] = track_bbox_iou(d, g)
        areas = np.asarray([np.mean([b[2] * b[3] for b in g.values()])
                            for g in gts]) if gts else np.zeros(0)
        lengths = np.asarray([len(g) for g in gts])
        base = {"ious": ious, "dt_scores": scores}
        buckets["all"].append({**base,
                               "gt_ignore": np.zeros(len(gts), bool)})
        for name, (lo, hi) in TRACKMAP_AREA_RANGES.items():
            ig = ~((areas >= lo) & (areas <= hi))
            buckets[name].append({**base, "gt_ignore": ig})
        for name, (lo, hi) in TRACKMAP_TIME_RANGES.items():
            ig = ~((lengths >= lo) & (lengths <= hi))
            buckets[name].append({**base, "gt_ignore": ig})

    out: Dict[str, float] = {}
    for name, recs in buckets.items():
        r = evaluate_ap(recs, iou_thrs)
        if name == "all":
            out["TrackAP"] = r["AP"]
            out["TrackAP50"] = r["AP50"]
            out["TrackAP75"] = r["AP75"]
        else:
            out[f"TrackAP_{name}"] = r["AP"]
    return out
