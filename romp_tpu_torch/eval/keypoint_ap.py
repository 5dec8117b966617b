"""OKS keypoint Average Precision — the crowdpose-api evaluation protocol
(a copy of `romp_tpu/eval/keypoint_ap.py`).

Parity: `romp/lib/evaluation/crowdpose-api/crowdpose/cocoeval.py` (a
pycocotools fork): OKS similarity with per-joint sigmas, greedy per-image
matching at IoU thresholds .5:.05:.95, 101-point interpolated AP, and
CrowdPose's AP(easy/medium/hard) split by the image crowdIndex. Mask/bbox
IoU variants come from `romp_tpu_torch.eval.mask_rle` (maskApi port).

Pure-numpy host code consuming CrowdPose/COCO-format json dicts
(`romp/test.py:96` test_crowdpose feeds detections in this format).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# CrowdPose 14-joint OKS sigmas (crowdpose-api cocoeval.py `self.kpt_oks_sigmas`)
CROWDPOSE_SIGMAS = np.array(
    [.79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89,
     .79, .79]) / 10.0
# COCO 17-joint sigmas (pycocotools)
COCO_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
     .87, .87, .89, .89]) / 10.0

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)


def oks_iou(gt_kps: np.ndarray, gt_areas: np.ndarray,
            dt_kps: np.ndarray, sigmas: np.ndarray) -> np.ndarray:
    """OKS matrix (n_dt, n_gt). gt_kps/dt_kps: (N, J, 3) with v flags on GT;
    gt_areas: (N,). Matches cocoeval.computeOks."""
    n_dt, n_gt = len(dt_kps), len(gt_kps)
    ious = np.zeros((n_dt, n_gt))
    vars_ = (sigmas * 2) ** 2
    for j in range(n_gt):
        g = gt_kps[j]
        vg = g[:, 2] > 0
        for i in range(n_dt):
            d = dt_kps[i]
            dx = d[:, 0] - g[:, 0]
            dy = d[:, 1] - g[:, 1]
            e = (dx ** 2 + dy ** 2) / vars_ / (gt_areas[j]
                                               + np.spacing(1)) / 2.0
            if vg.sum() > 0:
                e = e[vg]
            ious[i, j] = np.mean(np.exp(-e))
    return ious


def _match_image(ious: np.ndarray, dt_scores: np.ndarray,
                 gt_ignore: np.ndarray, thrs: np.ndarray):
    """Greedy per-image matching (cocoeval.evaluateImg).

    Returns (dt_matched (T, n_dt) gt index or -1, dt_ignore (T, n_dt))."""
    T = len(thrs)
    n_dt, n_gt = ious.shape
    order = np.argsort(-dt_scores, kind="mergesort")
    gtm = np.full((T, n_gt), -1, np.int64)
    dtm = np.full((T, n_dt), -1, np.int64)
    dt_ig = np.zeros((T, n_dt), bool)
    # gts sorted so non-ignored come first
    g_order = np.argsort(gt_ignore, kind="mergesort")
    for t, thr in enumerate(thrs):
        for di in order:
            best = thr
            m = -1
            for gi in g_order:
                if gtm[t, gi] >= 0 and not gt_ignore[gi]:
                    continue
                # stop at ignored gts once a real match was found
                if m > -1 and not gt_ignore[g_order[0]] and gt_ignore[gi] \
                        and not gt_ignore[m]:
                    break
                if ious[di, gi] < best:
                    continue
                best = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dtm[t, di] = m
            gtm[t, m] = di
            dt_ig[t, di] = bool(gt_ignore[m])
    return dtm, dt_ig


def evaluate_ap(per_image: Sequence[Dict],
                iou_thrs: np.ndarray = IOU_THRS) -> Dict[str, float]:
    """AP/AR over a list of per-image eval dicts.

    Each dict: ious (n_dt, n_gt), dt_scores (n_dt,), gt_ignore (n_gt,).
    Returns AP (mean over thresholds), AP50, AP75, AR. Accumulation follows
    cocoeval.accumulate: scores pooled across images, 101-point precision
    interpolation.
    """
    T = len(iou_thrs)
    all_scores, all_matched, all_ignored = [], [], []
    n_gt_total = 0
    for img in per_image:
        ious = np.asarray(img["ious"], np.float64)
        scores = np.asarray(img["dt_scores"], np.float64)
        gt_ignore = np.asarray(img.get(
            "gt_ignore", np.zeros(ious.shape[1], bool)), bool)
        n_gt_total += int((~gt_ignore).sum())
        if ious.size == 0:
            ious = ious.reshape(len(scores), -1)
        dtm, dt_ig = _match_image(ious, scores, gt_ignore, iou_thrs)
        all_scores.append(scores)
        all_matched.append(dtm >= 0)
        all_ignored.append(dt_ig)
    if n_gt_total == 0:
        return {"AP": -1.0, "AP50": -1.0, "AP75": -1.0, "AR": -1.0}
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    matched = (np.concatenate(all_matched, axis=1) if all_matched
               else np.zeros((T, 0), bool))
    ignored = (np.concatenate(all_ignored, axis=1) if all_ignored
               else np.zeros((T, 0), bool))
    order = np.argsort(-scores, kind="mergesort")
    matched = matched[:, order]
    ignored = ignored[:, order]

    ap_t = np.zeros(T)
    ar_t = np.zeros(T)
    for t in range(T):
        keep = ~ignored[t]
        tp = np.cumsum(matched[t][keep]).astype(np.float64)
        fp = np.cumsum(~matched[t][keep]).astype(np.float64)
        recall = tp / n_gt_total
        precision = tp / np.maximum(tp + fp, np.spacing(1))
        # precision envelope (monotone non-increasing from the right)
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        inds = np.searchsorted(recall, RECALL_THRS, side="left")
        q = np.zeros(len(RECALL_THRS))
        for ri, pi in enumerate(inds):
            if pi < len(precision):
                q[ri] = precision[pi]
        ap_t[t] = q.mean()
        ar_t[t] = recall[-1] if len(recall) else 0.0
    return {"AP": float(ap_t.mean()),
            "AP50": float(ap_t[0]),
            "AP75": float(ap_t[5]) if T > 5 else float("nan"),
            "AR": float(ar_t.mean())}


def crowdpose_keypoint_eval(gt_doc: Dict, dt_list: List[Dict],
                            sigmas: Optional[np.ndarray] = None
                            ) -> Dict[str, float]:
    """Full CrowdPose protocol: GT json dict ({images, annotations}) +
    detection list ([{image_id, keypoints, score}]) -> AP metrics incl. the
    crowdIndex split AP(easy <=0.1 / medium / hard >0.8)
    (crowdpose-api cocoeval.py summarize())."""
    sigmas = CROWDPOSE_SIGMAS if sigmas is None else sigmas
    images = {im["id"]: im for im in gt_doc["images"]}
    gt_by_img: Dict[int, List[Dict]] = {}
    for ann in gt_doc["annotations"]:
        gt_by_img.setdefault(ann["image_id"], []).append(ann)
    dt_by_img: Dict[int, List[Dict]] = {}
    for det in dt_list:
        dt_by_img.setdefault(det["image_id"], []).append(det)

    buckets = {"all": [], "easy": [], "medium": [], "hard": []}
    # union of GT and DT image ids: detections on GT-less images must still
    # pool as unmatched false positives (cocoeval evaluates all images)
    all_img_ids = set(gt_by_img) | set(dt_by_img)
    for img_id in all_img_ids:
        gts = gt_by_img.get(img_id, [])
        J = len(sigmas)
        if gts:
            gt_kps = np.stack([np.asarray(g["keypoints"], np.float64
                                          ).reshape(J, 3) for g in gts])
            gt_areas = np.asarray([
                g.get("area") or g["bbox"][2] * g["bbox"][3] for g in gts],
                np.float64)
            gt_ignore = np.asarray(
                [bool(g.get("iscrowd", 0)) or (g["keypoints"][2::3]
                                               and max(g["keypoints"][2::3])
                                               == 0)
                 for g in gts], bool)
        else:
            gt_kps = np.zeros((0, J, 3))
            gt_areas = np.zeros(0)
            gt_ignore = np.zeros(0, bool)
        dts = dt_by_img.get(img_id, [])
        if dts:
            dt_kps = np.stack([np.asarray(d["keypoints"], np.float64
                                          ).reshape(J, 3) for d in dts])
            scores = np.asarray([d["score"] for d in dts], np.float64)
            ious = oks_iou(gt_kps, gt_areas, dt_kps, sigmas)
        else:
            scores = np.zeros(0)
            ious = np.zeros((0, len(gts)))
        rec = {"ious": ious, "dt_scores": scores, "gt_ignore": gt_ignore}
        buckets["all"].append(rec)
        ci = images.get(img_id, {}).get("crowdIndex", 0.0)
        level = "easy" if ci <= 0.1 else ("hard" if ci > 0.8 else "medium")
        buckets[level].append(rec)

    out = {}
    for name, recs in buckets.items():
        r = evaluate_ap(recs)
        suffix = "" if name == "all" else f"_{name}"
        out[f"AP{suffix}"] = r["AP"]
        if name == "all":
            out["AP50"], out["AP75"], out["AR"] = (r["AP50"], r["AP75"],
                                                   r["AR"])
    return out
