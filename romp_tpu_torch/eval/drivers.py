"""Benchmark evaluation drivers: dataset -> pipeline -> matched metrics
(counterpart of `romp_tpu/eval/drivers.py`, over the port's metrics).

Parity targets: `romp/test.py` (Demo.test_eval), `romp/eval.py:93`
(val_result), `simple_romp/evaluation/eval_Relative_Human.py`,
`trace2/evaluation/evaluate_tracking.py`. The reference's "test strategy"
IS benchmark evaluation (SURVEY.md §4); these drivers reproduce the
protocols on our pipelines:

- `evaluate_mesh_dataset`: images + GT (kp3d/verts) -> matched MPJPE /
  PA-MPJPE / PVE (3DPW-style protocols; matching by projected-center
  distance as `romp/lib/maps_utils/result_parser.py` does for eval)
- `evaluate_relative_human`: depth-order PCRD + age accuracy from BEV
  outputs
- `evaluate_sequence_tracking`: TRACE outputs vs GT trajectories -> MOTA /
  IDF1 / HOTA
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from romp_tpu_torch.eval.metrics import evaluate_matched_pairs
from romp_tpu_torch.eval.mot_metrics import evaluate_tracking


def match_by_center(gt_centers: np.ndarray, pred_centers: np.ndarray,
                    max_dist: float = 100.0) -> List[Tuple[int, int]]:
    """Greedy nearest-center matching of GT persons to predictions
    (the protocol used by the reference eval drivers)."""
    if len(gt_centers) == 0 or len(pred_centers) == 0:
        return []
    from scipy.optimize import linear_sum_assignment

    d = np.linalg.norm(gt_centers[:, None] - pred_centers[None], axis=-1)
    rows, cols = linear_sum_assignment(d)
    return [(int(r), int(c)) for r, c in zip(rows, cols)
            if d[r, c] <= max_dist]


def evaluate_mesh_dataset(
        run_image: Callable[[np.ndarray], Optional[Dict[str, np.ndarray]]],
        samples: Iterable[Dict[str, np.ndarray]],
        align_inds=(45, 46)) -> Dict[str, float]:
    """samples yield dicts: image (H, W, 3 BGR), gt_kp3d (P, J, 3),
    gt_centers (P, 2 px), optional gt_verts (P, V, 3).

    run_image: the ROMP/BEV python API (image -> masked outputs with
    'joints', 'pj2d_org', optional 'verts').
    """
    gt_j, pr_j, gt_v, pr_v = [], [], [], []
    n_gt = n_matched = 0
    for s in samples:
        out = run_image(s["image"])
        gt_centers = s["gt_centers"]
        n_gt += len(gt_centers)
        if out is None or "joints" not in out:
            continue
        pred_centers = out["pj2d_org"][:, :24].mean(axis=1)
        for gi, pi in match_by_center(gt_centers, pred_centers):
            J = s["gt_kp3d"].shape[1]
            gt_j.append(s["gt_kp3d"][gi])
            pr_j.append(out["joints"][pi][:J])
            if "gt_verts" in s and "verts" in out:
                gt_v.append(s["gt_verts"][gi])
                pr_v.append(out["verts"][pi])
            n_matched += 1
    if not gt_j:
        return {"n_gt": n_gt, "n_matched": 0}
    res = evaluate_matched_pairs(
        np.stack(gt_j), np.stack(pr_j),
        np.stack(gt_v) if gt_v else None,
        np.stack(pr_v) if pr_v else None, align_inds=align_inds)
    res.update({"n_gt": n_gt, "n_matched": n_matched,
                "recall": n_matched / max(n_gt, 1)})
    return res


def evaluate_relative_human(
        run_image: Callable[[np.ndarray], Optional[Dict[str, np.ndarray]]],
        samples: Iterable[Dict[str, np.ndarray]]) -> Dict[str, float]:
    """samples yield: image, gt_centers (P, 2), depth_ordering (P, P; see
    metrics.relative_depth_accuracy), age_groups (P,) with -1 unannotated."""
    from romp_tpu_torch.eval.metrics import (
        age_group_accuracy, relative_depth_accuracy,
    )

    pcrds, kid_preds, age_gts = [], [], []
    for s in samples:
        out = run_image(s["image"])
        if out is None:
            continue
        pred_centers = out["pj2d_org"][:, :24].mean(axis=1)
        pairs = match_by_center(s["gt_centers"], pred_centers)
        if len(pairs) < 2:
            continue
        gis = [g for g, _ in pairs]
        pis = [p for _, p in pairs]
        depths = out["cam_trans"][pis, 2]
        order = s["depth_ordering"][np.ix_(gis, gis)]
        pcrd = relative_depth_accuracy(depths, order)
        if np.isfinite(pcrd):
            pcrds.append(pcrd)
        if "age_groups" in s and out.get("smpl_betas") is not None \
                and out["smpl_betas"].shape[-1] >= 11:
            kid_preds.extend(out["smpl_betas"][pis, 10])
            age_gts.extend(s["age_groups"][gis])
    res = {"pcrd": float(np.mean(pcrds)) if pcrds else float("nan")}
    if age_gts:
        res.update({f"age_{k}": v for k, v in age_group_accuracy(
            np.asarray(kid_preds), np.asarray(age_gts)).items()})
    return res


def evaluate_sequence_tracking(gt_tracks: Dict[int, Tuple[np.ndarray, np.ndarray]],
                               pred_tracks: Dict[int, Tuple[np.ndarray, np.ndarray]],
                               max_dist: float = 1.0) -> Dict[str, float]:
    """Thin alias over the MOT metric suite for TRACE sequence outputs."""
    return evaluate_tracking(gt_tracks, pred_tracks, max_dist=max_dist)
