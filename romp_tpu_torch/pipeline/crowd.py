"""Crowd / long-image mode: sliding-window BEV over panoramas (the port's
copy of `romp_tpu/pipeline/crowd.py`, driving the port's BevPipeline).

Parity: `simple_romp/bev/split2process.py` + `bev/main.py:184-258`
(process_long_image). All square crops go through the pipeline as ONE
batch instead of the reference's per-crop loop.

Host-side merge steps (dynamic person counts after masking):
- boundary-subject exclusion in overlap regions (cam-x thresholds)
- crop-cam -> full-image cam remap
- global duplicate suppression + outlier removal (numpy twins of the masked
  device versions in bev_pipeline, same math).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def padding_image_overlap(image: np.ndarray, overlap_ratio: float = 0.46
                          ) -> Tuple[np.ndarray, np.ndarray, int]:
    h, w = image.shape[:2]
    pad_length = int(h * overlap_ratio)
    pad_image = np.zeros((h, w + 2 * pad_length, 3), dtype=image.dtype)
    pad_image[:, pad_length:pad_length + w] = image
    # pad info expressed as if square-padded (reference quirk kept)
    top = (w - h) // 2
    info = np.array([top, w - top, 0, w, h, w], np.float32)
    return pad_image, info, pad_length


def get_image_split_plan(image: np.ndarray, overlap_ratio: float = 0.46
                         ) -> np.ndarray:
    """(N, 4) crop boxes [left, right, top, bottom], h x h windows sliding
    with the given overlap; last window right-aligned."""
    h, w = image.shape[:2]
    slide_time = int(np.ceil((w / h - 1) / (1 - overlap_ratio))) + 1
    step = (1 - overlap_ratio) * h
    boxes = []
    for i in range(slide_time):
        left = w - h if i == slide_time - 1 else step * i
        boxes.append([left, left + h, 0, h])
    return np.asarray(boxes, np.int32)


def exclude_boundary_mask(cam_x: np.ndarray, drop_boundary_ratio: float,
                          side: str, tolerance: float = 0.0) -> np.ndarray:
    """True for persons to KEEP (not in the dropped overlap strip)."""
    if side == "left":
        return ~(cam_x > (1 - drop_boundary_ratio + tolerance))
    return ~(cam_x < (drop_boundary_ratio - 1 - tolerance))


def convert_crop_cam_to_full_image(cam: np.ndarray, crop_box: np.ndarray,
                                   image_hw: Tuple[int, int]) -> np.ndarray:
    """Remap (s, ty, tx) from crop coords to the full panorama
    (`split2process.py:48-58`)."""
    h, w = image_hw
    scale_adjust = max(crop_box[1] - crop_box[0],
                       crop_box[3] - crop_box[2]) / max(h, w)
    cam = cam * scale_adjust
    bbox_mean_x = (crop_box[0] + crop_box[1]) / 2.0
    cam[:, 2] += bbox_mean_x / (w / 2.0) - 1.0
    return cam


def np_suppress_duplicates(pj2d: np.ndarray, scales: np.ndarray,
                           confs: np.ndarray, img_max_len: float,
                           nms_thresh: float) -> np.ndarray:
    """Numpy twin of bev_pipeline.suppress_duplicates with conf-based choice
    (crowd mode uses conf_based=True, `bev/main.py:251`)."""
    N = len(scales)
    keep = np.ones(N, bool)
    if N <= 1:
        return keep
    d = np.linalg.norm(pj2d[:, None] - pj2d[None], axis=-1).mean(-1)
    ps = scales * 2.0
    dn = d / np.maximum(ps[:, None], ps[None, :])
    thresh = nms_thresh * img_max_len / 640.0
    for i in range(N):
        for j in range(i + 1, N):
            if dn[i, j] < thresh:
                keep[i if confs[i] < confs[j] else j] = False
    return keep


def np_remove_outliers(cam_trans: np.ndarray, scales: np.ndarray,
                       relative_scale_thresh: float,
                       scale_thresh: float) -> np.ndarray:
    N = len(scales)
    keep = np.ones(N, bool)
    if N < 3:
        return keep
    d = np.linalg.norm(cam_trans[:, None] - cam_trans[None], axis=-1)
    d_sorted = np.sort(d, axis=1)[:, 1:-1]
    mean_dist = d_sorted.mean(1)
    others = (mean_dist.sum() - mean_dist) / (N - 1)
    rel = mean_dist / (others + 1e-8)
    keep &= ~((rel > relative_scale_thresh) & (scales < scale_thresh))
    return keep


def np_bev_cam_to_trans(cam: np.ndarray) -> np.ndarray:
    """numpy twin of bev_pipeline.bev_cam_to_trans (FOV 60 deg)."""
    tan = float(np.tan(np.radians(30.0)))
    depth = 1.0 / (cam[..., 0] * tan + 1e-3)
    xy = np.stack([cam[..., 2], cam[..., 1]], axis=-1) * depth[..., None] * tan
    return np.concatenate([xy, depth[..., None]], axis=-1)


def np_perspective_projection(points: np.ndarray, translation: np.ndarray,
                              focal_length: float = 443.4,
                              img_size: float = 512.0) -> np.ndarray:
    """numpy twin of ops.projection.perspective_projection (normalized)."""
    p = points + translation[..., None, :]
    z = np.maximum(p[..., 2], 1e-6)
    return np.stack([p[..., 0] / z, p[..., 1] / z],
                    axis=-1) * focal_length / (img_size / 2.0)


def process_long_image(bev_pipeline, image: np.ndarray, settings
                       ) -> Optional[Dict[str, np.ndarray]]:
    """Full crowd-mode flow. `bev_pipeline` is a BevPipeline; `settings`
    needs overlap_ratio / nms_thresh / relative_scale_thresh / input_size.

    The merge math below is numpy on the host: the pipeline's outputs
    come back once, as one batch."""
    from romp_tpu_torch.pipeline.video import filter_valid

    try:
        import cv2
    except ImportError:
        cv2 = None

    pad_img, pad_info, pad_length = padding_image_overlap(
        image, settings.overlap_ratio)
    boxes = get_image_split_plan(pad_img, settings.overlap_ratio)
    fh = pad_img.shape[0]
    size = settings.input_size

    crops = []
    for (l, r, t, b) in boxes:
        crop = pad_img[t:b, l:r]
        if cv2 is not None:
            crop = cv2.resize(crop, (size, size),
                              interpolation=cv2.INTER_CUBIC)
        else:
            idx = (np.arange(size) * (crop.shape[0] / size)).astype(int)
            crop = crop[idx][:, idx]
        crops.append(crop.astype(np.float32))
    out = bev_pipeline(np.stack(crops))   # ONE device call for all windows
    out = {k: v.cpu().numpy() for k, v in out.items()}

    per_crop: List[Optional[Dict[str, np.ndarray]]] = []
    for cid in range(len(boxes)):
        res = filter_valid(out, cid)
        per_crop.append(res if res.get("cam", np.zeros((0,))).shape[0] else None)

    # Boundary exclusion in overlaps (this crop's right strip, next's left).
    for cid, res in enumerate(per_crop):
        if res is None or cid == len(boxes) - 1:
            continue
        ratio = (boxes[cid, 1] - boxes[cid + 1, 0]) / fh / 2.0
        keep = exclude_boundary_mask(res["cam"][:, 2], ratio, "left")
        per_crop[cid] = {k: v[keep] for k, v in res.items()}
        nxt = per_crop[cid + 1]
        if nxt is not None and cid + 1 != len(boxes) - 1:
            keep_n = exclude_boundary_mask(nxt["cam"][:, 2], ratio, "right")
            per_crop[cid + 1] = {k: v[keep_n] for k, v in nxt.items()}

    # Remap cams to the full image and merge.
    merged: Dict[str, List[np.ndarray]] = {}
    for cid, res in enumerate(per_crop):
        if res is None or res["cam"].shape[0] == 0:
            continue
        box = boxes[cid].astype(np.float32).copy()
        box[:2] -= pad_length
        res = dict(res)
        res["cam"] = convert_crop_cam_to_full_image(
            res["cam"].copy(), box, image.shape[:2])
        for k, v in res.items():
            merged.setdefault(k, []).append(v)
    if not merged:
        return None
    outputs = {k: np.concatenate(v) for k, v in merged.items()}

    # Re-project with full-image cams; global pruning.
    outputs["cam_trans"] = np_bev_cam_to_trans(outputs["cam"])
    if "joints" in outputs:
        outputs["pj2d"] = np_perspective_projection(
            outputs["joints"], outputs["cam_trans"], img_size=size)
        keep = np_suppress_duplicates(
            outputs["pj2d"], outputs["cam"][:, 0], outputs["center_confs"],
            float(max(image.shape[:2])), settings.nms_thresh)
        outputs = {k: v[keep] for k, v in outputs.items()}
    keep = np_remove_outliers(outputs["cam_trans"], outputs["cam"][:, 0],
                              settings.relative_scale_thresh, 0.5)
    outputs = {k: v[keep] for k, v in outputs.items()}
    outputs["pad_info"] = pad_info
    return outputs
