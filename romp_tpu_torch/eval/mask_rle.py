"""COCO-style RLE mask operations — numpy port of the crowdpose-api C core
(a copy of `romp_tpu/eval/mask_rle.py`).

Parity: `romp/lib/evaluation/crowdpose-api/common/maskApi.c` — rleEncode
(:22), rleDecode (:39), rleMerge (:53), rleArea (:98), rleIou (:106),
rleToBbox (:141), bbIou (:160) — and the `_mask.pyx` wrapper semantics
(column-major / Fortran order bit layout, uncompressed {"size", "counts"}
dicts with leading-zero run convention).

Everything is vectorized numpy on the host (eval-only code, not a device
path); the LEB128-style compressed string codec of the C API is also
provided for reading official annotation files.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

Rle = Dict[str, Union[tuple, list, np.ndarray, bytes]]


def encode(mask: np.ndarray) -> Rle:
    """Binary mask (H, W) -> uncompressed RLE dict (column-major runs,
    first run counts zeros — maskApi.c:22 rleEncode)."""
    H, W = mask.shape
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    # run-length encode with a leading zero-run
    diffs = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], diffs, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    return {"size": (H, W), "counts": counts}


def decode(rle: Rle) -> np.ndarray:
    """RLE dict -> binary mask (H, W) uint8 (maskApi.c:39 rleDecode)."""
    H, W = rle["size"]
    counts = _counts_array(rle)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size < H * W:
        flat = np.concatenate([flat, np.zeros(H * W - flat.size, np.uint8)])
    return flat[:H * W].reshape((H, W), order="F")


def _counts_array(rle: Rle) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (bytes, str)):
        return np.asarray(_decompress_counts(c), np.int64)
    return np.asarray(c, np.int64)


def area(rle: Rle) -> int:
    """Foreground pixel count (maskApi.c:98 rleArea)."""
    counts = _counts_array(rle)
    return int(counts[1::2].sum())


def to_bbox(rle: Rle) -> np.ndarray:
    """RLE -> (x, y, w, h) tight bbox (maskApi.c:141 rleToBbox)."""
    H, W = rle["size"]
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if not len(ys):
        return np.zeros(4, np.float64)
    return np.asarray([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                       ys.max() - ys.min() + 1], np.float64)


def merge(rles: Sequence[Rle], intersect: bool = False) -> Rle:
    """Union (or intersection) of masks (maskApi.c:53 rleMerge)."""
    if not rles:
        return {"size": (0, 0), "counts": [0]}
    m = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m2 = decode(r).astype(bool)
        m = (m & m2) if intersect else (m | m2)
    return encode(m.astype(np.uint8))


def iou_masks(dt: Sequence[Rle], gt: Sequence[Rle],
              iscrowd: Sequence[int]) -> np.ndarray:
    """Pairwise mask IoU (maskApi.c:106 rleIou). For crowd GT the
    denominator is the DT area only (detections inside a crowd region score
    full overlap)."""
    out = np.zeros((len(dt), len(gt)), np.float64)
    dts = [decode(d).astype(bool) for d in dt]
    gts = [decode(g).astype(bool) for g in gt]
    for j, g in enumerate(gts):
        crowd = bool(iscrowd[j]) if j < len(iscrowd) else False
        ga = g.sum()
        for i, d in enumerate(dts):
            inter = np.logical_and(d, g).sum()
            da = d.sum()
            union = da if crowd else da + ga - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def iou_boxes(dt: np.ndarray, gt: np.ndarray,
              iscrowd: Sequence[int]) -> np.ndarray:
    """Pairwise bbox IoU, boxes (x, y, w, h) (maskApi.c:160 bbIou)."""
    dt = np.asarray(dt, np.float64).reshape(-1, 4)
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    out = np.zeros((len(dt), len(gt)), np.float64)
    for j, (gx, gy, gw, gh) in enumerate(gt):
        crowd = bool(iscrowd[j]) if j < len(iscrowd) else False
        ga = gw * gh
        for i, (dx, dy, dw, dh) in enumerate(dt):
            iw = min(dx + dw, gx + gw) - max(dx, gx)
            ih = min(dy + dh, gy + gh) - max(dy, gy)
            if iw <= 0 or ih <= 0:
                continue
            inter = iw * ih
            da = dw * dh
            union = da if crowd else da + ga - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


# ------------------------- compressed counts codec (maskApi.c rleToString) --

def _compress_counts(counts: Sequence[int]) -> bytes:
    """LEB128-with-sign-delta codec used by pycocotools (`maskApi.c:187`)."""
    out = bytearray()
    prev2 = 0
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return bytes(out)


def _decompress_counts(s: Union[bytes, str]) -> List[int]:
    """Inverse of _compress_counts (`maskApi.c:205` rleFrString)."""
    if isinstance(s, str):
        s = s.encode()
    counts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            ch = s[p] - 48
            x |= (ch & 0x1F) << (5 * k)
            more = bool(ch & 0x20)
            p += 1
            k += 1
            if not more and (ch & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def frUncompressed(rle: Rle) -> Rle:
    """Normalize any counts representation to a plain int list."""
    return {"size": tuple(rle["size"]), "counts": _counts_array(rle).tolist()}


def toCompressed(rle: Rle) -> Rle:
    return {"size": tuple(rle["size"]),
            "counts": _compress_counts(_counts_array(rle).tolist())}
