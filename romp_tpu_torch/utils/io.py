"""Host IO: image preprocessing, result saving, video collection, webcam.

Parity: `simple_romp/romp/utils.py:16-144` (padding_image, img_preprocess,
ResultSaver, save_video_results, WebcamVideoStream). cv2 is used when
available; preprocessing falls back to numpy + PIL-free bilinear otherwise.
"""
from __future__ import annotations

import os
import os.path as osp
from threading import Thread
from typing import Dict, List, Optional, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def padding_image(image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad to square, centered; returns (padded, pad_info) where
    pad_info = (top, bottom, left, right, h, w) (`utils.py:16-24`)."""
    h, w = image.shape[:2]
    side = max(h, w)
    pad = np.zeros((side, side, 3), dtype=image.dtype)
    top, left = (side - h) // 2, (side - w) // 2
    pad[top:top + h, left:left + w] = image
    info = np.array([top, top + h, left, left + w, h, w], np.float32)
    return pad, info


def img_preprocess(image_bgr: np.ndarray, input_size: int = 512
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """BGR uint8 -> (1, S, S, 3) float RGB in [0, 255] + pad info
    (`utils.py:26-30`; cubic resize like the reference)."""
    image = image_bgr[..., ::-1]
    pad, info = padding_image(image)
    if cv2 is not None:
        resized = cv2.resize(np.ascontiguousarray(pad),
                             (input_size, input_size),
                             interpolation=cv2.INTER_CUBIC)
    else:
        idx = (np.arange(input_size) * (pad.shape[0] / input_size)).astype(int)
        resized = pad[idx][:, idx]
    return resized[None].astype(np.float32), info


class ResultSaver:
    """npz + rendered-frame writer (`utils.py:43-86`)."""

    def __init__(self, mode: str = "image", save_path: str = "output",
                 save_npz: bool = True):
        self.is_dir = len(osp.splitext(save_path)[1]) == 0
        self.mode = mode
        self.save_path = save_path
        self.save_npz = save_npz
        self.save_dir = save_path if self.is_dir else osp.dirname(save_path)
        if self.mode in ("image", "video") and self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
        self.frame_save_paths: List[str] = []

    def __call__(self, outputs: Optional[Dict], input_path: str,
                 prefix: Optional[str] = None, img_ext: str = ".png"):
        if self.mode == "video" or self.is_dir:
            name = osp.splitext(osp.basename(input_path))[0] + img_ext
            save_path = osp.join(self.save_dir, name)
        else:
            save_path = self.save_path
        if prefix is not None:
            root, ext = osp.splitext(save_path)
            save_path = f"{root}_{prefix}{ext}"

        rendered = None
        if outputs is not None:
            outputs = dict(outputs)
            rendered = outputs.pop("rendered_image", None)
            if self.save_npz:
                np.savez(osp.splitext(save_path)[0] + ".npz", results=outputs)
        if rendered is None and cv2 is not None and osp.exists(input_path):
            rendered = cv2.imread(input_path)
        if rendered is not None and cv2 is not None:
            cv2.imwrite(save_path, rendered)
        if self.mode == "video":
            self.frame_save_paths.append(save_path)

    def save_video(self, save_path: str, frame_rate: int = 24):
        if not self.frame_save_paths or cv2 is None:
            return
        h, w = cv2.imread(self.frame_save_paths[0]).shape[:2]
        writer = cv2.VideoWriter(
            save_path, cv2.VideoWriter_fourcc(*"mp4v"), frame_rate, (w, h))
        for p in self.frame_save_paths:
            writer.write(cv2.imread(p))
        writer.release()


def save_video_results(frame_save_paths: List[str]) -> str:
    """Aggregate per-frame npz into video_results.npz with per-track
    sequences (`utils.py:88-110`)."""
    video_results, seq_results = {}, {}
    for fid, p in enumerate(frame_save_paths):
        npz = osp.splitext(p)[0] + ".npz"
        if not osp.exists(npz):
            continue
        fr = np.load(npz, allow_pickle=True)["results"][()]
        video_results[osp.basename(p)] = fr
        if "track_ids" not in fr:
            continue
        for j, tid in enumerate(fr["track_ids"]):
            tid = int(tid)
            if tid not in seq_results:
                seq_results[tid] = {"frame_id": []}
            seq_results[tid]["frame_id"].append(fid)
            for k in fr:
                seq_results[tid].setdefault(k, []).append(fr[k][j])
    out = osp.join(osp.dirname(frame_save_paths[0]), "video_results.npz")
    np.savez(out, results=video_results, sequence_results=seq_results)
    return out


def collect_image_paths(path: str) -> List[str]:
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    if osp.isdir(path):
        return sorted(osp.join(path, f) for f in os.listdir(path)
                      if f.lower().endswith(exts))
    return [path]


def extract_video_frames(video_path: str, out_dir: str) -> List[str]:
    assert cv2 is not None, "cv2 required for video decoding"
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    paths = []
    fid = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        p = osp.join(out_dir, f"{fid:08d}.jpg")
        cv2.imwrite(p, frame)
        paths.append(p)
        fid += 1
    cap.release()
    return paths


class WebcamVideoStream:
    """Threaded webcam reader (`utils.py:112-144`)."""

    def __init__(self, src: int = 0):
        assert cv2 is not None, "cv2 required for webcam capture"
        self.stream = cv2.VideoCapture(src)
        self.grabbed, self.frame = self.stream.read()
        self.stopped = False
        self._thread = None

    def start(self):
        self._thread = Thread(target=self._update, daemon=True)
        self._thread.start()
        return self

    def _update(self):
        while not self.stopped:
            self.grabbed, self.frame = self.stream.read()

    def read(self):
        return self.frame

    def stop(self):
        self.stopped = True
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        self.stream.release()
