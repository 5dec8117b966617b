"""Extract subsampled frames from Human3.6M videos for training packs (the
port's copy of `romp_tpu/tools/extract_h36m_frames.py`; cv2 only).

Parity target: `romp/lib/dataset/preprocess/h36m_extract_frames.py` —
walks archives/<subject>/Videos/*.mp4, skips "_ALL" multiview files, and
writes every Nth frame as <subject>_<action>_<cam_id>_<idx>.jpg.
(The reference hardcodes a 20-frame debug cap and skips frame 0; here the
cap is a flag and the subsample phase is configurable.)

Usage:
    python -m romp_tpu_torch.tools.extract_h36m_frames <video_root> <out_dir>
           [--every 5] [--max-frames 0] [--subjects S1,S5,...]
"""
from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
from typing import List, Optional

SUBJECTS = ("S1", "S5", "S6", "S7", "S8", "S9", "S11")
CAMERA_IDS = {"54138969": 0, "55011271": 1, "58860488": 2, "60457274": 3}


def extract_video(video_file: str, out_dir: str, every: int = 5,
                  max_frames: int = 0,
                  subject_id: Optional[str] = None) -> List[str]:
    """One video -> jpg frames. Returns the written paths."""
    import cv2

    video_name = osp.basename(video_file)
    action_name, cam_str = video_name.rsplit(".", 1)[0].rsplit(".", 1) \
        if video_name.count(".") >= 2 else (video_name.rsplit(".", 1)[0], "0")
    cam_id = CAMERA_IDS.get(cam_str, cam_str)
    subject = subject_id or osp.basename(
        osp.dirname(osp.dirname(video_file)))
    stem = osp.join(out_dir, f"{subject}_{action_name}_{cam_id}")
    cap = cv2.VideoCapture(video_file)
    written: List[str] = []
    frame_idx = -1
    out_idx = 0
    while True:
        frame_idx += 1
        ret, frame = cap.read()
        if not ret:
            break
        if frame_idx % every != 0 or frame_idx == 0:
            continue
        path = f"{stem}_{out_idx}.jpg"
        cv2.imwrite(path, frame)
        written.append(path)
        out_idx += 1
        if max_frames and out_idx >= max_frames:
            break
    cap.release()
    return written


def extract_subject(subject_id: str, src_folder: str, out_folder: str,
                    every: int = 5, max_frames: int = 0) -> List[str]:
    videos = sorted(glob.glob(
        osp.join(src_folder, subject_id, "Videos", "*.mp4")))
    written: List[str] = []
    for v in videos:
        if "_ALL" in v:
            continue
        written += extract_video(v, out_folder, every, max_frames,
                                 subject_id=subject_id)
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("video_root")
    ap.add_argument("out_dir")
    ap.add_argument("--every", type=int, default=5)
    ap.add_argument("--max-frames", type=int, default=0,
                    help="cap per video (0 = all)")
    ap.add_argument("--subjects", default=",".join(SUBJECTS))
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    total = 0
    for s in args.subjects.split(","):
        n = len(extract_subject(s.strip(), args.video_root, args.out_dir,
                                args.every, args.max_frames))
        print(f"{s}: {n} frames")
        total += n
    print(f"total: {total}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
