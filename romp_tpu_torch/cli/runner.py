"""Mode loops (image / video / webcam) shared by romp/bev CLIs.

Parity: `simple_romp/romp/main.py:178-204` main() dispatch.
"""
from __future__ import annotations

import os.path as osp
import sys
import tempfile

import numpy as np


def run_tool(model, settings) -> int:
    """Dispatch the mode loop, optionally wrapping the model so every
    frame's results are also broadcast to TCP clients (the reference's
    webcam→Blender live-mocap flow, `scripts/webcam_blender.sh`)."""
    server = None
    if getattr(settings, "socket_stream", False):
        from romp_tpu_torch.vis.socket_server import ResultsServer

        server = ResultsServer(port=settings.socket_port)
        print(f"streaming SMPL results on tcp://127.0.0.1:{server.port}")
        inner, frame_ids = model, iter(range(1 << 31))

        def model(frame):  # noqa: F811 — deliberate wrap
            out = inner(frame)
            if out is not None:
                server.broadcast(out, frame_id=next(frame_ids))
            return out

    try:
        return _run_modes(model, settings)
    finally:
        if server is not None:
            server.close()


def _run_modes(model, settings) -> int:
    try:
        import cv2
    except ImportError:
        print("cv2 required for CLI IO", file=sys.stderr)
        return 1
    from romp_tpu_torch.utils.io import (
        ResultSaver, collect_image_paths, extract_video_frames,
        save_video_results, WebcamVideoStream,
    )

    if settings.mode == "image":
        assert settings.input, "--input required"
        saver = ResultSaver(mode="image", save_path=settings.save_path)
        paths = collect_image_paths(settings.input)
        if not paths:
            print(f"error: no images found at {settings.input!r}",
                  file=sys.stderr)
            return 1
        for path in paths:
            image = cv2.imread(path)
            if image is None:
                print(f"error: cannot read image {path!r}", file=sys.stderr)
                return 1
            outputs = model(image)
            saver(outputs, path)
        return 0

    if settings.mode == "video":
        assert settings.input, "--input required"
        frame_dir = settings.input
        if osp.isfile(settings.input):
            frame_dir = tempfile.mkdtemp(prefix="romp_tpu_frames_")
            frame_paths = extract_video_frames(settings.input, frame_dir)
        else:
            frame_paths = collect_image_paths(frame_dir)
        saver = ResultSaver(mode="video", save_path=settings.save_path)
        for path in frame_paths:
            outputs = model(cv2.imread(path))
            saver(outputs, path)
        if settings.save_video:
            saver.save_video(osp.join(settings.save_path, "result.mp4"),
                             frame_rate=settings.frame_rate)
        if saver.frame_save_paths:
            save_video_results(saver.frame_save_paths)
        return 0

    if settings.mode == "webcam":
        # stream_factory: injectable for tests / non-camera sources (a
        # stream is anything with start()/read()/stop() and a `stopped`
        # flag); max_frames bounds the loop for smoke runs.
        factory = getattr(settings, "stream_factory", None) \
            or (lambda: WebcamVideoStream(settings.webcam_id))
        max_frames = getattr(settings, "max_frames", None)
        cap = factory().start()
        n_done = 0
        try:
            while max_frames is None or n_done < max_frames:
                frame = cap.read()
                if frame is None:
                    if getattr(cap, "stopped", False):
                        break
                    continue
                outputs = model(np.asarray(frame))
                n_done += 1
                if settings.show and outputs is not None \
                        and "rendered_image" in outputs:
                    cv2.imshow("romp_tpu", outputs["rendered_image"])
                    if cv2.waitKey(1) & 0xFF == ord("q"):
                        break
        finally:
            cap.stop()
        return 0

    print(f"unknown mode {settings.mode}", file=sys.stderr)
    return 1
