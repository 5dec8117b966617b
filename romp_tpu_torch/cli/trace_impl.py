"""trace2 CLI runner of the port: pipeline construction, sequence loading,
clip chunking, result saving (counterpart of `romp_tpu/cli/trace_impl.py`).
"""
from __future__ import annotations

import os
import os.path as osp
import sys
from typing import Dict, List

import numpy as np


def load_sequence_frames(path: str) -> List[str]:
    from romp_tpu_torch.utils.io import (
        collect_image_paths, extract_video_frames,
    )

    if osp.isfile(path):
        import tempfile

        return extract_video_frames(
            path, tempfile.mkdtemp(prefix="trace_frames_"))
    return collect_image_paths(path)


def save_tracking_matrix(results_per_frame: Dict[int, Dict], path: str):
    """MOT-style tracking text output (frame, id, bbox-ish from pj2d)."""
    lines = []
    for fid in sorted(results_per_frame):
        fr = results_per_frame[fid]
        for j, tid in enumerate(fr.get("track_ids", [])):
            pj = fr["pj2d"][j]
            x0, y0 = pj.min(0)
            x1, y1 = pj.max(0)
            lines.append(
                f"{fid+1},{int(tid)},{x0:.1f},{y0:.1f},{x1-x0:.1f},"
                f"{y1-y0:.1f},1,-1,-1,-1")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def save_world_view(results_per_frame: Dict[int, Dict], faces: np.ndarray,
                    save_dir: str) -> None:
    """Global-view renders, the top-down trajectory and the HTML viewer of
    the tracked people (`--show_items world`)."""
    from romp_tpu_torch.vis.world_view import visualize_global_trajectory

    flat = {k: [] for k in ("track_ids", "frame_ids", "frame_valid",
                            "world_cams", "verts")}
    for fid in sorted(results_per_frame):
        fr = results_per_frame[fid]
        n = len(fr["track_ids"])
        flat["track_ids"] += list(fr["track_ids"])
        flat["frame_ids"] += [fid] * n
        flat["frame_valid"] += [True] * n
        flat["world_cams"] += list(fr["world_cams"])
        flat["verts"] += list(fr["verts"])
    if flat["track_ids"]:
        visualize_global_trajectory(
            {k: np.asarray(v) for k, v in flat.items()}, np.asarray(faces),
            save_dir)


def build_trace_pipeline(settings):
    """The CLI's TracePipeline on `--GPU`'s device. Missing weights fall
    back to seeded random init, missing SMPL-A / SMIL files to synthetic
    assets, each with a warning. With the RAFT weights file present the
    flow comes from RAFT (`--raft_iters`, `--flow_dtype`, `--flow_size`,
    `--corr_dtype`; fnet shared over each clip's frames), else it is zero,
    with a warning (`romp_tpu/cli/trace_impl.py:77-98`)."""
    from romp_tpu_torch.cli.common import (
        device_from_flag, load_checkpoint_flexible, load_smpl_assets_flexible,
    )
    from romp_tpu_torch.models.trace import init_trace_params
    from romp_tpu_torch.pipeline.trace_pipeline import (
        TraceConfig, TracePipeline,
    )
    from romp_tpu_torch.pipeline.trace_tracking import SeqConfig
    from romp_tpu_torch.smpl.body_model import SmplModel

    device = device_from_flag(settings.GPU)
    params = load_checkpoint_flexible(
        settings.model_path,
        lambda g: init_trace_params(g, settings.temp_clip_length))
    adult = load_smpl_assets_flexible(settings.smpl_path, num_betas=11)
    baby = load_smpl_assets_flexible(settings.smil_path, num_betas=10, seed=1)
    cfg = TraceConfig(temp_clip_length=settings.temp_clip_length,
                      max_person=settings.max_person,
                      conf_thresh=settings.center_thresh,
                      compute_dtype=settings.compute_dtype)
    seq_cfg = SeqConfig(subject_num=settings.subject_num,
                        smooth_pose_shape=True)
    flow_fn = None
    raft_path = settings.raft_model_path
    if raft_path and osp.exists(raft_path):
        from romp_tpu_torch.models.raft import (
            filter_raft_state_dict, make_trace_flow_fn,
        )
        from romp_tpu_torch.utils.checkpoint import load_torch_checkpoint

        flow_fn = make_trace_flow_fn(
            filter_raft_state_dict(load_torch_checkpoint(raft_path)),
            iters=settings.raft_iters, compute_dtype=settings.flow_dtype,
            flow_input_size=settings.flow_size,
            corr_dtype=settings.corr_dtype, sequence=True, device=device)
    else:
        print("RAFT weights not found; running TRACE with zero optical flow",
              file=sys.stderr)
    return TracePipeline(params, SmplModel(adult), SmplModel(baby), cfg,
                         seq_cfg, flow_fn=flow_fn, device=device)


def run_trace(settings) -> int:
    try:
        import cv2
    except ImportError:
        print("cv2 required", file=sys.stderr)
        return 1
    from romp_tpu_torch.utils.io import img_preprocess

    pipe = build_trace_pipeline(settings)
    frame_paths = load_sequence_frames(settings.input)
    os.makedirs(settings.save_path, exist_ok=True)
    T = settings.temp_clip_length

    def decode_chunk(start):
        return np.stack([img_preprocess(cv2.imread(p))[0][0]
                         for p in frame_paths[start:start + T]])

    results_per_frame: Dict[int, Dict] = {}
    starts = list(range(0, len(frame_paths), T))

    # process_stream dispatches clip k+1's device frontend before it
    # collects clip k, so decoding and uploading the next clip and its
    # backbone / maps overlap this clip's host tracking and smoothing
    def clip_iter():
        for s in starts:
            yield pipe.prefetch(decode_chunk(s))

    fb = max(1, int(settings.frontend_batch))
    for start, out in zip(starts,
                          pipe.process_stream(clip_iter(), frontend_batch=fb)):
        if out is None:
            continue
        for row in range(len(out["track_ids"])):
            fid = start + int(out["frame_ids"][row])
            if not out["frame_valid"][row]:
                continue
            fr = results_per_frame.setdefault(fid, {k: [] for k in (
                "track_ids", "cam", "cam_trans", "world_cams", "world_grots",
                "smpl_thetas", "smpl_betas", "pj2d", "verts", "joints")})
            for k in fr:
                fr[k].append(out[k][row])
    for fid in results_per_frame:
        results_per_frame[fid] = {
            k: np.stack(v) for k, v in results_per_frame[fid].items()}

    seq_name = osp.basename(settings.input.rstrip("/")) or "sequence"
    np.savez(osp.join(settings.save_path, f"{seq_name}.npz"),
             results={str(k): v for k, v in results_per_frame.items()})
    save_tracking_matrix(results_per_frame,
                         osp.join(settings.save_path,
                                  f"TRACE_{seq_name}.txt"))
    if "world" in settings.show_items:
        save_world_view(results_per_frame,
                        pipe.smpl_adult.faces.cpu().numpy(),
                        osp.join(settings.save_path, "world_vis"))
    print(f"saved {len(results_per_frame)} frames of results to "
          f"{settings.save_path}")
    return 0
