"""Re-render saved results: npz outputs + source frames -> visualizations
(the port's counterpart of `romp_tpu/tools/show_results.py`, on its own
`cli/common.py`, `vis/compositor.py` and `vis/renderer.py`).

Equivalent of the reference's TRACE show tool (`simple_romp/trace2/show.py`):
loads per-frame npz results produced by the CLIs, re-renders mesh overlays /
bird views / rotating turntables without re-running inference.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

import numpy as np


def main(input_args=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--results_dir", type=str, required=True,
                        help="directory of <frame>.npz + <frame>.png pairs")
    parser.add_argument("--frames_dir", type=str, default=None,
                        help="source frames (defaults to results_dir pngs)")
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--show_items", type=str,
                        default="mesh,mesh_bird_view")
    parser.add_argument("--rotate_mesh", action="store_true")
    parser.add_argument("--frame_rate", type=int, default=24)
    parser.add_argument("--smpl_path", type=str, default=None)
    args = parser.parse_args(input_args)

    try:
        import cv2
    except ImportError:
        print("cv2 required", file=sys.stderr)
        return 1

    from romp_tpu_torch.cli.common import load_smpl_assets_flexible
    from romp_tpu_torch.vis.compositor import (
        render_results, render_rotating_mesh,
    )
    from romp_tpu_torch.vis.renderer import setup_renderer

    assets = load_smpl_assets_flexible(args.smpl_path, num_betas=10)
    renderer = setup_renderer("sim3dr")
    os.makedirs(args.save_dir, exist_ok=True)

    npzs = sorted(f for f in os.listdir(args.results_dir)
                  if f.endswith(".npz") and f != "video_results.npz")
    items = args.show_items.split(",")
    written = []
    for name in npzs:
        res = np.load(osp.join(args.results_dir, name),
                      allow_pickle=True)["results"][()]
        stem = osp.splitext(name)[0]
        frame_dir = args.frames_dir or args.results_dir
        img_path = None
        for ext in (".png", ".jpg", ".jpeg"):
            cand = osp.join(frame_dir, stem + ext)
            if osp.exists(cand):
                img_path = cand
                break
        if img_path is None or "verts" not in res:
            continue
        image = cv2.imread(img_path)
        out = render_results(renderer, res, image, assets.faces, items=items)
        save_path = osp.join(args.save_dir, stem + ".png")
        cv2.imwrite(save_path, out)
        written.append(save_path)

        if args.rotate_mesh and "cam_trans" in res:
            frames = render_rotating_mesh(
                renderer, res["verts"] + res["cam_trans"][:, None],
                assets.faces)
            h, w = frames[0].shape[:2]
            vw = cv2.VideoWriter(
                osp.join(args.save_dir, stem + "_rotate.mp4"),
                cv2.VideoWriter_fourcc(*"mp4v"), args.frame_rate, (w, h))
            for f in frames:
                vw.write(f)
            vw.release()
    print(f"rendered {len(written)} frames into {args.save_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
