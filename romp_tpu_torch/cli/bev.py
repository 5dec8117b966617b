"""`bev` CLI of the port — all-age multi-person 3D recovery with
bird's-eye-view depth (image / video / webcam, and crowd mode for wide
images).

    python -m romp_tpu_torch.cli.bev -m image -i photo.jpg -o out --GPU 0

Same flags and defaults as `romp_tpu/cli/bev.py`; only the device call
changes. `--GPU N` (default 0) runs on `cuda:N` and raises when that card
does not exist; `--GPU -1` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os.path as osp
import sys
from typing import Dict, Optional

import numpy as np

from romp_tpu_torch.cli.common import (
    DEFAULT_HOME, add_common_flags, device_from_flag,
    load_checkpoint_flexible, load_smpl_assets_flexible,
)

# Per-checkpoint confidence presets (`bev/main.py:19-25`).
CONF_DICT = {1: [0.25, 20, 2], 2: [0.1, 20, 1.6]}
LONG_CONF_DICT = {1: [0.12, 20, 1.5, 0.46], 2: [0.08, 20, 1.6, 0.8]}


def bev_settings(input_args=None):
    parser = argparse.ArgumentParser(
        description="romp_tpu_torch BEV: all-age 3D recovery with relative "
                    "depth (PyTorch + CUDA)")
    add_common_flags(parser, "bev")
    parser.add_argument("--model_id", type=int, default=2)
    parser.add_argument("--crowd", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="sliding-window mode for panorama-like images")
    parser.add_argument("--overlap_ratio", type=float, default=None)
    parser.add_argument("--center_thresh", type=float, default=None)
    parser.add_argument("--nms_thresh", type=float, default=None)
    parser.add_argument("--relative_scale_thresh", type=float, default=None)
    parser.add_argument("--show_patch_results", action="store_true")
    parser.add_argument("--show_items", type=str, default="mesh,mesh_bird_view")
    parser.add_argument("--smpl_path", type=str,
                        default=osp.join(DEFAULT_HOME, "SMPLA_NEUTRAL.pth"))
    parser.add_argument("--smil_path", type=str,
                        default=osp.join(DEFAULT_HOME, "smil_packed_info.pth"))
    parser.add_argument("--model_path", type=str,
                        default=osp.join(DEFAULT_HOME, "BEV.pth"))
    args = parser.parse_args(input_args)

    conf = (LONG_CONF_DICT if args.crowd else CONF_DICT)[args.model_id]
    if args.center_thresh is None:
        args.center_thresh = conf[0]
    if args.nms_thresh is None:
        args.nms_thresh = conf[1]
    if args.relative_scale_thresh is None:
        args.relative_scale_thresh = conf[2]
    if args.overlap_ratio is None:
        args.overlap_ratio = LONG_CONF_DICT[args.model_id][3]
    if args.show:
        args.render_mesh = True
    if args.render_mesh or args.show_largest:
        args.calc_smpl = True
    args.input_size = 512
    return args


class BEV:
    """Python API: `BEV(settings)(bgr_image) -> results dict`."""

    def __init__(self, settings):
        from romp_tpu_torch.models.bev import init_bev_params
        from romp_tpu_torch.pipeline.bev_pipeline import (
            BevConfig, BevPipeline,
        )
        from romp_tpu_torch.pipeline.video import TemporalOptimizer
        from romp_tpu_torch.smpl.body_model import SmplModel

        self.settings = settings
        device = device_from_flag(settings.GPU)
        params = load_checkpoint_flexible(settings.model_path, init_bev_params)
        adult = load_smpl_assets_flexible(settings.smpl_path, num_betas=11)
        baby = load_smpl_assets_flexible(settings.smil_path, num_betas=10,
                                         seed=1)
        self.smpl_faces = adult.faces
        cfg = BevConfig(
            max_person=settings.max_person,
            conf_thresh=settings.center_thresh,
            nms_thresh=settings.nms_thresh,
            relative_scale_thresh=settings.relative_scale_thresh,
            compute_dtype=settings.compute_dtype,
            calc_smpl=settings.calc_smpl,
            transfer_dtype=settings.transfer_dtype,
        )
        self.pipeline = BevPipeline(params, SmplModel(adult), SmplModel(baby),
                                    cfg, device)
        self.temporal = (TemporalOptimizer(smooth_coeff=settings.smooth_coeff)
                         if settings.temporal_optimize else None)
        self.renderer = None
        if settings.render_mesh:
            from romp_tpu_torch.vis.renderer import setup_renderer

            self.renderer = setup_renderer(settings.renderer)

    def __call__(self, bgr_image: np.ndarray) -> Optional[Dict]:
        from romp_tpu_torch.ops.projection import (
            convert_to_org_image_coords_np,
        )
        from romp_tpu_torch.pipeline.crowd import process_long_image
        from romp_tpu_torch.pipeline.video import filter_valid
        from romp_tpu_torch.utils.io import img_preprocess

        h, w = bgr_image.shape[:2]
        if w / h >= 2 and self.settings.crowd:
            res = process_long_image(self.pipeline, bgr_image[..., ::-1],
                                     self.settings)
            if res is None:
                print("No person detected!")
                return None
            pad_info = res.pop("pad_info")
        else:
            image, pad_info = img_preprocess(bgr_image)
            image = np.clip(image, 0, 255).astype(np.uint8)  # 4x smaller upload
            out = self.pipeline(image)
            res = filter_valid({k: v.cpu().numpy() for k, v in out.items()})
            if res.get("cam", np.zeros((0,))).shape[0] == 0:
                print("No person detected!")
                return None
            if self.temporal is not None:
                res = self.temporal(res)
                if res is None:
                    return None

        if "pj2d" in res:
            res["pj2d_org"] = convert_to_org_image_coords_np(
                res["pj2d"], pad_info)
        if "verts_camed" in res:
            res["verts_camed_org"] = convert_to_org_image_coords_np(
                res["verts_camed"], pad_info)
        if self.renderer is not None and "verts_camed_org" in res:
            from romp_tpu_torch.vis.compositor import render_results

            res["rendered_image"] = render_results(
                self.renderer, res, bgr_image, self.smpl_faces,
                items=self.settings.show_items.split(","))
        return res


def main(input_args=None):
    settings = bev_settings(input_args)
    from romp_tpu_torch.cli.runner import run_tool

    return run_tool(BEV(settings), settings)


if __name__ == "__main__":
    sys.exit(main())
