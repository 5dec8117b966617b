"""`romp` CLI of the port — image / video / webcam inference.

Same flags and defaults as `romp_tpu/cli/romp.py`; only the device call
changes, and `--backbone resnet50` runs ROMP's ResNet-50 variant (a
checkpoint of the training package; the JAX CLI is fixed at HRNet-W32). Imports nothing of the JAX package: the flags, the mode loops, the
video tracker, image IO and the renderer are the port's own copies.
`--GPU N` (default 0) runs on `cuda:N` and raises when that card does not
exist; `--GPU -1` runs on the CPU.
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


def romp_settings(input_args=None):
    parser = argparse.ArgumentParser(
        description="romp_tpu_torch: one-stage multi-person 3D mesh "
                    "recovery (PyTorch + CUDA)")
    add_common_flags(parser, "romp")
    parser.add_argument("--center_thresh", type=float, default=0.25)
    parser.add_argument("--show_items", type=str, default="mesh")
    parser.add_argument("--smpl_path", type=str,
                        default=osp.join(DEFAULT_HOME, "SMPL_NEUTRAL.pth"))
    parser.add_argument("--model_path", type=str,
                        default=osp.join(DEFAULT_HOME, "ROMP.pkl"))
    parser.add_argument("--root_align", type=bool, default=False)
    parser.add_argument("--backbone", type=str, default="hrnet32",
                        choices=("hrnet32", "resnet50"))
    args = parser.parse_args(input_args)
    if args.show:
        args.render_mesh = True
    if args.render_mesh or args.show_largest:
        args.calc_smpl = True
    return args


class ROMP:
    """Python API: `ROMP(settings)(bgr_image) -> results dict`."""

    def __init__(self, settings):
        from romp_tpu_torch.models.romp import init_romp_params
        from romp_tpu_torch.pipeline.video import TemporalOptimizer
        from romp_tpu_torch.pipeline.romp_pipeline import (
            RompConfig, RompPipeline,
        )
        from romp_tpu_torch.smpl.body_model import SmplModel

        self.settings = settings
        device = device_from_flag(settings.GPU)
        params = load_checkpoint_flexible(
            settings.model_path,
            lambda g: init_romp_params(g, settings.backbone))
        assets = load_smpl_assets_flexible(settings.smpl_path, num_betas=10)
        self.smpl_faces = assets.faces
        cfg = RompConfig(
            max_person=settings.max_person,
            conf_thresh=settings.center_thresh,
            root_align=settings.root_align,
            compute_dtype=settings.compute_dtype,
            calc_smpl=settings.calc_smpl,
            transfer_dtype=settings.transfer_dtype,
            fetch_slots=settings.fetch_person,
            backbone=settings.backbone,
        )
        self.pipeline = RompPipeline(params, SmplModel(assets, device), cfg,
                                     device)
        self.temporal = (TemporalOptimizer(smooth_coeff=settings.smooth_coeff)
                         if settings.temporal_optimize else None)
        self.renderer = None
        if settings.render_mesh:
            from romp_tpu_torch.vis.renderer import setup_renderer

            self.renderer = setup_renderer(settings.renderer)

    def __call__(self, bgr_image: np.ndarray) -> Optional[Dict]:
        from romp_tpu_torch.pipeline.video import filter_valid
        from romp_tpu_torch.utils.io import img_preprocess
        from romp_tpu_torch.ops.projection import (
            convert_to_org_image_coords_np,
        )

        image, pad_info = img_preprocess(bgr_image)
        image = np.clip(image, 0, 255).astype(np.uint8)   # 4x smaller upload
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
    settings = romp_settings(input_args)
    from romp_tpu_torch.cli.runner import run_tool

    return run_tool(ROMP(settings), settings)


if __name__ == "__main__":
    sys.exit(main())
