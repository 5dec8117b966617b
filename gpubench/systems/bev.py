"""BEV served by `romp_tpu_torch.serve.make_bev_service`."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def build(cfg: Dict, traffic: Dict, sd: Dict[str, torch.Tensor],
          assets: Dict[str, Dict[str, np.ndarray]], device):
    """The service at the configuration's settings, as `python -m
    romp_tpu_torch.serve --model bev` makes it (every slot fetched), with
    the traffic's max_batch and window_ms."""
    from romp_tpu_torch.pipeline.bev_pipeline import BevConfig
    from romp_tpu_torch.serve import make_bev_service
    from romp_tpu_torch.smpl.body_model import SmplAssets, SmplModel

    bc = BevConfig(
        input_size=cfg["input_size"], max_person=cfg["max_person"],
        conf_thresh=cfg["conf_thresh"], nms_thresh=cfg["nms_thresh"],
        relative_scale_thresh=cfg["relative_scale_thresh"],
        outlier_scale_thresh=cfg["outlier_scale_thresh"],
        compute_dtype=cfg["compute_dtype"], act_dtype=cfg["act_dtype"],
        transfer_dtype=cfg["transfer_dtype"], backbone=cfg["backbone"])
    return make_bev_service(
        sd, SmplModel(SmplAssets(**assets["adult"])),
        SmplModel(SmplAssets(**assets["baby"])), bc,
        max_batch=traffic["max_batch"], window_ms=traffic["window_ms"],
        device=device)
