"""ROMP served by `romp_tpu_torch.serve.make_romp_service`."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def build(cfg: Dict, traffic: Dict, sd: Dict[str, torch.Tensor],
          assets: Dict[str, Dict[str, np.ndarray]], device):
    """The service at the configuration's settings, as `python -m
    romp_tpu_torch.serve --model romp` makes it, with the traffic's
    max_batch, window_ms and fetch_person."""
    from romp_tpu_torch.pipeline.romp_pipeline import RompConfig
    from romp_tpu_torch.serve import make_romp_service
    from romp_tpu_torch.smpl.body_model import SmplAssets, SmplModel

    rc = RompConfig(
        input_size=cfg["input_size"], max_person=cfg["max_person"],
        conf_thresh=cfg["conf_thresh"], cam_scale_base=cfg["cam_scale_base"],
        compute_dtype=cfg["compute_dtype"], act_dtype=cfg["act_dtype"],
        transfer_dtype=cfg["transfer_dtype"], backbone=cfg["backbone"],
        fetch_slots=traffic["fetch_person"])
    return make_romp_service(
        sd, SmplModel(SmplAssets(**assets["smpl"])), rc,
        max_batch=traffic["max_batch"], window_ms=traffic["window_ms"],
        device=device)
