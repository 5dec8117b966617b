"""End-to-end BEV inference, fixed-K masked (counterpart of
`romp_tpu/pipeline/bev_pipeline.py`).

images (B, S, S, 3) RGB -> HRNet-W32 + BEV maps -> 3D center parse ->
parameter regression -> SMPL+A (the skinning kernel, adult and infant) ->
perspective projection -> duplicate suppression -> outlier removal. The two
O(K^2) pruning passes are masked tensor ops over (B, K, K), batched over the
images where the JAX package vmaps them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from romp_tpu_torch.models.bev import (
    BV_ROW_CH, BevNet, bev_forward_maps, bev_regress_params,
)
from romp_tpu_torch.models.layers import LayerOpts, cast_bf16, opts_from_names
from romp_tpu_torch.models.romp import BACKBONES
from romp_tpu_torch.ops.centermap import parse_centermap3d
from romp_tpu_torch.ops.projection import perspective_projection
from romp_tpu_torch.ops.rotations import rot6d_to_axis_angle
from romp_tpu_torch.pipeline.romp_pipeline import precision_flags
from romp_tpu_torch.smpl.body_model import SmplModel, smpla_forward

TAN_FOV_HALF = float(np.tan(np.radians(30.0)))  # FOV 60 deg
FOCAL_LENGTH_BEV = 443.4


@dataclasses.dataclass(frozen=True)
class BevConfig:
    """Same fields and defaults as the JAX package's BevConfig."""

    input_size: int = 512
    max_person: int = 64
    conf_thresh: float = 0.1
    nms_thresh: float = 16.0
    relative_scale_thresh: float = 3.0
    outlier_scale_thresh: float = 0.25
    compute_dtype: str = "float32"   # conv operand dtype; "bfloat16" = mixed
    act_dtype: str = "float32"       # "bfloat16" = low-memory inference
    calc_smpl: bool = True
    transfer_dtype: str = "float32"  # dtype of verts / joints / pj2d
    fuse_chains: bool = False        # HRNet chains through the CUDA kernel
    backbone: str = "hrnet32"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if self.transfer_dtype not in ("float32", "float16"):
            raise ValueError(f"transfer_dtype {self.transfer_dtype!r}")
        if self.act_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"act_dtype {self.act_dtype!r}")
        self.opts     # JAX refuses bf16 activations of f32 conv operands
        if self.backbone not in BACKBONES:
            raise NotImplementedError(
                f"backbone={self.backbone!r}: the port has {BACKBONES}")

    @property
    def opts(self) -> LayerOpts:
        return opts_from_names(self.compute_dtype, self.act_dtype,
                               self.fuse_chains)


def unpack_bev_params(params_pred: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., 146) -> cam (3), thetas (72, hands zero), betas (11)
    (`bev_pipeline.py:55`)."""
    lead = params_pred.shape[:-1]
    thetas = torch.cat([
        rot6d_to_axis_angle(params_pred[..., 3:9]),
        rot6d_to_axis_angle(params_pred[..., 9:135]),
        params_pred.new_zeros((*lead, 6))], dim=-1)
    return {"cam": params_pred[..., 0:3], "smpl_thetas": thetas,
            "smpl_betas": params_pred[..., 135:146]}


def scale_to_depth(scale: torch.Tensor) -> torch.Tensor:
    return 1.0 / (scale * TAN_FOV_HALF + 1e-3)


def bev_cam_to_trans(cam: torch.Tensor) -> torch.Tensor:
    """(s, ty, tx) -> camera-space (X, Y, depth), x and y swapped
    (`bev_pipeline.py:73`)."""
    depth = scale_to_depth(cam[..., 0])
    # not cam[..., [2, 1]]: a list index is uploaded, a host sync
    xy = torch.stack([cam[..., 2], cam[..., 1]], dim=-1) * depth[
        ..., None] * TAN_FOV_HALF
    return torch.cat([xy, depth[..., None]], dim=-1)


def _pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    """(B, K, ...) -> (B, K, K) Euclidean distances over the last dim."""
    return torch.linalg.vector_norm(x[:, :, None] - x[:, None, :], dim=-1)


def suppress_duplicates(pj2d: torch.Tensor, scales: torch.Tensor,
                        mask: torch.Tensor, img_max_len: torch.Tensor,
                        nms_thresh: float) -> torch.Tensor:
    """Masked duplicate suppression on projected 2D joints
    (`bev_pipeline.py:81`): of each valid pair closer than the threshold,
    the smaller-scale person goes. pj2d (B, K, J, 2); scales, mask (B, K);
    img_max_len (B,). Returns the new mask."""
    K = mask.shape[1]
    dn = _pairwise_dist(pj2d).mean(-1)                     # (B, K, K)
    ps = scales * 2.0
    dn = dn / torch.maximum(ps[:, :, None], ps[:, None, :])
    iu = torch.ones((K, K), dtype=torch.bool, device=mask.device).triu(1)
    dup = iu & mask[:, :, None] & mask[:, None, :] & (
        dn < (nms_thresh * img_max_len / 640.0)[:, None, None])
    smaller_i = ps[:, :, None] < ps[:, None, :]
    removed = (dup & smaller_i).any(2) | (dup & ~smaller_i).any(1)
    return mask & ~removed


def remove_outliers(cam_trans: torch.Tensor, scales: torch.Tensor,
                    mask: torch.Tensor, relative_scale_thresh: float,
                    scale_thresh: float) -> torch.Tensor:
    """Masked isolated-outlier removal (`bev_pipeline.py:106`): drop small
    persons whose mean distance to the others (less self and the farthest)
    is far above the rest's. A no-op on images with fewer than three valid
    persons. cam_trans (B, K, 3); scales, mask (B, K)."""
    n = mask.sum(1, keepdim=True)                          # (B, 1)
    m2 = mask[:, :, None] & mask[:, None, :]
    d = torch.where(m2, _pairwise_dist(cam_trans), 0.0)
    row_max = torch.where(m2, d, float("-inf")).amax(2)
    mean_dist = (d.sum(2) - row_max) / torch.clamp(n - 2, min=1)
    mean_dist = torch.where(mask, mean_dist, 0.0)
    others = (mean_dist.sum(1, keepdim=True) - mean_dist) / torch.clamp(
        n - 1, min=1)
    rel = mean_dist / (others + 1e-8)
    outlier = (rel > relative_scale_thresh) & (scales < scale_thresh) & mask
    return torch.where(n < 3, mask, mask & ~outlier)


def bev_inference(net: BevNet, smpl_adult: SmplModel, smpl_baby: SmplModel,
                  images: torch.Tensor, cfg: BevConfig,
                  img_max_len: Optional[torch.Tensor] = None,
                  ) -> Dict[str, torch.Tensor]:
    """images (B, S, S, 3) RGB in [0, 255] on the net's device -> fixed
    (B, K, ...) tensors (`bev_pipeline.py:126`). Call under
    `precision_flags(cfg)` (BevPipeline does)."""
    maps = bev_forward_maps(net, images, cfg.opts)
    det = parse_centermap3d(maps.center_maps_3d, cfg.max_person,
                            cfg.conf_thresh)
    params_pred = bev_regress_params(net, maps, det).float()
    out = unpack_bev_params(params_pred)
    out.update({
        "mask": det.mask,
        "center_confs": det.scores.float(),
        "pred_czyxs": det.zyx,
        "params_pred": params_pred,
        "cam_trans": bev_cam_to_trans(out["cam"]),
    })
    if not cfg.calc_smpl:
        return out

    B, K = det.mask.shape

    def flat(a):
        return a.reshape(B * K, *a.shape[2:])

    def unflat(a):
        return a.reshape(B, K, *a.shape[1:])

    verts, joints = smpla_forward(smpl_adult, smpl_baby,
                                  flat(out["smpl_betas"]),
                                  flat(out["smpl_thetas"]), root_align=True)
    trans = flat(out["cam_trans"])
    # FOCAL_LENGTH_BEV is calibrated at 512; other input sizes keep that
    # calibration of the normalized projection (`bev_pipeline.py:165-171`)
    focal = FOCAL_LENGTH_BEV * cfg.input_size / 512.0
    pj2d = perspective_projection(joints, trans, focal, cfg.input_size)
    verts_camed = torch.cat([
        perspective_projection(verts, trans, focal, cfg.input_size),
        verts[..., 2:3]], dim=-1)
    out.update({"verts": unflat(verts), "joints": unflat(joints),
                "pj2d": unflat(pj2d), "verts_camed": unflat(verts_camed)})

    if img_max_len is None:
        img_max_len = torch.full((B,), float(cfg.input_size),
                                 device=images.device)
    mask = suppress_duplicates(out["pj2d"], out["cam"][..., 0], out["mask"],
                               img_max_len, cfg.nms_thresh)
    out["mask"] = remove_outliers(out["cam_trans"], out["cam"][..., 0], mask,
                                  cfg.relative_scale_thresh,
                                  cfg.outlier_scale_thresh)
    if cfg.transfer_dtype == "float16":
        for k in ("verts", "joints", "pj2d", "verts_camed"):
            # clamp into f16 range: degenerate slots can hold huge values
            out[k] = torch.clamp(out[k], -6.0e4, 6.0e4).half()
    return out


class BevPipeline:
    """Owns the network (built from a torch-layout state dict), the SMPL-A
    and SMIL models and the config, on one device: the card unless the
    caller passes another (the CPU tests pass "cpu"). It never falls back
    to the CPU."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 smpl_adult: SmplModel, smpl_baby: SmplModel,
                 cfg: Optional[BevConfig] = None, device="cuda"):
        self.cfg = cfg or BevConfig()
        self.device = torch.device(device)
        map_size = (params["bv_out_layers.0.conv1.weight"].shape[1]
                    // BV_ROW_CH)
        net = BevNet(self.cfg.backbone, map_size)
        net.load_state_dict(params, strict=True)
        self.net = net.to(self.device).eval().requires_grad_(False)
        if self.cfg.fuse_chains:
            self.net.pack_chains()
        if self.cfg.act_dtype == "bfloat16":
            cast_bf16(self.net)    # bf16 weights and folded BN, once
        self.smpl_adult = smpl_adult.to(self.device)
        self.smpl_baby = smpl_baby.to(self.device)

    def __call__(self, images) -> Dict[str, torch.Tensor]:
        """images: (B, S, S, 3) RGB in [0, 255], numpy or tensor, any real
        dtype (uint8 uploads 4x fewer bytes)."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        images = images.to(self.device, non_blocking=True)
        with torch.inference_mode(), precision_flags(self.cfg):
            return bev_inference(self.net, self.smpl_adult, self.smpl_baby,
                                 images, self.cfg)
