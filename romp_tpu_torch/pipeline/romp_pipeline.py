"""End-to-end ROMP inference (counterpart of `romp_tpu/pipeline/romp_pipeline.py`).

image (B, S, S, 3) RGB -> backbone + heads -> center NMS / top-K parse ->
per-person parameter gather -> 6D -> axis-angle -> SMPL (skinning kernel)
-> weak-perspective projection + least-squares camera translation ->
fixed-shape (B, K, ...) tensors with a validity mask.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from romp_tpu_torch.models.layers import LayerOpts, cast_bf16, opts_from_names
from romp_tpu_torch.models.romp import BACKBONES, RompNet
from romp_tpu_torch.ops.centermap import parse_centermap2d, sample_maps_at
from romp_tpu_torch.ops.projection import (
    convert_to_org_image_coords, estimate_translation_lstsq,
    weak_perspective_projection,
)
from romp_tpu_torch.ops.rotations import rot6d_to_axis_angle
from romp_tpu_torch.smpl.body_model import SmplModel, smpl_forward


@dataclasses.dataclass(frozen=True)
class RompConfig:
    """Same fields and defaults as the JAX package's RompConfig."""

    input_size: int = 512
    max_person: int = 64
    conf_thresh: float = 0.25
    cam_scale_base: float = 1.1
    root_align: bool = False
    compute_dtype: str = "float32"   # conv operand dtype; "bfloat16" = mixed
    act_dtype: str = "float32"       # inter-layer activation dtype;
    #                                  "bfloat16" = low-memory inference
    calc_smpl: bool = True
    backbone: str = "hrnet32"
    transfer_dtype: str = "float32"  # dtype of the per-vertex outputs
    fetch_slots: int = 0             # >0: keep the top slots only
    fuse_chains: bool = False        # HRNet chains through the CUDA kernel

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
                f"backbone={self.backbone!r}: the port has {BACKBONES} so far "
                "(resnet50 is on the ROADMAP)")

    @property
    def opts(self) -> LayerOpts:
        return opts_from_names(self.compute_dtype, self.act_dtype,
                               self.fuse_chains)


@contextlib.contextmanager
def precision_flags(cfg: RompConfig):
    """TF32 for the call: cuDNN may use it on the mixed path only, where
    every conv operand is already bf16-rounded and so exact in TF32; the f32
    path, and every matmul, run in full f32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=cfg.compute_dtype == "bfloat16"):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def unpack_params(params_pred: torch.Tensor,
                  cam_scale_base: float) -> Dict[str, torch.Tensor]:
    """(..., 145) head channels -> cam / thetas (72, hands zero) / betas."""
    lead = params_pred.shape[:-1]
    cam = params_pred[..., 0:3]
    if cam_scale_base != 1.0:
        cam = torch.cat([torch.pow(cam_scale_base, cam[..., :1]),
                         cam[..., 1:]], dim=-1)
    thetas = torch.cat([
        rot6d_to_axis_angle(params_pred[..., 3:9]),
        rot6d_to_axis_angle(params_pred[..., 9:135]),
        params_pred.new_zeros((*lead, 6))], dim=-1)
    return {"cam": cam, "smpl_thetas": thetas,
            "smpl_betas": params_pred[..., 135:145]}


def romp_inference(net: RompNet, smpl: SmplModel, images: torch.Tensor,
                   cfg: RompConfig) -> Dict[str, torch.Tensor]:
    """images: (B, S, S, 3) RGB in [0, 255] on the net's device.

    Returns fixed-shape tensors with leading (B, K): mask, center_confs,
    centers, cam, smpl_thetas, smpl_betas and, with cfg.calc_smpl, verts,
    joints, pj2d, verts_camed, cam_trans. Call under `precision_flags(cfg)`
    (RompPipeline does).
    """
    center_maps, params_maps = net(images, cfg.opts)
    # bf16 activations: the head maps are widened before parsing, as JAX
    # does (`romp_pipeline.py:98-99`)
    center_maps, params_maps = center_maps.float(), params_maps.float()

    det = parse_centermap2d(center_maps[..., 0], cfg.max_person,
                            cfg.conf_thresh)
    B, K = det.scores.shape
    out = unpack_params(sample_maps_at(params_maps, det.flat_inds),
                        cfg.cam_scale_base)
    S = center_maps.shape[1]
    fi = det.flat_inds
    centers = torch.stack([fi % S, fi // S], dim=-1) * cfg.input_size // S
    out.update({"mask": det.mask, "center_confs": det.scores,
                "centers": centers.float()})

    if cfg.calc_smpl:
        def flat(a):
            return a.reshape(B * K, *a.shape[2:])

        def unflat(a):
            return a.reshape(B, K, *a.shape[1:])

        verts, joints = smpl_forward(smpl, flat(out["smpl_betas"]),
                                     flat(out["smpl_thetas"]),
                                     root_align=cfg.root_align)
        cam_flat = flat(out["cam"])
        pj2d = weak_perspective_projection(joints, cam_flat)
        verts_camed = weak_perspective_projection(verts, cam_flat,
                                                  keep_dim=True)
        j24 = joints[:, :24]
        pj24_pix = (pj2d[:, :24] + 1.0) * (cfg.input_size / 2.0)
        w = ((pj2d[:, :24, 1] > -2.0) & (j24[..., 2] != -2.0)).float()
        cam_trans = estimate_translation_lstsq(
            j24, pj24_pix, w, focal_length=443.4,
            img_size=float(cfg.input_size))

        if cfg.transfer_dtype == "float16":
            # clamp into f16 range: degenerate slots can hold huge values
            def tcast(a):
                return torch.clamp(a, -6.0e4, 6.0e4).half()
        else:
            def tcast(a):
                return a
        out.update({
            "verts": tcast(unflat(verts)),
            "joints": tcast(unflat(joints)),
            "pj2d": tcast(unflat(pj2d)),
            "verts_camed": tcast(unflat(verts_camed)),
            "cam_trans": unflat(cam_trans),
        })
    if 0 < cfg.fetch_slots < K:
        out = compact_slots(out, cfg.fetch_slots)
    return out


def compact_slots(out: Dict[str, torch.Tensor],
                  n: int) -> Dict[str, torch.Tensor]:
    """Reorder the K slots by (validity, confidence) descending (stable, as
    jnp.argsort) and keep the first n of every (B, K, ...) output."""
    key = out["center_confs"] + torch.where(
        out["mask"], 1.0e4, 0.0).to(out["center_confs"].dtype)
    order = torch.argsort(-key, dim=1, stable=True)[:, :n]      # (B, n)
    res = {}
    for k, v in out.items():
        idx = order.reshape(order.shape + (1,) * (v.dim() - 2))
        res[k] = torch.take_along_dim(v, idx, dim=1)
    return res


def project_to_org_image(out: Dict[str, torch.Tensor],
                         pad_info: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Add pj2d_org / verts_camed_org for one image's pad offsets (6,)."""
    res = dict(out)
    if "pj2d" in out:
        res["pj2d_org"] = convert_to_org_image_coords(out["pj2d"], pad_info)
    if "verts_camed" in out:
        res["verts_camed_org"] = convert_to_org_image_coords(
            out["verts_camed"], pad_info)
    return res


class RompPipeline:
    """Owns the network (built from a torch-layout state dict), the SMPL
    model and the config, on one device: the card unless the caller passes
    another (the CPU tests pass "cpu"). It never falls back to the CPU."""

    def __init__(self, params: Mapping[str, torch.Tensor], smpl: SmplModel,
                 cfg: Optional[RompConfig] = None, device="cuda"):
        self.cfg = cfg or RompConfig()
        self.device = torch.device(device)
        net = RompNet(self.cfg.backbone)
        net.load_state_dict(params, strict=True)
        self.net = net.to(self.device).eval().requires_grad_(False)
        if self.cfg.fuse_chains:
            self.net.pack_chains()
        if self.cfg.act_dtype == "bfloat16":
            cast_bf16(self.net)    # bf16 weights and folded BN, once
        self.smpl = smpl.to(self.device)

    def __call__(self, images) -> Dict[str, torch.Tensor]:
        """images: (B, S, S, 3) RGB in [0, 255], numpy or tensor, any real
        dtype (uint8 uploads 4x fewer bytes)."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        images = images.to(self.device, non_blocking=True)
        with torch.inference_mode(), precision_flags(self.cfg):
            return romp_inference(self.net, self.smpl, images, self.cfg)
