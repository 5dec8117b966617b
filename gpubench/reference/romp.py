"""ROMP (Sun et al., ICCV'21, arXiv 2008.12272), plain: the network, the
pipeline in the served output format, and the judge of served outputs.

Network: HRNet-W32, a CoordConv (x, y in [-1, 1]) on its 1/4 map, then
three heads (a stride-2 3x3 conv with bias, BN, two BasicBlocks, a 1x1 conv
with bias): params (142: 6D pose of 22 joints, 10 betas), center (1),
cam (3), at 1/8 of the input. Pipeline: 5x5 NMS and the top `max_person`
peaks of the center map, the head channels there, cam scale 1.1**s, SMPL,
weak-perspective projections, the least-squares camera translation, float16
transfer of the per-vertex outputs, and the top `fetch` slots by
(validity, confidence) when fewer are fetched than found.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from gpubench.reference import hrnet
from gpubench.reference.geometry import (
    nms, thetas_from_6d, translation_lstsq,
    weak_perspective,
)
from gpubench.reference.judge import pose_gap, rel_gap, worst
from gpubench.reference.nn import Ctx
from gpubench.reference.smpl import smpl

HEAD_CH = 64
FOCAL = 443.4
F16_MAX = 6.0e4


def head(c: Ctx, name: str, x: torch.Tensor, out: int) -> torch.Tensor:
    x = torch.relu(c.bn(f"{name}.0.1", c.conv2d(f"{name}.0.0", x, HEAD_CH, 3,
                                                2, bias=True)))
    for b in range(2):
        x = hrnet.basic_block(c, f"{name}.1.{b}.0", x, HEAD_CH)
    return c.conv2d(f"{name}.2", x, out, 1, bias=True)


def maps(c: Ctx, images: torch.Tensor, backbone: str = "hrnet32"):
    """(B, S, S, 3) -> center (B, S/8, S/8), params (B, S/8, S/8, 145) as
    [cam (3) | 6D pose (132) | betas (10)]."""
    feat = hrnet.hrnet(c, hrnet.normalize(images), hrnet.DEPTHS[backbone])
    n = feat.shape[2]
    r = torch.arange(n, device=feat.device, dtype=torch.float32) / (n - 1)
    r = r * 2.0 - 1.0
    coords = torch.stack([r[None, :].expand(n, n), r[:, None].expand(n, n)])
    feat = torch.cat([feat, coords[None].expand(feat.shape[0], -1, -1, -1)
                      .to(feat.dtype)], 1)
    params = head(c, "final_layers.1", feat, 142)
    center = head(c, "final_layers.2", feat, 1)
    cam = head(c, "final_layers.3", feat, 3)
    return center[:, 0], torch.cat([cam, params], 1).permute(0, 2, 3, 1)


def forward(c: Ctx, images: torch.Tensor, backbone: str = "hrnet32"):
    """The network alone (for `spec_of`, the calibration and the FLOP
    count)."""
    return maps(c, images, backbone)


def unpack(p: torch.Tensor, cam_scale_base: float):
    cam = torch.cat([torch.pow(cam_scale_base, p[..., :1]), p[..., 1:3]], -1)
    return cam, thetas_from_6d(p[..., 3:135]), p[..., 135:145]


def _gather(a: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """a (B, H, W, ...) at flat cells (B, K) -> (B, K, ...)."""
    a = a.flatten(1, 2)
    idx = flat.reshape(flat.shape + (1,) * (a.dim() - 2))
    return torch.take_along_dim(a, idx, 1)


def mesh(arrays, parents, cfg: Dict, cam, thetas, betas):
    """SMPL, the projections and the camera translation's joints, pixels
    and weights for (N,) persons."""
    size = float(cfg["input_size"])
    verts, joints = smpl(arrays["smpl"], parents, betas, thetas)
    pj2d = weak_perspective(joints, cam)
    verts_camed = weak_perspective(verts, cam, keep_z=True)
    return dict(verts=verts, joints=joints, pj2d=pj2d,
                verts_camed=verts_camed)


def trans_inputs(m: Dict[str, torch.Tensor], size: float, y: torch.Tensor):
    """The translation's 24 joints, their pixels and the weights
    (y > -2) & (z != -2), y the projected joints' y to decide by."""
    j24 = m["joints"][:, :24]
    pix = (m["pj2d"][:, :24] + 1.0) * (size / 2.0)
    return j24, pix, (y[:, :24] > -2.0) & (j24[..., 2] != -2.0)


def outputs(sd, arrays, parents, images, cfg: Dict, precision: str,
            fetch: int) -> Dict[str, torch.Tensor]:
    """The served outputs of `images`, computed plainly at `precision`."""
    c = Ctx(sd, precision)
    center, params = maps(c, images, cfg["backbone"])
    b, h, w = center.shape
    k = cfg["max_person"]
    scores, flat = torch.topk(nms(center).flatten(1), k, dim=1)
    cam, thetas, betas = unpack(_gather(params, flat), cfg["cam_scale_base"])
    s = cfg["input_size"]
    out = dict(mask=scores > cfg["conf_thresh"], center_confs=scores,
               centers=(torch.stack([flat % w, flat // w], -1) * s // w
                        ).float(),
               cam=cam, smpl_thetas=thetas, smpl_betas=betas)
    m = mesh(arrays, parents, cfg, cam.flatten(0, 1), thetas.flatten(0, 1),
             betas.flatten(0, 1))
    j24, pix, wt = trans_inputs(m, float(s), m["pj2d"][..., 1])
    for key, v in m.items():
        out[key] = v.clamp(-F16_MAX, F16_MAX).half().unflatten(0, (b, k))
    out["cam_trans"] = translation_lstsq(j24, pix, wt.float(), FOCAL,
                                         float(s)).unflatten(0, (b, k))
    if 0 < fetch < k:
        key = out["center_confs"] + torch.where(out["mask"], 1.0e4, 0.0)
        order = torch.argsort(-key, dim=1, stable=True)[:, :fetch]
        out = {n: torch.take_along_dim(
            v, order.reshape(order.shape + (1,) * (v.dim() - 2)), 1)
            for n, v in out.items()}
    return out


def judge(sd, arrays, parents: Sequence[int], images: torch.Tensor,
          prog: Dict[str, torch.Tensor], cfg: Dict) -> Dict[str, torch.Tensor]:
    """Gaps of the served outputs `prog` (leading (B, K)) of `images` from
    the reference at the configuration's precision, per image (B,). The
    reference takes the served slots' cells and computes everything else.
    - detect: the served confidence against the reference's center map
      there, how far that cell is below its 5x5 window's max (not a peak)
      and below the reference's K-th peak (not in the top K), and, where
      the mask differs from the reference's, how far the reference's score
      is from the threshold; over the map's max |value|.
    - params: betas over their max |value|; thetas by `pose_gap`.
    - mesh: verts and joints over their max |value|.
    - camera: cam, pj2d and verts_camed over their max |value|.
    - trans: cam_trans over its max |value|.
    - mask.mismatch: 1 where the served mask differs from the reference's."""
    c = Ctx(sd, cfg["compute_dtype"])
    center, params = maps(c, images, cfg["backbone"])
    b, h, w = center.shape
    s = cfg["input_size"]
    k = prog["center_confs"].shape[1]
    cell = (prog["centers"].float() * w / s).round().long()
    flat = (cell[..., 1] * w + cell[..., 0]).clamp(0, h * w - 1)
    conf = prog["center_confs"].float()
    zero = conf == 0.0     # a pick among the map's zeros (fewer peaks than K)
    ref = torch.where(zero, 0.0, center.flatten(1).gather(1, flat))
    win = F.max_pool2d(center[:, None], 5, 1, 2)[:, 0].flatten(1).gather(
        1, flat)
    kth = torch.topk(nms(center).flatten(1), k, dim=1).values[:, -1:]
    mask_ref = ref > cfg["conf_thresh"]
    scale = center.flatten(1).abs().amax(1)
    detect = {
        "detect.score": worst((conf - ref).abs()) / scale,
        "detect.peak": worst(torch.where(zero, 0.0, win - ref)) / scale,
        "detect.rank": worst((kth - ref).clamp(min=0.0)) / scale,
        "detect.mask": worst(torch.where(mask_ref != prog["mask"].bool(),
                                         (ref - cfg["conf_thresh"]).abs(),
                                         0.0)) / scale}

    gaps = dict(detect)
    p = _gather(params, flat)
    cam, _, betas = unpack(p, cfg["cam_scale_base"])
    thetas = prog["smpl_thetas"].float()
    gaps.update({"camera.cam": rel_gap(prog["cam"], cam),
                 "params.betas": rel_gap(prog["smpl_betas"], betas),
                 "params.pose": pose_gap(thetas, p[..., 3:135])})
    m = mesh(arrays, parents, cfg, cam.flatten(0, 1), thetas.flatten(0, 1),
             betas.flatten(0, 1))
    for n, v in m.items():
        group = "camera" if n in ("pj2d", "verts_camed") else "mesh"
        gaps[f"{group}.{n}"] = rel_gap(prog[n], v.unflatten(0, (b, k)))
    # the translation's joint weights are decided by the served pj2d
    # (float16: a -2 there is read both ways, the only value whose side of
    # the bound its float32 source does not fix); each slot is compared with
    # the nearer of the two solutions
    y = prog["pj2d"].flatten(0, 1)[..., 1].float()
    j24, pix, wt = trans_inputs(m, float(s), y)
    lo, hi = (translation_lstsq(j24, pix, wk.float(), FOCAL, float(s))
              .unflatten(0, (b, k)) for wk in (wt, wt | (
                  (y[:, :24] == -2.0) & (j24[..., 2] != -2.0))))
    tp = prog["cam_trans"].float()
    near = torch.where(((tp - lo).abs().amax(-1) <= (tp - hi).abs().amax(-1)
                        )[..., None], lo, hi)
    gaps["trans.cam_trans"] = rel_gap(tp, near)
    gaps["mask.mismatch"] = (mask_ref != prog["mask"].bool()).any(1).float()
    return gaps
