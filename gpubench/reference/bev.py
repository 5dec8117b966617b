"""BEV (Sun et al., CVPR'22, arXiv 2112.08274), plain: the network, the
pipeline in the served output format, and the judge of served outputs.

Network: HRNet-W32; a front-view head (center and 3 cam offsets on the 1/4
map); the bird's-eye-view branch (center, offsets and a 16-channel conv
stack folded over the map's rows into the channels of three 1D blocks
along x) giving 64 depth levels of center and depth cam offset; the 3D
center map as their outer product and the 3D cam map as depth anchors plus
offsets, each refined by a 3D BasicBlock; a 128-channel parameter head.
Pipeline: 5x5x5 NMS and the top `max_person` 3D peaks, the cams there, the
depth bin nearest each cam scale and the (y, x) cell its offsets point at,
an MLP over the front feature there plus the bin's position embedding,
SMPL+A (adult, or infant where beta 11 > 0.8), the pinhole projection,
duplicate suppression and outlier removal on the mask, float16 transfer.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference import hrnet
from gpubench.reference.geometry import (
    nms, perspective, thetas_from_6d,
)
from gpubench.reference.judge import pose_gap, rel_gap, trans_gap, worst
from gpubench.reference.nn import Ctx
from gpubench.reference.smpl import smpla

OUTMAP = 128
DEPTH = 64
HEAD_CH = 128
BV_CH = 16
TAN_FOV_HALF = math.tan(math.radians(30.0))
FOCAL = 443.4
F16_MAX = 6.0e4
BABY_THRESH = 0.8
# projections are compared where the point is at least this far (in
# metres) in front of the camera: nearer, x / z has no bound
Z_MIN = 0.1


def anchors() -> np.ndarray:
    """Depth-anchor scale of each of the 64 levels: piecewise linear from 8
    over bands to 1 / 10 / 20 / 100 m (2, 25, 3, 2 of 64 bins)."""
    levels = np.array([1.0, 10.0, 20.0, 100.0], np.float32)
    bins = (np.array([2, 25, 3, 2], np.float32) / 64.0 * OUTMAP).astype(
        np.int32)
    scales = 1.0 / np.tan(np.radians(30.0)) / levels
    out, prev = [], 8.0
    for scale, n in zip(scales, bins):
        out.append(prev - np.arange(1, n + 1) / n * (prev - scale))
        prev = scale
    return np.concatenate(out).astype(np.float32)


def coord3d(size: int, device) -> torch.Tensor:
    """(1, 3, 64, size, size): depth anchor, y, x (y, x in [-1, 1))."""
    z = torch.from_numpy(anchors()).to(device)
    r = torch.arange(size, device=device, dtype=torch.float32) / size * 2 - 1
    d = z.shape[0]
    return torch.stack([z[:, None, None].expand(d, size, size),
                        r[None, :, None].expand(d, size, size),
                        r[None, None, :].expand(d, size, size)])[None]


def head_block(c: Ctx, name: str, x: torch.Tensor) -> torch.Tensor:
    """BasicBlock to 128 channels whose shortcut is a 1x1 conv with bias."""
    out = torch.relu(c.bn(f"{name}.bn1", c.conv2d(f"{name}.conv1", x,
                                                  HEAD_CH, 3)))
    out = c.bn(f"{name}.bn2", c.conv2d(f"{name}.conv2", out, HEAD_CH, 3))
    return torch.relu(out + c.conv2d(f"{name}.downsample", x, HEAD_CH, 1,
                                     bias=True))


def block1d(c: Ctx, name: str, x: torch.Tensor, planes: int) -> torch.Tensor:
    x = torch.relu(c.bn(f"{name}.bn1", c.conv_nd_rounded(f"{name}.conv1", x,
                                                         planes)))
    return torch.relu(c.bn(f"{name}.bn2", c.conv_nd_rounded(f"{name}.conv2",
                                                            x, planes)))


def block3d(c: Ctx, name: str, x: torch.Tensor, planes: int) -> torch.Tensor:
    out = torch.relu(c.bn(f"{name}.bn1", c.conv_nd_rounded(f"{name}.conv1",
                                                           x, planes)))
    return c.bn(f"{name}.bn2", c.conv_nd_rounded(f"{name}.conv2", out,
                                                 planes)) + x


def maps(c: Ctx, images: torch.Tensor, backbone: str = "hrnet32"):
    """-> center (B, 64, H, W), cam (B, 3, 64, H, W), front (B, 128, H, W)."""
    feat = hrnet.hrnet(c, hrnet.normalize(images), hrnet.DEPTHS[backbone])
    b, _, h, w = feat.shape
    fv = c.conv2d("det_head.1", head_block(c, "det_head.0.0", feat), 4, 1,
                  bias=True)
    center_fv, cam_off = fv[:, :1], fv[:, 1:4]
    pre = feat
    for i, k in ((0, 1), (3, 3), (6, 1)):
        pre = torch.relu(c.bn(f"bv_pre_layers.{i + 1}", c.conv2d(
            f"bv_pre_layers.{i}", pre, BV_CH, k, bias=True)))
    bv = torch.cat([center_fv, cam_off, pre], 1).reshape(b, -1, w)
    for i, planes in enumerate((512, 512, 2 * DEPTH)):
        bv = block1d(c, f"bv_out_layers.{i}", bv, planes)
    center = center_fv * bv[:, :DEPTH, None, :]
    center = block3d(c, "center_map_refiner.0", center[:, None], 1)[:, 0]
    cam = coord3d(h, feat.device).to(feat.dtype) + cam_off[:, :, None]
    cam = torch.cat([cam[:, :2], cam[:, 2:] + bv[:, None, DEPTH:, None, :]], 1)
    cam = block3d(c, "cam_map_refiner.0", cam, 3)
    return center, cam, head_block(c, "param_head.0.0", feat)


def mlp(c: Ctx, feat: torch.Tensor, cz: torch.Tensor) -> torch.Tensor:
    h = feat + c.embedding("position_embeddings", cz, OUTMAP, HEAD_CH)
    h = torch.relu(c.linear("transformer.0", h, 512))
    h = torch.relu(c.linear("transformer.3", h, 512))
    return c.linear("transformer.6", h, 143)


def forward(c: Ctx, images: torch.Tensor, backbone: str = "hrnet32"):
    """The network with the MLP at one cell an image (for `spec_of`, the
    calibration and the FLOP count)."""
    center, cam, front = maps(c, images, backbone)
    zero = torch.zeros(images.shape[0], 1, dtype=torch.long,
                       device=images.device)
    return center, cam, mlp(c, front.flatten(2)[..., :1].transpose(1, 2),
                            zero)


def cells_of(cams: torch.Tensor, h: int, w: int):
    """The depth bin nearest each cam scale (ties to the lower) and the
    (y, x) cell its offsets point at on the 128 grid, clamped to [1, 127]
    (the published code's fixed 128 map): (cz, flat index into (h, w))."""
    anc = torch.from_numpy(anchors()).to(cams.device)
    cz = torch.argmin((cams[..., :1] - anc).abs(), dim=-1)
    cyx = torch.cat([(cz.float() / OUTMAP * 2.0 - 1.0)[..., None],
                     cams[..., 1:]], -1)
    czyx = ((cyx + 1.0) / 2.0 * OUTMAP).to(torch.int32).clamp(1, OUTMAP - 1)
    flat = (czyx[..., 1] * w + czyx[..., 2]).long().clamp(0, h * w - 1)
    return czyx[..., 0].long(), flat


def _at(a: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """a (B, C, ...) at flat spatial indices (B, K) -> (B, K, C)."""
    a = a.flatten(2)
    return a.gather(2, flat[:, None, :].expand(-1, a.shape[1], -1)
                    ).transpose(1, 2)


def cam_to_trans(cam: torch.Tensor) -> torch.Tensor:
    depth = 1.0 / (cam[..., 0] * TAN_FOV_HALF + 1e-3)
    xy = torch.stack([cam[..., 2], cam[..., 1]], -1) * (depth * TAN_FOV_HALF
                                                         )[..., None]
    return torch.cat([xy, depth[..., None]], -1)


def prune(mask, pj2d, scale, trans, cfg: Dict) -> torch.Tensor:
    """Duplicate suppression (of each valid pair whose projected joints lie
    closer than the threshold, the smaller goes) and isolated-outlier
    removal (small persons far from the rest; only with 3 or more)."""
    k = mask.shape[1]
    dn = torch.linalg.vector_norm(pj2d[:, :, None] - pj2d[:, None], dim=-1
                                  ).mean(-1)
    ps = scale * 2.0
    dn = dn / torch.maximum(ps[:, :, None], ps[:, None, :])
    upper = torch.ones((k, k), dtype=torch.bool, device=mask.device).triu(1)
    dup = upper & mask[:, :, None] & mask[:, None, :] & (
        dn < cfg["nms_thresh"] * cfg["input_size"] / 640.0)
    smaller = ps[:, :, None] < ps[:, None, :]
    mask = mask & ~((dup & smaller).any(2) | (dup & ~smaller).any(1))
    n = mask.sum(1, keepdim=True)
    both = mask[:, :, None] & mask[:, None, :]
    d = torch.where(both, torch.linalg.vector_norm(
        trans[:, :, None] - trans[:, None], dim=-1), 0.0)
    far = torch.where(both, d, float("-inf")).amax(2)
    mean = torch.where(mask, (d.sum(2) - far) / (n - 2).clamp(min=1), 0.0)
    others = (mean.sum(1, keepdim=True) - mean) / (n - 1).clamp(min=1)
    out = ((mean / (others + 1e-8) > cfg["relative_scale_thresh"])
           & (scale < cfg["outlier_scale_thresh"]) & mask)
    return torch.where(n < 3, mask, mask & ~out)


def project(verts, joints, trans, size: int):
    focal = FOCAL * size / 512.0
    return (perspective(joints, trans, focal, size),
            torch.cat([perspective(verts, trans, focal, size),
                       verts[..., 2:3]], -1))


def _people(arrays, parents, cam, thetas, betas, is_baby, size: int):
    """SMPL+A and the projections of (B, K) persons."""
    b, k = cam.shape[:2]
    trans = cam_to_trans(cam.flatten(0, 1))
    verts, joints = smpla(arrays["adult"], arrays["baby"], parents,
                          betas.flatten(0, 1), thetas.flatten(0, 1),
                          is_baby.flatten())
    pj2d, verts_camed = project(verts, joints, trans, size)
    return {n: v.unflatten(0, (b, k)) for n, v in dict(
        verts=verts, joints=joints, pj2d=pj2d, verts_camed=verts_camed,
        cam_trans=trans).items()}


def outputs(sd, arrays, parents, images, cfg: Dict, precision: str,
            fetch: int = 0) -> Dict[str, torch.Tensor]:
    """The served outputs of `images`, computed plainly at `precision`."""
    c = Ctx(sd, precision)
    center, cam3d, front = maps(c, images, cfg["backbone"])
    b, d, h, w = center.shape
    scores, idx = torch.topk(nms(center).flatten(1), cfg["max_person"], 1)
    rem = idx % (h * w)
    zyx = torch.stack([idx // (h * w), rem // w, rem % w], -1)
    cams = _at(cam3d, idx)
    cz, flat = cells_of(cams, h, w)
    params = torch.cat([cams, mlp(c, _at(front, flat), cz)], -1)
    thetas = thetas_from_6d(params[..., 3:135])
    people = _people(arrays, parents, params[..., :3], thetas,
                     params[..., 135:146], params[..., 145] > BABY_THRESH,
                     cfg["input_size"])
    mask = prune(scores > cfg["conf_thresh"], people["pj2d"],
                 params[..., 0], people["cam_trans"], cfg)
    out = dict(mask=mask, center_confs=scores, pred_czyxs=zyx.float(),
               params_pred=params, cam=params[..., :3],
               smpl_thetas=thetas,
               smpl_betas=params[..., 135:146],
               cam_trans=people["cam_trans"])
    for n in ("verts", "joints", "pj2d", "verts_camed"):
        out[n] = people[n].clamp(-F16_MAX, F16_MAX).half()
    return out


def _ray_gap(prog_pj, ref_pj, z, size: int) -> torch.Tensor:
    """Angle (radians) between the camera rays of two projections, where
    the point is at least Z_MIN in front of the camera; (B, ...) -> (B,)."""
    k = size / 2.0 / (FOCAL * size / 512.0)
    rp = torch.cat([prog_pj.float() * k, torch.ones_like(prog_pj[..., :1],
                                                         dtype=torch.float32)],
                   -1)
    rr = torch.cat([ref_pj * k, torch.ones_like(ref_pj[..., :1])], -1)
    ang = torch.atan2(torch.linalg.cross(rp, rr, dim=-1).norm(dim=-1),
                      (rp * rr).sum(-1))
    return worst(torch.where(z > Z_MIN, ang, 0.0))


def judge(sd, arrays, parents: Sequence[int], images: torch.Tensor,
          prog: Dict[str, torch.Tensor], cfg: Dict) -> Dict[str, torch.Tensor]:
    """Gaps of the served outputs `prog` (leading (B, K)) of `images` from
    the reference at the configuration's precision, per image (B,), by
    name (group.part). The reference takes the served slots' 3D cells, the
    depth bins, cells and infant choices that the served cams and betas
    make, and the served thetas as SMPL+A's pose (each of those is checked
    itself); it computes everything else.
    - detect: as ROMP's, on the 3D center map and a 5x5x5 window.
    - params: params_pred (raw) and cam, betas over their max |value|;
      thetas by `pose_gap`.
    - mesh: verts and joints over their max |value| (verts_camed's depth
      is verts'); pj2d and verts_camed as the angle between the served
      ray and the reference's projection of the served point, where it is
      Z_MIN or more in front of the camera.
    - trans: cam_trans by `trans_gap`.
    - mask.mismatch: 1 where the served mask differs from the reference's,
      pruned on its own values (not compared: see PERF.md)."""
    c = Ctx(sd, cfg["compute_dtype"])
    center, cam3d, front = maps(c, images, cfg["backbone"])
    b, d, h, w = center.shape
    k = prog["center_confs"].shape[1]
    zyx = prog["pred_czyxs"].round().long()
    idx = ((zyx[..., 0] * h + zyx[..., 1]) * w + zyx[..., 2]).clamp(
        0, d * h * w - 1)
    conf = prog["center_confs"].float()
    zero = conf == 0.0
    ref = torch.where(zero, 0.0, center.flatten(1).gather(1, idx))
    win = F.max_pool3d(center[:, None], 5, 1, 2)[:, 0].flatten(1).gather(
        1, idx)
    kth = torch.topk(nms(center).flatten(1), k, dim=1).values[:, -1:]
    scale = center.flatten(1).abs().amax(1)
    gaps = {"detect.score": worst((conf - ref).abs()) / scale,
            "detect.peak": worst(torch.where(zero, 0.0, win - ref)) / scale,
            "detect.rank": worst((kth - ref).clamp(min=0.0)) / scale}

    served = prog["params_pred"].float()
    cams = _at(cam3d, idx)
    cz, flat = cells_of(served[..., :3], h, w)
    params = torch.cat([cams, mlp(c, _at(front, flat), cz)], -1)
    thetas = prog["smpl_thetas"].float()
    gaps.update({
        "params.raw": rel_gap(served, params),
        "params.cam": rel_gap(prog["cam"], params[..., :3]),
        "params.betas": rel_gap(prog["smpl_betas"], params[..., 135:146]),
        "params.pose": pose_gap(thetas, params[..., 3:135])})

    size = cfg["input_size"]
    people = _people(arrays, parents, params[..., :3], thetas,
                     params[..., 135:146], served[..., 145] > BABY_THRESH,
                     size)
    def depth(points, trans):
        return (points.float() + trans.float()[:, :, None])[..., 2]

    # the projections, judged against the reference's projection of the
    # served verts, joints and cam_trans (those are compared with the
    # reference's): a point near the camera plane has no bound on its
    # projection's change
    tr = prog["cam_trans"].float()
    z, zj = depth(prog["verts"], tr), depth(prog["joints"], tr)
    pj_s, vc_s = project(prog["verts"].float().flatten(0, 1),
                         prog["joints"].float().flatten(0, 1),
                         tr.flatten(0, 1), size)
    gaps.update({
        "mesh.verts": rel_gap(prog["verts"], people["verts"]),
        "mesh.joints": rel_gap(prog["joints"], people["joints"]),
        "mesh.verts_camed_z": rel_gap(prog["verts_camed"][..., 2],
                                      people["verts_camed"][..., 2]),
        "mesh.pj2d_served": _ray_gap(prog["pj2d"], pj_s.unflatten(
            0, (b, k)), zj, size),
        "mesh.verts_camed_served": _ray_gap(
            prog["verts_camed"][..., :2],
            vc_s[..., :2].unflatten(0, (b, k)), z, size)})

    mask_ref = prune(ref > cfg["conf_thresh"], people["pj2d"],
                     params[..., 0], people["cam_trans"], cfg)
    gaps["trans.cam_trans"] = trans_gap(tr, people["cam_trans"])
    gaps["mask.mismatch"] = (mask_ref != prog["mask"].bool()).any(1).float()
    return gaps
