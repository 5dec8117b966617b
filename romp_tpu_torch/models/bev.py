"""BEV network in PyTorch (counterpart of `romp_tpu/models/bev.py`).

HRNet-W32, then the front-view head (a 2D center map and cam offsets), the
bird's-eye-view branch (the (C, H) plane of [center, cam offsets, 16
pre-stack features] folded into the channels of three 1D convs over x ->
64-level depth center map and depth cam offsets), the 3D center map as the
outer product FV(y, x) x BV(z, x) refined by a 3D block, the 3D cam map
(depth-anchor coord map + offsets) refined likewise, and an MLP over the
front features plus a depth position embedding that regresses
[22 x 6D pose | 11 betas] at each detected person.

Module names are the reference torch state-dict keys (the JAX package's
flat-dict keys). Activations are NCHW (NCDHW for the 3D maps); `BevMaps`
holds the JAX package's channels-last layout, as views.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from romp_tpu_torch.models.hrnet import Branch, hrnet32
from romp_tpu_torch.models.layers import (
    F32, BasicBlock1d, BasicBlock3d, BasicBlockConvDs, Conv2d, LayerOpts,
    batch_norm,
)
from romp_tpu_torch.ops.centermap import CenterDetections3D

OUTMAP = 128
DEPTH_LEVELS = 64
NUM_PARAMS_BEV = 143     # 22 * 6 pose + 11 betas
HEAD_CH = 128
BV_CH = OUTMAP // 8      # 16
BACKBONE_CH = 32
# channels per map row that the BV branch folds: center 1 + cam offset 3 +
# the pre-stack's 16
BV_ROW_CH = 4 + BV_CH


def cam3dmap_anchor(fov_deg: float = 60.0, size: int = OUTMAP) -> np.ndarray:
    """Depth-anchor scale per depth level (`bev.py:43`): piecewise-linear
    weak-perspective scale over four depth bands (1/10/20/100 m), each band
    a fixed share of the 64 bins, seeded at 8."""
    depth_level = np.array([1.0, 10.0, 20.0, 100.0], np.float32)
    bins = (np.array([2, 25, 3, 2], np.float32) / 64.0 * size).astype(np.int32)
    scales = 1.0 / np.tan(np.radians(fov_deg / 2.0)) / depth_level
    out, prev = [], 8.0
    for scale, n in zip(scales, bins):
        out.append(prev - np.arange(1, n + 1) / n * (prev - scale))
        prev = scale
    return np.concatenate(out).astype(np.float32)


def coord_maps_3d_halfz(size: int, z_base: np.ndarray) -> np.ndarray:
    """(1, D, size, size, 3): channel 0 the depth-anchor scale, channels 1,
    2 = y, x in [-1, 1) (`bev.py:61`, the JAX layout)."""
    D = len(z_base)
    r = (np.arange(size, dtype=np.float32) / size) * 2.0 - 1.0
    Z = np.broadcast_to(z_base[:, None, None], (D, size, size))
    Y = np.broadcast_to(r[None, :, None], (D, size, size))
    X = np.broadcast_to(r[None, None, :], (D, size, size))
    return np.stack([Z, Y, X], axis=-1)[None].astype(np.float32)


class Head(nn.ModuleList):
    """`_head_block` (`bev.py:72`), TRACE's `_head` (`trace.py:128-135`):
    `blocks` BasicBlockConvDs of 128 channels, then a 1x1 conv with bias
    when out_ch is given."""

    def __init__(self, in_ch: int, out_ch: Optional[int], blocks: int):
        mods: List[nn.Module] = [
            nn.ModuleList([BasicBlockConvDs(in_ch if b == 0 else HEAD_CH,
                                            HEAD_CH)])
            for b in range(blocks)]
        if out_ch is not None:
            mods.append(Conv2d(HEAD_CH, out_ch, 1, 1, padding=0, bias=True))
        super().__init__(mods)

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32,
                stop: Optional[int] = None, start: int = 0) -> torch.Tensor:
        """Run modules [start, stop) (all by default)."""
        for m in list(self)[start:stop]:
            x = m[0](x, opts) if isinstance(m, nn.ModuleList) else m(x, opts)
        return x


class BvPre(nn.ModuleList):
    """The BV branch's 1x1 / 3x3 / 1x1 conv-BN-ReLU stack (`bev.py:109-
    116`, `trace.py:143-150`), indices as the reference nn.Sequential
    (ReLUs at 2, 5, 8)."""

    def __init__(self, in_ch: int, ch: int = BV_CH):
        super().__init__([
            Conv2d(in_ch, ch, 1, 1, padding=0, bias=True), batch_norm(ch),
            nn.ReLU(),
            Conv2d(ch, ch, 3, 1, bias=True), batch_norm(ch), nn.ReLU(),
            Conv2d(ch, ch, 1, 1, padding=0, bias=True), batch_norm(ch),
            nn.ReLU()])

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        for i in (0, 3, 6):
            x = torch.relu(self[i + 1](self[i](x, opts)))
        return x


class BvOut(nn.ModuleList):
    """Three BasicBlock1d over the (C*H)-channel 1D map along x."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__([BasicBlock1d(in_ch, 512), BasicBlock1d(512, 512),
                          BasicBlock1d(512, out_ch)])

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        for block in self:
            x = block(x, opts)
        return x


def _bv_branch(pre: BvPre, out: BvOut, feat: torch.Tensor,
               fv_maps: List[torch.Tensor], opts: LayerOpts) -> torch.Tensor:
    """FV maps + the pre-stack's features, (C, H) collapsed into 1D-conv
    channels (index c*H + h) over x: (B, out_channels, W)
    (`bev.py:118-126`, `trace.py:138-158`)."""
    B, _, H, W = feat.shape
    summon = torch.cat(fv_maps + [pre(feat, opts)], dim=1)
    return out(summon.reshape(B, -1, W), opts)


class BevMaps(NamedTuple):
    """The JAX package's BevMaps layout (channels last)."""

    center_maps_3d: torch.Tensor   # (B, D, H, W)
    cam_maps_3d: torch.Tensor      # (B, D, H, W, 3)
    center_maps_fv: torch.Tensor   # (B, H, W, 1)
    front_feats: torch.Tensor      # (B, H, W, 128)


class BevNet(nn.Module):
    """BEV (`bev.py:88-140`). map_size (input_size / 4) sets the BV 1D
    convs' channel count (C * H), as the JAX package's init does; only 128
    (512 input) matches released checkpoints."""

    def __init__(self, backbone: str = "hrnet32", map_size: int = OUTMAP):
        super().__init__()
        self.backbone = hrnet32(backbone)
        C = BACKBONE_CH
        self.det_head = Head(C, 4, 1)
        self.bv_pre_layers = BvPre(C)
        self.bv_out_layers = BvOut(BV_ROW_CH * map_size, 2 * DEPTH_LEVELS)
        self.center_map_refiner = nn.ModuleList([BasicBlock3d(1, 1)])
        self.cam_map_refiner = nn.ModuleList([BasicBlock3d(3, 3)])
        self.param_head = Head(C, None, 1)
        self.position_embeddings = nn.Embedding(OUTMAP, HEAD_CH)
        # indices as the reference nn.Sequential (ReLU, Dropout between)
        self.transformer = nn.ModuleList([
            nn.Linear(HEAD_CH, 512), nn.ReLU(), nn.Identity(),
            nn.Linear(512, 512), nn.ReLU(), nn.Identity(),
            nn.Linear(512, NUM_PARAMS_BEV)])
        anchors = cam3dmap_anchor()
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)
        self.register_buffer("coord3d", torch.from_numpy(np.ascontiguousarray(
            coord_maps_3d_halfz(map_size, anchors).transpose(0, 4, 1, 2, 3))),
            persistent=False)          # (1, 3, D, S, S)

    def pack_chains(self) -> None:
        """Pack every HRNet branch chain for the fused-chain kernel."""
        for m in self.modules():
            if isinstance(m, Branch):
                m.pack()

    def extract_features(self, images: torch.Tensor,
                         opts: LayerOpts = F32) -> torch.Tensor:
        """(B, S, S, 3) RGB in [0, 255] (uint8 or float) -> (B, 32, S/4,
        S/4) backbone features in the activation dtype (JAX's BEV keeps
        them so, `bev.py:105`)."""
        x = ((images.float() / 255.0) * 2.0 - 1.0).permute(0, 3, 1, 2)
        return self.backbone(x.contiguous(), opts)


def bev_forward_maps(net: BevNet, images: torch.Tensor,
                     opts: LayerOpts = F32) -> BevMaps:
    """(B, S, S, 3) RGB in [0, 255] -> the 3D localization maps and the
    front features (`bev.py:88-140`)."""
    return bev_head_maps(net, net.extract_features(images, opts), opts)


def bev_head_maps(net: BevNet, feat: torch.Tensor,
                  opts: LayerOpts = F32) -> BevMaps:
    """The maps from backbone features (B, 32, H, W) (`bev.py:105-140`)."""
    maps_fv = net.det_head(feat, opts)                      # (B, 4, H, W)
    center_fv = maps_fv[:, :1]
    cam_offset = maps_fv[:, 1:4]
    bv = _bv_branch(net.bv_pre_layers, net.bv_out_layers, feat,
                    [center_fv, cam_offset], opts)          # (B, 2D, W)
    D = DEPTH_LEVELS
    center_bv, camoff_bv = bv[:, :D], bv[:, D:]
    c3d = center_fv * center_bv[:, :, None, :]              # (B, D, H, W)
    c3d = net.center_map_refiner[0](c3d[:, None], opts)[:, 0]
    cam3d = net.coord3d + cam_offset[:, :, None]            # (B, 3, D, H, W)
    # the BV offset goes on channel 2 of the cam map (`bev.py:136`)
    cam3d = torch.cat([cam3d[:, :2], cam3d[:, 2:] + camoff_bv[:, None, :,
                                                              None, :]], 1)
    cam3d = net.cam_map_refiner[0](cam3d, opts)
    front = net.param_head(feat, opts)                      # (B, 128, H, W)
    return BevMaps(c3d, cam3d.movedim(1, -1), center_fv.movedim(1, -1),
                   front.movedim(1, -1))


def cam_to_depth_bin(cam_scale: torch.Tensor,
                     anchors: torch.Tensor) -> torch.Tensor:
    """Index of the nearest depth anchor (`bev.py:143`); ties go to the
    lower index, as `jnp.argmin`."""
    return torch.argmin((cam_scale[..., None] - anchors).abs(), dim=-1)


def _gather_channels(maps: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """maps (B, ..., C), a channels-last view of a channels-first tensor;
    flat (B, K) indices into its spatial cells, clamped into range (as the
    JAX gathers clip them). Returns (B, K, C), read from the channels-first
    storage without a copy of the maps."""
    B, C = maps.shape[0], maps.shape[-1]
    planes = maps.movedim(-1, 1).reshape(B, C, -1)
    idx = flat.long().clamp(0, planes.shape[2] - 1)
    return torch.gather(planes, 2, idx[:, None, :].expand(-1, C, -1)
                        ).transpose(1, 2)


def bev_regress_params(net: BevNet, maps: BevMaps,
                       det: CenterDetections3D) -> torch.Tensor:
    """Cams at the 3D peaks, then the MLP at the front features plus the
    depth position embedding (`bev.py:150`). Returns (B, K, 146) f32:
    [cam(3) | 6D pose (132) | betas (11)]."""
    B, D, H, W, _ = maps.cam_maps_3d.shape
    zyx = det.zyx.long()
    flat3d = (zyx[..., 0] * H + zyx[..., 1]) * W + zyx[..., 2]
    cams = _gather_channels(maps.cam_maps_3d, flat3d)       # (B, K, 3)
    # cam -> (cz, cy, cx) on the fixed 128 map, clamped to [1, 127]
    cz = cam_to_depth_bin(cams[..., 0], net.anchors)
    cz_norm = cz.float() / 128.0 * 2.0 - 1.0
    cyx = torch.cat([cz_norm[..., None], cams[..., 1:]], dim=-1)
    czyx = ((cyx + 1.0) / 2.0 * OUTMAP).to(torch.int32).clamp(1, OUTMAP - 1)
    feat = _gather_channels(maps.front_feats, czyx[..., 1] * W + czyx[..., 2])
    h = feat + net.position_embeddings(czyx[..., 0].long())
    t = net.transformer
    h = torch.relu(t[0](h))
    h = torch.relu(t[3](h))
    return torch.cat([cams, t[6](h)], dim=-1)


def init_bev_params(generator: torch.Generator, input_size: int = 512,
                    backbone: str = "hrnet32") -> Dict[str, torch.Tensor]:
    """A fresh seeded state dict, initialized by the JAX package's rule
    (`layers.py:80-91`): every conv, Linear and Embedding weight He-normal
    over the product of all but the last dim of its stored shape (Cin *
    kernel for a conv; the first dim for a Linear (out, in) and for the
    Embedding), biases 0, BatchNorm weight 1, bias 0, mean 0, var 1. The
    numbers differ from JAX's (another generator); the distributions do
    not."""
    net = BevNet(backbone, input_size // 4)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
                fan_in = m.weight[0].numel()
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                fan_in = m.weight.shape[0]
            else:
                continue
            m.weight.normal_(0.0, (2.0 / max(fan_in, 1)) ** 0.5,
                             generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
    return net.state_dict()


def calibrate_bev_batchnorm(net: BevNet, images: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to those of its input on
    `images` (B, S, S, 3) RGB in [0, 255]: one train-mode pass with a
    cumulative average, as `romp.py:calibrate_batchnorm` does for ROMP. For
    random weights, whose untouched statistics let activations grow layer
    by layer. Leaves the net in eval mode."""
    bns = [m for m in net.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.momentum = None
        m.reset_running_stats()
    with torch.no_grad():
        net.train()
        bev_forward_maps(net, images)
    for m in bns:
        m.momentum = 0.1
    net.eval()
