"""TRACE temporal head in PyTorch (counterpart of `romp_tpu/models/trace.py`).

ConvGRU features over the clip plus a deformable-conv warp along predicted
motion offsets (the deform kernel, `romp_tpu_torch/ops/deform_conv.py`);
BEV-style coarse-to-fine 3D localization with a zero-z coord map; 3D
motion maps; camera-motion and camera-rotation heads; four TemporalEncoder
MLP regressors over per-track trajectory features.

Module names are the reference torch state_dict keys, which are also the
JAX package's flat-dict keys, so `load_state_dict(strict=True)` takes the
bridged JAX dict (`utils/checkpoint.py:state_dict_from_jax`). Activations
are NCHW (NCDHW for the 3D maps) inside; `trace_forward_maps` returns its
`TraceMaps` in the JAX package's channels-last layout, as views.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from romp_tpu_torch.models.bev import (
    BvOut, BvPre, Head, _bv_branch, cam3dmap_anchor,
)
from romp_tpu_torch.models.hrnet import hrnet32
from romp_tpu_torch.models.layers import (
    F32, BasicBlock, BasicBlock3d, BasicBlockConvDs, Conv2d, LayerOpts,
    _Bf16Cast, at_least_f32,
)
from romp_tpu_torch.ops.deform_conv import deform_conv2d

OUTMAP = 128
DEPTH_LEVELS = 64
HC = 128
BACKBONE_CH = 32
DEFORM_GROUPS = 8
SMPL_SHAPE_DIM = 21
TRACE_FOV = 50.0
# channels per map row that the BV branch collapses: center 1 + cam offset 3
# + local residual 3 + the pre-stack's 16
BV_ROW_CH = 7 + OUTMAP // 8


def trace_cam_anchor() -> np.ndarray:
    return cam3dmap_anchor(TRACE_FOV, OUTMAP)


def coord_maps_3d_zeroz(size: int = OUTMAP, zsize: int = DEPTH_LEVELS,
                        device=None) -> torch.Tensor:
    """(1, 3, D, S, S): channel 0 (z) zero, channels 1, 2 = y, x in [-1, 1)
    (`trace.py:50-58`, NCDHW here)."""
    r = (torch.arange(size, dtype=torch.float32, device=device) / size
         ) * 2.0 - 1.0
    yy = r.view(1, size, 1).expand(zsize, size, size)
    xx = r.view(1, 1, size).expand(zsize, size, size)
    return torch.stack([torch.zeros_like(yy), yy, xx], dim=0)[None]


class ConvGRUCell(nn.Module):
    """ConvGRU cell over (B, C, H, W) (`trace.py:63-75`)."""

    def __init__(self, in_ch: int, hidden: int):
        super().__init__()
        self.convz = Conv2d(in_ch + hidden, hidden, 3, bias=True)
        self.convr = Conv2d(in_ch + hidden, hidden, 3, bias=True)
        self.convq = Conv2d(in_ch + hidden, hidden, 3, bias=True)

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                opts: LayerOpts = F32) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx, opts))
        r = torch.sigmoid(self.convr(hx, opts))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1), opts))
        return (1.0 - z) * h + z * q


class ConvGRU(nn.Module):
    """Stacked ConvGRU (`trace.py:78-111`), state dict `temp_model.*`."""

    def __init__(self, ch: int = BACKBONE_CH, num_layers: int = 2):
        super().__init__()
        self.cell_list = nn.ModuleList(
            [ConvGRUCell(ch, ch) for _ in range(num_layers)])

    def forward(self, x_seq: torch.Tensor,
                hidden: Optional[List[torch.Tensor]],
                opts: LayerOpts = F32
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x_seq (B, T, C, H, W) -> (B, T, C, H, W) and the last hidden
        state per layer. With hidden None, the reference's warm start: the
        first frame is prepended and its output dropped."""
        drop_first = hidden is None
        if drop_first:
            B, _, C, H, W = x_seq.shape
            hidden = [x_seq.new_zeros((B, C, H, W)) for _ in self.cell_list]
            x_seq = torch.cat([x_seq[:, :1], x_seq], dim=1)
        cur = x_seq
        new_hidden = []
        for cell, h in zip(self.cell_list, hidden):
            outs = []
            for t in range(cur.shape[1]):
                h = cell(h, cur[:, t], opts)
                outs.append(h)
            new_hidden.append(h)
            cur = torch.stack(outs, dim=1)
        if drop_first:
            cur = cur[:, 1:]
        return cur, new_hidden


class TemporalEncoder(nn.Module):
    """MLP trajectory regressor (`trace.py:114-123`): two ReLU Linear
    layers, then one Linear head per output, concatenated."""

    def __init__(self, in_ch: int, out_sizes: Sequence[int],
                 hidden: int = 256):
        super().__init__()
        self.regressor = nn.Sequential(nn.Linear(in_ch, hidden), nn.ReLU(),
                                       nn.Linear(hidden, hidden), nn.ReLU())
        self.out_layers = nn.ModuleList(
            [nn.Linear(hidden, s) for s in out_sizes])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # bf16 features promote to f32 against the f32 weights, as JAX's
        # `x @ w.T + b` does (an f64 net stays f64)
        y = self.regressor(at_least_f32(x))
        return torch.cat([layer(y) for layer in self.out_layers], dim=-1)


class DeformWarp(_Bf16Cast, nn.Module):
    """Holds `deform_warper.weight` (Cout, C, 3, 3); 8 deform groups. The
    warp runs in the activation dtype (`trace.py:198-201`): f32 features
    and weight, or bf16 ones (the weight cast once by `cast_bf16`), with
    f32 offsets; the result is f32 either way."""

    def __init__(self, ch: int = BACKBONE_CH):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(ch, ch, 3, 3))

    def cast_bf16(self) -> None:
        self._set_bf16(weight=self.weight.to(torch.bfloat16).contiguous())

    def forward(self, x: torch.Tensor, offsets: torch.Tensor,
                opts: LayerOpts = F32) -> torch.Tensor:
        offsets = at_least_f32(offsets).contiguous()
        if opts.bf16_act:
            return deform_conv2d(x.to(torch.bfloat16).contiguous(), offsets,
                                 self._bf16("weight"), DEFORM_GROUPS)
        return deform_conv2d(at_least_f32(x).contiguous(), offsets,
                             at_least_f32(self.weight).contiguous(),
                             DEFORM_GROUPS)


class TraceMaps(NamedTuple):
    """The JAX package's TraceMaps layout (channels last)."""

    center_maps_3d: torch.Tensor    # (T, D, H, W)
    center_maps_fv: torch.Tensor    # (T, H, W, 1)
    cam_maps_3d: torch.Tensor       # (T, D, H, W, 3)
    motion_maps_3d: torch.Tensor    # (T, D, H, W, 3)
    motion_maps_fv: torch.Tensor    # (T, H, W, 3)
    mesh_feature_maps: torch.Tensor  # (T, H, W, 128)
    cam_motion_maps: torch.Tensor   # (T, H, W, 3)
    cam_rot_maps: torch.Tensor      # (T, H, W, 6)


class TraceNet(nn.Module):
    """The TRACE head, plus the frozen HRNet image backbone under
    `backbone.*` unless `backbone` is None (a head fed stand-in features).

    map_size sets the BV 1D convs' channel count (C * H), as in the JAX
    package; only 128 matches released checkpoints."""

    def __init__(self, backbone: Optional[str] = "hrnet32",
                 map_size: int = OUTMAP):
        super().__init__()
        if backbone is not None:
            self.backbone = hrnet32(backbone)
        C, H = BACKBONE_CH, map_size
        self.temp_model = ConvGRU(C)
        self.offset_feature_convert = nn.ModuleList(
            [BasicBlock(C, C) for _ in range(3)])
        self.feature_offset_predictor = Conv2d(C, DEFORM_GROUPS * 2 * 9, 3)
        self.deform_warper = DeformWarp(C)
        self.det_head = Head(C, 1 + 3 * 2, 1)
        self.bv_pre_layers = BvPre(C)
        self.bv_out_layers = BvOut(BV_ROW_CH * H, DEPTH_LEVELS * 3)
        self.center_map_refiner2 = nn.ModuleList([BasicBlock3d(1, 1)])
        self.cam_map_refiner = nn.ModuleList([BasicBlock3d(3, 3)])
        self.param_head = Head(C + 2, None, 2)
        self.motion_head = Head(C + 2, 3, 2)
        self.bv_motion_pre_layers = BvPre(C + 2)
        self.bv_motion_out_layers = BvOut((3 + OUTMAP // 8) * H,
                                          DEPTH_LEVELS)
        self.motion_map_refiner = nn.ModuleList([BasicBlock3d(3, 3)])
        self.cam_motion_head = Head(C + 2, 3, 6)
        self.cam_rot_head = nn.ModuleList([
            BasicBlockConvDs(HC, HC),
            Conv2d(HC, 6, 1, 1, padding=0, bias=True)])
        self.temp_globalrot_regressor = TemporalEncoder(HC, (6, 6))
        self.temp_smplpose_regressor = TemporalEncoder(HC, (126,))
        self.temp_smplshape_regressor = TemporalEncoder(HC, (SMPL_SHAPE_DIM,))
        self.temp_trans_regressor = TemporalEncoder(HC + 3, (3,))
        self.position_embeddings = nn.Embedding(OUTMAP, HC)

    def extract_features(self, images: torch.Tensor,
                         opts: LayerOpts = F32) -> torch.Tensor:
        """(T, S, S, 3) RGB in [0, 255] (uint8 or float) -> (T, 32, S/4,
        S/4) f32 backbone features (`trace_pipeline.py:98-105`)."""
        return backbone_features(self.backbone, images, opts)


def backbone_features(backbone: nn.Module, images: torch.Tensor,
                      opts: LayerOpts = F32) -> torch.Tensor:
    """An HRNet image backbone (TraceNet's, or ROMP's for TRACE training's
    frozen features) on (T, S, S, 3) RGB in [0, 255] -> (T, 32, S/4, S/4)
    f32 features."""
    x = ((images.float() / 255.0) * 2.0 - 1.0).permute(0, 3, 1, 2)
    return at_least_f32(backbone(x.contiguous(), opts))


def extract_temporal_features(net: TraceNet, feats: torch.Tensor,
                              hidden: Optional[List[torch.Tensor]],
                              temp_clip_length: int, opts: LayerOpts = F32,
                              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(T+1, C, H, W) features (frame 0 = the previous clip's last frame)
    -> (T, C, H, W) temporally fused features (`trace.py:172-197`)."""
    T1, C, H, W = feats.shape
    clip = min(temp_clip_length, T1 - 1)
    seq = feats[1:].reshape(-1, clip, C, H, W)
    temp_feats, hidden = net.temp_model(seq, hidden, opts)
    temp_feats = temp_feats.reshape(-1, C, H, W)
    mo = feats[1:] - feats[:-1]
    for block in net.offset_feature_convert:
        mo = block(mo, opts)
    offsets = net.feature_offset_predictor(mo, opts)
    # the warp runs in the activation dtype: f32 on the f32 and mixed
    # paths, bf16 features and weight on the bf16-activation path; the
    # offsets stay f32
    warped = net.deform_warper(feats[1:], offsets, opts)
    return temp_feats + warped + feats[1:], hidden


def trace_forward_maps(net: TraceNet, feats: torch.Tensor,
                       flows: torch.Tensor,
                       hidden: Optional[List[torch.Tensor]] = None,
                       temp_clip_length: int = 8, opts: LayerOpts = F32,
                       ) -> Tuple[TraceMaps, List[torch.Tensor]]:
    """All maps of one clip (`trace.py:200-277`).

    feats: (T+1, 32, H, W) backbone features (frame 0 = carry-over);
    flows: (T, 2, H, W) optical flow. Returns TraceMaps (channels last, as
    the JAX package) and the ConvGRU hidden state to carry.
    """
    feats, hidden = extract_temporal_features(net, feats, hidden,
                                              temp_clip_length, opts)
    T, _, H, W = feats.shape
    D = DEPTH_LEVELS
    coord3d = coord_maps_3d_zeroz(H, D, feats.device)

    # coarse-to-fine localization
    maps_fv = net.det_head(feats, opts)                    # (T, 7, H, W)
    center_fv = maps_fv[:, :1]
    cam_offset = maps_fv[:, 1:4]
    local_res = maps_fv[:, 4:7]
    bv_out = _bv_branch(net.bv_pre_layers, net.bv_out_layers, feats,
                        [center_fv, cam_offset, local_res], opts)
    center_bv = bv_out[:, :D]                              # (T, D, W)
    camoff_bv = bv_out[:, D:2 * D]
    c3d = center_fv * center_bv[:, :, None, :]             # (T, D, H, W)
    c3d = net.center_map_refiner2[0](c3d[:, None], opts)[:, 0]
    cam3d = coord3d + cam_offset[:, :, None]               # (T, 3, D, H, W)
    cam3d = torch.cat([cam3d[:, :1] + camoff_bv[:, None, :, None, :],
                       cam3d[:, 1:]], dim=1)               # z offset
    cam3d = net.cam_map_refiner[0](cam3d, opts)

    combined = torch.cat([flows, feats], dim=1)
    mesh_feats = net.param_head(combined, opts)

    # motion regression
    motion_fv = net.motion_head(combined, opts)            # (T, 3, H, W)
    motion_bv = _bv_branch(net.bv_motion_pre_layers, net.bv_motion_out_layers,
                           combined, [motion_fv], opts)    # (T, D, W)
    m3d = motion_fv[:, :, None] + motion_bv[:, None, :, None, :]
    m3d = net.motion_map_refiner[0](m3d, opts)
    # frame 0 of each clip has no supervised motion; out of place, as the
    # refiner's backward may have saved its output
    m3d = torch.cat([torch.zeros_like(m3d[:1]), m3d[1:]])

    # camera motion / rotation: cam_motion_head's first 5 blocks are the
    # shared features; block 5 + the 1x1 conv give the cam motion, and
    # cam_rot_head reads the shared features (`trace.py:250-264`)
    shared = net.cam_motion_head(combined, opts, stop=5)
    cam_motion = net.cam_motion_head(shared, opts, start=5)
    cam_rot = net.cam_rot_head[1](net.cam_rot_head[0](shared, opts), opts)

    def last(t):
        return t.movedim(1, -1)

    return TraceMaps(c3d, last(center_fv), last(cam3d), last(m3d),
                     last(motion_fv), last(mesh_feats), last(cam_motion),
                     last(cam_rot)), hidden


def trace_regress_trajectory(net: TraceNet,
                             traj_features: torch.Tensor) -> torch.Tensor:
    """(N, T, 128) -> (N, T, 159) [world grot 6 | cam grot 6 | pose 126 |
    betas 21] (`trace.py:280-291`)."""
    return torch.cat([net.temp_globalrot_regressor(traj_features),
                      net.temp_smplpose_regressor(traj_features),
                      net.temp_smplshape_regressor(traj_features)], dim=-1)


def trace_regress_trans(net: TraceNet, cams_init: torch.Tensor,
                        traj_features: torch.Tensor) -> torch.Tensor:
    """(N, T, 3) + (N, T, 128) -> (N, T, 3) normalized cams
    (`trace.py:294-298`)."""
    return net.temp_trans_regressor(torch.cat([cams_init, traj_features],
                                              dim=-1))


def init_trace_params(generator: torch.Generator, clip_length: int = 4,
                      map_size: int = OUTMAP,
                      backbone: Optional[str] = "hrnet32",
                      ) -> Dict[str, torch.Tensor]:
    """A fresh seeded state dict, initialized by the JAX package's rule
    (`layers.py:80-91`): every conv, Linear and Embedding weight He-normal
    over the product of all but the last dim of ITS stored shape (for a conv
    that is Cin * kernel, for a Linear (out, in) it is `out`), biases 0, BN
    weight 1, bias 0, running mean 0, var 1; `deform_warper.weight`
    N(0, 0.02^2). The numbers differ from JAX's (another generator); the
    distributions do not. clip_length is accepted for the JAX signature and
    shapes nothing."""
    del clip_length
    net = TraceNet(backbone, map_size)
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
        net.deform_warper.weight.normal_(0.0, 0.02, generator=generator)
    return net.state_dict()


def calibrate_trace_batchnorm(net: TraceNet, feats: torch.Tensor,
                              temp_clip_length: int) -> None:
    """Set every BatchNorm of the head to its input's statistics on one
    clip of features (T+1, 32, H, W), with zero flow: one train-mode pass
    with a cumulative average (as `romp.py:calibrate_batchnorm` does for
    ROMP). For random weights, whose untouched statistics let activations
    grow layer by layer. Leaves the net in eval mode."""
    bns = [m for name, m in net.named_modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)
           and not name.startswith("backbone.")]
    for m in bns:
        m.momentum = None
        m.reset_running_stats()
    T, _, H, W = feats.shape
    flows = feats.new_zeros((T - 1, 2, H, W))
    with torch.no_grad():
        net.train()
        trace_forward_maps(net, feats, flows, None, temp_clip_length)
    for m in bns:
        m.momentum = 0.1
    net.eval()
