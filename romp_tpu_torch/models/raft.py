"""RAFT optical flow in PyTorch (counterpart of `romp_tpu/models/raft.py`).

The basic RAFT: a 256-dim instance-norm feature encoder (`fnet`), a
batch-norm context encoder (`cnet`), a 4-level all-pairs correlation
pyramid read with a radius-4 window, SepConvGRU update iterations and the
convex 8x upsampling of the flow. Module names are the torch state-dict keys
(`fnet.*`, `cnet.*`, `update_block.*`), less torch's second registration of
each downsample norm (`*.downsample.1.*`, an alias of `*.norm3.*`) and the
BatchNorm counters, which `filter_raft_state_dict` drops. Activations are
NCHW; the images come in as the JAX package takes them, (B, H, W, 3) RGB in
[0, 255].

Precision (`compute_dtype`) follows the JAX flow function, whose store keeps
activations in the compute dtype (`act_dtype=dt`, `raft.py:518`):
- float32: every conv in f32 (TF32 off on the card), the reference numerics;
- bfloat16: the conv weights are stored in bf16 and every conv runs on bf16
  operands and returns bf16 (the function JAX's `preferred_element_type=
  bf16` conv computes: f32 sums, one rounding), then adds its bias in bf16
  (a second rounding, as in JAX); BatchNorm is folded into a scale and
  shift computed in f32 and applied in bf16 (`layers.py:164-168`); instance
  norm takes its statistics in f32 from the bf16 input, rounds them to bf16
  and normalizes in bf16, as `jnp.mean` / `jnp.var` of a bf16 array do.
The correlation volume is `fmap1 . fmap2^T / sqrt(C)` in f32 in both modes:
from bf16 features the products are exact in TF32, so the card runs that
matmul with TF32 on (f32 sums) and with TF32 off in f32 mode. The flow
accumulator (coords1) stays f32.

The lookup is one gather: the levels are zero-padded by one cell on every
side and packed into one row per query point, so each window's (2r+2)^2
integer taps of all four levels come in one `torch.gather` (indices clamped
into the zero border), then the shared-fraction bilinear blend in f32. This
is `corr_lookup_onehot`'s selection and blend (`raft.py:101`); the JAX
package's three TPU layouts of it are not ported.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

HDIM = CDIM = 128
CORR_LEVELS = 4
CORR_RADIUS = 4
EPS = 1e-5


class Conv(nn.Conv2d):
    """Conv2d with bias and torch's symmetric padding ((k - 1) // 2 per
    axis unless given); the input is cast to the weight's dtype, so a net
    whose conv weights are bf16 runs its convs on bf16 operands. The bias
    is added to the conv's output in that dtype, as JAX does (and as
    PyTorch's cuDNN path does anyway: a separate add)."""

    def __init__(self, in_ch: int, out_ch: int, kernel=3, stride: int = 1,
                 padding=None):
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        if padding is None:
            padding = ((kh - 1) // 2, (kw - 1) // 2)
        super().__init__(in_ch, out_ch, (kh, kw), stride, padding, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.weight.dtype), self.weight, None,
                        self.stride, self.padding) + self.bias[:, None, None]


class BatchNorm(nn.Module):
    """Inference BatchNorm2d with torch's parameter names and without the
    counter: (x - mean) * inv + bias in f32 (`layers.py:170`), the folded
    scale and shift in the activation dtype otherwise (`:164-168`). The
    statistics stay f32 whatever the convs' dtype."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + EPS) * self.weight
        if x.dtype == torch.float32:
            return ((x - self.running_mean[:, None, None]) * inv[:, None, None]
                    + self.bias[:, None, None])
        shift = self.bias - self.running_mean * inv
        return (x * inv.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


class InstanceNorm(nn.Module):
    """Parameter-free InstanceNorm2d (`raft.py:28`); statistics in f32,
    rounded to the activation dtype, the normalization in that dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x.float(), dim=(2, 3), correction=0,
                                   keepdim=True)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        return (x - mean) * torch.rsqrt(var + EPS)


def _norm(kind: str, ch: int) -> nn.Module:
    return InstanceNorm() if kind == "instance" else BatchNorm(ch)


class ResidualBlock(nn.Module):
    """`_residual_block` (`raft.py:43`); the downsample norm is `norm3`."""

    def __init__(self, in_ch: int, planes: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_ch, planes, 3, stride)
        self.conv2 = Conv(planes, planes, 3, 1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.ModuleList(
                [Conv(in_ch, planes, 1, stride, padding=0)])
            self.norm3 = _norm(norm, planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample[0](x))
        return torch.relu(x.to(y.dtype) + y)


class BasicEncoder(nn.Module):
    """`basic_encoder` (`raft.py:58`): (B, 3, H, W) in [-1, 1] ->
    (B, output_dim, H/8, W/8)."""

    def __init__(self, output_dim: int, norm: str):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, padding=3)
        self.norm1 = _norm(norm, 64)
        layers, in_ch = [], 64
        for planes, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.ModuleList([
                ResidualBlock(in_ch, planes, norm, stride),
                ResidualBlock(planes, planes, norm, 1)]))
            in_ch = planes
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = Conv(128, output_dim, 1, 1, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x)
        return self.conv2(x)


class MotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        cor_planes = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2
        self.convc1 = Conv(cor_planes, 256, 1, 1, padding=0)
        self.convc2 = Conv(256, 192, 3)
        self.convf1 = Conv(2, 128, 7, 1, padding=3)
        self.convf2 = Conv(128, 64, 3)
        self.conv = Conv(64 + 192, 128 - 2, 3)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        # JAX concatenates the f32 flow (promoting the result); the convs
        # that read it cast to their dtype, so the flow goes in cast
        return torch.cat([out, flow.to(out.dtype)], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int = HDIM, inp: int = 128 + CDIM):
        super().__init__()
        for suffix, k in (("1", (1, 5)), ("2", (5, 1))):
            for gate in ("convz", "convr", "convq"):
                setattr(self, gate + suffix, Conv(hidden + inp, hidden, k))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, "convz" + suffix)(hx))
            r = torch.sigmoid(getattr(self, "convr" + suffix)(hx))
            q = torch.tanh(getattr(self, "convq" + suffix)(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv(HDIM, 256, 3)
        self.conv2 = Conv(256, 2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = MotionEncoder()
        self.gru = SepConvGRU()
        self.flow_head = FlowHead()
        self.mask = nn.ModuleList([Conv(HDIM, 256, 3), nn.ReLU(),
                                   Conv(256, 64 * 9, 1, 1, padding=0)])

    def mask_head(self, net: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask[2](torch.relu(self.mask[0](net)))


class Raft(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(HDIM + CDIM, "batch")
        self.update_block = UpdateBlock()

    def set_compute_dtype(self, dtype: torch.dtype) -> "Raft":
        """Store every conv's weight and bias in `dtype` (the norms keep
        f32 statistics)."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.to(dtype)
        return self


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       out_dtype=torch.float32) -> List[torch.Tensor]:
    """All-pairs correlation and 2x2 average pools (`raft.py:71`).

    fmap*: (B, C, H, W). Returns the levels as (B*H*W, 1, H_i, W_i) in
    out_dtype, the volume computed in f32 (TF32 on only for bf16 features,
    whose products it keeps exact)."""
    B, C, H, W = fmap1.shape
    a = fmap1.float().reshape(B, C, H * W).transpose(1, 2)
    b = fmap2.float().reshape(B, C, H * W)
    with _matmul_tf32(fmap1.dtype == torch.bfloat16):
        corr = torch.bmm(a, b)
    corr = (corr / math.sqrt(C)).reshape(B * H * W, 1, H, W).to(out_dtype)
    pyramid = [corr]
    for _ in range(CORR_LEVELS - 1):
        h, w = corr.shape[2:]
        # a level under 2x2 pools to an empty one, as JAX's VALID window
        # does; its lookup taps all fall outside the map and read zero
        corr = (F.avg_pool2d(corr, 2, 2) if min(h, w) >= 2 else
                corr.new_zeros(corr.shape[:2] + (h // 2, w // 2)))
        pyramid.append(corr)
    return pyramid


@contextlib.contextmanager
def _matmul_tf32(allow: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class PackedPyramid:
    """The pyramid levels, each zero-padded by one cell on every side,
    flattened and concatenated into one (B*H*W, sum (H_i+2)(W_i+2)) buffer,
    built once a clip: one gather then reads a window's taps on all
    levels."""

    def __init__(self, pyramid: List[torch.Tensor]):
        dev = pyramid[0].device
        flat, dims, off = [], [], 0
        for corr in pyramid:
            Hi, Wi = corr.shape[2:]
            flat.append(F.pad(corr, (1, 1, 1, 1)).flatten(1))
            dims.append((Hi, Wi, off))
            off += (Hi + 2) * (Wi + 2)
        self.buf = torch.cat(flat, dim=1)
        L = len(dims)

        def col(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=dev).view(L, 1, 1, 1)

        self.scale = col([2.0 ** -i for i in range(L)], torch.float32)
        self.hmax = col([h + 1 for h, _, _ in dims], torch.int64)
        self.wmax = col([w + 1 for _, w, _ in dims], torch.int64)
        self.stride = col([w + 2 for _, w, _ in dims], torch.int64)
        self.off = col([o for _, _, o in dims], torch.int64)
        self.levels = L


def corr_lookup(packed: PackedPyramid, coords: torch.Tensor,
                radius: int = CORR_RADIUS) -> torch.Tensor:
    """coords: (B, 2, H, W) f32 (x, y) target positions. Returns
    (B, LEVELS*(2r+1)^2, H, W) f32 window features: on level i the taps sit
    at coords / 2^i + (dx, dy), dx, dy in [-r, r], bilinear with zeros
    outside the map; channel (i*(2r+1) + a)*(2r+1) + b carries
    (dx = a - r, dy = b - r), the x offset first (`raft.py:149-152`)."""
    B, _, H, W = coords.shape
    L, T = packed.levels, 2 * radius + 2
    c = coords.permute(0, 2, 3, 1).reshape(1, B * H * W, 2) * packed.scale[
        ..., 0]                                               # (L, P, 2)
    base = torch.floor(c)
    frac = (c - base)[..., None, None]                        # (L, P, 2, 1, 1)
    j = torch.arange(T, device=coords.device) - radius + 1    # +1: the border
    iy = (base[..., 1:2].long() + j).clamp_(min=0)            # (L, P, T)
    ix = (base[..., 0:1].long() + j).clamp_(min=0)
    iy = torch.minimum(iy, packed.hmax[..., 0])
    ix = torch.minimum(ix, packed.wmax[..., 0])
    idx = (packed.off + iy[..., :, None] * packed.stride
           + ix[..., None, :])                                # (L, P, T, T)
    idx = idx.permute(1, 0, 2, 3).reshape(B * H * W, L * T * T)
    patch = torch.gather(packed.buf, 1, idx).float().view(
        B * H * W, L, T, T).transpose(0, 1)                   # (L, P, y, x)
    fx, fy = frac[:, :, 0], frac[:, :, 1]
    px = patch[..., :, :-1] * (1.0 - fx) + patch[..., :, 1:] * fx
    win = px[..., :-1, :] * (1.0 - fy) + px[..., 1:, :] * fy  # (L, P, dy, dx)
    win = win.transpose(-1, -2).permute(1, 0, 2, 3)           # (P, L, dx, dy)
    return win.reshape(B, H, W, -1).permute(0, 3, 1, 2).contiguous()


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor
                         ) -> torch.Tensor:
    """Convex 8x upsampling (`raft.py:363`): flow (B, 2, H, W) f32, mask
    (B, 64*9, H, W) -> (B, 2, 8H, 8W) f32."""
    B, _, H, W = flow.shape
    mask = torch.softmax(mask.float().view(B, 1, 9, 8, 8, H, W), dim=2)
    up = F.unfold(8.0 * flow, (3, 3), padding=1).view(B, 2, 9, 1, 1, H, W)
    up = torch.sum(mask * up, dim=2)                          # (B, 2, 8, 8, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, 8 * H, 8 * W)


def raft_refine(net: Raft, fmap1: torch.Tensor, fmap2: torch.Tensor,
                cnet: torch.Tensor, iters: int,
                corr_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder outputs -> (flow_low (B, 2, H, W), flow_up (B, 2, 8H, 8W)),
    both f32 (`raft.py:380`); the iterations a plain loop."""
    packed = PackedPyramid(build_corr_pyramid(fmap1, fmap2, corr_dtype))
    h = torch.tanh(cnet[:, :HDIM])
    inp = torch.relu(cnet[:, HDIM:])
    B, _, H, W = fmap1.shape
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=fmap1.device),
        torch.arange(W, dtype=torch.float32, device=fmap1.device),
        indexing="ij")
    coords0 = torch.stack([gx, gy])[None]                     # (1, 2, H, W)
    coords1 = coords0.expand(B, -1, -1, -1)
    ub = net.update_block
    for _ in range(iters):
        corr = corr_lookup(packed, coords1)
        motion = ub.encoder(coords1 - coords0, corr)
        h = ub.gru(h, torch.cat([inp, motion.to(inp.dtype)], dim=1))
        coords1 = coords1 + ub.flow_head(h).float()
    flow = coords1 - coords0
    return flow, upsample_flow_convex(flow, ub.mask_head(h))


def _normalize(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) RGB [0, 255] -> (B, 3, H, W) in [-1, 1], f32 math."""
    x = 2.0 * (images.float() / 255.0) - 1.0
    return x.permute(0, 3, 1, 2).contiguous().to(dtype)


def raft_forward(net: Raft, image1: torch.Tensor, image2: torch.Tensor,
                 iters: int = 12, corr_dtype=torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RGB images (B, H, W, 3) in [0, 255] -> (flow_low (B, 2, H/8, W/8),
    flow_up (B, 2, H, W)), (dx, dy) channels (`raft.py:427`)."""
    dt = net.cnet.conv1.weight.dtype
    image1, image2 = _normalize(image1, dt), _normalize(image2, dt)
    fmap1, fmap2 = net.fnet(image1), net.fnet(image2)
    cnet = net.cnet(image1)
    return raft_refine(net, fmap1, fmap2, cnet, iters, corr_dtype)


def raft_forward_seq(net: Raft, frames_seq: torch.Tensor, iters: int = 12,
                     corr_dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flow over consecutive frames (`raft.py:442`): (T+1, H, W, 3) ->
    flows of the T pairs (t, t+1); fnet runs once per frame, cnet on the T
    first frames of the pairs."""
    imgs = _normalize(frames_seq, net.cnet.conv1.weight.dtype)
    fmaps = net.fnet(imgs)
    cnet = net.cnet(imgs[:-1])
    return raft_refine(net, fmaps[:-1], fmaps[1:], cnet, iters, corr_dtype)


def filter_raft_state_dict(params: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """Drop torch's duplicate `downsample.1` norm aliases (the tensors of
    `norm3`) and the BatchNorm counters from a RAFT checkpoint."""
    return {k: v for k, v in params.items()
            if ".downsample.1." not in k and "num_batches_tracked" not in k}


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) f32 -> (B, C, size, size): `jax.image.resize(...,
    "bilinear")`, which antialiases (a triangle kernel widened by the
    factor) when it shrinks and interpolates at half-pixel centers."""
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def make_trace_flow_fn(raft_params: Dict[str, torch.Tensor], iters: int = 20,
                       out_size: int = 128, compute_dtype: str = "float32",
                       flow_input_size: int = 512,
                       corr_dtype: str = "float32", sequence: bool = False,
                       device="cuda"):
    """Flow extractor for TRACE (`raft.py:470`): RAFT at flow_input_size,
    its full-resolution flow resized to out_size and given in 512-input
    pixels / 8 (the feature-map grid). Frames are (T, S, S, 3) RGB [0, 255]
    tensors (uint8 or float) on `device`; flows come back (T, out_size,
    out_size, 2) f32.

    The pairwise form is fn(prev, cur); with sequence=True, fn(frames) over
    T+1 consecutive frames, marked `takes_sequence`, which runs fnet once
    per frame. Convs and matmuls run under this function's own precision
    flags (see the module docstring), whatever the caller's."""
    dt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    cdt = torch.bfloat16 if corr_dtype == "bfloat16" else torch.float32
    S = flow_input_size
    net = Raft()
    net.load_state_dict(raft_params, strict=True)
    net = net.to(device).eval().requires_grad_(False).set_compute_dtype(dt)

    def prep(frames):
        if S == frames.shape[1]:
            return frames
        x = frames.float().permute(0, 3, 1, 2).contiguous()
        return resize_bilinear(x, S).permute(0, 2, 3, 1)

    def post(flow_up):
        flow = resize_bilinear(flow_up, out_size) * (512.0 / S / 8.0)
        return flow.permute(0, 2, 3, 1)

    @contextlib.contextmanager
    def flags():
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            yield

    if sequence:
        def flow_seq_fn(frames_seq):
            with flags():
                _, flow_up = raft_forward_seq(net, prep(frames_seq), iters,
                                              cdt)
                return post(flow_up)

        flow_seq_fn.takes_sequence = True
        return flow_seq_fn

    def flow_fn(frames_prev, frames_cur):
        with flags():
            _, flow_up = raft_forward(net, prep(frames_prev),
                                      prep(frames_cur), iters, cdt)
            return post(flow_up)

    return flow_fn


def init_raft_params(generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A fresh seeded state dict (torch layout), initialized by the JAX
    package's rule (`layers.py:80-91`): conv weights He-normal over fan_in
    = Cin * kh * kw, biases 0, BatchNorm weight 1, bias 0, mean 0, var 1.
    The numbers differ from JAX's (another generator); the distributions do
    not."""
    net = Raft()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Conv):
                m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5,
                                 generator=generator)
                m.bias.zero_()
    return net.state_dict()
