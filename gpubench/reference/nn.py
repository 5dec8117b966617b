"""Plain layers over a flat state dict, for the benchmark's reference.

The reference is written as functions over a state dict whose keys are the
published checkpoints' (and so the port's `load_state_dict` keys). Every
layer goes through one `Ctx`, which knows three things:

- the precision of the conv operands (`round_fn`): float32 leaves them,
  bfloat16 rounds both operands to bf16 and convolves in float32 (exact
  products, float32 sums: what the configurations' `compute_dtype
  bfloat16` states), float8 rounds them to e4m3 with one scale a tensor
  (the control, one step below bf16);
- a spec mode, in which the forward runs on the meta device and records
  each parameter's name, shape and initializer instead of reading it: the
  architecture is written once, and the parameter list follows from it;
- a calibration mode, in which every BatchNorm normalizes by the batch's
  own statistics and stores them as its running statistics (one train-mode
  pass with a cumulative average, the statistics trained weights give).

TF32 is off wherever the reference runs (`no_tf32`): a float32 conv or
matmul on the card would otherwise drop to TF32.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0   # largest finite float8 e4m3fn


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 (amax maps to 448), back in float32."""
    amax = x.abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDING: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "float32": lambda x: x,
    "bfloat16": round_bf16,
    "float8": round_fp8,
}

# the precision one step below each stated compute precision: the control
CONTROL_OF = {"float32": "bfloat16", "bfloat16": "float8"}


@contextlib.contextmanager
def no_tf32():
    """Full float32 matmuls and convs for the duration (restored after)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class Ctx:
    """One forward's parameters and precision. `sd` maps names to tensors;
    with `spec` set (a dict), parameters are created on the meta device and
    recorded there as name -> (shape, init), where init is one of "conv"
    (He-normal over the product of all but the first dim), "dense"
    (He-normal over the first dim, the port's rule for Linear and
    Embedding), "zero", "one" and "count"."""

    def __init__(self, sd: Optional[Dict[str, torch.Tensor]],
                 precision: str = "float32", calibrate: bool = False,
                 spec: Optional[Dict[str, Tuple[tuple, str]]] = None):
        self.sd = sd
        self.q = ROUNDING[precision]
        self.calibrate = calibrate
        self.spec = spec

    def p(self, name: str, shape: tuple, init: str) -> torch.Tensor:
        if self.spec is not None:
            self.spec[name] = (tuple(shape), init)
            dtype = torch.long if init == "count" else torch.float32
            return torch.empty(shape, device="meta", dtype=dtype)
        t = self.sd[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the "
                             f"architecture says {tuple(shape)}")
        return t

    def conv2d(self, name: str, x: torch.Tensor, out: int, k: int = 3,
               stride: int = 1, bias: bool = False) -> torch.Tensor:
        """Conv with padding (k - 1) // 2 and a float32 result."""
        w = self.p(f"{name}.weight", (out, x.shape[1], k, k), "conv")
        b = self.p(f"{name}.bias", (out,), "zero") if bias else None
        return F.conv2d(self.q(x), self.q(w), b, stride, (k - 1) // 2)

    def conv_nd_rounded(self, name: str, x: torch.Tensor, out: int,
                        k: int = 3) -> torch.Tensor:
        """1D / 3D conv, no bias: its output rounded to the compute
        precision too (the published JAX convs without a float32 result)."""
        nd = x.dim() - 2
        w = self.p(f"{name}.weight", (out, x.shape[1]) + (k,) * nd, "conv")
        conv = F.conv1d if nd == 1 else F.conv3d
        return self.q(conv(self.q(x), self.q(w), None, 1, (k - 1) // 2))

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        w = self.p(f"{name}.weight", (c,), "one")
        b = self.p(f"{name}.bias", (c,), "zero")
        mean = self.p(f"{name}.running_mean", (c,), "zero")
        var = self.p(f"{name}.running_var", (c,), "one")
        self.p(f"{name}.num_batches_tracked", (), "count")
        shape = (1, c) + (1,) * (x.dim() - 2)
        if self.calibrate:
            axes = [0] + list(range(2, x.dim()))
            n = x.numel() // c
            bmean = x.mean(axes)
            bvar = x.var(axes, unbiased=False)
            mean.copy_(bmean)
            var.copy_(bvar * n / max(n - 1, 1))
            self.sd[f"{name}.num_batches_tracked"].fill_(1)
            return ((x - bmean.view(shape)) * torch.rsqrt(
                bvar.view(shape) + BN_EPS)) * w.view(shape) + b.view(shape)
        return F.batch_norm(x, mean, var, w, b, False, 0.0, BN_EPS)

    def linear(self, name: str, x: torch.Tensor, out: int) -> torch.Tensor:
        w = self.p(f"{name}.weight", (out, x.shape[-1]), "dense")
        b = self.p(f"{name}.bias", (out,), "zero")
        return F.linear(x, w, b)

    def embedding(self, name: str, idx: torch.Tensor, num: int,
                  dim: int) -> torch.Tensor:
        return F.embedding(idx, self.p(f"{name}.weight", (num, dim), "dense"))


def spec_of(forward: Callable[[Ctx, torch.Tensor], object],
            image_shape: tuple) -> Dict[str, Tuple[tuple, str]]:
    """Every parameter `forward(ctx, images)` reads, in order: name ->
    (shape, init), found by running it on the meta device."""
    spec: Dict[str, Tuple[tuple, str]] = {}
    forward(Ctx(None, spec=spec), torch.empty(image_shape, device="meta"))
    return spec
