"""Linear-blend skinning: the hand-written CUDA kernel and its plain twin.

Counterpart of `romp_tpu/ops/pallas_lbs.py`. The kernel
(`romp_tpu_torch/csrc/lbs.cu`) computes, per person b and vertex v,

    T16 = A16[b] . W^T
    verts[b, m, v] = sum_n T16[4m+n, v] * v_posed[b, n, v] + T16[4m+3, v]

without ever writing the (B, 16, V) transform block. Forward only: the
analytic backward of `pallas_lbs.py:113-126` comes with the training slice.
"""
from __future__ import annotations

import torch

from romp_tpu_torch.ops import _build


def skinning_plain(a16: torch.Tensor, weights: torch.Tensor,
                   v_posed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch skinning (twin of `skinning_xla`, materializes T16).

    a16: (B, 16, J); weights: (V, J); v_posed: (B, 3, V) -> (B, 3, V).
    """
    t16 = torch.einsum("bkj,vj->bkv", a16, weights)
    return torch.stack([
        t16[:, 4 * m + 0] * v_posed[:, 0] + t16[:, 4 * m + 1] * v_posed[:, 1]
        + t16[:, 4 * m + 2] * v_posed[:, 2] + t16[:, 4 * m + 3]
        for m in range(3)], dim=1)


def skinning(a16: torch.Tensor, weights: torch.Tensor,
             v_posed: torch.Tensor) -> torch.Tensor:
    """Skinning: the CUDA kernel for CUDA tensors, `skinning_plain` for CPU
    tensors. a16: (B, 16, 24); weights: (V, 24); v_posed: (B, 3, V), f32.

    `skinning.launches` counts kernel launches.
    """
    if a16.device.type == "cpu":
        return skinning_plain(a16, weights, v_posed)
    if a16.dim() != 3 or a16.device.type != "cuda":
        raise ValueError(f"skinning: a16 must be a (B, 16, 24) CUDA tensor, "
                         f"got {tuple(a16.shape)} on {a16.device}")
    B, V = a16.shape[0], weights.shape[0]
    for name, t, shape in (("a16", a16, (B, 16, 24)),
                           ("weights", weights, (V, 24)),
                           ("v_posed", v_posed, (B, 3, V))):
        _build.check_operand("skinning", name, t, torch.float32, shape,
                             a16.device)
    out = torch.empty((B, 3, V), dtype=torch.float32, device=a16.device)
    if B == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(a16.device):
        err = lib.romp_skinning_f32(
            a16.data_ptr(), weights.data_ptr(), v_posed.data_ptr(),
            out.data_ptr(), B, V, 24, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "romp_skinning_f32")
    skinning.launches += 1
    return out


skinning.launches = 0
