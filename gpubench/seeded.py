"""Everything a run makes from its seed, on the device: the image pool,
the weights, the BatchNorm statistics and the SMPL arrays.

Each draws from its own stream of one seed (`generator`), so the same seed
gives the same inputs, and adding a draw to one stream moves no other.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference.nn import Ctx, no_tf32

# the SMPL kinematic tree (kintree_table[0] of the official release)
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
                17, 18, 19, 20, 21)
# the 21 vertices read as face, feet and hand joints (the official
# pack_smpl_info.py's VERTEX_IDS)
SMPL_EXTRA21 = (332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624,
                6787, 2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905, 6016,
                6133)
NUM_FACES = 13776


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + zlib.crc32(stream.encode()))
                  % (1 << 63))
    return g


def images(seed: int, n: int, size: int, device,
           stream: str = "images") -> torch.Tensor:
    """(n, size, size, 3) uint8 RGB: smooth colour fields at two scales plus
    pixel noise, so that the convolutions see structure at every size."""
    g = generator(seed, stream, device)

    def field(res):
        x = torch.rand((n, 3, res, res), generator=g, device=device)
        return F.interpolate(x, size=(size, size), mode="bilinear",
                             align_corners=False)

    x = 0.5 * field(8) + 0.3 * field(64) + 0.2 * torch.rand(
        (n, 3, size, size), generator=g, device=device)
    return (x * 255.0).round().clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).contiguous()


def weights(spec: Dict[str, Tuple[tuple, str]], seed: int,
            device) -> Dict[str, torch.Tensor]:
    """A state dict for `spec` (nn.spec_of): He-normal weights from one
    draw, biases and BatchNorm shifts and means 0, scales and variances 1."""
    g = generator(seed, "weights", device)
    he = [(n, s, i) for n, (s, i) in spec.items() if i in ("conv", "dense")]
    noise = torch.randn(sum(math.prod(s) for _, s, _ in he), generator=g,
                        device=device)
    sd, off = {}, 0
    for name, shape, init in he:
        size = math.prod(shape)
        fan = math.prod(shape[1:]) if init == "conv" else shape[0]
        sd[name] = noise[off:off + size].view(shape) * math.sqrt(2.0 / fan)
        off += size
    for name, (shape, init) in spec.items():
        if init == "zero":
            sd[name] = torch.zeros(shape, device=device)
        elif init == "one":
            sd[name] = torch.ones(shape, device=device)
        elif init == "count":
            sd[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return {n: sd[n] for n in spec}


def calibrate(forward, sd: Dict[str, torch.Tensor],
              batch: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to those of its input on
    `batch` (one float32 pass normalizing by the batch's own statistics),
    in place: random weights then keep the activations' scale layer after
    layer, as trained weights do."""
    with torch.no_grad(), no_tf32():
        forward(Ctx(sd, "float32", calibrate=True), batch)


def smpl_arrays(seed: int, num_betas: int, device, stream: str,
                verts: int = 6890, joints: int = 24) -> Dict[str, torch.Tensor]:
    """SMPL arrays at the published shapes (V = 6890, 24 joints, the real
    kinematic tree and extra-joint vertices), values drawn from the seed at
    the scales of the released model: a template of body size, shape and
    pose blend shapes, joint regressors averaging 8 vertices, skinning
    weights over 4 joints a vertex."""
    g = generator(seed, stream, device)

    def sparse_rows(rows, cols, nnz):
        pick = torch.rand((rows, cols), generator=g, device=device)
        idx = torch.topk(pick, nnz, dim=1).indices
        w = torch.rand((rows, nnz), generator=g, device=device) + 0.1
        out = torch.zeros((rows, cols), device=device)
        return out.scatter_(1, idx, w / w.sum(1, keepdim=True))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    return dict(
        v_template=randn(verts, 3) * 0.3,
        shapedirs=randn(verts, 3, num_betas) * 0.01,
        posedirs=randn(9 * (joints - 1), verts * 3) * 0.001,
        J_regressor=sparse_rows(joints, verts, 8),
        lbs_weights=sparse_rows(verts, joints, 4),
        extra_joints_idxs=torch.tensor(SMPL_EXTRA21, device=device),
        J_regressor_extra9=sparse_rows(9, verts, 6),
        J_regressor_h36m17=sparse_rows(17, verts, 6),
        faces=torch.randint(0, verts, (NUM_FACES, 3), generator=g,
                            device=device, dtype=torch.int32),
    )


def host_assets(arrays: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The arrays as the SMPL asset fields a program loads (numpy)."""
    out = {k: v.cpu().numpy() for k, v in arrays.items()}
    out["extra_joints_idxs"] = out["extra_joints_idxs"].astype(np.int32)
    out["parents"] = np.asarray(SMPL_PARENTS, np.int32)
    return out
