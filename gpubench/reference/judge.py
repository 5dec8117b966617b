"""The gap measures the judges share. Every gap is per image, the worst
over its slots and values; a NaN or an infinity in a served value reads as
an infinite gap (a comparison with NaN would otherwise pass)."""
from __future__ import annotations

import torch


def worst(d: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (B,): the largest entry of each image, NaN as inf."""
    return torch.nan_to_num(d.float(), nan=float("inf")).flatten(1).amax(1)


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (B,): max |prog - ref| over the image's max |ref|."""
    d = worst((prog.float() - ref.float()).abs())
    return d / ref.float().abs().flatten(1).amax(1).clamp(min=1e-12)


def trans_gap(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Camera translations (B, K, 3) compared as (x / z, y / z, 1 / z): the
    direction and inverse depth, which stay bounded where a far person's
    depth does not."""
    def stable(t):
        t = t.float()
        return torch.cat([t[..., :2] / t[..., 2:], 1.0 / t[..., 2:]], -1)
    return rel_gap(stable(prog), stable(ref))


def pose_gap(thetas: torch.Tensor, p6d: torch.Tensor) -> torch.Tensor:
    """How far the reference's 6D pose (B, K, J*6) is from one that the
    served axis-angle thetas (B, K, 72) follow from: per joint, with c1, c2
    the first columns of the served rotation, the distance of (a1, a2) from
    (a1 on c1's ray, a2 in the half-plane of c1 and +c2), over the image's
    largest 6D column. A backward error: Gram-Schmidt turns a small change
    of nearly parallel columns into a large one of the rotation, so the
    rotations themselves are not compared."""
    from gpubench.reference.geometry import axis_angle_to_matrix
    b, k = p6d.shape[:2]
    j = p6d.shape[-1] // 6
    rot = axis_angle_to_matrix(thetas.float().reshape(b, k, -1, 3)[:, :, :j])
    a = p6d.float().reshape(b, k, j, 3, 2)
    a1, a2 = a[..., 0], a[..., 1]
    c1, c2 = rot[..., 0], rot[..., 1]

    def dot(u, v):
        return (u * v).sum(-1, keepdim=True)

    e1 = (a1 - dot(a1, c1).clamp(min=0.0) * c1).norm(dim=-1)
    e2 = (a2 - dot(a2, c1) * c1 - dot(a2, c2).clamp(min=0.0) * c2
          ).norm(dim=-1)
    scale = torch.maximum(a1.norm(dim=-1), a2.norm(dim=-1)).flatten(1).amax(1)
    return worst(torch.maximum(e1, e2)) / scale.clamp(min=1e-12)
