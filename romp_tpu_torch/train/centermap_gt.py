"""Ground-truth center heatmaps, vectorized over fixed K persons
(counterpart of `romp_tpu/train/centermap_gt.py`).

Scale-adaptive Gaussian splats, one per person, combined by max, with the
exact center pixel forced to 1 (the reference's
`romp/lib/maps_utils/centermap.py:92-140,362-369,392-397`); one call renders
the whole (B, K) batch on the device. Centers are normalized (x, y) in
[-1, 1]; an invalid person has mask False.
"""
from __future__ import annotations

import torch

MIN_RADIUS_FRAC = 1.0 / 32.0   # map_size/32
SCALE_FACTOR_FRAC = 1.0 / 16.0  # map_size/16


def person_radius(bbox_hw_norm: torch.Tensor, map_size: int) -> torch.Tensor:
    """Adaptive splat radius from the normalized bbox (h, w) (..., 2),
    floored to int32 (`_calc_radius_`)."""
    scales = torch.linalg.norm(bbox_hw_norm / 2.0, dim=-1)
    r = scales * (map_size * SCALE_FACTOR_FRAC) + map_size * MIN_RADIUS_FRAC
    return torch.floor(r).to(torch.int32)


def _force_centers(heat: torch.Tensor, idx: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """heat (B, ...) with each image's flat cells idx (B, K) raised to 1
    where valid (`f.at[i].max(o)`)."""
    B = heat.shape[0]
    flat = heat.reshape(B, -1)
    ones = valid.to(heat.dtype)
    flat = flat.scatter_reduce(1, idx.long(), ones, reduce="amax")
    return flat.reshape(heat.shape)


def generate_centermap(centers: torch.Tensor, radii: torch.Tensor,
                       mask: torch.Tensor, map_size: int = 64
                       ) -> torch.Tensor:
    """centers (B, K, 2), radii (B, K) int32, mask (B, K) bool ->
    (B, map_size, map_size) in [0, 1]."""
    cx = torch.floor((centers[..., 0] + 1.0) / 2.0 * map_size).to(torch.int32)
    cy = torch.floor((centers[..., 1] + 1.0) / 2.0 * map_size).to(torch.int32)
    in_range = (cx >= 0) & (cy >= 0) & (cx < map_size) & (cy < map_size)
    valid = mask & in_range

    xs = torch.arange(map_size, device=centers.device, dtype=torch.int32)
    dx = xs[None, None, :] - cx[..., None]            # (B, K, S)
    dy = xs[None, None, :] - cy[..., None]
    diam = (2 * radii + 1).float()
    sigma = (diam / 6.0)[..., None, None]             # (B, K, 1, 1)
    d2 = (dx[:, :, None, :] ** 2 + dy[:, :, :, None] ** 2).float()
    g = torch.exp(-d2 / (2.0 * sigma ** 2))           # (B, K, S, S)
    box = ((dx.abs() <= radii[..., None])[:, :, None, :]
           & (dy.abs() <= radii[..., None])[:, :, :, None])
    g = torch.where(box & valid[..., None, None], g, torch.zeros_like(g))
    heat = g.amax(dim=1)                               # (B, S, S)
    idx = torch.where(valid, cy * map_size + cx, torch.zeros_like(cx))
    return _force_centers(heat, idx, valid)


def collision_aware_centers(centers: torch.Tensor, radii: torch.Tensor,
                            mask: torch.Tensor, map_size: int = 64,
                            collision_factor: float = 0.2) -> torch.Tensor:
    """CAR: push overlapping persons' centers apart, one repulsion pass over
    all pairs (`romp/lib/maps_utils/centermap.py:98-115`)."""
    d = centers[:, :, None] - centers[:, None, :]               # (B,K,K,2)
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-8)
    least = (radii[:, :, None] + radii[:, None, :] + 1.0) / map_size * 2.0
    eye = torch.eye(mask.shape[1], dtype=torch.bool, device=mask.device)
    pair = mask[:, :, None] & mask[:, None, :] & ~eye[None]
    colliding = pair & (dist < least)
    push = torch.abs((least - dist) / dist) * collision_factor
    offset = torch.where(colliding[..., None], d * push[..., None] * 0.5,
                         torch.zeros_like(d)).sum(dim=2)
    out = torch.clamp(centers + offset, -1.0, 1.0)
    out = torch.where(out == -1.0, torch.full_like(out, -0.96), out)
    out = torch.where(out == 1.0, torch.full_like(out, 0.96), out)
    return torch.where(mask[..., None], out, centers)


def generate_centermap3d(centers_zyx: torch.Tensor, mask: torch.Tensor,
                         map_size: int = 128, depth_size: int = 64,
                         radius: int = 3, dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """BEV's 3D GT centermap (`centermap.py:141-187`): fixed-radius 3D
    Gaussian splats combined by max, centers forced to 1. centers_zyx
    (B, K, 3) integer grid (z, y, x); mask (B, K) -> (B, depth_size,
    map_size, map_size) of `dtype`."""
    cz, cy, cx = (centers_zyx[..., i].to(torch.int32) for i in range(3))
    valid = (mask & (cz >= 0) & (cz < depth_size) & (cy >= 0)
             & (cy < map_size) & (cx >= 0) & (cx < map_size))
    sigma = (2 * radius + 1) / 6.0
    dev = centers_zyx.device
    dz = (torch.arange(depth_size, device=dev)[None, None] - cz[..., None])
    dy = (torch.arange(map_size, device=dev)[None, None] - cy[..., None])
    dx = (torch.arange(map_size, device=dev)[None, None] - cx[..., None])
    d2 = (dz[..., :, None, None] ** 2 + dy[..., None, :, None] ** 2
          + dx[..., None, None, :] ** 2).to(dtype)     # (B, K, D, S, S)
    box = ((dz.abs() <= radius)[..., :, None, None]
           & (dy.abs() <= radius)[..., None, :, None]
           & (dx.abs() <= radius)[..., None, None, :])
    g = torch.exp(-d2 / (2.0 * sigma ** 2))
    g = torch.where(box & valid[..., None, None, None], g, torch.zeros_like(g))
    heat = g.amax(dim=1)
    idx = torch.where(valid, (cz * map_size + cy) * map_size + cx,
                      torch.zeros_like(cz))
    return _force_centers(heat, idx, valid)
