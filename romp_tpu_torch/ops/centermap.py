"""Center-heatmap parsing with fixed-K outputs (counterpart of
`romp_tpu/ops/centermap.py`): 5x5 max-pool NMS -> top-K over the flat map
-> confidence threshold, as a (K,) validity mask instead of a dynamic count.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class CenterDetections(NamedTuple):
    """Fixed-K detections per image. Invalid slots have mask == False."""

    flat_inds: torch.Tensor   # (B, K) int32 — index into the flattened map
    yx: torch.Tensor          # (B, K, 2) float — (y, x) map coordinates
    scores: torch.Tensor      # (B, K) float
    mask: torch.Tensor        # (B, K) bool


def nms_heatmap(center_map: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Keep cells equal to their local max. center_map: (B, H, W).

    Max-pool with stride 1 and symmetric padding; F.max_pool2d pads with
    -inf, as `layers.py:388-396` does.
    """
    pooled = F.max_pool2d(center_map[:, None], window, stride=1,
                          padding=(window - 1) // 2)[:, 0]
    return torch.where(center_map == pooled, center_map,
                       torch.zeros_like(center_map))


def parse_centermap2d(center_map: torch.Tensor, max_person: int,
                      conf_thresh: float, nms_window: int = 5,
                      ) -> CenterDetections:
    """2D center parse. center_map: (B, H, W) -> top-`max_person` peaks.
    Tie order among equal scores may differ from `lax.top_k`'s."""
    B, H, W = center_map.shape
    nmsed = nms_heatmap(center_map, nms_window).reshape(B, H * W)
    scores, inds = torch.topk(nmsed, max_person, dim=1)
    return CenterDetections(
        flat_inds=inds.to(torch.int32),
        yx=torch.stack([inds // W, inds % W], dim=-1).float(),
        scores=scores,
        mask=scores > conf_thresh,
    )


def sample_maps_at(maps: torch.Tensor, flat_inds: torch.Tensor) -> torch.Tensor:
    """Gather per-person channels from a (B, H, W, C) map at flat (H*W)
    indices (clipped into range). Returns (B, K, C)."""
    B, H, W, C = maps.shape
    flat = maps.reshape(B, H * W, C)
    idx = flat_inds.long().clamp(0, H * W - 1)
    return torch.gather(flat, 1, idx[..., None].expand(*idx.shape, C))


class CenterDetections3D(NamedTuple):
    flat_inds: torch.Tensor   # (B, K) int32 — index into the (H*W) plane
    zyx: torch.Tensor         # (B, K, 3) float — (z, y, x)
    scores: torch.Tensor      # (B, K)
    mask: torch.Tensor        # (B, K) bool


def nms_heatmap3d(center_map: torch.Tensor, window: int = 5) -> torch.Tensor:
    """3D NMS over (B, D, H, W): the reference's MaxPool3d(5, 1, 2)
    (`centermap.py:63-73`), padding with -inf."""
    pooled = F.max_pool3d(center_map[:, None], window, stride=1,
                          padding=(window - 1) // 2)[:, 0]
    return torch.where(center_map == pooled, center_map,
                       torch.zeros_like(center_map))


def parse_centermap3d(center_map: torch.Tensor, max_person: int,
                      conf_thresh: float, nms_window: int = 5,
                      ) -> CenterDetections3D:
    """3D center parse (`centermap.py:76-96`). center_map: (B, D, H, W) ->
    top-`max_person` (z, y, x) peaks; flat_inds index the (H*W) front-view
    plane. Tie order among equal scores may differ from `lax.top_k`'s."""
    B, D, H, W = center_map.shape
    nmsed = nms_heatmap3d(center_map, nms_window).reshape(B, D * H * W)
    scores, inds = torch.topk(nmsed, max_person, dim=1)
    rem = inds % (H * W)
    return CenterDetections3D(
        flat_inds=rem.to(torch.int32),
        zyx=torch.stack([inds // (H * W), rem // W, rem % W], dim=-1).float(),
        scores=scores,
        mask=scores > conf_thresh,
    )
