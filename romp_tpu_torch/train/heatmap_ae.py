"""2D-pose pretraining's supervision: keypoint heatmaps and associative
embedding (counterpart of `romp_tpu/train/heatmap_ae.py`).

Reference: the bottom-up 2D-pose path used for backbone pretraining
(`romp/pretrain.py`, `romp/lib/loss_funcs/maps_loss.py:18-116`
HeatmapLoss / AELoss, `romp/lib/maps_utils/kp_group.py` HeatmapParser,
`target_generators.py`):
- per-joint Gaussian heatmap GT, rendered on the device;
- the channel-masked heatmap MSE;
- associative-embedding pull / push losses over fixed-(P,) persons;
- fixed-K heatmap peak parsing, and the host's grouping of peaks by tag.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from romp_tpu_torch.parallel.mesh import global_ratio, global_sums


def generate_joint_heatmaps(kp2d: torch.Tensor, vis: torch.Tensor,
                            map_size: int, sigma: float = 2.0
                            ) -> torch.Tensor:
    """kp2d (B, P, J, 2) in [-1, 1]; vis (B, P, J) -> (B, S, S, J): each
    joint's Gaussians over the persons, combined by max (`heatmap_ae.py:
    21-34`). Builds the (B, P, J, S, S) splats as JAX does."""
    cx = (kp2d[..., 0] + 1.0) / 2.0 * map_size
    cy = (kp2d[..., 1] + 1.0) / 2.0 * map_size
    xs = torch.arange(map_size, dtype=kp2d.dtype, device=kp2d.device)
    dx = xs - cx[..., None]                          # (B, P, J, S)
    dy = xs - cy[..., None]
    g = torch.exp(-(dx[:, :, :, None, :] ** 2 + dy[:, :, :, :, None] ** 2)
                  / (2.0 * sigma ** 2))              # (B, P, J, S, S)
    g = torch.where(vis[..., None, None], g, torch.zeros_like(g))
    return g.amax(dim=1).permute(0, 2, 3, 1)


def heatmap_mse_loss(pred: torch.Tensor, gt: torch.Tensor,
                     group=None) -> torch.Tensor:
    """Channel-masked MSE (`maps_loss.py:86-99`): only the supervised joints
    (GT channels that are not empty) count, over the images of all ranks of
    `group`. pred, gt (B, S, S, J)."""
    chan_mask = (gt.sum(dim=(1, 2)) > 0).to(pred.dtype)       # (B, J)
    per_chan = torch.mean((pred - gt) ** 2, dim=(1, 2))
    return global_ratio(torch.sum(per_chan * chan_mask), torch.sum(chan_mask),
                        1e-6, group)


def ae_loss(tags: torch.Tensor, kp2d: torch.Tensor, vis: torch.Tensor,
            person_mask: torch.Tensor, group=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Associative-embedding pull / push (`maps_loss.py:101-160`), each a
    mean over the joints or pairs of all ranks of `group`.

    tags (B, S, S, J) predicted embedding maps; kp2d (B, P, J, 2) in
    [-1, 1]; vis (B, P, J); person_mask (B, P). Returns (pull, push)."""
    B, S = tags.shape[0], tags.shape[1]
    P, J = kp2d.shape[1], kp2d.shape[2]
    cx = ((kp2d[..., 0] + 1) / 2 * S).to(torch.int32).clamp(0, S - 1)
    cy = ((kp2d[..., 1] + 1) / 2 * S).to(torch.int32).clamp(0, S - 1)
    flat = tags.permute(0, 3, 1, 2).reshape(B, J, S * S)       # (B, J, SS)
    idx = (cy * S + cx).transpose(1, 2).long()                 # (B, J, P)
    picked = torch.gather(flat, 2, idx).transpose(1, 2)        # (B, P, J)

    w = vis.to(tags.dtype) * person_mask[..., None]
    nj = torch.sum(w, dim=-1)                                  # (B, P)
    mean_tag = torch.sum(picked * w, dim=-1) / torch.clamp(nj, min=1.0)
    pull_num, pull_den = torch.sum(((picked - mean_tag[..., None]) ** 2)
                                   * w), torch.sum(w)

    pv = (person_mask & (nj > 0)).to(tags.dtype)               # (B, P)
    off_diag = 1.0 - torch.eye(P, dtype=tags.dtype, device=tags.device)
    pair = pv[:, :, None] * pv[:, None, :] * off_diag[None]
    diff = mean_tag[:, :, None] - mean_tag[:, None, :]
    push_num, push_den = torch.sum(torch.exp(-diff ** 2) * pair), torch.sum(
        pair)
    pull_num, pull_den, push_num, push_den = global_sums(
        pull_num, pull_den, push_num, push_den, group=group)
    return pull_num / (pull_den + 1e-6), push_num / (push_den + 1e-6)


def parse_joint_heatmaps(heat: torch.Tensor, tags: torch.Tensor,
                         max_person: int, conf_thresh: float = 0.1):
    """Fixed-K per-joint peaks (`heatmap_ae.py:75-91`): a 5x5 max-pool NMS
    (stride 1, -inf padding), then the top `max_person` cells of each joint.
    heat, tags (B, S, S, J). Returns (coords (B, J, K, 2) xy in map pixels,
    scores (B, J, K), tag values (B, J, K), valid (B, J, K)). Equal scores
    keep the lower index first, as `lax.top_k` does (a stable sort)."""
    B, S, _, J = heat.shape
    h = heat.permute(0, 3, 1, 2)                               # (B, J, S, S)
    pooled = F.max_pool2d(h, 5, stride=1, padding=2)
    nmsed = torch.where(h == pooled, h, torch.zeros_like(h)).reshape(
        B, J, S * S)
    order = torch.sort(nmsed, dim=-1, descending=True, stable=True)
    scores = order.values[..., :max_person]
    inds = order.indices[..., :max_person]
    xs = (inds % S).to(heat.dtype)
    ys = (inds // S).to(heat.dtype)
    tflat = tags.permute(0, 3, 1, 2).reshape(B, J, S * S)
    tvals = torch.gather(tflat, 2, inds)
    return (torch.stack([xs, ys], dim=-1), scores, tvals,
            scores > conf_thresh)


def group_by_tags(coords: np.ndarray, scores: np.ndarray, tvals: np.ndarray,
                  valid: np.ndarray, tag_thresh: float = 1.0
                  ) -> List[np.ndarray]:
    """Greedy host-side grouping of per-joint peaks into persons by tag
    distance (kp_group.py semantics; the JAX package's numpy code). Inputs
    are one image's (J, K, ...) arrays; returns a list of (J, 3) person
    keypoint arrays (x, y, conf), missing joints zeroed."""
    J = coords.shape[0]
    persons: List[dict] = []
    for j in range(J):
        for k in np.where(valid[j])[0]:
            tag = tvals[j, k]
            best, best_d = None, tag_thresh
            for p in persons:
                if j in p["joints"]:
                    continue
                d = abs(p["tag"] - tag)
                if d < best_d:
                    best, best_d = p, d
            if best is None:
                persons.append({"tag": float(tag), "n": 1,
                                "joints": {j: (*coords[j, k], scores[j, k])}})
            else:
                best["joints"][j] = (*coords[j, k], scores[j, k])
                best["tag"] = (best["tag"] * best["n"] + float(tag)) \
                    / (best["n"] + 1)
                best["n"] += 1
    out = []
    for p in persons:
        arr = np.zeros((J, 3), np.float32)
        for j, (x, y, s) in p["joints"].items():
            arr[j] = (x, y, s)
        out.append(arr)
    return out
