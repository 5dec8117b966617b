"""Camera / projection utilities (counterpart of `romp_tpu/ops/projection.py`)."""
from __future__ import annotations

import numpy as np
import torch

INVALID_TRANS = -1.0


def weak_perspective_projection(points: torch.Tensor, cam: torch.Tensor,
                                keep_dim: bool = False) -> torch.Tensor:
    """points: (..., N, 3); cam: (..., 3) = (s, tx, ty).

    Returns (..., N, 2) [or (..., N, 3) with the original z when keep_dim].
    """
    s = cam[..., None, 0:1]
    t = cam[..., None, 1:3]
    xy = points[..., :2] * s + t
    if keep_dim:
        return torch.cat([xy, points[..., 2:3]], dim=-1)
    return xy


def convert_to_org_image_coords(kps: torch.Tensor, pad_info: torch.Tensor,
                                ) -> torch.Tensor:
    """Map [-1, 1] input-square coords back to original-image pixels.
    pad_info: (6,) = (top, bottom, left, right, h, w)."""
    top, left = pad_info[0], pad_info[2]
    size = torch.maximum(pad_info[4], pad_info[5])
    out = [(kps[..., 0] + 1.0) * size / 2.0 - left,
           (kps[..., 1] + 1.0) * size / 2.0 - top]
    if kps.shape[-1] == 3:
        out.append((kps[..., 2] + 1.0) * size / 2.0)
    return torch.stack(out, dim=-1)


def convert_to_org_image_coords_np(kps, pad_info) -> np.ndarray:
    """Host numpy twin of convert_to_org_image_coords (the CLI's results
    are already on the host)."""
    kps = np.asarray(kps, np.float32)
    top, left = float(pad_info[0]), float(pad_info[2])
    size = float(max(pad_info[4], pad_info[5]))
    out = [(kps[..., 0] + 1.0) * size / 2.0 - left,
           (kps[..., 1] + 1.0) * size / 2.0 - top]
    if kps.shape[-1] == 3:
        out.append((kps[..., 2] + 1.0) * size / 2.0)
    return np.stack(out, axis=-1)


def cam_to_3d_trans(cam: torch.Tensor, weight: float = 2.0) -> torch.Tensor:
    """(s, tx, ty) -> rough 3D translation (dx, dy, depth) * weight."""
    s, tx, ty = cam[..., 0], cam[..., 1], cam[..., 2]
    return torch.stack([tx / s, ty / s, 1.0 / s], dim=-1) * weight


def estimate_translation_lstsq(joints3d: torch.Tensor, joints2d: torch.Tensor,
                               weights: torch.Tensor,
                               focal_length: float = 443.4,
                               img_size=512.0,
                               min_points: int = 4) -> torch.Tensor:
    """Weighted least-squares camera translation, batched
    (`projection.py:81-128`): the 3x3 normal equations of
    f*(X+tx) - (u-cx)*(Z+tz) ~ 0 (and likewise for y). Persons with fewer
    than `min_points` valid joints get INVALID_TRANS; their singular system
    is regularized by +I so the solve stays finite.

    joints3d: (B, N, 3); joints2d: (B, N, 2) pixels; weights: (B, N) {0, 1}.
    img_size: a float (square) or a (w, h) pair. Returns (B, 3).
    """
    if isinstance(img_size, (tuple, list)):
        cx, cy = img_size[0] / 2.0, img_size[1] / 2.0
    else:
        cx = cy = img_size / 2.0
    f = focal_length
    X, Y, Z = joints3d[..., 0], joints3d[..., 1], joints3d[..., 2]
    u, v = joints2d[..., 0], joints2d[..., 1]
    weights = weights.to(u.dtype)

    zeros = torch.zeros_like(u)
    fcol = torch.full_like(u, f)
    Qx = torch.stack([fcol, zeros, cx - u], dim=-1)             # (B, N, 3)
    Qy = torch.stack([zeros, fcol, cy - v], dim=-1)
    Q = torch.cat([Qx, Qy], dim=1)                              # (B, 2N, 3)
    c = torch.cat([(u - cx) * Z - f * X, (v - cy) * Z - f * Y], dim=1)
    w = torch.cat([weights, weights], dim=1)                    # (B, 2N)

    A = torch.einsum("bni,bn,bnj->bij", Q, w, Q)                # (B, 3, 3)
    b = torch.einsum("bni,bn,bn->bi", Q, w, c)                  # (B, 3)
    valid = torch.sum(weights, dim=-1) >= min_points            # (B,)
    A = A + (~valid).to(A.dtype)[:, None, None] * torch.eye(
        3, dtype=A.dtype, device=A.device)
    # solve_ex: no host sync on the singular-matrix check
    t = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]
    return torch.where(valid[:, None], t, torch.full_like(t, INVALID_TRANS))


def perspective_projection(points: torch.Tensor, translation: torch.Tensor,
                           focal_length: float, img_size: float = 512.0,
                           normalized: bool = True) -> torch.Tensor:
    """Pinhole projection of (..., N, 3) points offset by a (..., 3)
    translation (`projection.py:131-145`): normalized [-1, 1] coordinates,
    or pixels when `normalized` is False."""
    p = points + translation[..., None, :]
    z = torch.clamp(p[..., 2], min=1e-6)
    x = p[..., 0] / z * focal_length
    y = p[..., 1] / z * focal_length
    if normalized:
        return torch.stack([x, y], dim=-1) / (img_size / 2.0)
    return torch.stack([x + img_size / 2.0, y + img_size / 2.0], dim=-1)
