"""Host-side training augmentation pipeline.

The port's copy of the JAX package's numpy-only
`romp_tpu/train/data/augment.py`, so that the port imports nothing of that
package.

Semantics mirror `romp/lib/utils/augments.py` (crop/pad via trbl offsets
:100-152, rotation :260-300, flip :40-50, pose processing :87-98, synthetic
occlusion :347-433, color jitter) without the imgaug dependency: pure
numpy + cv2.

Output contract per sample: square image resized to `input_size`, kp2d
normalized to [-1, 1] (invalid joints = -2), kp3d rotated consistently,
global orient rotated/flipped.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from romp_tpu_torch.train.data.skeletons import (
    INVALID, SMPL54_FLIP, flip_pose_params,
)

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


@dataclasses.dataclass
class AugmentConfig:
    rot_prob: float = 0.4
    rot_factor: float = 30.0
    flip_prob: float = 0.5
    crop_prob: float = 0.4
    scale_range: Tuple[float, float] = (0.75, 1.25)
    color_jitter_prob: float = 0.3
    color_jitter: float = 0.2
    occlusion_prob: float = 0.0
    input_size: int = 512


def _valid(kp: np.ndarray) -> np.ndarray:
    return (kp > INVALID + 1e-6).all(axis=-1)


def rotate_image_and_kps(image: np.ndarray, kp2ds: np.ndarray,
                         angle: float) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate around the image center, expanding the canvas like the
    reference's img_kp_rotate (border replicate off; zeros)."""
    h, w = image.shape[:2]
    M = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    cos, sin = abs(M[0, 0]), abs(M[0, 1])
    nw, nh = int(h * sin + w * cos), int(h * cos + w * sin)
    M[0, 2] += nw / 2 - w / 2
    M[1, 2] += nh / 2 - h / 2
    image = cv2.warpAffine(image, M, (nw, nh))
    if kp2ds is not None:
        v = _valid(kp2ds)
        pts = np.concatenate([kp2ds, np.ones((*kp2ds.shape[:-1], 1))], -1)
        rot = pts @ M.T
        kp2ds = np.where(v[..., None], rot, INVALID)
    return image, kp2ds


def rotate_kp3d(kp3d: np.ndarray, angle: float) -> np.ndarray:
    """In-image-plane rotation of 3D joints (`augments.py:51-60`). Note the
    image y-axis points down, so 3D rotation is by -angle about z."""
    a = np.radians(-angle)
    R = np.array([[np.cos(a), -np.sin(a), 0.0],
                  [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]], np.float32)
    v = (kp3d != INVALID).any(axis=-1)
    out = kp3d @ R.T
    return np.where(v[..., None], out, INVALID)


def rotate_global_orient(pose: np.ndarray, angle: float) -> np.ndarray:
    """Compose the in-plane rotation into the global orient axis-angle
    (`augments.py` rot_aa)."""
    a = np.radians(-angle)
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]], np.float32)
    aa = pose[..., :3]
    angle_n = np.linalg.norm(aa, axis=-1, keepdims=True) + 1e-8
    axis = aa / angle_n
    K = np.zeros((*aa.shape[:-1], 3, 3), np.float32)
    K[..., 0, 1], K[..., 0, 2] = -axis[..., 2], axis[..., 1]
    K[..., 1, 0], K[..., 1, 2] = axis[..., 2], -axis[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -axis[..., 1], axis[..., 0]
    s = np.sin(angle_n)[..., None]
    c = np.cos(angle_n)[..., None]
    R = np.eye(3) + s * K + (1 - c) * (K @ K)
    Rnew = Rz @ R
    # matrix -> axis-angle via cv2.Rodrigues per person
    out = pose.copy()
    flat = Rnew.reshape(-1, 3, 3)
    aas = np.stack([cv2.Rodrigues(m)[0][:, 0] for m in flat])
    out[..., :3] = aas.reshape(aa.shape)
    return out


def flip_sample(image: np.ndarray, kp2ds: Optional[np.ndarray],
                kp3ds: Optional[np.ndarray], poses: Optional[np.ndarray]):
    """Horizontal mirror: image, 54-joint sets (with L/R swap), pose params."""
    w = image.shape[1]
    image = image[:, ::-1].copy()
    if kp2ds is not None:
        kp2ds = kp2ds[:, SMPL54_FLIP].copy()
        v = _valid(kp2ds)
        kp2ds[..., 0] = np.where(v, w - 1 - kp2ds[..., 0], INVALID)
    if kp3ds is not None:
        kp3ds = kp3ds[:, SMPL54_FLIP].copy()
        v = (kp3ds != INVALID).any(axis=-1)
        kp3ds[..., 0] = np.where(v, -kp3ds[..., 0], kp3ds[..., 0])
    if poses is not None:
        poses = flip_pose_params(poses)
    return image, kp2ds, kp3ds, poses


def synthetic_occlusion(image: np.ndarray, rng: np.random.RandomState,
                        max_patches: int = 3) -> np.ndarray:
    """Random textured rectangles (stand-in for the reference's VOC-object
    paste, `augments.py:347-433` — same training effect, no dataset dep)."""
    h, w = image.shape[:2]
    img = image.copy()
    for _ in range(rng.randint(1, max_patches + 1)):
        ph, pw = rng.randint(h // 10, h // 3), rng.randint(w // 10, w // 3)
        y, x = rng.randint(0, h - ph), rng.randint(0, w - pw)
        img[y:y + ph, x:x + pw] = rng.randint(0, 255, (ph, pw, 3))
    return img


def color_jitter(image: np.ndarray, rng: np.random.RandomState,
                 strength: float) -> np.ndarray:
    scale = 1.0 + rng.uniform(-strength, strength, 3)
    shift = rng.uniform(-strength, strength) * 50.0
    return np.clip(image.astype(np.float32) * scale + shift, 0, 255)


def square_pad_resize(image: np.ndarray, kp2ds: Optional[np.ndarray],
                      input_size: int):
    """Center square pad + resize; kp2d -> [-1, 1] normalized coords."""
    h, w = image.shape[:2]
    side = max(h, w)
    top, left = (side - h) // 2, (side - w) // 2
    pad = np.zeros((side, side, 3), image.dtype)
    pad[top:top + h, left:left + w] = image
    resized = cv2.resize(pad, (input_size, input_size),
                         interpolation=cv2.INTER_LINEAR)
    if kp2ds is not None:
        v = _valid(kp2ds)
        out = kp2ds.copy()
        out[..., 0] = (kp2ds[..., 0] + left) / side * 2.0 - 1.0
        out[..., 1] = (kp2ds[..., 1] + top) / side * 2.0 - 1.0
        kp2ds = np.where(v[..., None], out, INVALID)
    return resized.astype(np.float32), kp2ds


def augment_sample(image: np.ndarray, kp2ds: np.ndarray,
                   kp3ds: Optional[np.ndarray], poses: Optional[np.ndarray],
                   cfg: AugmentConfig, rng: np.random.RandomState,
                   train: bool = True,
                   extra_pts: Optional[np.ndarray] = None):
    """Full pipeline. image: HxWx3 RGB uint8; kp2ds: (P, 54, 2) pixels with
    INVALID; kp3ds: (P, 54, 3) or None; poses: (P, 66|72) or None.
    extra_pts: optional (P, M, 2) auxiliary pixel points (e.g. bbox corners
    for bbox-only persons) that follow the same geometric transforms as
    kp2ds but have no left/right identity (flip just mirrors x).

    Returns (image (S, S, 3) float32, kp2d_norm, kp3ds, poses, extra_norm).
    """
    # Geometric ops treat kp2ds and extra_pts identically — concatenate along
    # the joint axis, split back at the end. Flip is the exception (L/R swap
    # applies to named joints only), handled on the split arrays.
    M = 0
    if extra_pts is not None:
        M = extra_pts.shape[1]
        kp2ds = np.concatenate([kp2ds, extra_pts.astype(np.float32)], axis=1)

    if train and rng.rand() < cfg.crop_prob and _valid(kp2ds).any():
        # random scale-crop around the people bbox
        v = _valid(kp2ds)
        pts = kp2ds[v]
        l, t = pts.min(0)
        r, b = pts.max(0)
        cx, cy = (l + r) / 2, (t + b) / 2
        half = max(r - l, b - t) / 2 * rng.uniform(*cfg.scale_range) + 20
        x0, y0 = int(max(0, cx - half)), int(max(0, cy - half))
        x1 = int(min(image.shape[1], cx + half))
        y1 = int(min(image.shape[0], cy + half))
        if x1 - x0 > 32 and y1 - y0 > 32:
            image = image[y0:y1, x0:x1]
            shift = np.array([x0, y0], np.float32)
            vmask = _valid(kp2ds)
            kp2ds = np.where(vmask[..., None], kp2ds - shift, INVALID)

    if train and rng.rand() < cfg.rot_prob:
        angle = rng.uniform(-cfg.rot_factor, cfg.rot_factor)
        image, kp2ds = rotate_image_and_kps(image, kp2ds, angle)
        if kp3ds is not None:
            kp3ds = rotate_kp3d(kp3ds, angle)
        if poses is not None:
            poses = rotate_global_orient(poses, angle)

    if train and rng.rand() < cfg.flip_prob:
        extra = kp2ds[:, 54:] if M else None
        image, kp2d_only, kp3ds, poses = flip_sample(
            image, kp2ds[:, :54], kp3ds, poses)
        if M:
            w = image.shape[1]
            v = _valid(extra)
            extra = extra.copy()
            extra[..., 0] = np.where(v, w - 1 - extra[..., 0], INVALID)
            kp2ds = np.concatenate([kp2d_only, extra], axis=1)
        else:
            kp2ds = kp2d_only

    if train and rng.rand() < cfg.occlusion_prob:
        image = synthetic_occlusion(image, rng)
    if train and rng.rand() < cfg.color_jitter_prob:
        image = color_jitter(image, rng, cfg.color_jitter)

    image, kp2ds = square_pad_resize(image, kp2ds, cfg.input_size)
    extra_out = None
    if M:
        # bbox-style points are clamped into frame (the reference clips
        # bboxes on crop), not invalidated.
        extra_out, kp2ds = kp2ds[:, 54:], kp2ds[:, :54]
        v = _valid(extra_out)
        extra_out = np.where(v[..., None], np.clip(extra_out, -1.0, 1.0),
                             INVALID)
    if kp2ds is not None:
        # Joints pushed outside the crop/canvas are no longer supervisable:
        # mark them INVALID like the reference's process_kps set_minus
        # (`romp/lib/dataset/image_base.py:224-226`). Without this, the kp2d
        # loss pulls projections off-screen and person centers/bboxes
        # derived from these joints are skewed.
        inside = (np.abs(kp2ds) <= 1.0).all(axis=-1)
        kp2ds = np.where(inside[..., None], kp2ds, INVALID)
    return image, kp2ds, kp3ds, poses, extra_out
