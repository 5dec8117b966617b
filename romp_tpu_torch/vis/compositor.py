"""Result compositor: mesh overlay, bird/side views, skeletons, confidences.

Parity: `simple_romp/vis_human/main.py:23-112` (rendering_romp_bev_results)
and the view-rotation utilities `vis_human/vis_utils.py:10-80`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# Person color palette (`vis_human/vis_utils.py:5-6`).
COLOR_LIST = np.array([
    [.7, .7, .6], [.7, .5, .5], [.5, .5, .7], [.5, .55, .3], [.3, .5, .55],
    [1, 0.855, 0.725], [0.588, 0.804, 0.804], [1, 0.757, 0.757],
    [0.933, 0.474, 0.258], [0.847, 191 / 255, 0.847], [0.941, 1, 1]],
    dtype=np.float32)

SMPL24_BONES = [
    (0, 1), (0, 2), (0, 3), (1, 4), (2, 5), (3, 6), (4, 7), (5, 8), (6, 9),
    (7, 10), (8, 11), (9, 12), (9, 13), (9, 14), (12, 15), (13, 16),
    (14, 17), (16, 18), (17, 19), (18, 20), (19, 21), (20, 22), (21, 23)]


def _rot_x(deg: float) -> np.ndarray:
    a = np.radians(deg)
    return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                     [0, np.sin(a), np.cos(a)]], np.float32)


def _rot_y(deg: float) -> np.ndarray:
    a = np.radians(deg)
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]], np.float32)


def rotate_view_weak_perspective(verts: np.ndarray, rx: float = 30,
                                 ry: float = 0, img_shape=(512, 512),
                                 expand_ratio: float = 1.2) -> np.ndarray:
    """Rotate all meshes and fit them into an img_shape viewport
    (`vis_utils.py:26-53`). verts: (N, V, 3) camera-space."""
    h, w = img_shape
    vr = verts @ _rot_x(rx).T
    vr = vr @ _rot_y(ry).T
    center = 0.5 * (vr.reshape(-1, 3).min(0) + vr.reshape(-1, 3).max(0))
    va = vr - center
    img_center = np.array([w / 2, h / 2], np.float32)
    scale = 1.0 / (expand_ratio * np.abs(va[..., :2] / img_center).max())
    va = va * scale
    va[..., :2] += img_center
    return va


def render_mesh_overlay(renderer, verts_px: np.ndarray, faces: np.ndarray,
                        image: np.ndarray,
                        colors: Optional[np.ndarray] = None) -> np.ndarray:
    """verts_px: (N, V, 3) pixel coords (z: larger = farther in camera
    space, flipped here so nearer wins the z-test)."""
    v = np.asarray(verts_px, np.float32).copy()
    v[..., 2] = -v[..., 2]
    return renderer.render(v, faces, image, colors)


def draw_skeleton(image: np.ndarray, kp2d: np.ndarray,
                  color=(0, 255, 0)) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        return image
    img = image.copy()
    pts = kp2d.astype(int)
    for j in range(min(len(pts), 24)):
        cv2.circle(img, tuple(pts[j]), 3, color, -1)
    for a, b in SMPL24_BONES:
        if a < len(pts) and b < len(pts):
            cv2.line(img, tuple(pts[a]), tuple(pts[b]), color, 2)
    return img


def render_results(renderer, res: Dict[str, np.ndarray], image: np.ndarray,
                   faces: np.ndarray, items: List[str] = ("mesh",),
                   mesh_color: str = "identity") -> np.ndarray:
    """Compose the requested visualizations side-by-side
    (`vis_human/main.py:23-112`)."""
    h, w = image.shape[:2]
    n = res["verts"].shape[0] if "verts" in res else 0
    if mesh_color == "identity" and "track_ids" in res:
        colors = COLOR_LIST[np.asarray(res["track_ids"]) % len(COLOR_LIST)]
    elif mesh_color == "identity":
        # color by depth order (nearest first), like `vis_utils.py:147`
        order = np.argsort(res.get("cam_trans", np.zeros((n, 3)))[:, 2])
        colors = np.zeros((n, 3), np.float32)
        colors[order] = COLOR_LIST[np.arange(n) % len(COLOR_LIST)]
    else:
        colors = np.tile(COLOR_LIST[:1], (n, 1))

    panels = []
    canvas = image.copy()
    if "mesh" in items and "verts_camed_org" in res:
        canvas = render_mesh_overlay(renderer, res["verts_camed_org"], faces,
                                     canvas, colors)
    if "pj2d" in items and "pj2d_org" in res:
        for p in range(res["pj2d_org"].shape[0]):
            canvas = draw_skeleton(canvas, res["pj2d_org"][p][:24])
    if "center_conf" in items and "center_confs" in res \
            and "pj2d_org" in res:
        try:
            import cv2
            for p in range(res["pj2d_org"].shape[0]):
                pos = res["pj2d_org"][p][:24].mean(0).astype(int)
                cv2.putText(canvas, f"{float(res['center_confs'][p]):.2f}",
                            tuple(pos), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                            (255, 255, 0), 2)
        except ImportError:
            pass
    panels.append(canvas)

    if "verts" in res and "cam_trans" in res and n > 0:
        verts_cam = res["verts"] + res["cam_trans"][:, None]
        for item, (rx, ry) in (("mesh_bird_view", (90, 0)),
                               ("mesh_side_view", (0, 90))):
            if item not in items:
                continue
            vr = rotate_view_weak_perspective(verts_cam, rx=rx, ry=ry,
                                              img_shape=(h, h))
            bg = np.full((h, h, 3), 255, np.uint8)
            panels.append(render_mesh_overlay(renderer, vr, faces, bg,
                                              colors))
    return np.concatenate(panels, axis=1) if len(panels) > 1 else panels[0]


def render_rotating_mesh(renderer, verts_cam: np.ndarray, faces: np.ndarray,
                         size: int = 512, n_frames: int = 72,
                         colors: Optional[np.ndarray] = None
                         ) -> List[np.ndarray]:
    """Turntable frames of the reconstructed meshes on a white background
    (`vis_human/main.py:101` rotating-mesh video /
    `vis_utils.py:106` rendering_mesh_rotating_view)."""
    frames = []
    for i in range(n_frames):
        vr = rotate_view_weak_perspective(
            verts_cam, rx=0, ry=360.0 * i / n_frames, img_shape=(size, size))
        bg = np.full((size, size, 3), 255, np.uint8)
        frames.append(render_mesh_overlay(renderer, vr, faces, bg, colors))
    return frames
