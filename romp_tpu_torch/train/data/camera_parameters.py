"""Per-dataset camera intrinsics (counterpart of

The port's copy of the JAX package's numpy-only
`romp_tpu/train/data/camera_parameters.py`, so that the port imports nothing of that
package.
`romp/lib/dataset/camera_parameters.py` / `trace/lib/datasets/...`).

Values are the datasets' published calibration constants. Helpers convert
between intrinsics and the normalized FOV convention the pipelines use
(ROMP weak-persp: f=443.4 @ 512 = 60 deg; TRACE: f=548 @ 512 = 50 deg).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# Human3.6M: four fixed cameras (published calibration, focal/center in px
# at the native 1000x1002-ish resolutions).
H36M_CAMERAS: Dict[str, Dict[str, np.ndarray]] = {
    "54138969": {"f": np.array([1145.04940, 1143.78109]),
                 "c": np.array([512.54150, 515.45148])},
    "55011271": {"f": np.array([1149.67569, 1147.59161]),
                 "c": np.array([508.84863, 508.06491])},
    "58860488": {"f": np.array([1149.14071, 1148.79896]),
                 "c": np.array([519.81583, 501.40283])},
    "60457274": {"f": np.array([1145.51133, 1144.77392]),
                 "c": np.array([514.96819, 501.88201])},
}

# MuPoTS-3D test sequences: published intrinsics (approx; per-seq focal).
MUPOTS_FOCAL = 1500.0
MUPOTS_CENTER = np.array([1024.0, 768.0]) / 2.0

# AGORA renders: 3840x2160, focal from the published blender FOV.
AGORA_FOCAL_4K = 1973.0
AGORA_CENTER_4K = np.array([1920.0, 1080.0])

# Framework projection conventions.
ROMP_FOCAL_512 = 443.4     # FOV 60 deg at 512 input
TRACE_FOCAL_512 = 548.0    # FOV 50 deg at 512 input


def intrinsics_matrix(f, c) -> np.ndarray:
    K = np.eye(3)
    K[0, 0], K[1, 1] = np.broadcast_to(f, (2,))
    K[:2, 2] = c
    return K


def fov_to_focal(fov_deg: float, img_size: float) -> float:
    return img_size / 2.0 / np.tan(np.radians(fov_deg / 2.0))


def focal_to_fov(focal: float, img_size: float) -> float:
    return float(np.degrees(2.0 * np.arctan(img_size / 2.0 / focal)))


def rescale_intrinsics(f, c, src_size, dst_size):
    """Scale intrinsics when the image is resized (and square-padded)."""
    s = dst_size / float(max(np.broadcast_to(src_size, (2,))))
    return np.asarray(f) * s, np.asarray(c) * s
