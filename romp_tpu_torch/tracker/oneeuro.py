"""OneEuro temporal filter + SMPL-result smoothing.

Parity with `simple_romp/romp/utils.py:203-273`: adaptive low-pass whose
cutoff rises with signal speed; per-track filter banks for pose/betas/cam,
with the global rotation smoothed in matrix space (filter the 3x3 rotation
elementwise, then project back via axis-angle) exactly as
`smooth_global_rot_matrix` (`utils.py:188-193`).

Host-side numpy (stateful per-track scalar filters — not device work).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class LowPassFilter:
    def __init__(self):
        self.prev_raw: Optional[np.ndarray] = None
        self.prev_filtered: Optional[np.ndarray] = None

    def process(self, value: np.ndarray, alpha) -> np.ndarray:
        if self.prev_raw is None:
            s = value
        else:
            s = alpha * value + (1.0 - alpha) * self.prev_filtered
        self.prev_raw = value
        self.prev_filtered = s
        return s


class OneEuroFilter:
    def __init__(self, mincutoff: float = 1.0, beta: float = 0.0,
                 dcutoff: float = 1.0, freq: float = 30.0):
        self.freq = freq
        self.mincutoff = mincutoff
        self.beta = beta
        self.dcutoff = dcutoff
        self.x_filter = LowPassFilter()
        self.dx_filter = LowPassFilter()

    def _alpha(self, cutoff):
        tau = 1.0 / (2.0 * np.pi * cutoff)
        return 1.0 / (1.0 + tau * self.freq)

    def process(self, x: np.ndarray) -> np.ndarray:
        prev = self.x_filter.prev_raw
        dx = np.zeros_like(x) if prev is None else (x - prev) * self.freq
        edx = self.dx_filter.process(dx, self._alpha(self.dcutoff))
        cutoff = self.mincutoff + self.beta * np.abs(edx)
        return self.x_filter.process(x, self._alpha(cutoff))


def create_filter_bank(smooth_coeff: float = 3.0) -> Dict[str, OneEuroFilter]:
    """Per-quantity filters, cutoffs as `create_OneEuroFilter` (`utils.py:259`)."""
    return {
        "smpl_thetas": OneEuroFilter(smooth_coeff, 0.7),
        "cam": OneEuroFilter(1.6, 0.7),
        "smpl_betas": OneEuroFilter(0.6, 0.7),
        "global_rot": OneEuroFilter(smooth_coeff, 0.7),
    }


def _aa_to_matrix_np(aa: np.ndarray) -> np.ndarray:
    angle = np.linalg.norm(aa + 1e-8)
    axis = aa / angle
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * K
            + (1 - np.cos(angle)) * (np.outer(axis, axis) - np.eye(3)))


def _matrix_to_aa_np(R: np.ndarray) -> np.ndarray:
    # Robust conversion via device ops would pull a device trip; use the
    # closed-form with clamped trace (adequate after mild filtering).
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    angle = np.arccos(cos)
    if angle < 1e-7:
        return np.zeros(3)
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) / (2.0 * np.sin(angle))
    return axis * angle


def smooth_results(filters: Dict[str, OneEuroFilter],
                   thetas: Optional[np.ndarray] = None,
                   betas: Optional[np.ndarray] = None,
                   cam: Optional[np.ndarray] = None):
    """Smooth one person's (72,), (10|11,), (3,) results in place-free form."""
    if thetas is not None:
        R = _aa_to_matrix_np(thetas[:3])
        R_s = filters["global_rot"].process(R)
        grot = _matrix_to_aa_np(R_s)
        thetas = np.concatenate(
            [grot, filters["smpl_thetas"].process(thetas[3:])])
    if betas is not None:
        betas = filters["smpl_betas"].process(betas)
    if cam is not None:
        cam = filters["cam"].process(cam)
    return thetas, betas, cam
