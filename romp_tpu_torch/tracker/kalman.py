"""Constant-velocity Kalman filter over 3D body centers (+ scale).

State: (x, y, z, h, vx, vy, vz, vh) where h is the person-scale channel (the
reference uses weak-perspective scale as a bbox-height stand-in,
`simple_romp/tracker/kalman_filter_3dcenter.py:23-60`). Observation: the
first four state dims. Process/measurement noise scale with h, matching the
reference's std weights (1/20 position, 1/160 velocity).

Implemented as pure-numpy functions over (8,) mean / (8, 8) covariance so the
tracker can run them per-track or batched; no scipy dependency (4x4 solves
via np.linalg).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

NDIM = 4
STD_POS = 1.0 / 20.0
STD_VEL = 1.0 / 160.0

_MOTION = np.eye(2 * NDIM, dtype=np.float64)
for _i in range(NDIM):
    _MOTION[_i, NDIM + _i] = 1.0
_UPDATE = np.eye(NDIM, 2 * NDIM, dtype=np.float64)


def initiate(measurement: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """New track state from an (x, y, z, h) measurement."""
    mean = np.concatenate([measurement, np.zeros(NDIM)])
    h = measurement[3]
    std = np.array([2 * STD_POS * h] * 4 + [10 * STD_VEL * h] * 4)
    return mean, np.diag(np.square(std))


def predict(mean: np.ndarray, cov: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    h = mean[3]
    std = np.array([STD_POS * h] * 4 + [STD_VEL * h] * 4)
    motion_cov = np.diag(np.square(std))
    mean = _MOTION @ mean
    cov = _MOTION @ cov @ _MOTION.T + motion_cov
    return mean, cov


def update(mean: np.ndarray, cov: np.ndarray, measurement: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    h = mean[3]
    innovation_cov = np.diag(np.square(np.array([STD_POS * h] * 4)))
    proj_mean = _UPDATE @ mean
    proj_cov = _UPDATE @ cov @ _UPDATE.T + innovation_cov
    # Kalman gain via solve on the 4x4 projected covariance.
    gain = np.linalg.solve(proj_cov.T, (_UPDATE @ cov.T)).T  # (8, 4)
    innovation = measurement - proj_mean
    new_mean = mean + gain @ innovation
    new_cov = cov - gain @ proj_cov @ gain.T
    return new_mean, new_cov


def gating_distance(mean: np.ndarray, cov: np.ndarray,
                    measurements: np.ndarray) -> np.ndarray:
    """Squared Mahalanobis distance of (N, 4) measurements to the track."""
    h = mean[3]
    innovation_cov = np.diag(np.square(np.array([STD_POS * h] * 4)))
    proj_mean = _UPDATE @ mean
    proj_cov = _UPDATE @ cov @ _UPDATE.T + innovation_cov
    d = measurements - proj_mean
    sol = np.linalg.solve(proj_cov, d.T)
    return np.sum(d.T * sol, axis=0)
