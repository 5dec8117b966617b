"""Pose priors: the GMM max-mixture prior and SMPLify's angle prior
(counterpart of `romp_tpu/train/priors.py`).

Parity: `romp/lib/loss_funcs/prior_loss.py:160-260` (MaxMixturePrior over
the 69-dim body pose, min over components of the NLL with sqrdet-normalized
weights) and `:114` (exponential bend prior on knees and elbows). The GMM
ships with the reference as gmm_08.pkl; `GmmPrior.load` reads that pickle
or a packed npz, `GmmPrior.synthetic` draws the JAX package's seeded
stand-in (the same numpy draw, so the same numbers).
"""
from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from romp_tpu_torch.parallel.mesh import global_ratio

POSE_DIM = 69


@dataclasses.dataclass(frozen=True)
class GmmPrior:
    means: torch.Tensor        # (K, 69)
    precisions: torch.Tensor   # (K, 69, 69)
    nll_weights: torch.Tensor  # (K,)

    def to(self, device) -> "GmmPrior":
        return GmmPrior(*(t.to(device) for t in (
            self.means, self.precisions, self.nll_weights)))

    @staticmethod
    def from_gmm_arrays(means: np.ndarray, covs: np.ndarray,
                        weights: np.ndarray) -> "GmmPrior":
        precisions = np.stack([np.linalg.inv(c) for c in covs])
        sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covs])
        const = (2 * np.pi) ** (POSE_DIM / 2.0)
        nll_w = weights / (const * (sqrdets / sqrdets.min()))
        return GmmPrior(*(torch.tensor(np.asarray(a, np.float32))
                          for a in (means, precisions, nll_w)))

    @staticmethod
    def load(path: str) -> "GmmPrior":
        if path.endswith(".npz"):
            d = np.load(path)
            return GmmPrior.from_gmm_arrays(d["means"], d["covars"],
                                            d["weights"])
        with open(path, "rb") as f:
            gmm = pickle.load(f, encoding="latin1")
        if not isinstance(gmm, dict):
            gmm = {"means": gmm.means_, "covars": gmm.covars_,
                   "weights": gmm.weights_}
        return GmmPrior.from_gmm_arrays(
            np.asarray(gmm["means"]), np.asarray(gmm["covars"]),
            np.asarray(gmm["weights"]))

    @staticmethod
    def synthetic(num_gaussians: int = 8, seed: int = 0) -> "GmmPrior":
        rng = np.random.RandomState(seed)
        means = rng.randn(num_gaussians, POSE_DIM).astype(np.float32) * 0.2
        covs = []
        for _ in range(num_gaussians):
            a = rng.randn(POSE_DIM, POSE_DIM) * 0.05
            covs.append(a @ a.T + np.eye(POSE_DIM) * 0.3)
        weights = rng.dirichlet(np.ones(num_gaussians))
        return GmmPrior.from_gmm_arrays(means, np.stack(covs), weights)


def gmm_prior_nll(prior: GmmPrior, body_pose: torch.Tensor) -> torch.Tensor:
    """(N, <=69) body pose -> (N,) min over components of the NLL."""
    d = body_pose.shape[-1]
    diff = body_pose[:, None, :] - prior.means[None, :, :d]
    prec = prior.precisions[:, :d, :d]
    quad = torch.einsum("nkj,kji,nki->nk", diff, prec, diff)
    ll = 0.5 * quad - torch.log(prior.nll_weights)[None]
    return torch.min(ll, dim=1).values


def gmm_prior_loss(prior: GmmPrior, body_pose: torch.Tensor,
                   person_w: torch.Tensor, valuable_thresh: float = 5.0,
                   group=None) -> torch.Tensor:
    """NLL / 100, values below 5 zeroed (`calc_loss.py:152-157`), the
    weighted mean over the persons (of all ranks of `group`)."""
    nll = gmm_prior_nll(prior, body_pose) / 100.0
    nll = torch.where(nll < valuable_thresh, torch.zeros_like(nll), nll)
    return global_ratio(torch.sum(nll * person_w), torch.sum(person_w), 1e-6,
                        group)


def angle_prior(pose: torch.Tensor) -> torch.Tensor:
    """SMPLify bend prior (`prior_loss.py:114-120`) on a (N, 72|66) pose:
    elbows' z (55, 58) and knees' x (12, 15) with signs +, -, -, -."""
    comps = torch.stack([pose[:, 55], -pose[:, 58], -pose[:, 12],
                         -pose[:, 15]], dim=-1)
    return torch.sum(torch.exp(comps) ** 2, dim=-1)
