"""EProPnP's Monte-Carlo pose-distribution layer on the LM core
(counterpart of `romp_tpu/ops/epropnp_mc.py`).

The reference is `trace/lib/epropnp/epropnp.py:36`
(EProPnPBase.monte_carlo_forward) with its 4-DoF specialization (`:199`):
adaptive multiple importance sampling (AMIS) over the pose posterior
p(y) ~ exp(-cost(y)) of weighted 2D-3D correspondences. Each iteration
draws pose samples from the current proposal, evaluates the reprojection
cost, takes balance-heuristic mixture log-weights over ALL iterations'
proposals, and refits the proposal from the weighted samples. As in the
JAX package: fixed iteration and sample counts; the yaw proposal is a
wrapped normal + uniform mixture; the translation proposal a multivariate
Student-t (df = 3). Pose (4-DoF): [tx, ty, tz, yaw], yaw about the y axis.

Each sampler is a draw from a `torch.Generator` (`_mvt_draw`,
`_yaw_draw`: the raw normals, chi-square and uniforms, on the generator's
device) and a transform of those draws (`_mvt_sample`, `_yaw_sample`), so
that the same draws can be fed to another device or replayed from JAX.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from romp_tpu_torch.ops.pnp import _residuals, lm_pnp

_DF = 3.0          # Student-t degrees of freedom (epropnp.py:205)
_UNIFORM_MIX = 0.25  # uniform share of the yaw proposal (epropnp.py:206)


class MCPnPResult(NamedTuple):
    pose_opt: torch.Tensor            # (B, 4) LM solution [t(3), yaw]
    pose_samples: torch.Tensor        # (S, B, 4)
    sample_logweights: torch.Tensor   # (S, B) importance log-weights
    cost_opt: torch.Tensor            # (B,)


# ------------------------------ proposal distributions (sampler + logpdf) --

def _mvt_draw(gen: torch.Generator, shape: Tuple[int, ...],
              dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Student-t's raw draws for `shape` = (..., B): standard normals
    (..., B, 3) and chi-square(df)/df (..., B), the latter as the mean of
    three squared normals (chi-square(3) is their sum; JAX draws it as
    gamma(1.5) / 1.5, the same distribution)."""
    z = torch.randn(*shape, 3, generator=gen, dtype=dtype, device=gen.device)
    n = torch.randn(*shape, 3, generator=gen, dtype=dtype, device=gen.device)
    return z, (n ** 2).sum(-1) / _DF


def _mvt_sample(draw, mode, cov_tril):
    """Multivariate Student-t(df=3) from `_mvt_draw`'s draws: mode (B, 3),
    cov_tril (B, 3, 3)."""
    z, g = draw
    scale = torch.sqrt(1.0 / torch.clamp(g, min=1e-12))[..., None]
    return mode + torch.einsum("bij,...bj->...bi", cov_tril, z) * scale


def _mvt_logprob(x, mode, cov_tril):
    """log pdf of the multivariate t (df=3, dim=3). x: (..., B, 3)."""
    d = 3.0
    diff = x - mode
    tril_b = cov_tril.expand(*diff.shape[:-1], 3, 3)
    sol = torch.linalg.solve_triangular(tril_b, diff[..., None],
                                        upper=False)[..., 0]
    maha = (sol ** 2).sum(-1)
    logdet = torch.log(torch.diagonal(cov_tril, dim1=-2, dim2=-1).abs()
                       ).sum(-1)
    const = (math.lgamma((_DF + d) / 2.0) - math.lgamma(_DF / 2.0)
             - 0.5 * d * math.log(_DF * math.pi))
    return const - logdet - 0.5 * (_DF + d) * torch.log1p(maha / _DF)


def _yaw_draw(gen: torch.Generator, shape: Tuple[int, ...],
              dtype=torch.float32
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The yaw proposal's raw draws for `shape` = (..., B): a standard
    normal, a uniform over [-pi, pi) and a uniform over [0, 1) (the
    mixture's pick)."""
    def uniform():
        return torch.rand(*shape, generator=gen, dtype=dtype,
                          device=gen.device)

    n = torch.randn(*shape, generator=gen, dtype=dtype, device=gen.device)
    return n, uniform() * (2.0 * math.pi) - math.pi, uniform()


def _yaw_sample(draw, mode, sigma):
    """Wrapped-normal + uniform mix over [-pi, pi) from `_yaw_draw`'s
    draws. mode / sigma: (B,)."""
    n, unif, pick = draw
    norm = torch.remainder(mode + sigma * n + math.pi, 2.0 * math.pi) \
        - math.pi
    return torch.where(pick < _UNIFORM_MIX, unif, norm)


def _yaw_logprob(x, mode, sigma):
    """log pdf of the wrapped-normal (+uniform) yaw proposal; the wrap sum
    over k in [-2, 2] is exact to ~1e-8 for sigma < 1.5."""
    ks = torch.arange(-2, 3, dtype=x.dtype, device=x.device) * (2.0 * math.pi)
    d = x[..., None] - mode[..., None] + ks
    log_norm = torch.logsumexp(
        -0.5 * (d / sigma[..., None]) ** 2
        - torch.log(sigma[..., None] * math.sqrt(2.0 * math.pi)), dim=-1)
    log_unif = torch.full_like(x, -math.log(2.0 * math.pi))
    return torch.logaddexp(log_norm + math.log(1.0 - _UNIFORM_MIX),
                           log_unif + math.log(_UNIFORM_MIX))


def _pose_cost(pose, pts3d, pts2d, w, focal, center):
    """Weighted squared reprojection cost of 4-DoF poses (..., B, 4) ->
    (..., B). The reference wraps this in an adaptive Huber (`cost_fun`);
    the squared error is its quadratic regime."""
    yaw = pose[..., 3]
    zero = torch.zeros_like(yaw)
    aa = torch.stack([zero, yaw, zero], -1)
    flat = torch.cat([aa, pose[..., :3]], -1).reshape(-1, 6)

    def rep(a):
        return a.expand(*pose.shape[:-2], *a.shape).reshape(-1, *a.shape[1:])

    r = _residuals(flat, rep(pts3d), rep(pts2d), rep(w), focal, center)
    return 0.5 * (r ** 2).sum(-1).reshape(pose.shape[:-1])


def _weighted_refit(samples, logweights):
    """The proposal refit from weighted samples (`epropnp.py:238`
    estimate_params). samples: (S, B, 4); logweights: (S, B). Returns
    mode (B, 3), cov_tril (B, 3, 3), yaw_mode (B,), yaw_sigma (B,)."""
    w = torch.softmax(logweights, dim=0)                     # (S, B)
    t = samples[..., :3]
    mean = (w[..., None] * t).sum(0)
    diff = t - mean
    cov = torch.einsum("sbi,sbj,sb->bij", diff, diff, w)
    cov = cov + torch.eye(3, dtype=cov.dtype, device=cov.device) * 1e-6
    tril = torch.linalg.cholesky(cov)
    yaw = samples[..., 3]
    c = (w * torch.cos(yaw)).sum(0)
    s = (w * torch.sin(yaw)).sum(0)
    yaw_mode = torch.atan2(s, c)
    r = torch.clamp(torch.sqrt(c ** 2 + s ** 2), 1e-6, 1.0 - 1e-6)
    yaw_sigma = torch.sqrt(-2.0 * torch.log(r))               # wrapped normal
    return mean, tril, yaw_mode, torch.clamp(yaw_sigma, 0.02, 2.0)


def _mixture_logprob(samp, modes, trils, yaw_modes, yaw_sigmas):
    """Balance-heuristic mixture log-density of samples (I, S, B, 4) under
    the proposals so far (each list of the same length n)."""
    lp = [_mvt_logprob(samp[..., :3], m, tr) + _yaw_logprob(samp[..., 3],
                                                            ym, ys)
          for m, tr, ym, ys in zip(modes, trils, yaw_modes, yaw_sigmas)]
    return torch.logsumexp(torch.stack(lp), dim=0) - math.log(len(lp))


def monte_carlo_pnp(generator: torch.Generator, pts3d: torch.Tensor,
                    pts2d: torch.Tensor, weights: torch.Tensor, focal: float,
                    center: torch.Tensor, mc_samples: int = 128,
                    num_iter: int = 4, lm_iters: int = 10) -> MCPnPResult:
    """AMIS sampling of the 4-DoF pose posterior (`epropnp.py:88`
    monte_carlo_forward). pts3d: (B, N, 3); pts2d: (B, N, 2) px; weights:
    (B, N), all on one device. The samples are drawn from `generator` on
    its own device and moved to that of the points. Returns the LM mode
    and the weighted pose samples."""
    if mc_samples % num_iter:
        raise ValueError(f"mc_samples={mc_samples} is not a multiple of "
                         f"num_iter={num_iter}")
    S = mc_samples // num_iter
    B = pts3d.shape[0]
    kw = dict(dtype=pts3d.dtype, device=pts3d.device)
    center = torch.as_tensor(center, **kw)

    sol = lm_pnp(pts3d, pts2d, weights, focal, center, iters=lm_iters, dof=4)
    yaw0 = sol.rotation_aa[:, 1]
    pose_opt = torch.cat([sol.translation, yaw0[:, None]], -1)

    # the initial proposal from the LM solution (initial_fit,
    # epropnp.py:216): a diagonal covariance scaled like cholesky_wrapper's
    # [1, 1, 4] prior
    depth = torch.clamp(sol.translation[:, 2], min=0.5)
    diag0 = 0.05 * depth[:, None] * torch.tensor([1.0, 1.0, 4.0], **kw)
    modes = [sol.translation]
    trils = [torch.eye(3, **kw)[None] * diag0[:, None, :]]
    yaw_modes = [yaw0]
    yaw_sigmas = [torch.full((B,), 0.3, **kw)]

    def moved(draw):
        return tuple(d.to(**kw) for d in draw)

    all_samples, all_costs = [], []      # per iteration (S, B, 4), (S, B)
    for i in range(num_iter):
        t_s = _mvt_sample(moved(_mvt_draw(generator, (S, B), pts3d.dtype)),
                          modes[i], trils[i])
        y_s = _yaw_sample(moved(_yaw_draw(generator, (S, B), pts3d.dtype)),
                          yaw_modes[i], yaw_sigmas[i])
        samples_i = torch.cat([t_s, y_s[..., None]], -1)
        all_samples.append(samples_i)
        all_costs.append(_pose_cost(samples_i, pts3d, pts2d, weights, focal,
                                    center))
        if i == num_iter - 1:
            break
        samp = torch.stack(all_samples)                  # (i+1, S, B, 4)
        mix = _mixture_logprob(samp, modes, trils, yaw_modes, yaw_sigmas)
        lw = (-torch.stack(all_costs) - mix).reshape(-1, B)
        m, tr, ym, ysig = _weighted_refit(samp.reshape(-1, B, 4), lw)
        modes.append(m)
        trils.append(tr)
        yaw_modes.append(ym)
        yaw_sigmas.append(ysig)

    samp = torch.stack(all_samples)                      # (num_iter, S, B, 4)
    mix = _mixture_logprob(samp, modes, trils, yaw_modes, yaw_sigmas)
    logweights = (-torch.stack(all_costs) - mix).reshape(mc_samples, B)
    return MCPnPResult(pose_opt, samp.reshape(mc_samples, B, 4), logweights,
                       sol.cost)


def monte_carlo_pose_loss(logweights: torch.Tensor, pose_samples,
                          pose_gt, cost_gt: torch.Tensor) -> torch.Tensor:
    """EProPnP's Monte-Carlo pose NLL (KL surrogate): cost(y_gt) + the log
    of the self-normalized partition estimate
    (`trace/lib/epropnp/monte_carlo_pose_loss.py`). logweights: (S, B)."""
    log_z = torch.logsumexp(logweights, dim=0) - math.log(logweights.shape[0])
    return (cost_gt + log_z).mean()
