"""Laplace (IRLS) approximate inference for general likelihoods.

Port of gp_ss_ak_tpu/inference/laplace.py. The reference's inference
core is a GPML-style `infLaplace` Newton iteration on the latent alpha
with a Brent line search (`irls`/`PSI`/`brentmin`,
GP_Utils.cpp:180-397). For its shipped (warped-)Gaussian likelihoods
that fixed point is available in closed form (inference/gaussian.py),
but the general machinery serves non-conjugate likelihoods (Student-t,
Poisson, ...) on the same device path.

As in the JAX package:
- dlp and d2lp come from autodiff of the likelihood's log_prob
  (`torch.func.grad` of the summed log_prob, and of its summed
  gradient), not hand-derived tables (GP_Utils.cpp:398-432);
- the Newton step uses the exact B-solve, and a backtracking halving
  line search on psi (up to `max_halvings` evaluations, the first
  improving step taken) replaces Brent's method;
- maxit = 20, stopping when psi improves by less than tol
  (GP_Utils.cpp:199-227).

What differs from JAX: `lax.scan` and `lax.while_loop` are host loops,
with one host read per Newton step (the stopping test) and one per
line-search evaluation (is it better?). `fit_latent`, `predict_latent`
and `nlml` take `stats`, a dict that receives the Newton iterations
("newton_iters") and the line-search evaluations past the first of each
step ("halvings"). The flagship model's K and kX in `predict_latent`
are built by the fused Gram kernel K1 (JAX uses `kernel.matrix`); the
dense algebra runs under `highest_precision()`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gp_ss_ak_torch.inference.gaussian import _cross_gram, _noisy_gram
from gp_ss_ak_torch.kernels.distance import highest_precision
from gp_ss_ak_torch.ops.chol import cholesky


class LaplaceState(NamedTuple):
    """The Newton iteration's carry: latent weights, latents, psi and
    the steps taken."""

    alpha: torch.Tensor
    f: torch.Tensor
    psi: torch.Tensor
    it: int


def _derivs(log_prob: Callable, y, f):
    """Per-point lp, dlp = d lp/df, d2lp = d^2 lp/df^2 by autodiff."""
    lp = log_prob(y, f)

    def total(ff):
        return torch.sum(log_prob(y, ff))

    dlp = torch.func.grad(total)(f)
    d2lp = torch.func.grad(
        lambda ff: torch.sum(torch.func.grad(total)(ff)))(f)
    return lp, dlp, d2lp


def _psi(K, log_prob, y, alpha, mean):
    f = K @ alpha + mean
    lp = log_prob(y, f)
    return 0.5 * torch.dot(alpha, K @ alpha) - torch.sum(lp), f


def _whitened_chol(K, d2lp):
    """(W, sqrt W, chol(I + sqrt W K sqrt W)) with W = max(-d2lp, 0),
    the clamp of GP_Utils.cpp:210-213."""
    W = torch.clamp_min(-d2lp, 0.0)
    sw = torch.sqrt(W)
    B = (sw[:, None] * sw[None, :]) * K
    B.diagonal().add_(1.0)
    return W, sw, cholesky(B)


def fit_latent(K: torch.Tensor, y: torch.Tensor, log_prob: Callable,
               mean: torch.Tensor = None, maxit: int = 20,
               tol: float = 1e-6, max_halvings: int = 10,
               stats: Optional[dict] = None):
    """Newton/IRLS for the Laplace mode. Returns (alpha, f_hat, psi).

    Mirrors the convergence policy of GP_Utils.cpp:199-227: maxit=20,
    stop when psi improves by less than tol.
    """
    n = K.shape[0]
    mean = torch.zeros(n, dtype=K.dtype, device=K.device) \
        if mean is None else mean
    alpha0 = torch.zeros(n, dtype=K.dtype, device=K.device)
    halvings = 0
    with highest_precision():
        psi0, f0 = _psi(K, log_prob, y, alpha0, mean)
        state = LaplaceState(alpha0, f0, psi0, 0)
        while state.it < maxit:
            _, dlp, d2lp = _derivs(log_prob, y, state.f)
            W, sw, L = _whitened_chol(K, d2lp)
            b = W * (state.f - mean) + dlp
            t = torch.cholesky_solve((sw * (K @ b))[:, None], L)[:, 0]
            dalpha = b - sw * t - state.alpha
            step, best_step, psi, f = 1.0, 0.0, state.psi, state.f
            while step > 2.0 ** (-max_halvings):
                psi_c, f_c = _psi(K, log_prob, y,
                                  state.alpha + step * dalpha, mean)
                if bool(psi_c < psi):
                    best_step, psi, f = step, psi_c, f_c
                    break
                step *= 0.5
                halvings += 1
            converged = bool(state.psi - psi < tol)
            state = LaplaceState(state.alpha + best_step * dalpha, f, psi,
                                 state.it + 1)
            if converged:
                break
    if stats is not None:
        stats["newton_iters"] = state.it
        stats["halvings"] = halvings
        stats["alpha"] = state.alpha
    return state.alpha, state.f, state.psi


def predict_latent(kernel, params, X, y, log_prob: Callable, Xstar,
                   mean: torch.Tensor = None, maxit: int = 20,
                   stats: Optional[dict] = None):
    """Laplace posterior over latents at Xstar: (mu, var).

    GPML predLaplace structure (mirrored from the reference's
    posteriorMeanVar shape, GP_Utils.cpp:943-1004): mu = kX^T alpha_hat
    with alpha_hat = grad lp(f_hat); var via the whitened B-solve.
    Observation-level moments for non-Gaussian likelihoods are the
    caller's quadrature (inference/quadrature.py has the nodes).
    """
    with highest_precision():
        K = _noisy_gram(kernel, params, 0.0, X)
        _, f, _ = fit_latent(K, y, log_prob, mean, maxit, stats=stats)
        _, dlp, d2lp = _derivs(log_prob, y, f)
        _, sw, L = _whitened_chol(K, d2lp)
        del K
        kX = _cross_gram(kernel, params, X, Xstar)
        mu = kX.T @ dlp
        v = torch.linalg.solve_triangular(L, sw[:, None] * kX, upper=False)
        kdiag = kernel.diag(params, Xstar)
        var = torch.clamp_min(kdiag - torch.sum(v * v, dim=0), 0.0)
    return mu, var


def nlml(K: torch.Tensor, y: torch.Tensor, log_prob: Callable,
         mean: torch.Tensor = None, maxit: int = 20,
         stats: Optional[dict] = None) -> torch.Tensor:
    """Laplace-approximate NLML: psi(alpha_hat) + 1/2 log det B
    (GP_Utils.cpp:1138-1162 composition)."""
    with highest_precision():
        _, f, psi = fit_latent(K, y, log_prob, mean, maxit, stats=stats)
        _, _, d2lp = _derivs(log_prob, y, f)
        L = _whitened_chol(K, d2lp)[2]
        return psi + torch.sum(torch.log(torch.diagonal(L)))
