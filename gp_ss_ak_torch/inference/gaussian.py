"""Exact Gaussian(-warped) GP regression: NLML, posterior, prediction.

Port of gp_ss_ak_tpu/inference/gaussian.py, with its two gradients of
the NLML (the training path). The reference reaches these quantities
through Laplace/IRLS iteration (GP_Utils.cpp:180-381); for a
(warped-)Gaussian likelihood that converges to exact GP regression in
one Newton step, so the closed form is computed directly with a single
Cholesky of A = K + sn2 I:

  L = 1/2 g(y)^T alpha + 1/2 log det(K + sn2 I) + N/2 log 2pi
      - sum log g'(y)

(g the identity for the plain Gaussian). A failed Cholesky surfaces as
NaN in the objective (the reference's Chol_fail -> NaN protocol,
GP_Utils.cpp:884-887, 1145-1146), via `ops.chol.cholesky`;
`factorize(robust=True)` retries with a growing diagonal nugget instead
(utils/psd.py).

Gradients: `nlml(grad_mode="autodiff")` differentiates through potrf;
`grad_mode="qw"` (what the fit engine uses) replaces that with the
closed-form QW adjoint of `QuadLogdet` (gaussian.py:107-142). Both meet
the fused Gram's own backward (ops/fused.FusedExpansBiasA) for the
flagship model; the warp hypers get theirs by autograd through
g(y) and log g'(y).

Warped predictions push the latent Gaussian through g^-1 with the
reference's 20-node Gauss-Hermite mix (`warped_predictive_mix`).

Batches: `nlml(grad_mode="qw")` and `predict` also take B independent
problems (the JAX package's jax.vmap over ensemble members and sampler
chains): X (B, n, d), y (B, n), Xstar (B, m, d), kernel parameters with
(B,) leaves and lik_hypers (n_lik, B) (`kernel.unpack(flats.T)`,
`flats[:, nk:].T` of (B, p) flat vectors). The flagship model with the
plain Gaussian likelihood runs them at once (so do `factorize` and
`posterior_mean_var`): each member gets its own batched K1 build,
potrf, solves and QW adjoint; a member whose factor fails gets a NaN
value and gradient, and the others are untouched. Any other model
loops over the members and stacks the results: right, not fast.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.autograd.profiler import record_function
from torch.utils._pytree import tree_map

from gp_ss_ak_torch.inference import warping
from gp_ss_ak_torch.inference.likelihoods import Gaussian, WarpedGaussian
from gp_ss_ak_torch.inference.quadrature import gauss_hermite
from gp_ss_ak_torch.kernels.distance import highest_precision
from gp_ss_ak_torch.ops.chol import cho_solve, cholesky
from gp_ss_ak_torch.ops.fused import (_is_flagship, maybe_fused_A,
                                      maybe_fused_cross)
from gp_ss_ak_torch.utils.psd import robust_cholesky


class Posterior(NamedTuple):
    """Derived GP state (the reference recomputes this on model load —
    model files store only hyperparameters, GP_Utils.cpp:1360-1390)."""

    alpha: torch.Tensor  # (n,)   (K + sn2 I)^-1 g(y)
    chol: torch.Tensor   # (n, n) lower Cholesky of K + sn2 I
    gy: torch.Tensor     # (n,)   effective (possibly warped) targets
    lgpy: torch.Tensor   # (n,)   log g'(y): zeros for plain Gaussian
    y_max: Optional[torch.Tensor] = None  # max of RAW targets (rbf clamp)
    linv: Optional[torch.Tensor] = None   # optional (n, n) L^-1, set by
    # serve.Predictor: turns each batch's triangular solve into a GEMM
    nugget: Optional[torch.Tensor] = None  # diagonal added by the robust
    # factorization (utils/psd.py); None on the plain path


def _loops_members(kernel, likelihood, X) -> bool:
    """Whether X is a batch of problems that runs member by member: any
    model but the flagship with the plain Gaussian likelihood."""
    return X.dim() == 3 and not (_is_flagship(kernel)
                                 and isinstance(likelihood, Gaussian))


def _members(params, lik_hypers, *batched):
    """Member b's (params, lik_hypers, *arrays) of a batch, for each b."""
    for b in range(batched[0].shape[0]):
        yield (tree_map(lambda t: t[b], params), lik_hypers[:, b],
               *(a[b] for a in batched))


def _gram(kernel, params, X, jitter: float = 0.0):
    K = kernel.matrix(params, X, X, same=True)
    if jitter:
        K = K + jitter * torch.eye(X.shape[0], dtype=K.dtype,
                                   device=K.device)
    return K


def _noisy_gram(kernel, params, sn2, X, jitter: float = 0.0):
    """A = K + (sn2 + jitter) I: the fused kernel (K1) for the flagship
    model, else the generic torch Gram (one problem only)."""
    A = maybe_fused_A(kernel, params, sn2, X, jitter)
    if A is not None:
        return A
    if X.dim() != 2:
        raise ValueError("a batch of problems (X of shape (B, n, d)) "
                         "takes the flagship model only")
    K = _gram(kernel, params, X, jitter)
    return K + sn2 * torch.eye(X.shape[0], dtype=K.dtype, device=K.device)


def factorize(kernel, params, lik_hypers, X, y, likelihood=Gaussian(),
              jitter: float = 0.0, robust: bool = False) -> Posterior:
    """Build alpha and the Cholesky factor of A = K + sn2 I, on the
    (warped) targets g(y) with the likelihood's noise.

    The flagship ExpAns+Bias model builds A through the fused Gram
    kernel (ops/fused.py); other kernels use the generic torch Gram.
    `robust=True` swaps the plain Cholesky for the jitter-retry
    factorization (utils/psd.py): on failure the diagonal nugget grows
    instead of NaN propagating; the nugget used is in Posterior.nugget."""
    gy, lgpy = likelihood.effective_target(lik_hypers, y)
    sn2 = likelihood.noise_variance(lik_hypers)
    nugget = None
    with highest_precision():
        A = _noisy_gram(kernel, params, sn2, X, jitter)
        if robust:
            L, nugget = robust_cholesky(A)
        else:
            L = cholesky(A)  # all NaN on failure -> NaN objective
        del A
        alpha = torch.cholesky_solve(gy[..., None], L)[..., 0]
    return Posterior(alpha=alpha, chol=L, gy=gy, lgpy=lgpy,
                     y_max=torch.amax(y, dim=-1), nugget=nugget)


class QuadLogdet(torch.autograd.Function):
    """1/2 gy^T A^-1 gy + 1/2 log det A with the closed-form adjoint
    (gaussian.py:107-142, the reference's QW algebra GP_Utils.cpp:
    1164-1220):

      dA = ghat * 1/2 (A^-1 - alpha alpha^T),  dgy = ghat * alpha

    A^-1 = L^-T L^-1 from ONE n-RHS triangular solve and one GEMM.
    A failed factor (NaN, ops.chol) gives a NaN value and a NaN
    gradient; nothing raises, so the optimizers reject the step. Both
    passes carry a profiler range named after them, and inside the
    backward's the solve and the GEMM carry "QuadLogdet.linv" and
    "QuadLogdet.ainv"."""

    @staticmethod
    @record_function("QuadLogdet.forward")
    def forward(ctx, A, gy):
        with highest_precision():
            L = cholesky(A)
            alpha = cho_solve(L, gy[..., None])[..., 0]
        ctx.save_for_backward(L, alpha)
        return 0.5 * torch.sum(gy * alpha, dim=-1) + torch.sum(
            torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)

    @staticmethod
    @record_function("QuadLogdet.backward")
    def backward(ctx, ghat):
        L, alpha = ctx.saved_tensors
        grad_A = grad_gy = None
        if ctx.needs_input_grad[0]:
            eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
            with highest_precision():
                with record_function("QuadLogdet.linv"):
                    Linv = torch.linalg.solve_triangular(
                        L, eye.expand_as(L), upper=False)
                del eye
                with record_function("QuadLogdet.ainv"):
                    grad_A = Linv.mT @ Linv
            del Linv
            if grad_A.dim() == 2:
                grad_A.addr_(alpha, alpha, alpha=-1.0)
            else:
                grad_A.baddbmm_(alpha[..., :, None], alpha[..., None, :],
                                alpha=-1.0)
            grad_A.mul_(0.5 * ghat[..., None, None])
        if ctx.needs_input_grad[1]:
            grad_gy = ghat[..., None] * alpha
        return grad_A, grad_gy


def _quad_logdet(A: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    return QuadLogdet.apply(A, gy)


def nlml(kernel, params, lik_hypers, X, y, likelihood=Gaussian(),
         jitter: float = 0.0, grad_mode: str = "autodiff") -> torch.Tensor:
    """Negative log marginal likelihood (the reference prints it as
    "-logL", Opt_pars.cpp:282).

    grad_mode "autodiff": reverse mode through the Cholesky (default).
    grad_mode "qw": the closed-form QW adjoint (`QuadLogdet`): the same
    values and gradients, another backward schedule; it also takes a
    batch of problems (module docstring) and returns (B,) values."""
    if _loops_members(kernel, likelihood, X):
        return torch.stack([nlml(kernel, p, lh, Xb, yb, likelihood, jitter,
                                 grad_mode)
                            for p, lh, Xb, yb in _members(params, lik_hypers,
                                                          X, y)])
    n = X.shape[-2]
    const = 0.5 * n * math.log(2.0 * math.pi)
    if grad_mode == "qw":
        gy, lgpy = likelihood.effective_target(lik_hypers, y)
        sn2 = likelihood.noise_variance(lik_hypers)
        with highest_precision():
            A = _noisy_gram(kernel, params, sn2, X, jitter)
            core = _quad_logdet(A, gy)
        return core + const - torch.sum(lgpy, dim=-1)
    if grad_mode != "autodiff":
        raise ValueError(f"grad_mode must be 'autodiff' or 'qw', got "
                         f"{grad_mode!r}")
    post = factorize(kernel, params, lik_hypers, X, y, likelihood, jitter)
    half_logdet = torch.sum(torch.log(torch.diagonal(post.chol)))
    fit = 0.5 * torch.dot(post.gy, post.alpha)
    return fit + half_logdet + const - torch.sum(post.lgpy)


def warped_predictive_mix(likelihood, lik_hypers, mu, var, ymax):
    """20-node Gauss-Hermite push of the LATENT Gaussian through g^-1;
    the reference mixes with z = mu + sigma x_k and measures the spread
    around the latent mean (GP_Utils.cpp:1059-1077), replicated
    exactly. `ymax` is the max of the RAW training targets (the rbf
    family's centre clamp, GP_Utils.cpp:591)."""
    nodes, weights = gauss_hermite(20)
    nodes = torch.as_tensor(nodes, dtype=mu.dtype, device=mu.device)
    weights = torch.as_tensor(weights, dtype=mu.dtype, device=mu.device)
    sig = torch.sqrt(var)
    Z = mu[:, None] + sig[:, None] * nodes[None, :]
    G = warping.inverse(likelihood.family,
                        likelihood.warp_hypers(lik_hypers), Z,
                        y_train_max=ymax)
    mu_w = G @ weights
    var_w = ((G - mu[:, None]) ** 2) @ weights
    return mu_w, var_w


def _cross_gram(kernel, params, X, Xstar):
    """K(X, X*), (n, m): the fused kernel (K1) for the flagship model,
    else the generic torch Gram."""
    kX = maybe_fused_cross(kernel, params, X, Xstar)
    if kX is None:
        if X.dim() != 2:
            raise ValueError("a batch of problems (X of shape (B, n, d)) "
                             "takes the flagship model only")
        kX = kernel.matrix(params, X, Xstar, same=False)
    return kX


def posterior_mean_var(kernel, params, lik_hypers, X, post: Posterior,
                       Xstar, likelihood=Gaussian(), full_cov: bool = False):
    """Latent+noise predictive mean/variance at Xstar.

    Mirrors posteriorMeanVar (GP_Utils.cpp:943-1080): cross-kernel,
    mu = kX^T alpha, whitened solve for the variance, clamp at 0 BEFORE
    the observation noise is added; warped models then push the
    Gaussian through g^-1 (`warped_predictive_mix`), and under
    `full_cov` return (mu_w, var_w, None). The flagship cross-Gram goes
    through the fused kernel (ops/fused.py). A batch of problems
    (module docstring) gives (B, m) means and variances."""
    with highest_precision():
        kX = _cross_gram(kernel, params, X, Xstar)             # (n, m)
        mu = (kX.mT @ post.alpha[..., None])[..., 0]
        if Xstar.dim() == 3:
            kdiag = torch.func.vmap(kernel.diag)(params, Xstar)
        else:
            kdiag = kernel.diag(params, Xstar)
        if post.linv is not None:
            v = post.linv @ kX
        else:
            v = torch.linalg.solve_triangular(post.chol, kX, upper=False)
        if full_cov:
            Kss = kernel.matrix(params, Xstar, Xstar, same=True)
            cov = Kss - v.T @ v
            var = torch.clamp_min(torch.diagonal(cov), 0.0)
        else:
            var = torch.clamp_min(kdiag - torch.sum(v * v, dim=-2), 0.0)
    sn2 = likelihood.noise_variance(lik_hypers)
    var = var + sn2[..., None]
    if isinstance(likelihood, WarpedGaussian):
        ymax = post.y_max if post.y_max is not None else torch.max(post.gy)
        mu_w, var_w = warped_predictive_mix(likelihood, lik_hypers, mu, var,
                                            ymax)
        if full_cov:
            return mu_w, var_w, None
        return mu_w, var_w
    if full_cov:
        eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
        return mu, var, cov + sn2 * eye
    return mu, var


def posterior_mean(kernel, params, lik_hypers, X, post: Posterior, Xstar,
                   likelihood=Gaussian(), chunk: int = 4096):
    """The predictive mean of `posterior_mean_var` at Xstar, `chunk`
    queries at a time, so that no more than an (n, chunk) cross-Gram is
    held. A plain Gaussian needs mu = kX^T alpha alone, with no
    variance solve; a warped model's mean mixes over the latent sigma,
    so each chunk also takes its triangular solve."""
    parts = []
    for s in range(0, Xstar.shape[0], chunk):
        Xq = Xstar[s:s + chunk]
        if isinstance(likelihood, WarpedGaussian):
            mu, _ = posterior_mean_var(kernel, params, lik_hypers, X, post,
                                       Xq, likelihood)
        else:
            with highest_precision():
                mu = _cross_gram(kernel, params, X, Xq).T @ post.alpha
        parts.append(mu)
    return torch.cat(parts)


def predict(kernel, params, lik_hypers, X, y, Xstar, likelihood=Gaussian(),
            jitter: float = 0.0, full_cov: bool = False):
    """One-shot factorize + predict (the reference's test-mode flow,
    gp_ss_ak.cpp:382-409: load hypers, rebuild alpha/chol, predict).
    A batch of problems (module docstring) gives (B, m) means and
    variances."""
    if _loops_members(kernel, likelihood, X):
        outs = [predict(kernel, p, lh, Xb, yb, Xs, likelihood, jitter)
                for p, lh, Xb, yb, Xs in _members(params, lik_hypers, X, y,
                                                  Xstar)]
        return tuple(torch.stack(o) for o in zip(*outs))
    post = factorize(kernel, params, lik_hypers, X, y, likelihood, jitter)
    return posterior_mean_var(kernel, params, lik_hypers, X, post, Xstar,
                              likelihood, full_cov)
