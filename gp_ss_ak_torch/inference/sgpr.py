"""Sparse GP regression (Titsias variational inducing points).

Port of gp_ss_ak_tpu/inference/sgpr.py: the single-card route past the
dense wall, O(n m^2) time and O(n m) memory for m inducing points.

Collapsed evidence lower bound (Titsias 2009):

  L = chol(Kmm + jitter I)
  A = L^-1 Kmn / sigma                      (m, n)
  B = I + A A^T,  LB = chol(B)
  c = LB^-1 A y / sigma
  ELBO = -n/2 log(2 pi sigma^2) - sum log diag LB
         - ||y||^2/(2 sigma^2) + ||c||^2 / 2
         - (sum kdiag(X) / sigma^2 - ||A||_F^2) / 2

Gradients by torch autograd; the inducing locations Z are free
parameters, optimized jointly with the kernel hyperparameters.

What differs from JAX, and why:
  * The flagship model (Sum([ExpAns, Bias])) builds Kmm + jitter I,
    Kmn and Kms with the fused Gram kernel K1 (ops/fused.py:
    `fused_expans_bias_A`, and the differentiable cross entry
    `maybe_fused_cross` through `gaussian._cross_gram` for Kmn and
    Kms), as every flagship Gram of the port
    does; JAX builds them with `kernel.matrix` (plain XLA). Any other
    kernel takes `kernel.matrix` here too.
  * The m x m algebra (Cholesky factors, triangular solves, A A^T)
    runs under `highest_precision()`, the counterpart of
    `Precision.HIGHEST`, so no TF32 enters; a failed Cholesky gives
    NaN (ops.chol), which the optimizer rejects, as in JAX.
  * `init_inducing` draws its subset with a torch.Generator seeded by
    `seed`, not `jax.random.choice`: the same seed picks other points.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from gp_ss_ak_torch.inference.gaussian import _cross_gram, _noisy_gram
from gp_ss_ak_torch.kernels.distance import highest_precision
from gp_ss_ak_torch.ops.chol import cholesky
from gp_ss_ak_torch.optim.lbfgsb import DEFAULT_LOWER, DEFAULT_UPPER, LBFGSB


class SGPRState(NamedTuple):
    L: torch.Tensor    # chol(Kmm)
    LB: torch.Tensor   # chol(I + A A^T)
    A: torch.Tensor    # whitened cross-cov (m, n)
    c: torch.Tensor    # (m,)


def _lower_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, B, upper=False)


def _factors(kernel, params, sn2, X, y, Z, jitter) -> SGPRState:
    m = Z.shape[0]
    with highest_precision():
        Kmm = _noisy_gram(kernel, params, 0.0, Z, jitter)
        Kmn = _cross_gram(kernel, params, Z, X)
        L = cholesky(Kmm)
        sigma = torch.sqrt(sn2)
        A = _lower_solve(L, Kmn) / sigma
        B = torch.eye(m, dtype=A.dtype, device=A.device) + A @ A.T
        LB = cholesky(B)
        c = _lower_solve(LB, (A @ y)[:, None])[:, 0] / sigma
    return SGPRState(L=L, LB=LB, A=A, c=c)


def elbo(kernel, params, lik_hypers, X, y, Z,
         jitter: float = 1e-6) -> torch.Tensor:
    """The collapsed bound (to MAXIMIZE); `neg_elbo` is the objective
    for the box-constrained optimizers."""
    n = X.shape[0]
    sn2 = lik_hypers[0]
    st = _factors(kernel, params, sn2, X, y, Z, jitter)
    kdiag_sum = torch.sum(kernel.diag(params, X))
    trace_term = kdiag_sum / sn2 - torch.sum(st.A * st.A)
    return (-0.5 * n * torch.log(2.0 * math.pi * sn2)
            - torch.sum(torch.log(torch.diagonal(st.LB)))
            - 0.5 * torch.dot(y, y) / sn2
            + 0.5 * torch.dot(st.c, st.c)
            - 0.5 * trace_term)


def neg_elbo(kernel, params, lik_hypers, X, y, Z, jitter: float = 1e-6):
    return -elbo(kernel, params, lik_hypers, X, y, Z, jitter)


def predict(kernel, params, lik_hypers, X, y, Z, Xstar,
            jitter: float = 1e-6, with_noise: bool = True):
    """Predictive mean/variance of the collapsed variational posterior."""
    sn2 = lik_hypers[0]
    st = _factors(kernel, params, sn2, X, y, Z, jitter)
    with highest_precision():
        Kms = _cross_gram(kernel, params, Z, Xstar)         # (m, s)
        tmp1 = _lower_solve(st.L, Kms)
        tmp2 = _lower_solve(st.LB, tmp1)
        mu = tmp2.T @ st.c
        kdiag = kernel.diag(params, Xstar)
        var = (kdiag
               - torch.sum(tmp1 * tmp1, dim=0)
               + torch.sum(tmp2 * tmp2, dim=0))
        var = torch.clamp_min(var, 0.0)
    if with_noise:
        var = var + sn2
    return mu, var


def init_inducing(X, m: int, seed: int = 0) -> torch.Tensor:
    """m inducing locations sampled without replacement from X (a
    permutation drawn on the host from a torch.Generator seeded by
    `seed`, so the subset is the same on every device)."""
    X = torch.as_tensor(X)
    n = X.shape[0]
    g = torch.Generator().manual_seed(int(seed))
    idx = torch.randperm(n, generator=g)[:min(m, n)]
    return X[idx.to(X.device)]


def fit_sgpr(model, X, y, m: int = 128, iters: int = 100, seed: int = 0,
             z_bound: float = None, jitter: float = 1e-6, verbose: int = 0,
             optimize_z: bool = True):
    """Joint bound-constrained L-BFGS over hypers AND inducing
    locations. Hypers keep the reference box [1e-4, 6]; inducing
    coordinates get +-z_bound (default: 2x the data range).
    `optimize_z=False` freezes Z at init_inducing's subset and
    optimizes hypers only (the ablation arm of the m-sweep). The
    objective runs on the device and in the dtype of the model's
    parameters, one host read per evaluation (value and gradient).
    Returns (fitted_model, Z, OptResult)."""
    flat0 = model.pack()
    dtype, device = flat0.dtype, flat0.device
    Xd = torch.as_tensor(X, dtype=dtype, device=device)
    yd = torch.as_tensor(y, dtype=dtype, device=device)
    Z0 = init_inducing(Xd, m, seed)
    m_eff, d = Z0.shape
    kern = model.kernel
    nk = kern.n_params
    nl = model.lik_hypers.numel()
    if z_bound is None:
        z_bound = 2.0 * float(torch.max(torch.abs(Xd)))

    def unpack(v):
        kp = kern.unpack(v[:nk])
        lh = v[nk : nk + nl]
        Z = v[nk + nl :].reshape(m_eff, d) if optimize_z else Z0
        return kp, lh, Z

    def vgrad(x):
        v = torch.tensor(np.asarray(x, np.float64), dtype=dtype,
                         device=device, requires_grad=True)
        with torch.enable_grad():
            kp, lh, Z = unpack(v)
            val = neg_elbo(kern, kp, lh, Xd, yd, Z, jitter)
            (grad,) = torch.autograd.grad(val, v)
        out = torch.cat([val.detach().reshape(1), grad]).cpu()
        return float(out[0]), out[1:].numpy().astype(np.float64)

    v0 = flat0.detach().cpu().numpy().astype(np.float64)[: nk + nl]
    lb = np.full(nk + nl, DEFAULT_LOWER)
    ub = np.full(nk + nl, DEFAULT_UPPER)
    if optimize_z:
        v0 = np.concatenate([v0, Z0.cpu().numpy().astype(np.float64)
                             .ravel()])
        lb = np.concatenate([lb, np.full(m_eff * d, -z_bound)])
        ub = np.concatenate([ub, np.full(m_eff * d, z_bound)])
    res = LBFGSB(maxiter=iters, verbose=verbose).minimize(vgrad, v0, lb, ub)
    kp, lh, Z = unpack(torch.as_tensor(res.x, dtype=dtype, device=device))
    fitted = replace(model, kernel_params=kp, lik_hypers=lh,
                     num_data=int(Xd.shape[0]), input_dim=int(d))
    return fitted, Z, res
