"""Serving: factor once, predict many (dense and matrix-free servers).

The reference's test mode rebuilds alpha/chol on every invocation
(gp_ss_ak.cpp:382-395). `Predictor` factors the training posterior
ONCE, keeps (alpha, L, L^-1) on the device, and serves posterior
mean/variance for batches of query points: each batch is one
cross-Gram (the fused CUDA kernel for the flagship model) and one GEMM
with L^-1.

L^-1 comes from one n-RHS `torch.linalg.solve_triangular(L, I)`. The
JAX package's block-row `blocked_linv` (gp_ss_ak_tpu/serve.py:23-69)
only dodged an XLA:TPU out-of-memory failure in that solve and is not
ported.

`IterativePredictor` is the matrix-free server past the dense wall:
K(X, X) never exists; every solve is batched CG over the streamed Gram
matmat (the CUDA kernel csrc/matmat.cu on a GPU, ops/matvec.py).

Both servers take the plain and the warped Gaussian likelihood.

A `Predictor` request carries torch.profiler ranges (recorded only
while a profiler is active): "serve.request" around the call, and in
it, for each batch, "serve.to_device" (the query's upload),
"serve.posterior" (cross-Gram, GEMV, the L^-1 SGEMM, the variance
reduce) and "serve.to_host" (mean and variance to the host). No range
sits inside a per-step loop: a request opens 4, and 3 more for each
further batch.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.profiler import record_function

from gp_ss_ak_torch.inference import gaussian
from gp_ss_ak_torch.inference.iterative import (
    UnconvergedSolveWarning,
    auto_precond_rank,
    bcg_solve_info,
    pivoted_cholesky,
    solve_state,
    unconverged_message,
    whitened_solve_info,
)
from gp_ss_ak_torch.inference.likelihoods import WarpedGaussian
from gp_ss_ak_torch.kernels.distance import highest_precision, pad_to_3d
from gp_ss_ak_torch.model import GPModel
from gp_ss_ak_torch.ops.matvec import operator_arrays, streamed_matmat
from gp_ss_ak_torch.ops.pairwise import expans_bias_gram
from gp_ss_ak_torch.optim.iterative_fit import supports_iterative


class Predictor:
    """Posterior server for one trained model + training set, on the
    dtype and device of the model's parameters."""

    #: above this training size the one-time L^-1 (an n x n buffer) is
    #: not precomputed by default — pass precompute_inverse=True to
    #: override. Kept from the JAX package for behavioural parity; its
    #: value was sized for a 16 GB TPU and is still to be re-derived
    #: for an 80 GB H100.
    PRECOMPUTE_MAX_N = 16384

    def __init__(self, model: GPModel, X, y, robust: bool = False,
                 precompute_inverse: Optional[bool] = None):
        self.model = model
        flat = model.pack()
        self.dtype, self.device = flat.dtype, flat.device
        self.X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        self.y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        # robust=True adds an escalating diagonal nugget instead of
        # propagating NaN (utils/psd.py); .nugget is what it added
        self.post = gaussian.factorize(
            model.kernel, model.kernel_params, model.lik_hypers,
            self.X, self.y, model.likelihood, robust=robust)
        self.nugget = (self.post.nugget if self.post.nugget is not None
                       else torch.zeros((), dtype=self.dtype,
                                        device=self.device))
        n = self.X.shape[0]
        if precompute_inverse is None:
            precompute_inverse = n <= self.PRECOMPUTE_MAX_N
        if precompute_inverse:
            eye = torch.eye(n, dtype=self.dtype, device=self.device)
            with highest_precision():
                linv = torch.linalg.solve_triangular(self.post.chol, eye,
                                                     upper=False)
            self.post = self.post._replace(linv=linv)

    def _predict(self, Xs: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        m = self.model
        with record_function("serve.to_device"):
            Xs_t = torch.as_tensor(Xs, dtype=self.dtype, device=self.device)
        with record_function("serve.posterior"):
            return gaussian.posterior_mean_var(
                m.kernel, m.kernel_params, m.lik_hypers, self.X, self.post,
                Xs_t, m.likelihood)

    def __call__(self, Xstar, batch_size: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        # a range of its own each call (a decorator's one instance would
        # be shared by concurrent requests)
        with record_function("serve.request"):
            Xs = np.asarray(Xstar)
            if batch_size is None or Xs.shape[0] <= batch_size:
                mu, var = self._predict(Xs)
                with record_function("serve.to_host"):
                    return mu.cpu().numpy(), var.cpu().numpy()
            mus, vars_ = [], []
            # fixed-size batches (the tail padded by repeating its last
            # row), as the JAX server does, so every batch has one shape
            m = Xs.shape[0]
            for start in range(0, m, batch_size):
                chunk = Xs[start : start + batch_size]
                pad = batch_size - chunk.shape[0]
                if pad:
                    chunk = np.concatenate([chunk, np.repeat(
                        chunk[-1:], pad, axis=0)])
                mu, var = self._predict(chunk)
                take = batch_size - pad
                with record_function("serve.to_host"):
                    mus.append(mu[:take].cpu().numpy())
                    vars_.append(var[:take].cpu().numpy())
            return np.concatenate(mus), np.concatenate(vars_)


class IterativePredictor:
    """Matrix-free posterior server: K(X, X) is never materialized.
    Port of gp_ss_ak_tpu/serve.py:145-429, on the device of the model's
    parameters, in float32 whatever the model's dtype (as the JAX
    class).

      setup  alpha = A^-1 y by whitened batched CG (plain CG on
             P^(-1/2) A P^(-1/2), P the rank-k pivoted-Cholesky
             preconditioner) over the streamed Gram matmat; alpha stays
             on the device.
      mean   mu = k*' alpha, k* = s^2 exp(-r) + bias built by the fused
             cross-Gram (ops/pairwise, K1) over row chunks of `chunk`
             training points; no solves. The variance builds k* again
             (one K1 pass, negligible next to its solve).
      var    sigma^2 = (s^2 + bias) - k*' A^-1 k* + sn2: one batched
             whitened-CG solve per query batch (all columns share each
             streamed pass), clamped >= 0 before the noise add, the
             reference's order (GP_Utils.cpp:1002-1041).

    Queries are recentred by the TRAINING mean and mapped through the
    same metric M as the training points (not the combined-mean
    convention of ops/fused.maybe_fused_cross); distances are
    translation invariant, so this only affects round-off.

    A WarpedGaussian model runs the same algebra on g(y) (alpha =
    (K + sn2 I)^-1 g(y), sn2 = exp(2 theta), g's rbf clamp at the raw
    targets' max) and pushes each batch's latent (mu, var) through g^-1
    with the dense path's Gauss-Hermite mix
    (gaussian.warped_predictive_mix). Its predictive mean mixes over
    the latent sigma, so a warped `mean_only` call still solves for the
    variance.

    Every solve is judged (inference.iterative.solve_state) against
    `cg_tol`: `setup_rel_residual` and `last_rel_residual` keep the
    setup's and the last request's (its worst block). An unconverged
    solve warns once per server (UnconvergedSolveWarning); a failed
    setup solve makes every mean and variance NaN, and a failed request
    solve that request's variances, as the dense Predictor's failed
    factor does (the JAX server uses the best iterate as it is).
    """

    #: max right-hand-side columns per variance solve. TPU-era values,
    #: set by the TPU kernel's VMEM ceiling (serve.py:341-353), kept for
    #: parity and still to be re-derived on the H100, where the CUDA
    #: kernel holds no per-column state beyond its tile.
    SOLVE_COL_BLOCK = 1024
    SOLVE_COL_BLOCK_LARGE_N = 512
    LARGE_N_THRESHOLD = 80000

    def __init__(self, model: GPModel, X, y, precond_rank=None,
                 cg_tol: float = 1e-4, cg_maxiter: int = 800,
                 chunk: int = 4096):
        if not supports_iterative(model):
            raise ValueError(
                "IterativePredictor supports only Sum([ExpAns, Bias]) "
                "with a (Warped)Gaussian likelihood; got "
                f"{model.kernel!r} / {type(model.likelihood).__name__}")
        f32 = torch.float32
        self.model = model
        self.device = device = model.pack().device
        ep, bp = model.kernel_params
        expans = model.kernel.children[0]
        Xd = torch.as_tensor(X, dtype=f32, device=device)
        yraw = torch.as_tensor(y, dtype=f32, device=device)
        lik = model.likelihood
        lh = model.lik_hypers.to(f32).reshape(-1)
        self.likelihood, self.lik_hypers = lik, lh
        self.warped = isinstance(lik, WarpedGaussian)
        # rbf warp families clamp their centres at max(raw y)
        self.y_max = torch.max(yraw)
        if self.warped:
            yd, _ = lik.effective_target(lh, yraw, self.y_max)
        else:
            yd = yraw
        n = Xd.shape[0]
        self.n = n
        self.cg_tol = cg_tol
        self.cg_maxiter = cg_maxiter
        rank = auto_precond_rank(n) if precond_rank is None \
            else precond_rank
        self.precond_rank = rank

        # recentre by the TRAINING mean and map through M; queries
        # share c and M (_map_queries)
        Xp = pad_to_3d(Xd)
        self._c = torch.mean(Xp, dim=0)
        self._M = expans.metric(ep, Xp.shape[-1]).to(f32)
        with highest_precision():
            Xm = (Xp - self._c) @ self._M
        sigma = ep["Sigma"].to(f32)
        bias = bp["Sigma"].to(f32)
        sn2 = lik.noise_variance(lh)
        self.sigma, self.bias, self.sn2 = sigma, bias, sn2
        self.s2 = sigma * sigma
        self._Xm = Xm.contiguous()
        Xop, scal = operator_arrays(Xm, sigma)
        d = Xm.shape[1]

        def matmat(V):
            return streamed_matmat(Xop, scal, bias, sn2, V, d)

        # whitened-CG solve route (f32-stable at the flagship
        # conditioning); rank 0 takes plain batched CG
        if rank:
            L = pivoted_cholesky(self._Xm, sigma, bias, rank)

            def solve(B):
                sols, it, rel, _ld, _wmm = whitened_solve_info(
                    matmat, L, sn2, B, tol=cg_tol, maxiter=cg_maxiter)
                return sols, it, rel
        else:
            def solve(B):
                return bcg_solve_info(matmat, B, None, tol=cg_tol,
                                      maxiter=cg_maxiter)
        self._solve = solve
        self._warned = False
        alpha, it, rel = solve(yd[:, None])
        self.setup_cg_iters = int(it)
        self.setup_rel_residual = float(rel)
        self._setup_failed = not self._judge("setup", rel)
        self.alpha = torch.full_like(alpha[:, 0], math.nan) \
            if self._setup_failed else alpha[:, 0]
        self._chunk = chunk
        self.last_cg_iters = None
        self.last_rel_residual = None

    def _judge(self, what: str, rel) -> bool:
        """False when the solve failed; warns for the server's first
        unconverged solve."""
        state = solve_state(rel, self.cg_tol)
        if state == "unconverged" and not self._warned:
            self._warned = True
            warnings.warn(unconverged_message(
                f"IterativePredictor ({what})", 1, 1, float(rel),
                self.cg_tol), UnconvergedSolveWarning, stacklevel=3)
        return state != "failed"

    def _map_queries(self, Xs: np.ndarray) -> torch.Tensor:
        Xsp = pad_to_3d(torch.as_tensor(Xs, dtype=torch.float32,
                                        device=self.device))
        with highest_precision():
            return ((Xsp - self._c) @ self._M).contiguous()

    def _cross_chunks(self, Xsm: torch.Tensor):
        """k*(X_train, X_batch) = s^2 exp(-r) + bias, `chunk` training
        rows at a time, through the fused cross-Gram (K1)."""
        for s in range(0, self.n, self._chunk):
            yield s, expans_bias_gram(self._Xm[s:s + self._chunk],
                                      self.sigma, self.bias, None, Xsm)

    def _mean(self, Xsm: torch.Tensor) -> torch.Tensor:
        mu = torch.zeros(Xsm.shape[0], dtype=torch.float32,
                         device=self.device)
        with highest_precision():
            for s, kc in self._cross_chunks(Xsm):
                mu += kc.T @ self.alpha[s:s + kc.shape[0]]
        return mu

    def _solve_col_block(self) -> int:
        if self.n > self.LARGE_N_THRESHOLD:
            return self.SOLVE_COL_BLOCK_LARGE_N
        return self.SOLVE_COL_BLOCK

    def _var(self, Xsm: torch.Tensor) -> torch.Tensor:
        kx = torch.cat([kc for _, kc in self._cross_chunks(Xsm)])  # (n, B)
        B = kx.shape[1]
        blk = self._solve_col_block()
        if B <= blk:
            W, it, rel = self._solve(kx)
            iters, rel = int(it), float(rel)
        else:
            pad = (-B) % blk
            kx_p = torch.nn.functional.pad(kx, (0, pad)) if pad else kx
            parts, iters, rels = [], 0, []
            for s in range(0, B + pad, blk):
                Wb, it, rel = self._solve(kx_p[:, s:s + blk])
                parts.append(Wb)
                iters = max(iters, int(it))
                rels.append(float(rel))
            W = torch.cat(parts, dim=1)[:, :B]
            # the worst block; a non-finite one wins
            rel = max(rels, key=lambda r: r if r == r else math.inf)
        self.last_cg_iters, self.last_rel_residual = iters, rel
        kss = self.s2 + self.bias                    # k(x*, x*)
        var = kss - torch.sum(kx * W, dim=0)
        # clamp BEFORE the noise add: reference order
        var = torch.clamp_min(var, 0.0) + self.sn2
        if not self._judge("request", rel) or self._setup_failed:
            var = torch.full_like(var, math.nan)
        return var

    def __call__(self, Xstar, batch_size: int = 4096,
                 mean_only: bool = False, latent: bool = False
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Posterior mean and variance (noise included) at Xstar, in
        batches of `batch_size` (the tail padded by repeating its last
        row, as the JAX server does). `mean_only` returns (mu, None):
        a plain Gaussian then skips the variance solves, a warped model
        still pays them. `latent=True` returns a warped model's LATENT
        Gaussian (mu, var), noise included and the warp mix not
        applied; for a plain Gaussian it changes nothing."""
        Xs = np.asarray(Xstar)
        m = Xs.shape[0]
        mus, vars_ = [], []
        mix = self.warped and not latent
        need_var = (not mean_only) or mix
        for start in range(0, m, batch_size):
            chunk = Xs[start:start + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)])
            Xsm = self._map_queries(chunk)
            take = batch_size - pad
            mu_b = self._mean(Xsm)
            var_b = self._var(Xsm) if need_var else None
            if mix:
                mu_b, var_b = gaussian.warped_predictive_mix(
                    self.likelihood, self.lik_hypers, mu_b, var_b,
                    self.y_max)
            mus.append(mu_b[:take].cpu().numpy())
            if not mean_only:
                vars_.append(var_b[:take].cpu().numpy())
        mu = np.concatenate(mus)
        return mu, (None if mean_only else np.concatenate(vars_))
