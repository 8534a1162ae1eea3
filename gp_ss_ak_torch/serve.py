"""Serving: factor once, predict many (the dense Predictor).

The reference's test mode rebuilds alpha/chol on every invocation
(gp_ss_ak.cpp:382-395). `Predictor` factors the training posterior
ONCE, keeps (alpha, L, L^-1) on the device, and serves posterior
mean/variance for batches of query points: each batch is one
cross-Gram (the fused CUDA kernel for the flagship model) and one GEMM
with L^-1.

L^-1 comes from one n-RHS `torch.linalg.solve_triangular(L, I)`. The
JAX package's block-row `blocked_linv` (gp_ss_ak_tpu/serve.py:23-69)
only dodged an XLA:TPU out-of-memory failure in that solve and is not
ported. The matrix-free `IterativePredictor` is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gp_ss_ak_torch.inference import gaussian
from gp_ss_ak_torch.kernels.distance import highest_precision
from gp_ss_ak_torch.model import GPModel


class Predictor:
    """Posterior server for one trained model + training set, on the
    dtype and device of the model's parameters."""

    #: above this training size the one-time L^-1 (an n x n buffer) is
    #: not precomputed by default — pass precompute_inverse=True to
    #: override. Kept from the JAX package for behavioural parity; its
    #: value was sized for a 16 GB TPU and is still to be re-derived
    #: for an 80 GB H100.
    PRECOMPUTE_MAX_N = 16384

    def __init__(self, model: GPModel, X, y,
                 precompute_inverse: Optional[bool] = None):
        self.model = model
        flat = model.pack()
        self.dtype, self.device = flat.dtype, flat.device
        self.X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        self.y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        self.post = gaussian.factorize(
            model.kernel, model.kernel_params, model.lik_hypers,
            self.X, self.y, model.likelihood)
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
        Xs_t = torch.as_tensor(Xs, dtype=self.dtype, device=self.device)
        return gaussian.posterior_mean_var(
            m.kernel, m.kernel_params, m.lik_hypers, self.X, self.post,
            Xs_t, m.likelihood)

    def __call__(self, Xstar, batch_size: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        Xs = np.asarray(Xstar)
        if batch_size is None or Xs.shape[0] <= batch_size:
            mu, var = self._predict(Xs)
            return mu.cpu().numpy(), var.cpu().numpy()
        mus, vars_ = [], []
        # fixed-size batches (the tail padded by repeating its last row),
        # as the JAX server does, so every batch has one shape
        m = Xs.shape[0]
        for start in range(0, m, batch_size):
            chunk = Xs[start : start + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.repeat(
                    chunk[-1:], pad, axis=0)])
            mu, var = self._predict(chunk)
            take = batch_size - pad
            mus.append(mu[:take].cpu().numpy())
            vars_.append(var[:take].cpu().numpy())
        return np.concatenate(mus), np.concatenate(vars_)
