"""Batched multi-deposit GP ensembles (BASELINE.json config 5).

Port of gp_ss_ak_tpu/ensemble/batched.py. Hundreds of INDEPENDENT GPs
(one per ore deposit or domain) are fitted together: every evaluation
of the batched L-BFGS (optim/batched_lbfgs.py) evaluates all deposits
at once, which for the flagship model is one batched K1 launch, one
batched potrf and one batched QW adjoint (optim.api.batched_nlml_fn),
in float64 whatever the model's dtype (optim.api.OBJECTIVE_DTYPE).
Prediction is the exact posterior of every deposit at once.

All GPs share (n, d, m) shapes — pad ragged deposits upstream with
repeated rows + zero-weight targets if needed. With `mesh=` (a
parallel.Mesh) the deposits are split over the ranks, each rank fits its
share as one batch, and the results are gathered onto every rank (the
JAX package shards the batch axis over the devices).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gp_ss_ak_torch.inference import gaussian
from gp_ss_ak_torch.model import GPModel
from gp_ss_ak_torch.optim.api import minimize_batched, unpack_batched

class EnsembleFit(NamedTuple):
    flat: torch.Tensor       # (B, p) fitted hypers per deposit
    fun: torch.Tensor        # (B,) final NLML
    n_iters: torch.Tensor    # (B,)
    converged: torch.Tensor  # (B,)
    n_evals: int = 0         # batched evaluations of the objective


def _as(model: GPModel, a) -> torch.Tensor:
    flat0 = model.pack()
    return torch.as_tensor(a, dtype=flat0.dtype, device=flat0.device)


def fit_ensemble(model: GPModel, Xb, yb, maxiter: int = 100,
                 lower: Optional[np.ndarray] = None,
                 upper: Optional[np.ndarray] = None,
                 mesh=None, hook=None) -> EnsembleFit:
    """Fit B independent GPs: Xb (B, n, d), yb (B, n), each from the
    model's hyperparameters, on the model's device and dtype.

    hook(points (B, p), values (B,), gradients (B, p), mask (B,)) is
    called once per batched evaluation, with the device tensors the
    optimizer holds and no host read of its own; a true return ends the
    fit with each deposit's best so far and `converged` false
    (optim/batched_lbfgs.py).

    With `mesh`, every rank passes the whole batch and fits its
    contiguous share of at least one deposit (B >= mesh.size); each
    deposit's fit is what the undivided batch gives it, and the result
    (n_evals: the most any rank made) is the same on every rank. Each
    rank's hook sees its own share."""
    if mesh is None:
        res = minimize_batched(model, Xb, yb, maxiter, lower, upper,
                               hook=hook)
        return EnsembleFit(res.x, res.fun, res.n_iters, res.converged,
                           res.n_evals)
    from gp_ss_ak_torch.parallel import comm

    B = len(Xb)
    if B < mesh.size:
        raise ValueError(f"fit_ensemble: {B} deposits over {mesh.size} "
                         "ranks; give every rank one")
    lo, hi = comm.block_bounds(mesh, B)
    res = minimize_batched(model, Xb[lo:hi], yb[lo:hi], maxiter, lower,
                           upper, hook=hook)
    x = res.x
    cols = torch.stack([res.fun, res.n_iters.to(x.dtype),
                        res.converged.to(x.dtype)], dim=1)
    out = comm.all_gather_blocks(mesh, torch.cat([x, cols], dim=1), B)
    p = x.shape[1]
    n_evals = int(comm.pmax(mesh, torch.tensor(res.n_evals,
                                               device=x.device)))
    return EnsembleFit(out[:, :p], out[:, p], out[:, p + 1].to(
        res.n_iters.dtype), out[:, p + 2] > 0.5, n_evals)


def predict_batched(model: GPModel, flats: torch.Tensor, Xb, yb, Xstar_b):
    """Posterior mean/var of B problems, each with its own flat hypers
    (B, p): Xb (B, n, d), yb (B, n), Xstar_b (B, m, d) -> (B, m) each.
    The flagship model with the plain Gaussian likelihood predicts all
    at once (batched K1 for A and for the cross-Gram); any other model
    loops over the members (inference/gaussian.py)."""
    kp, lh = unpack_batched(model, flats)
    return gaussian.predict(model.kernel, kp, lh, Xb, yb, Xstar_b,
                            model.likelihood)


def predict_ensemble(model: GPModel, fit: EnsembleFit, Xb, yb, Xstar_b):
    """Posterior mean/var per deposit: Xstar_b (B, m, d) ->
    mu (B, m), var (B, m)."""
    with torch.no_grad():
        return predict_batched(model, _as(model, fit.flat), _as(model, Xb),
                               _as(model, yb), _as(model, Xstar_b))
