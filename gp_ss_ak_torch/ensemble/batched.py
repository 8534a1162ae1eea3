"""Batched multi-deposit GP ensembles (BASELINE.json config 5).

Port of gp_ss_ak_tpu/ensemble/batched.py. Hundreds of INDEPENDENT GPs
(one per ore deposit or domain) are fitted together: every evaluation
of the batched L-BFGS (optim/batched_lbfgs.py) evaluates all deposits
at once, which for the flagship model is one batched K1 launch, one
batched potrf and one batched QW adjoint (optim.api.batched_nlml_fn).
Prediction is the exact posterior of every deposit at once.

All GPs share (n, d, m) shapes — pad ragged deposits upstream with
repeated rows + zero-weight targets if needed. The JAX package's
`mesh=` (deposits sharded over devices) waits for the port of
parallel/ and raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gp_ss_ak_torch.inference import gaussian
from gp_ss_ak_torch.model import GPModel
from gp_ss_ak_torch.optim.api import minimize_batched, unpack_batched

#: the refusal of the JAX package's mesh hooks (here and in bayes/)
PARALLEL_NOT_PORTED = ("waits for the port of parallel/ "
                       "(gp_ss_ak_tpu/parallel) to gp_ss_ak_torch")


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
                 mesh=None) -> EnsembleFit:
    """Fit B independent GPs: Xb (B, n, d), yb (B, n), each from the
    model's hyperparameters, on the model's device and dtype."""
    if mesh is not None:
        raise NotImplementedError(
            "fit_ensemble(mesh=...) (deposits sharded over devices) "
            + PARALLEL_NOT_PORTED)
    res = minimize_batched(model, Xb, yb, maxiter, lower, upper)
    return EnsembleFit(res.x, res.fun, res.n_iters, res.converged,
                       res.n_evals)


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
