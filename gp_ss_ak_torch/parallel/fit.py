"""Large-N training: host L-BFGS over the mesh engines' NLML.

Port of gp_ss_ak_tpu/parallel/fit.py. The same optimizer contract as
optim.fit (box [1e-4, 6], NaN rejection, best-so-far), with the
objective and gradient evaluated by the row-split exact pipeline
(`fit_distributed`) or the ring's matrix-free one (`fit_ring`). Every
rank runs the same optimizer on the same replicated values and
gradients, so all ranks take the same steps and return the same model;
a caller that writes files does so on rank 0 only (cli.py).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from gp_ss_ak_torch.inference.iterative import (
    UnconvergedSolveWarning,
    solve_summary,
    unconverged_message,
)
from gp_ss_ak_torch.model import GPModel
from gp_ss_ak_torch.optim.api import _fitted, host_optimizer
from gp_ss_ak_torch.optim.lbfgsb import (
    DEFAULT_LOWER,
    DEFAULT_UPPER,
    LBFGSB,
    OptResult,
)
from gp_ss_ak_torch.parallel.mesh import Mesh
from gp_ss_ak_torch.parallel.nlml import (
    make_dist_nlml_and_grad,
    shard_training_data,
)

#: the fits' block size: rows pad to a multiple of ranks x NB, and the
#: block Cholesky factors NB columns a step (the JAX package's default)
NB = 256


def _minimize(model: GPModel, X, nlml_grad, X_local, y_local, opt, lower,
              upper, callback) -> Tuple[GPModel, OptResult]:
    flat0 = model.pack().detach()

    def value_and_grad(x_np):
        v, g = nlml_grad(torch.as_tensor(x_np, dtype=flat0.dtype,
                                         device=X_local.device),
                         X_local, y_local)
        out = torch.cat([v.reshape(1), g]).cpu().numpy()   # one host read
        return float(out[0]), out[1:].astype(np.float64)

    x0 = flat0.cpu().numpy().astype(np.float64)
    p = x0.shape[0]
    lb = np.full(p, DEFAULT_LOWER) if lower is None else np.asarray(lower)
    ub = np.full(p, DEFAULT_UPPER) if upper is None else np.asarray(upper)
    res = opt.minimize(value_and_grad, x0, lb, ub, callback=callback)
    return _fitted(model, res, X), res


def _data(model: GPModel, X, y, mesh: Mesh, nb: int):
    dtype = model.pack().dtype
    return shard_training_data(mesh, torch.as_tensor(X, dtype=dtype),
                               torch.as_tensor(y, dtype=dtype), nb=nb)


def fit_distributed(
    model: GPModel,
    X,
    y,
    mesh: Mesh,
    nb: int = NB,
    optimizer: str = "LBFGS",
    iters: int = 100,
    lower: Optional[np.ndarray] = None,
    upper: Optional[np.ndarray] = None,
    verbose: int = 0,
    callback=None,
    grad_mode: str = "auto",
    probes: int = 32,
    fused: Optional[bool] = None,
) -> Tuple[GPModel, OptResult]:
    """Distributed fit over the row-split NLML, on every rank of `mesh`
    with the full X, y (each rank keeps its row block).

    `grad_mode="auto"` (the default) switches from the exact N-RHS
    gradient to the `probes`-probe Hutchinson estimator above
    parallel.nlml.EXACT_GRAD_MAX_N rows, deterministic per evaluation
    (fixed probes); "exact" forces the exact gradient at any size."""
    X_local, y_local, n, _ = _data(model, X, y, mesh, nb)
    nlml_grad = make_dist_nlml_and_grad(model.kernel, model.likelihood,
                                        mesh, n=n, nb=nb,
                                        grad_mode=grad_mode, probes=probes,
                                        fused=fused)
    return _minimize(model, X, nlml_grad, X_local, y_local,
                     host_optimizer(optimizer, iters, verbose), lower,
                     upper, callback)


def fit_ring(
    model: GPModel,
    X,
    y,
    mesh: Mesh,
    nb: int = NB,
    iters: int = 100,
    lower: Optional[np.ndarray] = None,
    upper: Optional[np.ndarray] = None,
    verbose: int = 0,
    callback=None,
    precond_rank: int = 64,
    probes: int = 8,
    slq_probes: int = 16,
    lanczos_iters: int = 32,
    cg_tol: float = 1e-4,
    cg_maxiter: int = 400,
    seed: int = 0,
) -> Tuple[GPModel, OptResult]:
    """Fit past the row-panel wall: L-BFGS-B over the ring's matrix-free
    NLML (parallel.ring.make_ring_nlml_and_grad); no rank holds more
    than an (n_local, TILE_CHUNK) tile. The probes are fixed per fit
    (drawn from `seed`), so the optimizer sees a deterministic
    objective. Flagship Sum([ExpAns, Bias]) + Gaussian likelihood
    only. As `optim.fit` does, a fit with evaluations whose CG ended
    above `cg_tol` warns once (UnconvergedSolveWarning, on every rank:
    the residuals are psum-reduced); a failed solve's evaluation is NaN,
    which the optimizer rejects."""
    from gp_ss_ak_torch.parallel.ring import make_ring_nlml_and_grad

    X_local, y_local, n, _ = _data(model, X, y, mesh, nb)
    ring = make_ring_nlml_and_grad(
        model.kernel, mesh, n=n, precond_rank=precond_rank, probes=probes,
        slq_probes=slq_probes, lanczos_iters=lanczos_iters, cg_tol=cg_tol,
        cg_maxiter=cg_maxiter, probe_seed=seed, with_stats=True)
    rels = []

    def nlml_grad(flat, X_local, y_local):
        value, grad, stats = ring(flat, X_local, y_local)
        rels.append(float(stats[1]))
        return value, grad

    out = _minimize(model, X, nlml_grad, X_local, y_local,
                    LBFGSB(maxiter=iters, verbose=verbose), lower, upper,
                    callback)
    n_bad, max_rel = solve_summary(rels, cg_tol)
    if n_bad:
        warnings.warn(unconverged_message("fit_ring", n_bad, len(rels),
                                          max_rel, cg_tol),
                      UnconvergedSolveWarning, stacklevel=2)
    return out
