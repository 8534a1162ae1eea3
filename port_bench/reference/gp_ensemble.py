"""Plain reference of the batched multi-deposit ensemble: B independent
exact GPs, Sum([ExpAns, Bias]) with Gaussian noise, one per deposit,
written from the model's equations in plain PyTorch.

For deposit b, from its own raw composites (X_b, y_b):

    (Xs, ys)  = the symmetric standardization of deposit b alone
    A(theta)  = Sigma^2 exp(-||M (x_i - x_j)||) + bias + sn2 [i == j]
    NLML      = 1/2 ys' A^-1 ys + 1/2 log det A + n/2 log 2 pi
    dNLML/dtheta_k = 1/2 sum_ij (A^-1 - alpha alpha')_ij dA_ij/dtheta_k,
                     alpha = A^-1 ys

over the 10 flat hyperparameters (reference/gp.py's order and its
`metric`, `gram`, `factor`, `nlml` and `contract_grad`). Each deposit is
computed alone, from its own data and its own hyperparameters: nothing
is batched, so no member can see another's. The gradient is exact: A^-1
from the factor, the weight W = A^-1 - alpha alpha' held fixed, and
d/dtheta of 1/2 sum(W * A(theta)) by autograd through the Gram entries.
It imports nothing of the program, of the JAX package or of JAX, and
sets torch's float32 products to full float32 (`no_tf32`).

Departures from the reference binary's math (GP_SS_AK's `gp_ss_ak`,
which fits one deposit per process):
- distances by direct differences of the mapped points, where the
  binary recentres both sets and expands |a|^2 + |b|^2 - 2 a'b with a
  clamp at 0; the diagonal's exp(0) = 1 is exact here;
- A = K + sn2 I is factored directly, where the binary factors the
  likelihood-weighted B = I + W^1/2 K W^1/2 (the same NLML for the
  Gaussian likelihood);
- the gradient by autograd of the Gram entries against W, where the
  binary contracts its hand-derived derivative matrices against its
  weight matrix QW;
- float64 throughout (`F64`), or the control's TF32 (`CONTROL`).

`fit` is the reference's own fit of one deposit, to hold the program's
optimizer to: scipy's L-BFGS-B on `evaluate` in float64, with the
reference binary's memory (6 pairs) and tolerances (relative change
1e-9, projected gradient 1e-6; Opt_pars.h) and scipy's line search
in the place of the binary's.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.gp import (  # noqa: F401  (re-exported)
    CONTROL,
    F64,
    N_HYPER,
    TF32,
    Prec,
    contract_grad,
    factor,
    nlml,
    no_tf32,
    standardize,
)


def evaluate(X_raw: np.ndarray, y_raw: np.ndarray, theta, prec: Prec,
             device) -> tuple:
    """(NLML, gradient (10,) as float64 numpy) of one deposit at the flat
    hyperparameters `theta`, from its raw composites, in `prec`'s
    arithmetic on `device`. A failed factor gives NaN for both."""
    no_tf32()
    Xs, ys, _, _ = standardize(X_raw, y_raw)
    n = len(ys)

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=prec.dtype,
                               device=device)

    Xs_t, ys_t = put(Xs), put(ys)
    th = put(np.asarray(theta, np.float64))
    fac = factor(Xs_t, th, prec, n)          # one tile: one potrf
    f, alpha = nlml(fac, ys_t)
    if not fac.ok:
        return f, np.full(N_HYPER, np.nan)
    eye = torch.eye(n, dtype=prec.dtype, device=device)
    W = fac.solve(eye) - alpha[:, None] * alpha[None, :]
    del fac, eye
    g = contract_grad(Xs_t, theta, lambda A, s, e: torch.sum(W[s:e] * A),
                      prec, n)
    return f, g


def evaluate_batch(Xb_raw, yb_raw, thetas, prec: Prec, device):
    """(values (B,), gradients (B, 10)) of B independent deposits, each
    by `evaluate` on its own raw data and hyperparameters."""
    out = [evaluate(X, y, th, prec, device)
           for X, y, th in zip(Xb_raw, yb_raw, thetas)]
    return (np.array([f for f, _ in out]),
            np.stack([g for _, g in out]))


def fit(X_raw: np.ndarray, y_raw: np.ndarray, theta0, lower: float,
        upper: float, maxiter: int, device) -> tuple:
    """(NLML at the start, NLML at the end) of the reference's fit of one
    deposit from its raw composites: L-BFGS-B from `theta0` clamped into
    the box [lower, upper] on every hyperparameter, at most `maxiter`
    iterations, in float64."""
    from scipy.optimize import minimize

    x0 = np.clip(np.asarray(theta0, np.float64), lower, upper)

    def fg(theta):
        f, g = evaluate(X_raw, y_raw, theta, F64, device)
        return (f, g) if np.isfinite(f) else (np.inf, np.zeros(N_HYPER))

    f0 = fg(x0)[0]
    res = minimize(fg, x0, jac=True, method="L-BFGS-B",
                   bounds=[(lower, upper)] * N_HYPER,
                   options={"maxiter": maxiter, "maxcor": 6, "ftol": 1e-9,
                            "gtol": 1e-6})
    return f0, float(res.fun)
