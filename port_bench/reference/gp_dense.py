"""Plain exact reference of the dense fit: one data set, the NLML of
reference/gp.py, its exact gradient, and the reference's own fit,
written from the model's equations in plain PyTorch.

    hyperparameters, M, A(theta) and NLML as in reference/gp.py
    dNLML/dtheta_k = 1/2 sum_ij (A^-1 - alpha alpha')_ij dA_ij/dtheta_k,
                     alpha = A^-1 ys

The factor is gp.py's tiled Cholesky (`factor`, the configuration's
tile). The gradient is exact: the weight W = A^-1 - alpha alpha' held
fixed, and d/dtheta of 1/2 sum(W * A(theta)) by autograd through the
Gram entries (gp.py's `contract_grad`), a block of `chunk` rows at a
time. W's rows come from the factor alone, a tile of columns of A^-1 at
a time (`inverse_columns`: forward substitution over the tiles of the
identity's columns, which skips the tiles above the diagonal, where
L^-1 is zero, then gp.py's tiled back substitution), transposed, since
A^-1 is symmetric. So neither A^-1 nor A is ever held whole: the
factor's lower tiles (1.3 GB in float64 at N = 16384 and tile 4096), a
tile of A^-1's columns (0.5 GB) and a block of A.

It imports nothing of the program, of the JAX package or of JAX, takes
nothing the program made, and sets torch's float32 products to full
float32 (`no_tf32`). `CONTROL` is gp.py's: TF32 products (float32 sums)
and a float32 factor.

Departures from the reference binary's math (GP_SS_AK's `gp_ss_ak`) are
gp_ensemble.py's: distances by direct differences of the mapped points,
A factored directly, the gradient by autograd of the Gram entries
against W, float64 throughout.

`fit` is the reference's own fit, to hold the program's optimizer to:
scipy's L-BFGS-B on `evaluate` in float64, with the program's host
optimizer's memory (6 pairs), tolerances (relative change 1e-9,
projected gradient 1e-6; the reference binary's, Opt_pars.h) and
iteration count, in the same box, and scipy's line search.
"""

from __future__ import annotations

import math

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


def evaluate(Xs: torch.Tensor, ys: torch.Tensor, theta, prec: Prec,
             tile: int, chunk: int) -> tuple:
    """(NLML, gradient (10,) as float64 numpy) at the flat
    hyperparameters `theta`, over the standardized data Xs (n, 3) and
    ys (n,) in `prec`'s dtype on their device. A failed factor gives NaN
    for both."""
    no_tf32()
    th = torch.as_tensor(np.asarray(theta, np.float64), dtype=prec.dtype,
                         device=Xs.device)
    fac = factor(Xs, th, prec, tile)
    f, alpha = nlml(fac, ys)
    if not fac.ok:
        return f, np.full(N_HYPER, math.nan)
    edges, held = fac.edges, {}

    def columns(s, e):
        """A^-1[:, s:e], from the tiles of columns it spans, each tile's
        solved once (the blocks come in order)."""
        parts = []
        for b in range(len(edges) - 1):
            lo, hi = max(s, edges[b]), min(e, edges[b + 1])
            if lo < hi:
                if b not in held:
                    held.clear()
                    held[b] = inverse_columns(fac, b)
                parts.append(held[b][:, lo - edges[b]:hi - edges[b]])
        return torch.cat(parts, 1)

    def weight(A, s, e):
        W = columns(s, e).T - alpha[s:e, None] * alpha[None, :]
        return torch.sum(W * A)

    return f, contract_grad(Xs, theta, weight, prec, chunk)


def inverse_columns(fac, b: int) -> torch.Tensor:
    """A^-1's columns of tile b, (n, tile b's width): L^-1 of the
    identity's columns by forward substitution over the tiles (zero in
    the tiles above b), then L^-T of that (`Factor.upper_solve`)."""
    e, T, mm = fac.edges, fac.tiles, fac.prec.mm
    like = T[b, b]
    Y = [like.new_zeros(e[i + 1] - e[i], e[b + 1] - e[b])
         for i in range(b)]
    for i in range(b, len(e) - 1):
        acc = (torch.eye(e[b + 1] - e[b], dtype=like.dtype,
                         device=like.device) if i == b
               else like.new_zeros(e[i + 1] - e[i], e[b + 1] - e[b]))
        for k in range(b, i):
            acc -= mm(T[i, k], Y[k])
        Y.append(torch.linalg.solve_triangular(T[i, i], acc, upper=False))
    return fac.upper_solve(torch.cat(Y))


def fit(Xs: torch.Tensor, ys: torch.Tensor, theta0, lower: float,
        upper: float, maxiter: int, tile: int, chunk: int) -> tuple:
    """(NLML at the start, NLML at the end) of the reference's fit:
    L-BFGS-B from `theta0` clamped into the box [lower, upper] on every
    hyperparameter, at most `maxiter` iterations, in float64 over Xs
    and ys (float64, on their device)."""
    from scipy.optimize import minimize

    x0 = np.clip(np.asarray(theta0, np.float64), lower, upper)

    def fg(theta):
        f, g = evaluate(Xs, ys, theta, F64, tile, chunk)
        return (f, g) if np.isfinite(f) else (np.inf, np.zeros(N_HYPER))

    f0 = fg(x0)[0]
    res = minimize(fg, x0, jac=True, method="L-BFGS-B",
                   bounds=[(lower, upper)] * N_HYPER,
                   options={"maxiter": maxiter, "maxcor": 6, "ftol": 1e-9,
                            "gtol": 1e-6})
    return f0, float(res.fun)
