"""Scaled Conjugate Gradients (Moller 1993) — the reference's `-o SCG`.

Behavioral spec from `scgOptimise` (Opt_pars.cpp:979-1124): finite-
difference curvature along the search direction, trust-region lambda
adaptation from the comparison ratio Delta, direction restart every
`dim` iterations, convergence when |Delta f| < tol. Host-driver form
like LBFGSB (objective+grad are device calls); bounds are enforced
by projection at evaluation points.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from gp_ss_ak_torch.optim.lbfgsb import DEFAULT_LOWER, DEFAULT_UPPER, OptResult


@dataclass
class SCG:
    maxiter: int = 100
    tol: float = 1e-6
    sigma0: float = 1e-4
    lambda_init: float = 1e-6
    verbose: int = 0

    def minimize(
        self,
        value_and_grad: Callable[[np.ndarray], Tuple[float, np.ndarray]],
        x0: np.ndarray,
        lower: Optional[np.ndarray] = None,
        upper: Optional[np.ndarray] = None,
        callback: Optional[Callable] = None,
    ) -> OptResult:
        x = np.asarray(x0, np.float64).copy()
        p = x.shape[0]
        lb = np.full(p, DEFAULT_LOWER) if lower is None else np.asarray(lower)
        ub = np.full(p, DEFAULT_UPPER) if upper is None else np.asarray(upper)
        x = np.clip(x, lb, ub)

        n_evals = [0]

        def fg(z):
            n_evals[0] += 1
            f, g = value_and_grad(np.clip(z, lb, ub))
            return float(f), np.asarray(g, np.float64)

        lam = self.lambda_init
        lam_bar = 0.0
        f, grad = fg(x)
        if not np.isfinite(f):
            # shrink toward a small-hyper anchor out of the NaN region
            # (same policy as LBFGSB.minimize)
            anchor = np.clip(np.full(p, 0.5), lb, ub)
            for _ in range(10):
                x = 0.5 * (x + anchor)
                f, grad = fg(x)
                if np.isfinite(f):
                    break
        r = -grad
        d = r.copy()
        success = True
        best_x, best_f = x.copy(), f
        trace = [f]
        converged = False
        stop_reason = "maxiter"
        it = 0

        for it in range(1, self.maxiter + 1):
            if success:
                mu = float(np.dot(d, d))
                if mu < 1e-30:
                    converged = True
                    stop_reason = "direction_collapse"
                    break
                sigma = self.sigma0 / np.sqrt(mu)
                _, g_plus = fg(x + sigma * d)
                theta = float(np.dot(d, g_plus - grad)) / sigma  # curvature
            delta = theta + lam * mu
            if delta <= 0:  # make Hessian model positive definite
                lam = 2.0 * (lam - delta / mu)
                delta = theta + lam * mu
                lam_bar = lam
            phi = float(np.dot(d, r))
            alpha = phi / delta
            x_new = np.clip(x + alpha * d, lb, ub)
            f_new, grad_new = fg(x_new)

            if not np.isfinite(f_new) or phi == 0:
                # NaN objective (failed Cholesky): force the
                # trust-region shrink path so lambda grows and the
                # next trial point moves (no silent spin)
                Delta = -1.0
            else:
                Delta = 2.0 * delta * (f - f_new) / (phi * phi)
            if np.isfinite(f_new) and Delta >= 0:
                success = True
                lam_bar = 0.0
                f_prev = f
                x, f, grad = x_new, f_new, grad_new
                r_new = -grad
                if f < best_f:
                    best_f, best_x = f, x.copy()
                trace.append(f)
                if callback is not None:
                    callback(it, x, f)
                if self.verbose > 0:
                    print(f"[scg] iter {it:4d}  -logL {f:.8f}")
                if abs(f_prev - f) < self.tol:
                    converged = True
                    stop_reason = "objective_rel_change_tol"
                    break
                if it % p == 0:  # restart (Opt_pars.cpp restart policy)
                    d = r_new
                else:
                    beta = (float(np.dot(r_new, r_new)) -
                            float(np.dot(r_new, r))) / phi
                    d = r_new + beta * d
                r = r_new
                if Delta >= 0.75:
                    lam = max(lam / 4.0, 1e-15)
            else:
                success = False
                lam_bar = lam
            if Delta < 0.25:
                lam += (delta * (1.0 - Delta) / mu) if mu > 0 else lam
                lam = min(lam, 1e15)

        return OptResult(best_x, best_f, it, n_evals[0], converged, trace,
                         stop_reason)
