"""Dense inverse-Hessian BFGS (host driver).

The reference implements a genuinely different algorithm for `-o BFGS`
(`Opt_Algs::BFGSOptimize`, Opt_pars.cpp:451-538) than its L-BFGS-B: a
full dense inverse-Hessian update (Nocedal-Wright eq. 6.17)

    H <- (I - rho s y^T) H (I - rho y s^T) + rho s s^T,  rho = 1/(y^T s)

with these observable behaviors, kept here:

- hard box bounds [1e-4, 6] on every hyperparameter (Opt_pars.cpp:455-459);
- bound handling by *step shrinking*: the trial step length is divided
  by 1.2 until the iterate is inside the box (Opt_pars.cpp:496-507) —
  the reference does NOT project onto the box;
- best-so-far acceptance: only improving steps move the incumbent
  (Opt_pars.cpp:510-516), NaN objectives reject the step;
- H0 = I rescaled after the first step to (s^T y)/(y^T y) * I
  (Opt_pars.cpp:521-526).

The line search is selectable: "interp" (the same safeguarded
interpolating Armijo search the L-BFGS-B driver uses) or "wolfe"
(strong-Wolfe bracket+zoom, Nocedal-Wright Algorithms 3.5/3.6 — the
textbook pairing for dense BFGS, whose curvature condition keeps
y^T s > 0 so the update stays positive definite).

Reference quirks deliberately NOT replicated (SURVEY.md §7):
`ChkBnd` writing lower-bound values into upper violations
(Opt_pars.h:92-98), and the curvature-skip `continue` that can spin
the iteration counter without moving (Opt_pars.cpp:279-287).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from gp_ss_ak_torch.optim.lbfgsb import (
    DEFAULT_LOWER,
    DEFAULT_UPPER,
    LBFGSB,
    OptResult,
)


@dataclass
class DenseBFGS:
    maxiter: int = 100
    tol: float = 1e-9            # relative objective-change tolerance
    gtol: float = 1e-6           # projected-gradient tolerance
    line_search: str = "wolfe"   # "wolfe" | "interp" | "potra"
    wolfe_c1: float = 1e-4
    wolfe_c2: float = 0.9
    max_ls: int = 25
    shrink: float = 1.2          # bound step-shrink factor (Opt_pars.cpp:498)
    verbose: int = 0

    def minimize(
        self,
        value_and_grad: Callable[[np.ndarray], Tuple[float, np.ndarray]],
        x0: np.ndarray,
        lower: Optional[np.ndarray] = None,
        upper: Optional[np.ndarray] = None,
        callback: Optional[Callable] = None,
    ) -> OptResult:
        x0 = np.asarray(x0, np.float64)
        p = x0.shape[0]
        lb = np.full(p, DEFAULT_LOWER) if lower is None else np.asarray(lower)
        ub = np.full(p, DEFAULT_UPPER) if upper is None else np.asarray(upper)
        x = np.clip(x0, lb, ub)

        n_evals = [0]

        def fg(z):
            n_evals[0] += 1
            f, g = value_and_grad(z)
            return float(f), np.asarray(g, np.float64)

        f, g = fg(x)
        best_x, best_f = x.copy(), f
        H = np.eye(p)
        trace = [f]
        converged = False
        stop_reason = "maxiter"
        it = 0
        first_pair = True

        for it in range(1, self.maxiter + 1):
            pg = x - np.clip(x - g, lb, ub)
            if np.max(np.abs(pg)) < self.gtol:
                converged = True
                stop_reason = "projected_gradient_tol"
                break

            # active-set handling: variables sitting on (or numerically
            # at) a bound are snapped onto it and their outward search
            # components dropped, so the step-shrink below doesn't
            # zigzag against the constraint
            tol = 1e-8 * (ub - lb)
            x = np.where(x - lb <= tol, lb, np.where(ub - x <= tol, ub, x))
            d = -H @ g
            if not np.all(np.isfinite(d)) or float(d @ g) >= 0.0:
                # H lost positive-definiteness — reset (NW §6.1 safeguard)
                H = np.eye(p)
                d = -g
            d = np.where(((x <= lb) & (d < 0)) | ((x >= ub) & (d > 0)),
                         0.0, d)
            if not np.any(d):
                converged = True
                stop_reason = "all_directions_blocked"
                break

            # reference bound handling: shrink the whole step by 1.2
            # until the trial point is inside the box (Opt_pars.cpp:496)
            t_max = 1.0
            while t_max >= 1e-12:
                if np.all(x + t_max * d >= lb) and np.all(x + t_max * d <= ub):
                    break
                t_max /= self.shrink
            if t_max < 1e-12:
                # fully blocked even after the active-set drop (the
                # reference instead stalls with steplength=0,
                # Opt_pars.cpp:501)
                converged = True
                stop_reason = "step_fully_blocked"
                break
            limited = t_max < 1.0 - 1e-12

            if self.line_search == "wolfe":
                ok, t, f_new, g_new = _strong_wolfe(
                    fg, x, f, g, d, t_max, self.wolfe_c1, self.wolfe_c2,
                    self.max_ls)
                x_new = x + t * d
            elif self.line_search == "potra":
                # the reference's own search family
                # (Opt_pars.cpp:543-974)
                from gp_ss_ak_torch.optim.linesearch import potra_shi_search

                ok, x_new, f_new, g_new = potra_shi_search(
                    fg, x, f, g, d, lb, ub, t_init=t_max)
            else:
                ls = LBFGSB(armijo_c1=self.wolfe_c1,
                            max_backtracks=self.max_ls)
                ok, x_new, f_new, g_new = ls._line_search(
                    fg, x, f, g, d, lb, ub, t_max)
            if not ok or not np.isfinite(f_new):
                if not np.allclose(H, np.eye(p)):
                    H = np.eye(p)  # retry from steepest descent next iter
                    continue
                converged = True
                stop_reason = "line_search_no_progress"
                break

            s = x_new - x
            y = g_new - g
            sy = float(s @ y)
            if first_pair and sy > 0:
                # H0 rescale after the first accepted step
                # (Opt_pars.cpp:521-526; NW eq. 6.20)
                H = np.eye(p) * (sy / max(float(y @ y), 1e-300))
                first_pair = False
            if np.isfinite(sy) and sy > 1e-12 * np.linalg.norm(s) * \
                    np.linalg.norm(y):
                rho = 1.0 / sy
                V = np.eye(p) - rho * np.outer(s, y)
                H = V @ H @ V.T + rho * np.outer(s, s)

            # best-so-far acceptance (Opt_pars.cpp:510-516): the
            # incumbent only moves on improvement, but the curvature
            # pair above always updates H
            if f_new < f:
                x, f, g = x_new, f_new, g_new
            else:
                g = g_new  # stand still; fresh gradient information
            trace.append(f)
            if f < best_f:
                best_f, best_x = f, x.copy()
            if callback is not None:
                callback(it, x, f)
            if self.verbose > 0:
                print(f"[bfgs] iter {it:4d}  -logL {f:.8f}")
            # objective-change convergence only counts on steps the box
            # didn't clip — bound-limited steps make tiny |df| while the
            # free variables still have far to go
            if (not limited and len(trace) > 1
                    and abs(trace[-2] - trace[-1]) <= self.tol * (
                        1.0 + abs(trace[-1]))):
                converged = True
                stop_reason = "objective_rel_change_tol"
                break

        return OptResult(best_x, best_f, it, n_evals[0], converged, trace,
                         stop_reason)


def _strong_wolfe(fg, x, f0, g0, d, t_max, c1, c2, max_ls):
    """Strong-Wolfe line search: bracket (NW Alg. 3.5) + zoom (Alg. 3.6).

    phi(t) = f(x + t d). NaN objectives are treated as phi = +inf
    (bracket high) so failed Cholesky regions are zoomed away from —
    the same recovery the reference reaches by its fa != fa bail
    (Opt_pars.cpp:748-752)."""
    dphi0 = float(g0 @ d)

    def phi(t):
        fv, gv = fg(x + t * d)
        if not np.isfinite(fv):
            return np.inf, 0.0, gv
        return fv, float(gv @ d), gv

    t_prev, f_prev, dphi_prev = 0.0, f0, dphi0
    t = min(1.0, t_max)
    f_t = f0
    for i in range(max_ls):
        f_t, dphi_t, g_t = phi(t)
        if f_t > f0 + c1 * t * dphi0 or (i > 0 and f_t >= f_prev):
            return _zoom(phi, f0, dphi0, t_prev, f_prev, dphi_prev,
                         t, f_t, c1, c2, max_ls)
        if abs(dphi_t) <= -c2 * dphi0:
            return True, t, f_t, g_t
        if dphi_t >= 0:
            return _zoom(phi, f0, dphi0, t, f_t, dphi_t,
                         t_prev, f_prev, c1, c2, max_ls)
        t_prev, f_prev, dphi_prev = t, f_t, dphi_t
        if t >= t_max:
            return True, t, f_t, g_t  # bound-limited step
        t = min(2.0 * t, t_max)
    return (f_t < f0), t, f_t, g_t


def _zoom(phi, f0, dphi0, lo, f_lo, dphi_lo, hi, f_hi, c1, c2, max_ls):
    g_best = None
    for _ in range(max_ls):
        # safeguarded bisection (quadratic interp collapses on the NaN
        # plateau where f_hi = inf)
        if np.isfinite(f_hi) and dphi_lo != 0.0:
            t = lo - 0.5 * dphi_lo * (hi - lo) ** 2 / (
                f_hi - f_lo - dphi_lo * (hi - lo))
            if not np.isfinite(t) or t <= min(lo, hi) or t >= max(lo, hi):
                t = 0.5 * (lo + hi)
        else:
            t = 0.5 * (lo + hi)
        f_t, dphi_t, g_t = phi(t)
        if f_t > f0 + c1 * t * dphi0 or f_t >= f_lo:
            hi, f_hi = t, f_t
        else:
            if abs(dphi_t) <= -c2 * dphi0:
                return True, t, f_t, g_t
            if dphi_t * (hi - lo) >= 0:
                hi, f_hi = lo, f_lo
            lo, f_lo, dphi_lo, g_best = t, f_t, dphi_t, g_t
        if abs(hi - lo) < 1e-14:
            break
    if g_best is not None and f_lo < f0:
        return True, lo, f_lo, g_best
    return False, 0.0, f0, g_best if g_best is not None else 0.0 * np.asarray(dphi0)
