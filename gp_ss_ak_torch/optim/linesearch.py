"""Potra-Shi efficient line search (host driver).

The reference's ACTIVE line search — `Efficient_line_search`,
Opt_pars.cpp:543-974, used by both its L-BFGS-B and dense BFGS — is a
Potra & Shi (1995, "Efficient line search algorithm for unconstrained
optimization") bracketing scheme. Structure kept here:

  step 1: unit-step trial; accept inside the [rho, sig] Armijo band;
  step 2: geometric expansion a_n -> b_n = J b_n until the objective
          turns up (bracket found) or the band accepts;
  step 3: within [a, b], evaluate at a + tau1 (b-a) and a + tau2 (b-a),
          build the TWO-POINT linear-blend interpolant and take the
          best of its three quartile candidates; accept in-band,
          curvature early-exit via tau3 * |divided difference|,
          else shrink the bracket toward the candidate;
  throughout: every evaluation updates a global best step (the
          reference's final_steplength tracking), bound violations
          shrink the trial by 1.2, NaN objectives bail to the best
          seen (Opt_pars.cpp:748-752).

Reference quirks deliberately NOT replicated (documented per
SURVEY.md §7):
  * phi'(0) there is `accu(g.t() * d)` on two ROW vectors — an outer
    product whose accu is sum(g)*sum(d), not the directional
    derivative (Opt_pars.cpp:573). Here phi'(0) = g . d.
  * `ChkBnd` writes lower-bound values into upper violations
    (Opt_pars.h:92-98); here trials are shrunk, never teleported.

Default constants are the reference's user parameters
(Opt_pars.cpp:551-560).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def potra_shi_search(
    fg: Callable[[np.ndarray], Tuple[float, np.ndarray]],
    x: np.ndarray,
    f0: float,
    g0: np.ndarray,
    d: np.ndarray,
    lb: np.ndarray,
    ub: np.ndarray,
    t_init: float = 1.0,
    rho: float = 1e-14,
    sig: float = 0.99,
    J: float = 2.0,
    tau1: float = 1e-14,
    tau2: float = 0.49,
    tau3: float = 2.1,
    maxls: int = 4,
    shrink: float = 1.2,
):
    """Returns (ok, x_new, f_new, g_new).

    ok is True when any improving step was found; the returned point
    is the global best evaluated during the search (the reference's
    best-so-far contract)."""
    dphi0 = float(g0 @ d)
    best = {"t": 0.0, "x": x, "f": f0, "g": g0}

    def feasible_t(t):
        while t >= 1e-15:
            c = x + t * d
            if np.all(c >= lb) and np.all(c <= ub):
                return t
            t /= shrink
        return 0.0

    def phi(t):
        t = feasible_t(t)
        if t == 0.0:
            return 0.0, f0, g0
        c = x + t * d
        fc, gc = fg(c)
        if np.isfinite(fc) and fc < best["f"]:
            best.update(t=t, x=c, f=fc, g=gc)
        return t, fc, gc

    def done():
        ok = best["f"] < f0
        return ok, best["x"], best["f"], best["g"]

    def in_band(t, ft, fa=f0, ta=0.0):
        lo = ft <= fa + (t - ta) * rho * dphi0
        hi = ft >= fa + (t - ta) * sig * dphi0
        return lo and hi

    # ---- step 1: unit trial ------------------------------------------
    t1, f1, _g1 = phi(t_init)
    if not np.isfinite(f1):
        # NaN region at the nominal step: retreat geometrically
        t = t1 / 4.0
        for _ in range(20):
            t, ft, _ = phi(t)
            if np.isfinite(ft):
                break
            t /= 4.0
        return done()
    if in_band(t1, f1):
        return done()

    if f1 > f0 + rho * t1 * dphi0:
        # overshot immediately: bracket is [0, t1]
        a, fa_v = 0.0, f0
        b, fb_v = t1, f1
    else:
        # ---- step 2: expansion ---------------------------------------
        an, fa_v = t1, f1
        bn = min(J * t1, feasible_t(J * t1) or t1)
        bn, fb_v, _ = phi(bn)
        a = b = None
        for _ in range(20):
            if not (np.isfinite(fa_v) and np.isfinite(fb_v)):
                return done()
            if fb_v > fa_v + (bn - an) * rho * dphi0:
                a, b = an, bn
                break
            if fb_v >= fa_v + (bn - an) * sig * dphi0:
                return done()
            an, fa_v = bn, fb_v
            nxt = feasible_t(J * bn)
            if nxt <= bn * (1 + 1e-12):
                return done()  # pinned at the box
            bn, fb_v, _ = phi(nxt)
        if a is None:
            return done()

    # ---- step 3: interpolation on the bracket ------------------------
    an, bn = a, b
    fa_v = f0 if an == 0.0 else fa_v
    t1l, t2l = tau1, tau2
    for it in range(maxls):
        lowv = an + t1l * (bn - an)
        highv = an + t2l * (bn - an)
        lowv, flow, glow = phi(lowv)
        highv, fhigh, ghigh = phi(highv)
        if not (np.isfinite(flow) and np.isfinite(fhigh)) \
                or highv <= lowv:
            break
        dlow = float(glow @ d)
        dhigh = float(ghigh @ d)

        def interp(xq):
            # two-point linear blend of the tangent models
            # (Opt_pars.cpp:863-872)
            w = (highv - xq) / (highv - lowv)
            return (flow + (xq - lowv) * dlow) * w + \
                (fhigh + (xq - highv) * dhigh) * (1.0 - w)

        cand = [an + q * (bn - an) for q in (0.25, 0.5, 0.75)]
        cn = min(cand, key=interp)
        cn, fcn, _gcn = phi(cn)
        if not np.isfinite(fcn):
            break
        # divided-difference curvature estimate (Opt_pars.cpp:905-917)
        denom1 = bn - cn
        denom2 = cn - an
        if denom1 != 0.0 and denom2 != 0.0 and bn != an:
            deltan = abs(((fb_v - fcn) / denom1
                          - (fcn - fa_v) / denom2) / (bn - an))
        else:
            deltan = np.inf
        if in_band(cn, fcn, fa_v, an):
            return done()
        if (rho - sig) * dphi0 >= tau3 * (bn - an) * deltan:
            return done()
        if fcn <= fa_v + (cn - an) * rho * dphi0:
            an, fa_v = cn, fcn
        else:
            bn, fb_v = cn, fcn
    return done()
