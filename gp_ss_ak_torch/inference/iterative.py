"""Matrix-free iterative solves: the pieces the matrix-free server needs.

Port of gp_ss_ak_tpu/inference/iterative.py, generic in dtype:

  pivoted_cholesky      rank-k factor L (L L^T ~ K) without building K;
  precond_sqrt_*        P^(-1/2) for P = L L^T + sn2 I, by the k x k
                        eigendecomposition of L^T L;
  bcg_*                 batched CG: B right-hand sides in lock-step, one
                        blocked matmat per iteration, with the stall
                        cut-off and the resumable state tuple;
  whitened_solve_info   plain batched CG on P^(-1/2) A P^(-1/2), the
                        float32-stable route at the flagship conditioning;
  auto_precond_rank     the N-scaled default rank.

JAX's `lax.while_loop` and `lax.fori_loop` become Python loops. The
batched-CG condition is one host read per iteration, negligible next to
the O(N^2) operator pass each iteration makes. The pivot index stays on
the device. Probes, Lanczos/SLQ, Woodbury, `cg_solve`, `pcg_solve`,
`choose_mode` and the NLML/gradient engine arrive with the training
slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from gp_ss_ak_torch.kernels.distance import highest_precision


def _t(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# pivoted-Cholesky preconditioner (GPyTorch/BBMM recipe)
# ---------------------------------------------------------------------------

def pivoted_cholesky(Xm: torch.Tensor, sigma, bias, rank: int) -> torch.Tensor:
    """Rank-`rank` pivoted Cholesky of K = sigma^2 exp(-||xi-xj||) + bias
    without building K: greedy max-diagonal pivoting, one kernel column
    (O(n d)) per step. Returns L (n, rank) with L L^T ~ K.

    The product L Li runs in full float32 (no TF32): its error lands in
    the cancellation c - L Li and is amplified by 1/sqrt(d_i), which
    floors the preconditioned CG at large rank (iterative.py:112-118)."""
    n = Xm.shape[0]
    s = _t(sigma, Xm)
    s2 = s * s
    diag = (s2 + _t(bias, Xm)).reshape(1)
    L = torch.zeros((n, rank), dtype=Xm.dtype, device=Xm.device)
    d = diag.expand(n).clone()
    with highest_precision():
        for j in range(rank):
            i = torch.argmax(d).reshape(1)          # first max, as JAX
            xi = Xm.index_select(0, i)
            d2 = torch.sum((Xm - xi) ** 2, dim=1)
            c = s2 * torch.exp(-torch.sqrt(torch.clamp_min(d2, 0.0))) + bias
            c.index_copy_(0, i, diag)               # exact diagonal
            di = d.index_select(0, i)
            Li = L.index_select(0, i)[0]
            # columns j.. of L are still zero: skip them in the product
            l = (c - L[:, :j] @ Li[:j]) \
                / torch.sqrt(torch.clamp_min(di, 1e-30))
            l = torch.where(di > 1e-30, l, torch.zeros_like(l))
            L[:, j] = l
            d = torch.clamp_min(d - l * l, 0.0)
            d.index_fill_(0, i, 0.0)
    return L


def precond_sqrt_pieces(L: torch.Tensor, sn2):
    """The pieces of P^(-1/2) and logdet P for P = L L^T + sn2 I.
    Returns (Q (n, k), inv_sqrt_eig (k,), logdet_P ()).

    `torch.linalg.eigh` may give other signs, or another basis of a
    degenerate eigenspace, than JAX: Q differs, P^(-1/2) v does not."""
    n = L.shape[0]
    sn2 = _t(sn2, L)
    with highest_precision():
        S, U = torch.linalg.eigh(L.T @ L)
        S = torch.clamp_min(S, 0.0)
        mask = S > 1e-10
        Q = L @ (U / torch.sqrt(torch.clamp_min(S, 1e-30))[None, :])
    Q = Q * mask[None, :].to(L.dtype)
    inv_sqrt_eig = torch.where(mask, 1.0 / torch.sqrt(S + sn2),
                               torch.zeros_like(S))
    logdet_P = (n - torch.sum(mask)) * torch.log(sn2) + torch.sum(
        torch.where(mask, torch.log(S + sn2), torch.zeros_like(S)))
    return Q, inv_sqrt_eig, logdet_P


def precond_sqrt_apply(Q: torch.Tensor, inv_sqrt_eig: torch.Tensor, sn2,
                       v: torch.Tensor) -> torch.Tensor:
    """P^(-1/2) v from the pieces of `precond_sqrt_pieces`; v is (n,)
    or (n, B)."""
    rsn = 1.0 / torch.sqrt(_t(sn2, Q))
    vm = v if v.dim() == 2 else v[:, None]
    with highest_precision():
        Qtv = Q.T @ vm
        out = (vm - Q @ Qtv) * rsn + Q @ (inv_sqrt_eig[:, None] * Qtv)
    return out if v.dim() == 2 else out[:, 0]


# ---------------------------------------------------------------------------
# batched (P)CG
# ---------------------------------------------------------------------------

#: bcg stops after this many consecutive iterations in which no column
#: improved its best residual meaningfully: a column whose achievable
#: residual floor sits above `tol` would otherwise spin the lock-step
#: solve to `maxiter` while Xbest no longer changes.
BCG_STALL_ITERS = 25


def bcg_init(B_rhs: torch.Tensor, pinv=None, tol: float = 1e-5,
             X0=None, R0=None):
    """Initial (state, thresh) for the batched-PCG loop (`bcg_segment`).
    The state is a flat tuple of tensors:
    (X, R, Z, P, rz, it, Xbest, rn_best, stall).

    Warm start: pass both X0 and its true residual R0 = B - A X0. The
    threshold stays relative to ||B||, and the best-iterate tracking
    seeds from (X0, ||R0||^2)."""
    if (X0 is None) != (R0 is None):
        raise ValueError("warm start needs both X0 and R0")
    X = torch.zeros_like(B_rhs) if X0 is None else X0
    R = B_rhs if R0 is None else R0
    Z = pinv(R) if pinv is not None else R
    rz = torch.sum(R * Z, dim=0)
    rn0 = torch.sum(B_rhs * B_rhs, dim=0)
    rn_start = rn0 if R0 is None else torch.sum(R0 * R0, dim=0)
    thresh = (tol ** 2) * rn0
    zero = torch.zeros((), dtype=torch.int64, device=B_rhs.device)
    state = (X, R, Z, Z, rz, zero, X, rn_start, zero)
    return state, thresh


def _stall_iters(pinv) -> int:
    """Stall window: plain CG residuals plateau and drop in phases that
    can exceed the preconditioned window, so it gets 4x the patience."""
    return BCG_STALL_ITERS if pinv is not None else 4 * BCG_STALL_ITERS


def _active(R, thresh):
    # a column stays active while its residual is finite and above
    # tolerance; a non-finite residual freezes it (a = 0 below), and the
    # best iterate is what gets returned
    rn = torch.sum(R * R, dim=0)
    return (rn > thresh) & torch.isfinite(rn)


def bcg_segment(matmat: Callable, pinv, state, thresh, it_cap: int):
    """Advance the batched-PCG state until convergence, stall, or the
    absolute iteration count reaches `it_cap`. Returns the new state;
    pass it back with a larger cap to resume, bit-identical to one
    uninterrupted loop, since the state tuple is the loop carry."""
    stall_cap = _stall_iters(pinv)

    def cond(state):
        _X, R, _Z, _P, _rz, it, _Xb, _rb, stall = state
        go = torch.any(_active(R, thresh)) & (it < it_cap) \
            & (stall < stall_cap)
        return bool(go)         # the one host read per iteration

    while cond(state):
        X, R, Z, P, rz, it, Xbest, rn_best, stall = state
        active = _active(R, thresh)
        AP = matmat(P)
        pAp = torch.sum(P * AP, dim=0)
        ok = active & (pAp > 0) & torch.isfinite(pAp) & torch.isfinite(rz)
        a = torch.where(ok, rz / torch.where(pAp > 0, pAp,
                                             torch.ones_like(pAp)),
                        torch.zeros_like(pAp))
        X = X + a[None, :] * P
        R = R - a[None, :] * AP
        rn = torch.sum(R * R, dim=0)
        better = torch.isfinite(rn) & (rn < rn_best) \
            & torch.all(torch.isfinite(X), dim=0)
        Xbest = torch.where(better[None, :], X, Xbest)
        # only a meaningful improvement (0.1% in the squared residual)
        # resets the stall counter: near the rounding floor the best
        # residual keeps creeping down by noise-level amounts
        meaningful = better & (rn < 0.999 * rn_best)
        rn_best = torch.where(better, rn, rn_best)
        stall = torch.where(torch.any(meaningful & active),
                            torch.zeros_like(stall), stall + 1)
        Z = pinv(R) if pinv is not None else R
        rz_new = torch.sum(R * Z, dim=0)
        beta = torch.where(ok, rz_new / torch.where(rz > 0, rz,
                                                    torch.ones_like(rz)),
                           torch.zeros_like(rz))
        P = Z + beta[None, :] * P
        state = (X, R, Z, P, rz_new, it + 1, Xbest, rn_best, stall)
    return state


def bcg_done(state, thresh, *, pinv) -> torch.Tensor:
    """True when the state has converged or stalled (resuming with a
    larger cap would do nothing). `pinv` is keyword-required so a caller
    pairs the right stall window with its segment loop."""
    _X, R, _Z, _P, _rz, _it, _Xb, _rb, stall = state
    still = torch.any(_active(R, thresh))
    return (~still) | (stall >= _stall_iters(pinv))


def bcg_rel_residual(state, thresh, tol: float) -> torch.Tensor:
    """Worst-column achieved relative residual ||r|| / ||b|| (thresh is
    tol^2 ||b||^2 per column)."""
    rn_best = state[7]
    rn0 = thresh / (tol * tol)
    rel2 = torch.where(rn0 > 0, rn_best / torch.where(
        rn0 > 0, rn0, torch.ones_like(rn0)), torch.zeros_like(rn0))
    return torch.sqrt(torch.max(rel2))


def bcg_solve_info(matmat: Callable, B_rhs: torch.Tensor, pinv=None,
                   tol: float = 1e-5, maxiter: int = 500):
    """`bcg_solve` plus the achieved worst-column relative residual.
    Returns (X (n, B), n_iters, rel_residual)."""
    state, thresh = bcg_init(B_rhs, pinv, tol)
    state = bcg_segment(matmat, pinv, state, thresh, maxiter)
    return state[6], state[5], bcg_rel_residual(state, thresh, tol)


def whitened_solve_info(op_matmat: Callable, L: torch.Tensor, sn2,
                        B_rhs: torch.Tensor, tol: float = 1e-4,
                        maxiter: int = 500):
    """Solve A X = B by plain batched CG on the whitened operator
    P^(-1/2) A P^(-1/2), P = L L^T + sn2 I. Mathematically PCG with P;
    numerically it avoids the r'z cross products that break down in
    float32 at the flagship conditioning, since CG here runs on
    kappa ~ (lambda_k + sn2) / sn2.

    Returns (X, iters, rel_whitened, logdet_P, wmm), wmm the whitened
    matmat closure."""
    Q, ise, logdet_P = precond_sqrt_pieces(L, sn2)

    def wmm(V):
        return precond_sqrt_apply(
            Q, ise, sn2, op_matmat(precond_sqrt_apply(Q, ise, sn2, V)))

    Bt = precond_sqrt_apply(Q, ise, sn2, B_rhs)
    Xw, it, rel = bcg_solve_info(wmm, Bt, None, tol=tol, maxiter=maxiter)
    return precond_sqrt_apply(Q, ise, sn2, Xw), it, rel, logdet_P, wmm


def bcg_solve(matmat: Callable, B_rhs: torch.Tensor, pinv=None,
              tol: float = 1e-5, maxiter: int = 500):
    """Batched (P)CG: B right-hand sides in lock-step through one
    blocked matmat per iteration. Converged columns freeze; the solve
    also stops once no column has improved for the stall window.
    Returns (X (n, B), n_iters)."""
    state, thresh = bcg_init(B_rhs, pinv, tol)
    state = bcg_segment(matmat, pinv, state, thresh, maxiter)
    return state[6], state[5]


def auto_precond_rank(n: int) -> int:
    """N-scaled default preconditioner rank (iterative.py:727-744): the
    ExpAns eigenvalues decay only polynomially, so the rank grows with N
    up to a cap. The 1024 cap and N/48 slope were tuned on a TPU and are
    still to be re-derived on the H100."""
    return max(64, min(1024, n // 48))
