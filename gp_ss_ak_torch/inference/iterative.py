"""Matrix-free iterative inference: CG solves + stochastic Lanczos logdet.

Port of gp_ss_ak_tpu/inference/iterative.py: the exact-GP NLML and its
gradient at N where the kernel matrix cannot exist in memory
(GPyTorch's BBMM recipe), and the solvers of the matrix-free server.

  alpha     CG on A v = y over the streamed operator (ops/matvec.py:
            K2 for one vector, K3 for a block of columns);
  logdet A  m-probe stochastic Lanczos quadrature over Rademacher
            probes, optionally on the pivoted-Cholesky-whitened operator;
  gradient  Hutchinson trace + fit-term contractions against dA/dtheta
            through a chunked dense row build (`_grad_contraction`).

Operator modes (`choose_mode`): "chol" materializes A with K1 and
factors it exactly; "gemm" holds A in float32 and runs CG/SLQ as GEMMs;
"gemm_bf16" (opt-in only) holds K in bfloat16, its solves floored at
BF16_CG_TOL_FLOOR; "stream" never builds A. Everything else runs in
float32, as in the JAX package. The stages of an
evaluation (pivoted Cholesky, whitened solve, SLQ, contraction,
materialized factor) carry profiler ranges named
"iterative.<function>", so a torch.profiler trace of the real call
splits its device time by stage.

What differs from JAX, and why:
  * `lax.while_loop`, `fori_loop` and `scan` become Python loops. A CG
    loop reads the host once per iteration (its stopping test), next to
    the O(N^2) operator pass it makes; a Lanczos loop runs its fixed k
    steps with no host read. Probes, tridiagonals and the batched k x k
    `eigh` of the quadrature stay on the device.
  * Random probes: `jax.random` keys become `torch.Generator`s (on the
    data's device, seeded by the caller), which draw other bits from
    the same seed. Every function that draws probes also accepts the
    probe matrix itself (`Z=`), so a test hands both packages one matrix.
  * `_grad_contraction` takes `jax.grad` through `lax.map(remat(...))`
    over row chunks. One torch graph over all chunks would keep O(N^2)
    saved tensors, so here each chunk runs forward and backward on its
    own and the leaf gradients (sigma, bias, sn2, Xm) are summed: live
    memory stays O(chunk x N), as remat gives.
  * The mode thresholds scale with the card's memory (`_mode_thresholds`)
    like JAX's with the TPU's; the CPU keeps the 16 GB defaults.
  * The JAX functions' tile sizes (tm, tn) and `interpret` switch have
    no counterpart: the CUDA kernels pick their own tiles and CPU
    tensors take the plain versions.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.autograd.profiler import record_function

from gp_ss_ak_torch.kernels.distance import gram_sqdist, highest_precision


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


@record_function("iterative.whitened_solve_info")
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


# ---------------------------------------------------------------------------
# conjugate gradients, Woodbury, P^(-1/2)
# ---------------------------------------------------------------------------

def cg_solve(matvec: Callable, b: torch.Tensor, tol: float = 1e-5,
             maxiter: int = 500, x0=None):
    """Plain CG on SPD A. Returns (x, n_iters, final residual norm)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = r
    rs = torch.dot(r, r)
    thresh = (tol * torch.sqrt(torch.dot(b, b))) ** 2
    it = 0
    while it < maxiter and bool(rs > thresh):    # one host read
        Ap = matvec(p)
        alpha = rs / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return x, it, torch.sqrt(rs)


def woodbury_pieces(L: torch.Tensor, sn2) -> torch.Tensor:
    """The k x k Cholesky factor of M = sn2 I_k + L^T L, the only
    precomputable piece of the Woodbury apply."""
    k = L.shape[1]
    with highest_precision():
        M = _t(sn2, L) * torch.eye(k, dtype=L.dtype, device=L.device) \
            + L.T @ L
    return torch.linalg.cholesky(M)


def woodbury_apply(L: torch.Tensor, Mchol: torch.Tensor, sn2,
                   v: torch.Tensor) -> torch.Tensor:
    """P^-1 v = (v - L M^-1 L^T v) / sn2 for P = L L^T + sn2 I; v is
    (n,) or (n, B)."""
    vm = v if v.dim() == 2 else v[:, None]
    with highest_precision():
        w = torch.cholesky_solve(L.T @ vm, Mchol)
        out = (vm - L @ w) / _t(sn2, L)
    return out if v.dim() == 2 else out[:, 0]


def woodbury_preconditioner(L: torch.Tensor, sn2) -> Callable:
    """P^-1 for P = L L^T + sn2 I via the Woodbury identity."""
    Mchol = woodbury_pieces(L, sn2)

    def pinv(v):
        return woodbury_apply(L, Mchol, sn2, v)

    return pinv


def precond_sqrt(L: torch.Tensor, sn2):
    """Exact P^(-1/2) apply and logdet P for P = L L^T + sn2 I, from the
    k x k eigendecomposition of L^T L (`precond_sqrt_pieces`). Returns
    (apply_inv_sqrt, logdet_P)."""
    Q, inv_sqrt_eig, logdet_P = precond_sqrt_pieces(L, sn2)

    def apply_inv_sqrt(v):
        return precond_sqrt_apply(Q, inv_sqrt_eig, sn2, v)

    return apply_inv_sqrt, logdet_P


def pcg_solve(matvec: Callable, b: torch.Tensor, pinv: Callable,
              tol: float = 1e-5, maxiter: int = 500, x0=None):
    """Preconditioned CG, returning the best iterate seen. Returns
    (x, n_iters, best residual norm)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = pinv(r)
    p = z
    rz = torch.dot(r, z)
    bnorm2 = torch.dot(b, b)
    thresh = (tol ** 2) * bnorm2
    xbest, rn_best = x, bnorm2
    rn = torch.dot(r, r)
    it = 0
    while it < maxiter and bool((rn > thresh) & torch.isfinite(rn)):
        Ap = matvec(p)
        a = rz / torch.dot(p, Ap)
        x = x + a * p
        r = r - a * Ap
        rn = torch.dot(r, r)
        better = torch.isfinite(rn) & (rn < rn_best) \
            & torch.all(torch.isfinite(x))
        xbest = torch.where(better, x, xbest)
        rn_best = torch.where(better, rn, rn_best)
        z = pinv(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return xbest, it, torch.sqrt(rn_best)


# ---------------------------------------------------------------------------
# stochastic Lanczos quadrature for logdet
# ---------------------------------------------------------------------------

def rademacher(key: torch.Generator, shape, device=None) -> torch.Tensor:
    """float32 Rademacher (+-1) probes drawn from `key` on its device."""
    device = key.device if device is None else device
    bits = torch.randint(0, 2, shape, generator=key, device=device)
    return (2 * bits - 1).to(torch.float32)


def _probes(key, n: int, probes: int, Z, device) -> torch.Tensor:
    """The (n, probes) probe block: Z as given, else drawn from key."""
    if Z is not None:
        Z = torch.as_tensor(Z, dtype=torch.float32, device=device)
        if tuple(Z.shape) != (n, probes):
            raise ValueError(f"probe matrix must be ({n}, {probes}), got "
                             f"{tuple(Z.shape)}")
        return Z
    if key is None:
        raise ValueError("pass a torch.Generator or the probe matrix Z")
    return rademacher(key, (n, probes), device)


def _lanczos_step(matmat, carry):
    V_prev, V_cur, beta_prev = carry
    W = matmat(V_cur) - beta_prev[None, :] * V_prev
    alpha = torch.sum(W * V_cur, dim=0)
    W = W - alpha[None, :] * V_cur
    beta = torch.linalg.vector_norm(W, dim=0)
    safe = torch.where(beta > 0, beta, torch.ones_like(beta))
    V_next = torch.where(beta[None, :] > 1e-10, W / safe[None, :],
                         torch.zeros_like(W))
    return (V_cur, V_next, beta), alpha, beta


def _lanczos(matvec: Callable, v0: torch.Tensor, k: int):
    """k-step Lanczos without reorthogonalization (standard for SLQ) on
    one vector. Returns (alphas (k,), betas (k-1,))."""
    v = v0 / torch.linalg.vector_norm(v0)
    carry = (torch.zeros_like(v)[:, None], v[:, None],
             torch.zeros((1,), dtype=v.dtype, device=v.device))

    def mv(V):
        return matvec(V[:, 0])[:, None]

    alphas, betas = [], []
    for _ in range(k):
        carry, a, b = _lanczos_step(mv, carry)
        alphas.append(a[0])
        betas.append(b[0])
    return torch.stack(alphas), torch.stack(betas)[:-1]


def _quadrature(alphas: torch.Tensor, betas: torch.Tensor,
                n: int) -> torch.Tensor:
    """n * sum_i V[0, i]^2 log w_i for each tridiagonal (alphas (k, B),
    off-diagonals betas (k-1, B)): one batched k x k eigh on the
    device. Returns (B,)."""
    T = torch.diag_embed(alphas.T) + torch.diag_embed(betas.T, 1) \
        + torch.diag_embed(betas.T, -1)
    w, V = torch.linalg.eigh(T)
    w = torch.clamp_min(w, 1e-12)
    return float(n) * torch.sum(V[:, 0, :] ** 2 * torch.log(w), dim=-1)


def slq_logdet(matvec: Callable, n: int, key, probes: int = 16,
               lanczos_iters: int = 32, Z=None,
               device=None) -> torch.Tensor:
    """E_z [z' log(A) z] with Rademacher probes, one probe at a time
    through the single-vector `matvec` (K2 on the streamed operator),
    by Gauss quadrature on each Lanczos tridiagonal. Z (n, probes)
    injects the probes."""
    Zm = _probes(key, n, probes, Z, device)
    a_cols, b_cols = [], []
    for p in range(probes):
        a, b = _lanczos(matvec, Zm[:, p], lanczos_iters)
        a_cols.append(a)
        b_cols.append(b)
    vals = _quadrature(torch.stack(a_cols, 1), torch.stack(b_cols, 1), n)
    return torch.mean(vals)


def lanczos_batched_init(V0: torch.Tensor):
    """Initial carry for a segmented batched Lanczos."""
    V = V0 / torch.linalg.vector_norm(V0, dim=0, keepdim=True)
    b = V0.shape[1]
    return (torch.zeros_like(V), V,
            torch.zeros((b,), dtype=V.dtype, device=V.device))


def lanczos_batched_segment(matmat: Callable, carry, k_steps: int):
    """Advance the batched Lanczos by `k_steps`; returns (carry, alphas
    (k_steps, B), betas (k_steps, B)). Concatenated segments reproduce
    `_lanczos_batched` exactly (same recurrence, same carry)."""
    alphas, betas = [], []
    for _ in range(k_steps):
        carry, a, b = _lanczos_step(matmat, carry)
        alphas.append(a)
        betas.append(b)
    return carry, torch.stack(alphas), torch.stack(betas)


def _lanczos_batched(matmat: Callable, V0: torch.Tensor, k: int):
    """k-step Lanczos on B probes at once, every step ONE blocked
    matmat. V0 (n, B); returns (alphas (k, B), betas (k-1, B))."""
    _, alphas, betas = lanczos_batched_segment(
        matmat, lanczos_batched_init(V0), k)
    return alphas, betas[:-1]


def slq_quadrature(alphas: torch.Tensor, betas: torch.Tensor,
                   n: int) -> torch.Tensor:
    """mean_z ||z||^2 e1' log(T_z) e1 from the (k, B) coefficient stacks;
    `betas` is (k, B) with its last row unused."""
    return torch.mean(_quadrature(alphas, betas[:-1], n))


@record_function("iterative.slq_logdet_batched")
def slq_logdet_batched(matmat: Callable, n: int, key, probes: int = 16,
                       lanczos_iters: int = 32, Z=None,
                       device=None) -> torch.Tensor:
    """Batched-probe SLQ: all probes ride the same blocked matmats."""
    Zm = _probes(key, n, probes, Z, device)
    alphas, betas = _lanczos_batched(matmat, Zm, lanczos_iters)
    return torch.mean(_quadrature(alphas, betas, n))


def slq_logdet_preconditioned(op_matmat: Callable, L: torch.Tensor, sn2,
                              n: int, key, probes: int = 16,
                              lanczos_iters: int = 16,
                              Z=None) -> torch.Tensor:
    """logdet A = logdet P + tr log(P^-1/2 A P^-1/2): the determinant
    lemma for the rank-k preconditioner and SLQ only on the whitened
    operator, whose spectrum clusters at 1."""
    inv_sqrt, logdet_P = precond_sqrt(L, sn2)

    def whitened(V):
        return inv_sqrt(op_matmat(inv_sqrt(V)))

    return logdet_P + slq_logdet_batched(whitened, n, key, probes,
                                         lanczos_iters, Z, L.device)


# ---------------------------------------------------------------------------
# chunked differentiable matvec
# ---------------------------------------------------------------------------

def chunked_matvec(params_to_A_row_chunk: Callable, v: torch.Tensor,
                   n_chunks: int) -> torch.Tensor:
    """y = A v with A produced a chunk of rows at a time
    (differentiable; the graph keeps every chunk, unlike JAX's remat)."""
    with highest_precision():
        ys = [params_to_A_row_chunk(c) @ v for c in range(n_chunks)]
    return torch.cat(ys).reshape(-1)


class IterStats(NamedTuple):
    """Solve diagnostics + alpha from one fused NLML+grad evaluation."""

    cg_iters: int
    rel_residual: torch.Tensor
    alpha: torch.Tensor


class IterativeGP(NamedTuple):
    """Factory bundle for the matrix-free flagship (ExpAns+Bias)."""

    Xm: torch.Tensor        # metric-mapped recentred points (n, d)
    sigma: torch.Tensor
    bias: torch.Tensor
    sn2: torch.Tensor


#: operator-mode size thresholds, for a 16 GB device
#: (iterative.py:631-641):
#:   chol : A + L both live in f32 during the factorization (8 N^2 B)
#:   gemm : A in f32 (4 N^2 B)  /  gemm_bf16 : K in bf16 (2 N^2 B)
#: A CUDA device scales them by sqrt(its memory / 16 GB); the CPU keeps
#: the defaults, so CPU runs resolve modes exactly as the JAX package.
#: `choose_mode`'s auto pick reads the first two: gemm_bf16 is opt-in.
CHOL_MATERIALIZE_MAX_N = 32768
GEMM_MATERIALIZE_MAX_N_F32 = 49152
GEMM_MATERIALIZE_MAX_N_BF16 = 73728
_REFERENCE_HBM_BYTES = 16e9

#: the achievable relative residual of CG over a bf16-stored operator:
#: a cg_tol below it only stalls CG to cg_maxiter (iterative.py:644-646)
BF16_CG_TOL_FLOOR = 1e-3


@functools.lru_cache(maxsize=None)
def _mode_thresholds(device: Optional[torch.device] = None):
    """(chol_max, gemm_max, bf16_max) for `device`: scaled by
    sqrt(total memory / 16 GB) on a CUDA device, the defaults elsewhere."""
    scale = 1.0
    if device is not None and torch.device(device).type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        scale = math.sqrt(total / _REFERENCE_HBM_BYTES)

    def rnd(x):
        return max(1024, int(x * scale) // 1024 * 1024)

    return (rnd(CHOL_MATERIALIZE_MAX_N), rnd(GEMM_MATERIALIZE_MAX_N_F32),
            rnd(GEMM_MATERIALIZE_MAX_N_BF16))


def choose_mode(n: int, mode: str = "auto", device=None) -> str:
    """Resolve the operator mode for problem size n on `device`:
    "chol" (materialize A, exact Cholesky), "gemm" (A in f32, CG/SLQ as
    GEMMs), "stream" (never materialize), or the opt-in "gemm_bf16"
    (K in bfloat16), which auto never picks: the ~0.4% entrywise
    quantization of K has spectral norm ~ 0.002 sqrt(N), which swamps
    the flagship's sn2 = 0.016 past N ~ 10^3 and biases the SLQ logdet
    by hundreds of nats (iterative.py:675-683); its value is not to be
    trusted. Where the quantization exceeds sn2 the stored A is
    indefinite and CG stalls: at the flagship's default noise this mode
    returns a ZERO gradient and raises nothing (an H100 at N = 65536,
    sn2 = 0.016: rel_residual 1.0; the JAX package does the same), so
    fit(engine_opts={"mode": "gemm_bf16"}) stops at its start as if
    converged. It is fit-grade only where sn2 stays above the
    quantization (sn2 = 1 there: the sigma and sn2 gradients within
    5.0e-3 of "gemm"'s)."""
    if mode != "auto":
        valid = ("chol", "gemm", "gemm_bf16", "stream")
        if mode not in valid:
            raise ValueError(f"mode must be one of {valid} or 'auto'")
        return mode
    chol_max, gemm_max = _mode_thresholds(
        None if device is None else torch.device(device))[:2]
    if n <= chol_max:
        return "chol"
    if n <= gemm_max:
        return "gemm"
    return "stream"


def _effective_cg_tol(cg_tol: float, mode: str) -> float:
    return max(cg_tol, BF16_CG_TOL_FLOOR) if mode == "gemm_bf16" \
        else cg_tol


def _flagship_operator(it_gp: IterativeGP, mode: str = "stream"):
    from gp_ss_ak_torch.ops.matvec import (
        MaterializedOperator,
        MatvecOperator,
    )

    if mode in ("gemm", "gemm_bf16"):
        dt = torch.float32 if mode == "gemm" else torch.bfloat16
        return MaterializedOperator(it_gp.Xm, it_gp.sigma, it_gp.bias,
                                    it_gp.sn2, store_dtype=dt)
    return MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias, it_gp.sn2)


@record_function("iterative._pivchol")
def _pivchol(it_gp: IterativeGP, rank):
    if rank is None:
        rank = auto_precond_rank(it_gp.Xm.shape[0])
    if not rank:
        return None
    return pivoted_cholesky(it_gp.Xm.to(torch.float32), it_gp.sigma,
                            it_gp.bias, rank)


def make_preconditioner(it_gp: IterativeGP, rank=None):
    """rank-`rank` pivoted-Cholesky Woodbury preconditioner for
    A = K + sn2 I (None -> auto_precond_rank(n); 0 disables)."""
    L = _pivchol(it_gp, rank)
    if L is None:
        return None
    return woodbury_preconditioner(L, it_gp.sn2)


def _f32(it_gp: IterativeGP) -> IterativeGP:
    f32 = torch.float32
    dev = it_gp.Xm.device
    return IterativeGP(*(torch.as_tensor(v, dtype=f32, device=dev)
                         for v in it_gp))


def _const(n: int) -> float:
    return 0.5 * n * math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# the NLML and its gradient
# ---------------------------------------------------------------------------

def nlml_iterative(it_gp: IterativeGP, y, key, cg_tol: float = 1e-4,
                   cg_maxiter: int = 800, probes: int = 16,
                   lanczos_iters: int = 32, precond_rank=None,
                   mode: str = "auto", Z=None):
    """Matrix-free NLML: 1/2 y'alpha + 1/2 logdet A + n/2 log 2pi.
    Returns (value, alpha, cg_iters).

    "chol" mode computes the exact value by a materialized Cholesky.
    Otherwise `precond_rank` > 0 solves by whitened CG and takes the
    logdet as logdet P + SLQ(P^-1/2 A P^-1/2); `precond_rank=0` solves
    by plain CG through the single-vector operator (K2 in stream mode)
    and runs SLQ on the raw A, which is biased at small sn2
    (iterative.py:584-585). Z (n, probes) injects the SLQ probes."""
    it_gp = _f32(it_gp)
    y = torch.as_tensor(y, dtype=torch.float32, device=it_gp.Xm.device)
    n = y.shape[0]
    mode = choose_mode(n, mode, y.device)
    if mode == "chol":
        Lc, half_logdet = _materialized_chol(it_gp)
        with highest_precision():
            alpha = torch.cholesky_solve(y[:, None], Lc)[:, 0]
        val = 0.5 * torch.dot(y, alpha) + half_logdet + _const(n)
        return val, alpha, 0
    op = _flagship_operator(it_gp, mode=mode)
    cg_tol = _effective_cg_tol(cg_tol, mode)
    L = _pivchol(it_gp, precond_rank)
    if L is None:
        alpha, it, _ = cg_solve(op, y, tol=cg_tol, maxiter=cg_maxiter)
        half_logdet = 0.5 * slq_logdet_batched(
            op.matmat, n, key, probes, lanczos_iters, Z, y.device)
    else:
        sols, it, _rel, logdet_P, wmm = whitened_solve_info(
            op.matmat, L, it_gp.sn2, y[:, None], tol=cg_tol,
            maxiter=cg_maxiter)
        alpha = sols[:, 0]
        half_logdet = 0.5 * (logdet_P + slq_logdet_batched(
            wmm, n, key, probes, lanczos_iters, Z, y.device))
    val = 0.5 * torch.dot(y, alpha) + half_logdet + _const(n)
    return val, alpha, int(it)


def grad_iterative(it_gp: IterativeGP, y, key, alpha=None,
                   probes: int = 8, cg_tol: float = 1e-4,
                   cg_maxiter: int = 800, chunk: int = 1024,
                   precond_rank=None, mode: str = "auto", Z=None):
    """d NLML / d (sigma, bias, sn2, Xm) via Hutchinson + fit term:

      grad = 1/2 E_z [ (A^-1 z)' dA z ]  -  1/2 alpha' dA alpha

    "chol" mode solves the probes exactly; otherwise by batched CG
    (whitened when precond_rank > 0). Z (n, probes) injects the probes."""
    it_gp = _f32(it_gp)
    y = torch.as_tensor(y, dtype=torch.float32, device=it_gp.Xm.device)
    n = y.shape[0]
    mode = choose_mode(n, mode, y.device)
    Zm = _probes(key, n, probes, Z, y.device)
    if mode == "chol":
        L, _ = _materialized_chol(it_gp)
        with highest_precision():
            if alpha is None:
                sols = torch.cholesky_solve(torch.cat([y[:, None], Zm], 1), L)
                alpha, ws = sols[:, 0], sols[:, 1:].T
            else:
                ws = torch.cholesky_solve(Zm, L).T
        del L
        return _grad_contraction(it_gp, alpha, ws, Zm.T, chunk)
    op = _flagship_operator(it_gp, mode=mode)
    cg_tol = _effective_cg_tol(cg_tol, mode)
    L = _pivchol(it_gp, precond_rank)

    def _solve(B):
        if L is None:
            return bcg_solve(op.matmat, B, None, tol=cg_tol,
                             maxiter=cg_maxiter)[0]
        return whitened_solve_info(op.matmat, L, it_gp.sn2, B,
                                   tol=cg_tol, maxiter=cg_maxiter)[0]

    if alpha is None:
        sols = _solve(torch.cat([y[:, None], Zm], 1))
        alpha, ws = sols[:, 0], sols[:, 1:].T
    else:
        ws = _solve(Zm).T
    return _grad_contraction(it_gp, alpha, ws, Zm.T, chunk)


@record_function("iterative._grad_contraction")
def _grad_contraction(it_gp: IterativeGP, alpha, ws, zs, chunk: int):
    """The differentiable part of the gradient: given alpha = A^-1 y and
    probe pairs (w = A^-1 z, z), contract against dA/dtheta through a
    dense row build, `chunk` rows at a time (iterative.py:855-910):

      grad = d/dtheta [ 1/2 sum_j c_j U[:,j]' (A V)[:,j] ]

    with U = [w_1..w_m, alpha], V = [z_1..z_m, alpha], c = [1/m.., -1]:
    one pass over the Gram rows carries all m+1 columns. Each chunk runs
    its own forward and backward and the leaf gradients are summed, so
    live memory is O(chunk x N). Returns (d_sigma, d_bias, d_sn2, d_Xm)."""
    f32 = torch.float32
    n = alpha.shape[0]
    m = ws.shape[0]
    U = torch.cat([ws.T, alpha[:, None]], 1).detach().to(f32)
    V = torch.cat([zs.T, alpha[:, None]], 1).detach().to(f32)
    coef = torch.cat([torch.full((m,), 1.0 / m, dtype=f32,
                                 device=U.device),
                      torch.full((1,), -1.0, dtype=f32, device=U.device)])
    leaves = [t.detach().to(f32).requires_grad_()
              for t in (it_gp.sigma, it_gp.bias, it_gp.sn2, it_gp.Xm)]
    sigma, bias, sn2, Xm = leaves
    cols = torch.arange(n, device=Xm.device)
    total = [torch.zeros_like(t) for t in leaves]
    with torch.enable_grad(), highest_precision():
        for s in range(0, n, chunk):
            rows = Xm[s:s + chunk]
            c = rows.shape[0]
            d2 = gram_sqdist(rows, Xm)
            on_diag = (s + torch.arange(c, device=Xm.device))[:, None] \
                == cols[None, :]
            r = torch.sqrt(torch.where(on_diag, 1.0,
                                       torch.clamp_min(d2, 1e-30)))
            k = sigma * sigma * torch.where(on_diag, 1.0, torch.exp(-r))
            k = k + bias + sn2 * on_diag
            per_col = torch.sum(U[s:s + c] * (k @ V), dim=0)     # (m+1,)
            val = 0.5 * torch.dot(per_col, coef)
            for acc, g in zip(total, torch.autograd.grad(val, leaves)):
                acc += g
    return tuple(total)


@record_function("iterative._materialized_chol")
def _materialized_chol(it_gp: IterativeGP):
    """Build A with the fused Gram kernel (K1) and factor it. Returns
    (L, half_logdet); a failed factor is NaN (ops.chol). A is dropped
    after the factorization, so the peak is A + L (8 N^2 bytes)."""
    from gp_ss_ak_torch.ops.chol import cholesky
    from gp_ss_ak_torch.ops.pairwise import expans_bias_gram

    A = expans_bias_gram(it_gp.Xm.to(torch.float32).contiguous(),
                         it_gp.sigma, it_gp.bias, it_gp.sn2)
    L = cholesky(A)
    del A
    return L, torch.sum(torch.log(torch.diagonal(L)))


def nlml_and_grad_chol(it_gp: IterativeGP, y, key_trace,
                       probes: int = 16, chunk: int = 1024, Z=None):
    """Materialized exact-Cholesky NLML + Hutchinson gradient: exact
    alpha and logdet, exact probe solves; only the trace estimate is
    stochastic. Returns (value, (d_sigma, d_bias, d_sn2, d_Xm), alpha).
    A failed factorization gives a NaN value, which the optimizers
    reject."""
    it_gp = _f32(it_gp)
    y = torch.as_tensor(y, dtype=torch.float32, device=it_gp.Xm.device)
    n = y.shape[0]
    L, half_logdet = _materialized_chol(it_gp)
    Zm = _probes(key_trace, n, probes, Z, y.device)
    with highest_precision():
        sols = torch.cholesky_solve(torch.cat([y[:, None], Zm], 1), L)
    del L
    alpha, ws = sols[:, 0], sols[:, 1:].T
    val = 0.5 * torch.dot(y, alpha) + half_logdet + _const(n)
    grads = _grad_contraction(it_gp, alpha, ws, Zm.T, chunk)
    return val, grads, alpha


def nlml_and_grad_iterative(it_gp: IterativeGP, y, key_logdet, key_trace,
                            cg_tol: float = 1e-4, cg_maxiter: int = 800,
                            probes: int = 8, lanczos_iters: int = 32,
                            chunk: int = 1024, precond_rank=None,
                            slq_probes: int = 64, mode: str = "auto",
                            Z_logdet=None, Z_trace=None):
    """Fused NLML + gradient, sharing every expensive intermediate: the
    pivoted Cholesky is built once, and alpha = A^-1 y rides the same
    batched solve as the Hutchinson probes ([y | Z] in lock-step). The
    SLQ takes `slq_probes` probes (its cost is flat in the count) on
    the same whitened operator.

    Returns (value, (d_sigma, d_bias, d_sn2, d_Xm), IterStats(cg_iters,
    rel_residual, alpha)); rel_residual is 0 on the exact chol path.
    Z_logdet (n, slq_probes) and Z_trace (n, probes) inject the probes."""
    it_gp = _f32(it_gp)
    y = torch.as_tensor(y, dtype=torch.float32, device=it_gp.Xm.device)
    n = y.shape[0]
    mode = choose_mode(n, mode, y.device)
    if mode == "chol":
        val, grads, alpha = nlml_and_grad_chol(
            it_gp, y, key_trace, probes=probes, chunk=chunk, Z=Z_trace)
        return val, grads, IterStats(
            0, torch.zeros((), dtype=torch.float32, device=y.device), alpha)
    op = _flagship_operator(it_gp, mode=mode)
    cg_tol = _effective_cg_tol(cg_tol, mode)
    L = _pivchol(it_gp, precond_rank)
    Zm = _probes(key_trace, n, probes, Z_trace, y.device)
    rhs = torch.cat([y[:, None], Zm], 1)
    if L is None:
        sols, it, rel = bcg_solve_info(op.matmat, rhs, None, tol=cg_tol,
                                       maxiter=cg_maxiter)
        half_logdet = 0.5 * slq_logdet_batched(
            op.matmat, n, key_logdet, slq_probes, lanczos_iters, Z_logdet,
            y.device)
    else:
        sols, it, rel, logdet_P, wmm = whitened_solve_info(
            op.matmat, L, it_gp.sn2, rhs, tol=cg_tol, maxiter=cg_maxiter)
        del L
        half_logdet = 0.5 * (logdet_P + slq_logdet_batched(
            wmm, n, key_logdet, slq_probes, lanczos_iters, Z_logdet,
            y.device))
    alpha, ws = sols[:, 0], sols[:, 1:].T
    val = 0.5 * torch.dot(y, alpha) + half_logdet + _const(n)
    grads = _grad_contraction(it_gp, alpha, ws, Zm.T, chunk)
    return val, grads, IterStats(int(it), rel, alpha)
