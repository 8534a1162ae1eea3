"""Ring-rotation distributed Gram matmat + CG: the route past the
row-panel wall.

Port of gp_ss_ak_tpu/parallel/ring.py, structurally ring attention with
the N x N kernel matrix in the role of the attention matrix. The exact
pipeline (parallel/nlml.py) holds each rank's (n_local, N) row panel of
A; here nothing larger than an (n_local, TILE_CHUNK) tile exists:

  each rank holds an X block and a V block; the blocks rotate around the
  ring of ranks (comm.ring_shift, JAX's lax.ppermute); at each of the P
  steps a rank builds the tiles K(X_local, X_visiting) a column chunk at
  a time and accumulates tile @ V_visiting.

The flagship Sum([ExpAns, Bias]) + Gaussian model only, as in the
single-card matrix-free engine: A = sigma^2 exp(-||xm_i - xm_j||) + bias
+ sn2 I over metric-mapped points, padding rows acting as identity rows.

What differs from the JAX package, and why:
  * The tile. JAX builds it in jnp (the expansion, then jnp.matmul); here
    it is K1's cross entry (ops/fused.fused_expans_bias_cross): on the
    card the hand-written kernel, whose direct differences give an exact
    zero distance at coincident points, and on CPU tensors its plain
    version. Every tile pairing a point with itself has that entry set
    to exactly sigma^2 + bias by comparing global ids (a no-op on the
    card): as JAX's NLML tiles do, and also in the matvec, CG and
    posterior mean, whose JAX tiles leave sqrt(round-off) of distance
    there (about 1e-8 of K in float64). The tile-times-V product stays
    torch.matmul, as JAX's is jnp.matmul.
  * Differentiating the ring. Autograd cannot cross a send/recv, so the
    RAW X blocks and V rotate outside autograd, and every rank maps the
    visiting block itself under autograd (the centre c is a
    hyperparameter-free mean of the data). The surrogate
    0.5 sum U o (A V) then has a purely local gradient, which is
    all-reduced; backward runs per tile chunk, so one chunk's graph is
    alive at a time (JAX uses jax.checkpoint for the same end).
  * Chunking. JAX's `_pick_chunk` needs a divisor of n_local and falls
    back to chunks of one row at a prime n_local. Here the last chunk of
    a block is simply shorter.
  * Probes come from a torch.Generator seeded by `probe_seed` (or are
    passed in), as in parallel/nlml.py, over the true rows.
  * The loops (CG, Lanczos, pivoted Cholesky) are host loops: a CG
    iteration reads one flag to the host.
  * The Woodbury P^-1 that JAX's `_ring_precond` also returns is not
    ported: every caller whitens with P^(-1/2) and passes no P^-1.
  * Every solve is judged (inference.iterative.solve_state): a failed
    one (relative residual >= 1 or non-finite) makes the evaluation's
    value and gradient, or the predict's means and variances, NaN;
    an unconverged one keeps its best iterate, and the predict warns
    (UnconvergedSolveWarning). The residuals are psum-reduced, so every
    rank reaches the same verdict.

An evaluation's stages carry profiler ranges ("ring.pivoted_cholesky",
"ring.cg", "ring.slq", "ring.surrogate").
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.autograd.profiler import record_function

from gp_ss_ak_torch.inference.iterative import (
    BCG_STALL_ITERS,
    _nan_if_failed,
    _quadrature,
    _warn_unconverged,
    auto_precond_rank,
    pivoted_cholesky,
    rademacher,
    solve_state,
)
from gp_ss_ak_torch.kernels.distance import highest_precision, pad_to_3d
from gp_ss_ak_torch.ops.fused import _is_flagship, fused_expans_bias_cross
from gp_ss_ak_torch.parallel import comm
from gp_ss_ak_torch.parallel.mesh import Mesh
from gp_ss_ak_torch.parallel.nlml import _gather_chains, _probe_rows

#: most columns of a materialized tile: one (n_local, TILE_CHUNK) panel
#: at a time, whatever N / P is. Kept from the JAX package
#: (ring.py:218-224), where it was sized for a 16 GB TPU; still to be
#: re-derived on the H100.
TILE_CHUNK = 4096

#: the gathered pivoted Cholesky holds the full (n_pad, rank) factor on
#: every rank while it builds it; past this many bytes the per-step
#: distributed build runs instead. Kept from the JAX package
#: (ring.py:341).
GATHERED_PIVCHOL_MAX_BYTES = 2 << 30

#: queries per chunk of `make_ring_posterior_mean`'s cross tile
#: (n_local x PREDICT_CHUNK)
PREDICT_CHUNK = 4096


def _flagship_only(kernel, what: str) -> None:
    if not _is_flagship(kernel):
        raise ValueError(f"{what} supports the flagship Sum([ExpAns, Bias]) "
                         "kernel only")


class _Local:
    """This rank's view of the ring problem: the data-only centre c (the
    mean of the true rows, psum-reduced, so every rank maps with the same
    c), the padded raw rows Xp, global row ids g and the valid mask."""

    def __init__(self, mesh: Mesh, X_local: torch.Tensor, n: int):
        self.mesh, self.n = mesh, n
        self.Xp = pad_to_3d(X_local.detach())
        self.n_local = self.Xp.shape[0]
        self.g0 = mesh.rank * self.n_local
        self.g = self.g0 + torch.arange(self.n_local, device=X_local.device)
        self.valid = self.g < n
        self.c = comm.psum(mesh, torch.sum(torch.where(
            self.valid[:, None], self.Xp, 0.0), dim=0)) / n

    def mapped(self, kernel, params, X: torch.Tensor) -> torch.Tensor:
        """(pad_to_3d(X) - c) @ M, differentiable in the parameters."""
        M = kernel.children[0].metric(params[0], self.Xp.shape[-1])
        return (pad_to_3d(X) - self.c) @ M


def _tile(Xm_rows, Xm_cols, sigma, bias, diag_offset: Optional[int] = None,
          rows_valid: Optional[int] = None, cols_valid: Optional[int] = None):
    """One (rows, cols) kernel tile through K1's cross entry.

    `diag_offset`, the first row's global id minus the first column's:
    the entries [i, i + diag_offset] pair a point with itself, and are
    set to exactly sigma^2 + bias, as JAX's global-id compare does. Rows
    past `rows_valid` and columns past `cols_valid` are zeroed: padding
    rows all map to one point, and their cotangent must be zero.
    In-place writes on the kernel's fresh output are autograd-safe (its
    backward does not read it)."""
    K = fused_expans_bias_cross(Xm_rows.contiguous(), Xm_cols.contiguous(),
                                sigma, bias)
    if diag_offset is not None:
        d = K.diagonal(offset=diag_offset)
        d.copy_((sigma * sigma + bias).expand_as(d))
    if rows_valid is not None and rows_valid < K.shape[0]:
        K[max(rows_valid, 0):] = 0.0
    if cols_valid is not None and cols_valid < K.shape[1]:
        K[:, max(cols_valid, 0):] = 0.0
    return K


def _chunks(n_local: int, tile_chunk: Optional[int]):
    chunk = max(1, min(tile_chunk or TILE_CHUNK, n_local))
    return [(s, min(s + chunk, n_local)) for s in range(0, n_local, chunk)]


def _ring_tiles(loc: _Local, Xb, Vb, tile_chunk, step):
    """Visit every block of the ring: for each of the P steps, `step(Xc,
    Vc, gc0)` on each column chunk of the visiting block (gc0 the
    chunk's first global id), then rotate the blocks (P rotations, the
    last one brings them home, as JAX's scan does)."""
    mesh = loc.mesh
    d = Xb.shape[1]
    for k in range(mesh.size):
        src = (mesh.rank - k) % mesh.size
        for s, e in _chunks(loc.n_local, tile_chunk):
            step(Xb[s:e], Vb[s:e], src * loc.n_local + s)
        both = comm.ring_shift(mesh, torch.cat([Xb, Vb], dim=1))
        Xb, Vb = both[:, :d], both[:, d:]


def _ring_matmat_fn(loc: _Local, Xm, sigma, bias, sn2, tile_chunk=None):
    """(n_local, B) -> (A V)_local, every column riding one rotation of
    the ring (JAX's `_ring_matmat_fn`)."""
    n = loc.n

    def matmat(V):
        Vz = torch.where(loc.valid[:, None], V, 0.0)
        Q = torch.zeros_like(Vz)

        def step(Xc, Vc, gc0):
            T = _tile(Xm, Xc, sigma, bias, loc.g0 - gc0, n - loc.g0,
                      n - gc0)
            Q.addmm_(T, Vc)

        with highest_precision():
            _ring_tiles(loc, Xm, Vz, tile_chunk, step)
        return torch.where(loc.valid[:, None], Q + sn2 * V, V)

    return matmat


def _ring_pivoted_chol(loc: _Local, Xm, sigma, bias, rank: int,
                       n_pad: int) -> torch.Tensor:
    """Distributed pivoted Cholesky of K (no noise): `rank` greedy
    max-diagonal steps, each one pmax, one pmin and one psum (the pivot
    point and its row of L) plus an O(n_local d) column build. L comes
    back row-split (n_local, rank)."""
    mesh = loc.mesh
    s2 = sigma * sigma
    n_local, d = Xm.shape
    dvec = torch.where(loc.valid, s2 + bias, 0.0)
    L = Xm.new_zeros((n_local, rank))
    with highest_precision():
        for j in range(rank):
            local_max = torch.max(dvec)
            gmax = comm.pmax(mesh, local_max)
            # owner = the attaining rank with the smallest global row id
            cand = torch.where(local_max >= gmax, loc.g[torch.argmax(dvec)],
                               n_pad)
            owner_row = loc.g == comm.pmin(mesh, cand)
            xl = comm.psum(mesh, torch.sum(torch.where(
                owner_row[:, None], torch.cat([Xm, L], dim=1), 0.0), dim=0))
            xi, Li = xl[:d], xl[d:]
            dist = torch.sqrt(torch.clamp_min(
                torch.sum((Xm - xi) ** 2, dim=1), 0.0))
            c = torch.where(owner_row, s2 + bias, s2 * torch.exp(-dist) + bias)
            l = (c - L @ Li) / torch.sqrt(torch.clamp_min(gmax, 1e-30))
            l = torch.where((gmax > 1e-30) & loc.valid, l, 0.0)
            L[:, j] = l
            dvec = torch.where(owner_row, 0.0,
                               torch.clamp_min(dvec - l * l, 0.0))
    return L


def _ring_pivoted_chol_gathered(loc: _Local, Xm, sigma, bias, rank: int,
                                n_pad: int) -> torch.Tensor:
    """Replicated-build pivoted Cholesky: all-gather the mapped points
    and run the single-card greedy recursion
    (inference.iterative.pivoted_cholesky) identically on every rank over
    the true rows, the global rows [0, n); padding rows get zero rows of
    L; then keep the local row block. Each step is local (argmax, one
    O(n d) column, one (n, rank) matvec); the distributed build pays
    latency-bound collectives every step instead."""
    L = torch.zeros((n_pad, rank), dtype=Xm.dtype, device=Xm.device)
    L[:loc.n] = pivoted_cholesky(comm.all_gather(loc.mesh, Xm)[:loc.n],
                                 sigma, bias, rank)
    return L[loc.g0:loc.g0 + loc.n_local]


def _ring_pivchol_dispatch(loc: _Local, Xm, sigma, bias, rank: int,
                           n_pad: int) -> torch.Tensor:
    """The gathered build when the full-L transient fits
    GATHERED_PIVCHOL_MAX_BYTES, else the per-step distributed one."""
    if n_pad * rank * Xm.element_size() <= GATHERED_PIVCHOL_MAX_BYTES:
        return _ring_pivoted_chol_gathered(loc, Xm, sigma, bias, rank,
                                           n_pad)
    return _ring_pivoted_chol(loc, Xm, sigma, bias, rank, n_pad)


def _ring_precond(mesh: Mesh, L_local: torch.Tensor, sn2, n_true: int):
    """Exact P^(-1/2) and logdet P for P = L L^T + sn2 I over the valid
    n_true-dimensional subspace: the k x k core L^T L is one psum,
    everything else local products (inference/iterative.precond_sqrt,
    row-split). Returns (inv_sqrt, logdet_P)."""
    with highest_precision():
        LtL = comm.psum(mesh, L_local.mT @ L_local)
        S, U = torch.linalg.eigh(LtL)
        S = torch.clamp_min(S, 0.0)
        mask = S > 1e-10
        Q = (L_local @ (U / torch.sqrt(torch.clamp_min(S, 1e-30))[None, :])
             ) * mask[None, :].to(L_local.dtype)
    inv_sqrt_eig = torch.where(mask, 1.0 / torch.sqrt(S + sn2), 0.0)
    rsn = 1.0 / torch.sqrt(sn2)
    logdet_P = (n_true - torch.sum(mask)) * torch.log(sn2) + torch.sum(
        torch.where(mask, torch.log(S + sn2), 0.0))

    def inv_sqrt(V):
        with highest_precision():
            QtV = comm.psum(mesh, Q.mT @ V)
            return (V - Q @ QtV) * rsn + Q @ (inv_sqrt_eig[:, None] * QtV)

    return inv_sqrt, logdet_P


def _ring_bcg(mesh: Mesh, matmat: Callable, B_local: torch.Tensor,
              tol: float, maxiter: int, uniform: Optional[Mesh] = None):
    """Batched CG with psum'd inner products and the best-iterate /
    non-finite / stall hardening of inference.iterative.bcg_solve
    (frozen columns never poison the result; a tolerance below the
    float32 floor stops at the plateau). One flag read to the host per
    iteration: the psum'd quantities are the same on every rank, so all
    ranks leave the loop at the same step.

    `uniform`: on a two-level mesh the continue flag is also OR-reduced
    over the chain mesh, so every chain iterates until the slowest one
    converges (frozen columns make the extra iterations no-ops), as
    JAX's `uniform_axis` (ring.py:466-495).

    Returns (X best (n_local, B), iterations, worst-column achieved
    relative residual ||r|| / ||b||)."""
    def psum_cols(M):
        return comm.psum(mesh, torch.sum(M, dim=0))

    X = torch.zeros_like(B_local)
    R = B_local
    Pv = R
    rn0 = psum_cols(B_local * B_local)
    rn = rn0                          # = psum_cols(R * R), also rz
    thresh = (tol ** 2) * rn0
    Xbest, rn_best = X, rn0
    it = 0
    stall = torch.zeros((), dtype=torch.int64, device=rn0.device)

    def active(rn):
        return (rn > thresh) & torch.isfinite(rn)

    while it < maxiter:
        go = torch.any(active(rn)) & (stall < BCG_STALL_ITERS)
        if not (comm.any_rank(uniform, go) if uniform is not None
                else bool(go)):
            break
        act = active(rn)
        AP = matmat(Pv)
        pAp = psum_cols(Pv * AP)
        ok = act & (pAp > 0) & torch.isfinite(pAp) & torch.isfinite(rn)
        a = torch.where(ok, rn / torch.where(pAp > 0, pAp, 1.0), 0.0)
        X = X + a[None, :] * Pv
        R = R - a[None, :] * AP
        rn_new = psum_cols(R * R)
        better = torch.isfinite(rn_new) & (rn_new < rn_best)
        Xbest = torch.where(better[None, :], X, Xbest)
        # only a meaningful (0.1%) improvement resets the stall count:
        # noise-level creep near the float32 floor must not defer it
        meaningful = better & (rn_new < 0.999 * rn_best)
        rn_best = torch.where(better, rn_new, rn_best)
        stall = torch.where(torch.any(meaningful & act),
                            torch.zeros_like(stall), stall + 1)
        beta = torch.where(ok, rn_new / torch.where(rn > 0, rn, 1.0), 0.0)
        Pv = R + beta[None, :] * Pv
        rn = rn_new
        it += 1
    rel = torch.sqrt(torch.max(torch.where(
        rn0 > 0, rn_best / torch.where(rn0 > 0, rn0, 1.0), 0.0)))
    return Xbest, it, rel


def _ring_slq_logdet(mesh: Mesh, matmat, inv_sqrt, logdet_P, Z_local,
                     n_true: int, k_steps: int) -> torch.Tensor:
    """Preconditioned SLQ with a distributed batched Lanczos: every
    reduction a psum, every step one ring matmat shared by all probes;
    the quadrature on the replicated tridiagonals is local."""
    norms = torch.sqrt(comm.psum(mesh, torch.sum(Z_local * Z_local, dim=0)))
    V_cur = Z_local / norms[None, :]
    V_prev = torch.zeros_like(V_cur)
    beta = torch.zeros_like(norms)
    alphas, betas = [], []
    for _ in range(k_steps):
        W = inv_sqrt(matmat(inv_sqrt(V_cur))) - beta[None, :] * V_prev
        alpha = comm.psum(mesh, torch.sum(W * V_cur, dim=0))
        W = W - alpha[None, :] * V_cur
        beta = torch.sqrt(comm.psum(mesh, torch.sum(W * W, dim=0)))
        V_next = torch.where(beta[None, :] > 1e-10,
                             W / torch.where(beta > 0, beta, 1.0)[None, :],
                             0.0)
        V_prev, V_cur = V_cur, V_next
        alphas.append(alpha)
        betas.append(beta)
    resid = torch.mean(_quadrature(torch.stack(alphas),
                                   torch.stack(betas)[:-1], n_true))
    return logdet_P + resid


def draw_probes(seed: int, n: int, probes: int, slq_probes: int):
    """The ring NLML's (n, probes) trace probes and (n, slq_probes) SLQ
    probes over the true rows: Rademacher from two CPU generators derived
    from `seed` (JAX splits PRNGKey(seed) into two keys)."""
    return (rademacher(torch.Generator().manual_seed(2 * int(seed)),
                       (n, probes), device="cpu"),
            rademacher(torch.Generator().manual_seed(2 * int(seed) + 1),
                       (n, slq_probes), device="cpu"))


def _hypers(kernel, flat):
    nk = kernel.n_params
    params = kernel.unpack(flat[:nk])
    return params, params[0]["Sigma"], params[1]["Sigma"], flat[nk]


def make_ring_matvec(kernel, mesh: Mesh, n: int) -> Callable:
    """Returns f(flat, X_local, v_local) -> (A v)_local, where
    A = K + sn2 I with identity padding rows and K never exists, not even
    as a row panel."""
    _flagship_only(kernel, "ring matvec")

    def f(flat, X_local, v_local):
        with torch.no_grad():
            params, sigma, bias, sn2 = _hypers(kernel, flat.detach())
            loc = _Local(mesh, X_local, n)
            mm = _ring_matmat_fn(loc, loc.mapped(kernel, params, X_local),
                                 sigma, bias, sn2)
            return mm(v_local[:, None])[:, 0]

    return f


def make_ring_cg_solve(kernel, mesh: Mesh, n: int, tol: float = 1e-6,
                       maxiter: int = 1000) -> Callable:
    """Returns f(flat, X_local, b_local) -> (x_local, iterations,
    residual): CG on A x = b where every matvec is one ring pass and
    every inner product a psum. One flag read per iteration. x is NaN
    when the solve failed (residual >= ||b||, or non-finite)."""
    _flagship_only(kernel, "ring CG")

    def f(flat, X_local, b_local):
        with torch.no_grad():
            params, sigma, bias, sn2 = _hypers(kernel, flat.detach())
            loc = _Local(mesh, X_local, n)
            mm = _ring_matmat_fn(loc, loc.mapped(kernel, params, X_local),
                                 sigma, bias, sn2)

            def pdot(a, b):
                return comm.psum(mesh, torch.dot(a, b))

            b = torch.where(loc.valid, b_local, 0.0)
            x = torch.zeros_like(b)
            r, p = b, b
            rs = pdot(r, r)
            thresh = tol ** 2 * pdot(b, b)
            it = 0
            while it < maxiter and bool(rs > thresh):
                Ap = mm(p[:, None])[:, 0]
                a = rs / pdot(p, Ap)
                x = x + a * p
                r = r - a * Ap
                rs_new = pdot(r, r)
                p = r + (rs_new / rs) * p
                rs = rs_new
                it += 1
            return _nan_if_failed(x, rs, pdot(b, b)), it, torch.sqrt(rs)

    return f


def make_ring_nlml_and_grad(kernel, mesh: Mesh, n: int,
                            precond_rank: Optional[int] = None,
                            probes: int = 8, slq_probes: int = 16,
                            lanczos_iters: int = 32, cg_tol: float = 1e-4,
                            cg_maxiter: int = 400, probe_seed: int = 0,
                            with_stats: bool = False,
                            tile_chunk: Optional[int] = None, Z=None,
                            Zl=None) -> Callable:
    """Ring-distributed matrix-free NLML + gradient: nothing larger than
    an (n_local, tile_chunk) tile or an (n_local, probes) block exists on
    any rank.

    Per evaluation (the BBMM estimator, distributed):
      alpha + Hutchinson probe solves: ONE ring batched CG on [y | Z],
          whitened by a ring-built pivoted-Cholesky preconditioner of
          rank `precond_rank` (None: auto_precond_rank(n));
      logdet: exact logdet P + SLQ on the whitened operator through a
          psum'd batched Lanczos (`slq_probes` x `lanczos_iters`);
      gradient: d/dtheta [mean_z w'A z / 2 - alpha'A alpha / 2] through
          the ring tile build, per chunk, all-reduced.

    The probes (Z (n, probes) and Zl (n, slq_probes), else
    `draw_probes(probe_seed, ...)`) are fixed, so an optimizer sees a
    deterministic objective. Returns f(flat, X_local, y_local) ->
    (value, grad), or (value, grad, stats) with stats = [CG iterations,
    achieved relative residual] when `with_stats`. A failed solve gives
    a NaN value and gradient (`solve_state` against `cg_tol`)."""
    _flagship_only(kernel, "ring NLML")
    if precond_rank is None:
        precond_rank = auto_precond_rank(n)
    if Z is None or Zl is None:
        Zd, Zld = draw_probes(probe_seed, n, probes, slq_probes)
        Z = Zd if Z is None else Z
        Zl = Zld if Zl is None else Zl
    body = _make_ring_body(kernel, mesh, n, precond_rank, probes,
                           slq_probes, lanczos_iters, cg_tol, cg_maxiter,
                           Z, Zl, tile_chunk)

    def f(flat, X_local, y_local):
        value, grad, it, rel = body(flat, X_local, y_local)
        if with_stats:
            return value, grad, torch.stack([
                torch.as_tensor(float(it), dtype=value.dtype,
                                device=value.device), rel.to(value.dtype)])
        return value, grad

    return f


def _make_ring_body(kernel, mesh: Mesh, n: int, precond_rank: int,
                    probes: int, slq_probes: int, lanczos_iters: int,
                    cg_tol: float, cg_maxiter: int, Z, Zl,
                    tile_chunk: Optional[int] = None,
                    uniform: Optional[Mesh] = None):
    """Per-rank ring NLML+grad body, shared by the 1-D mesh and the rows
    of the two-level mesh. Returns (value, grad, CG iterations, achieved
    relative residual); a failed solve returns a NaN value and gradient
    without the SLQ or the surrogate (on every rank of `mesh`, whose
    residual is one psum)."""
    nk = kernel.n_params

    def body(flat, X_local, y_local):
        flat = flat.detach()
        dt, dev = X_local.dtype, X_local.device
        with torch.no_grad():
            params, sigma, bias, sn2 = _hypers(kernel, flat)
            loc = _Local(mesh, X_local, n)
            n_pad = loc.n_local * mesh.size
            Xm = loc.mapped(kernel, params, X_local)
            matmat = _ring_matmat_fn(loc, Xm, sigma, bias, sn2, tile_chunk)
            with record_function("ring.pivoted_cholesky"):
                L = _ring_pivchol_dispatch(loc, Xm, sigma, bias,
                                           precond_rank, n_pad)
                inv_sqrt, logdet_P = _ring_precond(mesh, L, sn2, n)
            del L
            Z_loc = _probe_rows(Z, n, probes, 0, loc.g0, loc.n_local, dt,
                                dev)
            yz = torch.where(loc.valid, y_local, 0.0)
            rhs = torch.cat([yz[:, None], Z_loc], dim=1)
            # whitened CG (plain CG on P^(-1/2) A P^(-1/2)): the float32-
            # stable route (inference.iterative.whitened_solve_info)
            with record_function("ring.cg"):
                sols_w, cg_it, cg_rel = _ring_bcg(
                    mesh, lambda V: inv_sqrt(matmat(inv_sqrt(V))),
                    inv_sqrt(rhs), cg_tol, cg_maxiter, uniform)
                sols = inv_sqrt(sols_w)
            if solve_state(cg_rel, cg_tol) == "failed":
                nan = torch.full((), math.nan, dtype=dt, device=dev)
                return nan, torch.full_like(flat, math.nan), cg_it, cg_rel
            alpha, ws = sols[:, 0], sols[:, 1:]
            Zl_loc = _probe_rows(Zl, n, slq_probes, 0, loc.g0, loc.n_local,
                                 dt, dev)
            with record_function("ring.slq"):
                logdet = _ring_slq_logdet(mesh, matmat, inv_sqrt, logdet_P,
                                          Zl_loc, n, lanczos_iters)
            fit = 0.5 * comm.psum(mesh, torch.dot(yz, alpha))
            value = fit + 0.5 * logdet + 0.5 * n * math.log(2.0 * math.pi)
            coef = torch.cat([torch.full((probes,), 1.0 / probes, dtype=dt,
                                         device=dev),
                              torch.full((1,), -1.0, dtype=dt, device=dev)])
            U = torch.cat([ws, alpha[:, None]], dim=1) * coef[None, :] \
                * loc.valid[:, None]
            V = torch.cat([Z_loc, alpha[:, None]], dim=1) \
                * loc.valid[:, None]
        with record_function("ring.surrogate"):
            grad = _surrogate_grad(kernel, loc, flat, X_local, U, V,
                                   tile_chunk)
        return value, grad, cg_it, cg_rel

    return body


def _surrogate_grad(kernel, loc: _Local, flat, X_local, U, V, tile_chunk):
    """d/dtheta of 0.5 sum U o (A(theta) V) over this rank's rows,
    all-reduced: the raw visiting blocks rotate outside autograd and are
    mapped here under it; backward runs per tile chunk."""
    nk = kernel.n_params
    x = flat.clone().requires_grad_(True)
    grad = torch.zeros_like(flat)

    def step(Xc, Vc, gc0):
        nonlocal grad
        with torch.enable_grad():
            params = kernel.unpack(x[:nk])
            T = _tile(loc.mapped(kernel, params, X_local),
                      loc.mapped(kernel, params, Xc), params[0]["Sigma"],
                      params[1]["Sigma"], loc.g0 - gc0, loc.n - loc.g0,
                      loc.n - gc0)
            (gc,) = torch.autograd.grad(0.5 * torch.sum(U * (T @ Vc)), x)
        grad = grad + gc

    with highest_precision():
        _ring_tiles(loc, X_local.detach(), V, tile_chunk, step)
        with torch.enable_grad():
            # the diagonal sn2 V on the true rows (V is zero elsewhere)
            (gs,) = torch.autograd.grad(0.5 * x[nk] * torch.sum(U * V), x)
    return comm.psum(loc.mesh, grad + gs)


def make_two_level_ring_nlml_and_grad(kernel, two, n: int,
                                      precond_rank: Optional[int] = None,
                                      probes: int = 8, slq_probes: int = 16,
                                      lanczos_iters: int = 32,
                                      cg_tol: float = 1e-4,
                                      cg_maxiter: int = 400,
                                      probe_seed: int = 0, Z=None,
                                      Zl=None) -> Callable:
    """Two-level ring over a parallel.multihost.TwoLevelMesh: each chain
    owns its hyperparameter vector; within a chain the ring NLML+grad
    runs panel-free over the chain's row mesh, its CG's continue flag
    OR-reduced over the chain mesh.

    Returns f(flats (C, p), X_local, y_local) -> (values (C,), grads
    (C, p)), the same on every rank; X_local/y_local are this rank's rows
    (shard_training_data on two.rows)."""
    _flagship_only(kernel, "ring NLML")
    if precond_rank is None:
        precond_rank = auto_precond_rank(n)
    if Z is None or Zl is None:
        Zd, Zld = draw_probes(probe_seed, n, probes, slq_probes)
        Z = Zd if Z is None else Z
        Zl = Zld if Zl is None else Zl
    body = _make_ring_body(kernel, two.rows, n, precond_rank, probes,
                           slq_probes, lanczos_iters, cg_tol, cg_maxiter,
                           Z, Zl, uniform=two.chains)

    def f(flats, X_local, y_local):
        value, grad, _, _ = body(flats[two.chain], X_local, y_local)
        return _gather_chains(two, flats, value, grad)

    return f


def make_ring_predict(kernel, mesh: Mesh, n: int, tol: float = 1e-6,
                      maxiter: int = 1000,
                      precond_rank: Optional[int] = None) -> Callable:
    """Panel-free posterior mean AND variance at Xstar (replicated, m
    queries): alpha and the m variance solves U = A^-1 kX ride ONE ring
    batched CG ([y | kX]); then mu = kX' alpha and var = kdiag -
    sum(kX o U) + sn2, each one psum. Mirrors posteriorMeanVar
    (GP_Utils.cpp:943-1043). Serve in chunks: a chunk costs one ring CG.
    An unconverged solve warns (UnconvergedSolveWarning); a failed one
    gives NaN means and variances.

    Returns f(flat, X_local, y_local, Xstar) -> (mu, var)."""
    _flagship_only(kernel, "ring predict")
    if precond_rank is None:
        precond_rank = auto_precond_rank(n)

    def f(flat, X_local, y_local, Xstar):
        Xstar = torch.as_tensor(Xstar, dtype=X_local.dtype,
                                device=X_local.device)
        with torch.no_grad():
            params, sigma, bias, sn2 = _hypers(kernel, flat.detach())
            loc = _Local(mesh, X_local, n)
            Xm = loc.mapped(kernel, params, X_local)
            matmat = _ring_matmat_fn(loc, Xm, sigma, bias, sn2)
            # queries mapped with the same global centre as the rows
            kX = _tile(Xm, loc.mapped(kernel, params, Xstar), sigma, bias,
                       rows_valid=n - loc.g0)
            yz = torch.where(loc.valid, y_local, 0.0)
            rhs = torch.cat([yz[:, None], kX], dim=1)
            if precond_rank:
                L = _ring_pivchol_dispatch(loc, Xm, sigma, bias,
                                           precond_rank,
                                           loc.n_local * mesh.size)
                inv_sqrt, _ = _ring_precond(mesh, L, sn2, n)
                sols_w, _, rel = _ring_bcg(
                    mesh, lambda V: inv_sqrt(matmat(inv_sqrt(V))),
                    inv_sqrt(rhs), tol, maxiter)
                sols = inv_sqrt(sols_w)
            else:
                sols, _, rel = _ring_bcg(mesh, matmat, rhs, tol, maxiter)
            state = solve_state(rel, tol)
            if state == "unconverged":
                _warn_unconverged("ring predict", rel, tol)
            alpha, U = sols[:, 0], sols[:, 1:]
            with highest_precision():
                mu = comm.psum(mesh, kX.mT @ alpha)
            quad = comm.psum(mesh, torch.sum(kX * U, dim=0))
            var = torch.clamp_min(sigma * sigma + bias - quad, 0.0) + sn2
            if state == "failed":
                mu, var = (torch.full_like(t, math.nan) for t in (mu, var))
        return mu, var

    return f


def make_ring_posterior_mean(kernel, mesh: Mesh, n: int, tol: float = 1e-6,
                             maxiter: int = 1000) -> Callable:
    """Returns f(flat, X_local, y_local, Xstar) -> (mu, CG iterations,
    residual): alpha by ring CG (make_ring_cg_solve), then
    mu = kX^T alpha, one psum over the ranks' cross tiles, PREDICT_CHUNK
    queries at a time. Mirrors _postMean
    (GP_Utils.cpp:958-972) at panel-free scale."""
    cg = make_ring_cg_solve(kernel, mesh, n, tol, maxiter)

    def f(flat, X_local, y_local, Xstar):
        Xstar = torch.as_tensor(Xstar, dtype=X_local.dtype,
                                device=X_local.device)
        alpha, it, res = cg(flat, X_local, y_local)
        with torch.no_grad():
            params, sigma, bias, _ = _hypers(kernel, flat.detach())
            loc = _Local(mesh, X_local, n)
            Xm = loc.mapped(kernel, params, X_local)
            mus = []
            for s in range(0, Xstar.shape[0], PREDICT_CHUNK):
                Xq = Xstar[s:s + PREDICT_CHUNK]
                kX = _tile(Xm, loc.mapped(kernel, params, Xq),
                           sigma, bias, rows_valid=n - loc.g0)
                with highest_precision():
                    mus.append(comm.psum(mesh, kX.mT @ alpha))
        return torch.cat(mus), it, res

    return f
