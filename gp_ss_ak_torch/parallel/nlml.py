"""Row-split exact GP: NLML + gradient + prediction at large N.

Port of gp_ss_ak_tpu/parallel/nlml.py. Every function returned here is
the per-rank body of the JAX package's shard_map over the row axis: each
rank calls it with its own row block (`shard_training_data`) and the
replicated flat hyperparameters, and gets the same value and gradient
as every other rank.

  X's blocks are all-gathered (N x d is small); each rank builds its ROW
  PANEL of A = K + sn2 I, (n_local, N): for the flagship model on the
  card through K1's cross entry (ops/fused.fused_expans_bias_cross,
  the JAX package's `fused=True`), elsewhere through kernel.matrix; the
  N x N matrix never exists on one rank. The distributed block Cholesky
  and substitutions (parallel/pchol.py) give alpha, the half
  log-determinant and the posterior solves.

Gradients use the reference's QW algebra (GP_Utils.cpp:1164-1220), not a
backward pass through the factorization:
dNLML/dtheta = 1/2 tr[(A^-1 - alpha alpha^T) dA/dtheta]. Each rank forms
its rows of QW from a distributed N-RHS solve (grad_mode "exact") or the
Hutchinson estimate from `probes` solves ("hutchinson"), and contracts
them against autograd of its OWN panel build. JAX's shard_map sums the
ranks' cotangents of the replicated hyperparameters by itself; torch
autograd does not, so each rank's local gradient is all-reduced here
(`comm.psum`).

The stages carry profiler ranges ("dist.block_cholesky", "dist.solves",
"dist.contraction"), so a torch.profiler trace splits an evaluation's
device time by stage.

Padding: rows past the true N are identity rows (unit diagonal, zero y),
which leave the log-determinant and the solves unchanged
(parallel/mesh.pad_rows).

Probes: the JAX package draws jax.random.rademacher(PRNGKey(probe_seed))
over the padded rows. Here they come from a torch.Generator seeded by
`probe_seed`, drawn over the TRUE rows on the CPU (the same matrix on
every rank and at every mesh size), or are passed in as `Z`, so a test
hands both packages one matrix.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
from torch.autograd.profiler import record_function

from gp_ss_ak_torch.inference.gaussian import (
    _cross_gram,
    warped_predictive_mix,
)
from gp_ss_ak_torch.inference.iterative import rademacher
from gp_ss_ak_torch.inference.likelihoods import WarpedGaussian
from gp_ss_ak_torch.kernels.distance import highest_precision
from gp_ss_ak_torch.ops.fused import (
    _is_flagship,
    fused_expans_bias_cross,
    mapped_points,
)
from gp_ss_ak_torch.parallel import comm
from gp_ss_ak_torch.parallel.mesh import Mesh, pad_rows
from gp_ss_ak_torch.parallel.pchol import (
    block_cholesky_local,
    solve_chol_local,
    tri_solve_lower_local,
)

#: grad_mode="auto" switchover, kept from the JAX package for parity: at
#: or below this N the exact N-RHS Q = A^-1 gradient is used, above it
#: the Hutchinson estimator. Measured on a TPU v5e
#: (gp_ss_ak_tpu/parallel/nlml.py:49-59); still to be re-derived on the
#: H100.
EXACT_GRAD_MAX_N = 8192

#: queries per chunk of `make_dist_predict`'s cross panel (n_local x
#: chunk)
PREDICT_CHUNK = 4096


def _use_fused(kernel, fused: Optional[bool], device) -> bool:
    """K1's cross entry for the flagship model on the card (JAX: on the
    TPU), kernel.matrix elsewhere, unless the caller says."""
    if fused is None:
        return torch.device(device).type == "cuda" and _is_flagship(kernel)
    if fused and not _is_flagship(kernel):
        raise ValueError("fused=True requires the flagship "
                         "Sum([ExpAns, Bias]) kernel")
    return fused


def _build_A_local(kernel, params, sn2, X_local, X_all, g0: int,
                   n_valid: int, fused: bool) -> torch.Tensor:
    """Row panel of A = K + sn2 I with identity padding rows,
    differentiable in the hyperparameters.

    With `fused` the panel comes from K1's cross entry: the points are
    recentred by the mean of the gathered X (every rank computes the same
    centre, so the panels agree across ranks) and metric-mapped once; the
    closed-form backward of `FusedExpansBiasCross` keeps the QW
    contraction's gradient path."""
    n_local, N = X_local.shape[0], X_all.shape[0]
    if fused:
        ep, bp = params
        Xm_all = mapped_points(kernel.children[0], ep, X_all).contiguous()
        K = fused_expans_bias_cross(Xm_all[g0:g0 + n_local], Xm_all,
                                    ep["Sigma"], bp["Sigma"])
    else:
        K = kernel.matrix(params, X_local, X_all, same=False)
    g = g0 + torch.arange(n_local, device=K.device)
    cols = torch.arange(N, device=K.device)
    valid = (g < n_valid)[:, None] & (cols < n_valid)[None, :]
    A = torch.where(valid, K, 0.0)
    # the local rows' diagonal entries A[i, g0 + i]: k(x, x) + sn2 on true
    # rows (exactly, as the dense build's same=True; the expansion leaves
    # sqrt(round-off) of distance there), 1 on padding. A is a fresh
    # tensor, so the in-place copy is autograd-safe
    one = torch.ones((), dtype=A.dtype, device=A.device)
    A.diagonal(offset=g0).copy_(torch.where(
        g < n_valid, kernel.diag(params, X_local) + sn2, one))
    return A


def _probe_rows(Z, n: int, probes: int, seed: int, g0: int, n_local: int,
                dtype, device) -> torch.Tensor:
    """This rank's rows of the (n, probes) probe matrix (Z as given, else
    Rademacher from a CPU torch.Generator seeded by `seed`), zero on
    padding rows."""
    if Z is None:
        Z = rademacher(torch.Generator().manual_seed(int(seed)),
                       (n, probes), device="cpu")
    Z = Z.detach().cpu() if torch.is_tensor(Z) else torch.from_numpy(
        np.array(Z))
    if tuple(Z.shape) != (n, probes):
        raise ValueError(f"probe matrix must be ({n}, {probes}), got "
                         f"{tuple(Z.shape)}")
    out = torch.zeros((n_local, probes), dtype=dtype)
    lo, hi = min(g0, n), min(g0 + n_local, n)
    out[:hi - lo] = Z[lo:hi].to(dtype)
    return out.to(device)


def _points(mesh: Mesh, X_local, valid):
    """(this rank's rows, every rank's rows) with the padding rows zeroed:
    whatever the caller left there changes no bit of the result (the
    generic Gram recentres both sets by their combined mean)."""
    X_local = torch.where(valid[:, None], X_local, 0.0)
    return X_local, comm.all_gather(mesh, X_local)


def _targets(likelihood, warped: bool, lik_h, y_local, valid, mesh: Mesh):
    """(g(y) on true rows, zero on padding; the global max of the raw
    targets, or None; sum of log g'(y) over the true rows)."""
    if not warped:
        return y_local, None, 0.0
    ymax = comm.pmax(mesh, torch.max(torch.where(valid, y_local, -math.inf)))
    gy, lgpy = likelihood.effective_target(lik_h, y_local, ymax)
    return (torch.where(valid, gy, 0.0), ymax,
            comm.psum(mesh, torch.sum(torch.where(valid, lgpy, 0.0))))


def make_dist_nlml_and_grad(kernel, likelihood, mesh: Mesh, n: int,
                            nb: int = 128, fused: Optional[bool] = None,
                            grad_mode: str = "auto", probes: int = 32,
                            probe_seed: int = 0, Z=None) -> Callable:
    """Returns f(flat, X_local, y_local) -> (nlml, grad), both the same
    on every rank.

    `n` is the true (unpadded) number of rows; X_local, y_local are this
    rank's rows of the data padded to pad_rows(n, mesh.size, nb)
    (`shard_training_data`). WarpedGaussian is supported: targets are
    warped per rank, the global y-max for the rbf clamp is a pmax, the
    - sum log g'(y) Jacobian joins the objective, and sn2 = exp(2 theta)
    (GP_Utils.cpp:417-430).

    `grad_mode`: "exact" (this rank's rows of Q = A^-1 by an N-RHS
    solve), "hutchinson" (`probes` Rademacher probes, Z (n, probes) if
    given), or "auto": exact for n <= EXACT_GRAD_MAX_N. The probe matrix
    is fixed per function, so an optimizer sees a deterministic
    objective. The alpha^T dA alpha term stays exact."""
    if grad_mode == "auto":
        grad_mode = "exact" if n <= EXACT_GRAD_MAX_N else "hutchinson"
    if grad_mode not in ("exact", "hutchinson"):
        raise ValueError(f"grad_mode must be exact, hutchinson or auto, "
                         f"got {grad_mode!r}")
    return _make_nlml_body(kernel, likelihood, mesh, n, nb,
                           _use_fused(kernel, fused, mesh.device),
                           grad_mode, probes, probe_seed, Z)


def _make_nlml_body(kernel, likelihood, mesh: Mesh, n: int, nb: int,
                    fused: bool, grad_mode: str, probes: int,
                    probe_seed: int, Z):
    """Per-rank NLML+grad body, shared by the 1-D mesh and the rows of
    the two-level mesh."""
    nk = kernel.n_params
    warped = isinstance(likelihood, WarpedGaussian)

    def sn2_of(flat):
        return (likelihood.noise_variance(flat[nk:]) if warped
                else flat[nk])

    def body(flat, X_local, y_local):
        flat = flat.detach()
        n_local = X_local.shape[0]
        g0 = mesh.rank * n_local
        N = n_local * mesh.size
        dt, dev = X_local.dtype, X_local.device
        valid = g0 + torch.arange(n_local, device=dev) < n
        with torch.no_grad(), highest_precision():
            gy, ymax, lgpy_sum = _targets(likelihood, warped, flat[nk:],
                                          y_local, valid, mesh)
            X_local, X_all = _points(mesh, X_local, valid)
            A = _build_A_local(kernel, kernel.unpack(flat[:nk]),
                               sn2_of(flat), X_local, X_all, g0, n, fused)
            with record_function("dist.block_cholesky"):
                L, half_logdet = block_cholesky_local(A, nb, mesh)
            del A
            with record_function("dist.solves"):
                alpha = solve_chol_local(L, gy[:, None], nb, mesh)[:, 0]
                fit = 0.5 * comm.psum(mesh, torch.dot(gy, alpha))
                alpha_all = comm.all_gather(mesh, alpha)
                if grad_mode == "exact":
                    eye = torch.zeros((n_local, N), dtype=dt, device=dev)
                    eye.diagonal(offset=g0).fill_(1.0)
                    W = solve_chol_local(L, eye, nb, mesh)
                    del eye
                    W.sub_(torch.outer(alpha, alpha_all))    # QW rows
                else:
                    Z_loc = _probe_rows(Z, n, probes, probe_seed, g0,
                                        n_local, dt, dev)
                    Z_all = comm.all_gather(mesh, Z_loc)
                    W = solve_chol_local(L, Z_loc, nb, mesh)  # A^-1 Z
            del L
            value = (fit + half_logdet + 0.5 * n * math.log(2.0 * math.pi)
                     - lgpy_sum)

        x = flat.clone().requires_grad_(True)
        with torch.enable_grad(), highest_precision(), \
                record_function("dist.contraction"):
            A_ = _build_A_local(kernel, kernel.unpack(x[:nk]), sn2_of(x),
                                X_local, X_all, g0, n, fused)
            if grad_mode == "exact":
                c = 0.5 * torch.sum(W * A_)
            else:
                tr_est = torch.sum(W * (A_ @ Z_all)) / probes
                quad = torch.dot(alpha, A_ @ alpha_all)
                c = 0.5 * (tr_est - quad)
            if warped:
                # d/dw [1/2 gy' A^-1 gy] = alpha' dgy/dw, and the
                # Jacobian - sum dlog g'(y)/dw: local elementwise terms
                gy_, lgpy_ = likelihood.effective_target(x[nk:], y_local,
                                                         ymax)
                c = c + torch.dot(alpha, torch.where(valid, gy_, 0.0)) \
                    - torch.sum(torch.where(valid, lgpy_, 0.0))
            (grad,) = torch.autograd.grad(c, x)
        return value, comm.psum(mesh, grad)

    return body


def make_two_level_nlml_and_grad(kernel, likelihood, two, n: int,
                                 nb: int = 128, fused: Optional[bool] = None,
                                 grad_mode: str = "auto", probes: int = 32,
                                 probe_seed: int = 0, Z=None) -> Callable:
    """Two-level parallelism over a parallel.multihost.TwoLevelMesh: each
    CHAIN (sampler chain, ensemble member, restart) owns its own
    hyperparameter vector and a full copy of the data; within a chain
    the panels and the block Cholesky are row-split over the chain's row
    mesh, and the chain mesh carries no per-step collective.
    `likelihood` and `grad_mode` as in make_dist_nlml_and_grad.

    Returns f(flats (C, p), X_local, y_local) -> (values (C,), grads
    (C, p)), the same on every rank; X_local/y_local are this rank's rows
    (shard_training_data on two.rows)."""
    f = make_dist_nlml_and_grad(kernel, likelihood, two.rows, n, nb, fused,
                                grad_mode, probes, probe_seed, Z)

    def run(flats, X_local, y_local):
        value, grad = f(flats[two.chain], X_local, y_local)
        return _gather_chains(two, flats, value, grad)

    return run


def _gather_chains(two, flats, value, grad):
    """Every chain's (value, grad) on every rank: one all-gather over
    the chain mesh."""
    if flats.shape[0] != two.n_chains:
        raise ValueError(f"expected {two.n_chains} chains, got "
                         f"{flats.shape[0]}")
    out = comm.all_gather(two.chains, torch.cat([value.reshape(1),
                                                 grad])[None])
    return out[:, 0], out[:, 1:]


def make_dist_predict(kernel, likelihood, mesh: Mesh, n: int,
                      nb: int = 128, fused: Optional[bool] = None
                      ) -> Callable:
    """Returns f(flat, X_local, y_local, Xstar, mean_only=False) ->
    (mu, var), the same on every rank.

    Xstar is replicated; one factorization serves all of it,
    PREDICT_CHUNK queries at a time. Mirrors posteriorMeanVar
    (GP_Utils.cpp:943-1043): cross-kernel (`gaussian._cross_gram`, K1's
    cross entry for the flagship model), kX^T alpha, whitened triangular
    solve, clamp, + sn2; WarpedGaussian models get the 20-node
    Gauss-Hermite g^-1 push (gaussian.warped_predictive_mix). With
    `mean_only` a plain Gaussian model skips the variance solves and var
    is None (a warped model still needs them for its mix)."""
    fused = _use_fused(kernel, fused, mesh.device)
    nk = kernel.n_params
    warped = isinstance(likelihood, WarpedGaussian)

    def predict(flat, X_local, y_local, Xstar, mean_only: bool = False):
        flat = flat.detach()
        Xstar = torch.as_tensor(Xstar, dtype=X_local.dtype,
                                device=X_local.device)
        n_local = X_local.shape[0]
        g0 = mesh.rank * n_local
        valid = g0 + torch.arange(n_local, device=X_local.device) < n
        params = kernel.unpack(flat[:nk])
        sn2 = likelihood.noise_variance(flat[nk:]) if warped else flat[nk]
        with torch.no_grad(), highest_precision():
            gy, ymax, _ = _targets(likelihood, warped, flat[nk:], y_local,
                                   valid, mesh)
            X_local, X_all = _points(mesh, X_local, valid)
            A = _build_A_local(kernel, params, sn2, X_local, X_all, g0, n,
                               fused)
            L, _ = block_cholesky_local(A, nb, mesh)
            del A
            alpha = solve_chol_local(L, gy[:, None], nb, mesh)[:, 0]
            need_var = warped or not mean_only
            mus, vars_ = [], []
            for s in range(0, Xstar.shape[0], PREDICT_CHUNK):
                Xq = Xstar[s:s + PREDICT_CHUNK]
                kX = torch.where(valid[:, None],
                                 _cross_gram(kernel, params, X_local, Xq),
                                 0.0)
                mus.append(comm.psum(mesh, kX.mT @ alpha))
                if need_var:
                    v = tri_solve_lower_local(L, kX, nb, mesh)
                    ssq = comm.psum(mesh, torch.sum(v * v, dim=0))
                    vars_.append(torch.clamp_min(
                        kernel.diag(params, Xq) - ssq, 0.0) + sn2)
            mu = torch.cat(mus)
            var = torch.cat(vars_) if need_var else None
            if warped:
                mu, var = warped_predictive_mix(likelihood, flat[nk:], mu,
                                                var, ymax)
        return mu, var

    return predict


def shard_training_data(mesh: Mesh, X, y, nb: int = 128):
    """Pad to (ranks x nb) multiples with zero rows and hand this rank its
    contiguous row block on the mesh's device, in X's dtype. Returns
    (X_local, y_local, n_true, n_padded)."""
    X = torch.as_tensor(X)
    y = torch.as_tensor(y, dtype=X.dtype)
    n, d = X.shape
    n_pad = pad_rows(n, mesh.size, nb)
    n_local = n_pad // mesh.size
    lo, hi = min(mesh.rank * n_local, n), min((mesh.rank + 1) * n_local, n)
    Xl = torch.zeros((n_local, d), dtype=X.dtype)
    yl = torch.zeros((n_local,), dtype=X.dtype)
    Xl[:hi - lo] = X[lo:hi]
    yl[:hi - lo] = y[lo:hi]
    return Xl.to(mesh.device), yl.to(mesh.device), n, n_pad
