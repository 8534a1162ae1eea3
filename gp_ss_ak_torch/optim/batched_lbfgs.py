"""Bound-constrained L-BFGS over a batch of independent problems.

The counterpart of gp_ss_ak_tpu/optim/jax_lbfgs.py, the whole-fit
device optimizer behind `-o JIT` and the multi-deposit ensembles. Same
algorithm: box projection, the masked two-loop recursion over rolling
(m, p) correction buffers, NaN rejection, best-so-far, a backtracking
line search that halves the step. Same semantics as `jax.vmap` of that
`lax.while_loop`: each member stops on its own condition and keeps its
own iteration count; the loop runs while any member is active; a
finished member is still carried, its state selected away
(`torch.where`) and never changed.

What differs is where the loop runs. JAX compiles the whole fit into
one device program. Here the iterations and the line-search steps are a
host loop: every line-search step is one batched evaluation of all the
members (a finished member is evaluated at its own current point and
the result discarded), and the host reads one device flag per step
(is any member still searching?) and one per iteration (is any member
still active?). No CUDA graph.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.autograd.profiler import record_function


class BatchedOptResult(NamedTuple):
    x: torch.Tensor          # (B, p) best point of each member
    fun: torch.Tensor        # (B,) its objective value
    n_iters: torch.Tensor    # (B,) iterations each member took
    converged: torch.Tensor  # (B,) stopped on its own rule, not maxiter
    n_evals: int             # batched evaluations of value_and_grad


def _two_loop(g, S, Y, valid):
    """Masked two-loop recursion over rolling (B, m, p) buffers."""
    m = S.shape[1]
    sy = torch.sum(S * Y, dim=-1)                            # (B, m)
    rho = torch.where(valid & (sy > 1e-12),
                      1.0 / torch.where(sy == 0, 1.0, sy), 0.0)
    q = g
    alphas = [None] * m
    for idx in range(m - 1, -1, -1):
        a = rho[:, idx] * torch.sum(S[:, idx] * q, dim=-1)
        q = q - a[:, None] * Y[:, idx]
        alphas[idx] = a
    yy_last = torch.sum(Y[:, -1] * Y[:, -1], dim=-1)
    gamma = torch.where(valid[:, -1] & (yy_last > 0),
                        sy[:, -1] / torch.where(yy_last == 0, 1.0, yy_last),
                        1.0)
    q = q * gamma[:, None]
    for i in range(m):
        b = rho[:, i] * torch.sum(Y[:, i] * q, dim=-1)
        q = q + S[:, i] * (alphas[i] - b)[:, None]
    return q


def _push(buf, new, good):
    """Roll each member's buffer by one and append `new`, where `good`."""
    rolled = torch.cat([buf[:, 1:], new[:, None]], dim=1)
    return torch.where(good.view(-1, *([1] * (buf.dim() - 1))), rolled, buf)


def minimize(value_and_grad: Callable, x0: torch.Tensor,
             lower: torch.Tensor, upper: torch.Tensor,
             maxiter: int = 100, memory: int = 6,
             gtol: float = 1e-6, ftol: float = 1e-9,
             max_backtracks: int = 20,
             hook: Optional[Callable] = None) -> BatchedOptResult:
    """Minimize B independent problems at once.

    value_and_grad maps points (B, p) to values (B,) and gradients
    (B, p) for all members in one call; x0 is (B, p); lower and upper
    are (p,) or (B, p), on x0's device and dtype. hook(points, values,
    gradients, mask) -> bool sees each evaluation (module docstring)."""
    B, p = x0.shape
    x = torch.clamp(x0, lower, upper)
    f, g = value_and_grad(x)
    n_evals = 1
    S = x.new_zeros((B, memory, p))
    Y = x.new_zeros((B, memory, p))
    valid = torch.zeros((B, memory), dtype=torch.bool, device=x.device)
    best_x, best_f = x, f
    it = torch.zeros(B, dtype=torch.long, device=x.device)
    done = torch.zeros(B, dtype=torch.bool, device=x.device)
    min_t = 2.0 ** (-max_backtracks)
    # the start's evaluation reaches the hook after the first flag read
    start_unseen = hook is not None

    def cut():
        return BatchedOptResult(best_x, best_f, it,
                                torch.zeros_like(done), n_evals)

    while True:
        with record_function("batched_lbfgs.direction"):
            active = (it < maxiter) & ~done
            more = bool(active.any())
            if more:
                pg = x - torch.clamp(x - g, lower, upper)
                kkt = torch.amax(torch.abs(pg), dim=-1) < gtol

                d = -_two_loop(g, S, Y, valid)
                at_lo = x <= lower + 1e-12
                at_hi = x >= upper - 1e-12
                bad = (at_lo & (d < 0)) | (at_hi & (d > 0))
                d = torch.where(bad, -g, d)
                d = torch.where((at_lo & (g > 0)) | (at_hi & (g < 0)), 0.0,
                                d)
                descent = torch.sum(d * g, dim=-1) < 0
                d = torch.where(descent[:, None], d, -g)
        if start_unseen:
            start_unseen = False
            if hook(x, f, g, active):
                return cut()
        if not more:
            break

        # the line search: members still searching are those active and
        # not yet accepted with t above its floor
        t = torch.ones(B, dtype=x.dtype, device=x.device)
        accepted = torch.zeros(B, dtype=torch.bool, device=x.device)
        searching = active
        x_new, f_new, g_new = x, f, g
        while True:
            cand = torch.where(searching[:, None],
                               torch.clamp(x + t[:, None] * d, lower, upper),
                               x)
            fc, gc = value_and_grad(cand)
            n_evals += 1
            with record_function("batched_lbfgs.line_search"):
                ok = searching & torch.isfinite(fc) & (fc < f)
                x_new = torch.where(ok[:, None], cand, x_new)
                f_new = torch.where(ok, fc, f_new)
                g_new = torch.where(ok[:, None], gc, g_new)
                accepted = accepted | ok
                t = torch.where(searching, t * 0.5, t)
                used = searching
                searching = searching & ~accepted & (t > min_t)
                more = bool(searching.any())
            if hook is not None and hook(cand, fc, gc, used):
                # keep what this iteration accepted before the stop
                improved = active & (f_new < best_f)
                best_x = torch.where(improved[:, None], x_new, best_x)
                best_f = torch.where(improved, f_new, best_f)
                return cut()
            if not more:
                break

        with record_function("batched_lbfgs.update"):
            s = x_new - x
            yv = g_new - g
            sy = torch.sum(s * yv, dim=-1)
            good = active & accepted & (
                sy > 1e-10 * torch.linalg.vector_norm(s, dim=-1)
                * torch.linalg.vector_norm(yv, dim=-1))
            S = _push(S, s, good)
            Y = _push(Y, yv, good)
            valid = _push(valid, torch.ones_like(good), good)
            improved = active & (f_new < best_f)
            best_x = torch.where(improved[:, None], x_new, best_x)
            best_f = torch.where(improved, f_new, best_f)
            small_change = accepted & (torch.abs(f - f_new)
                                       <= ftol * (1.0 + torch.abs(f_new)))
            stop = kkt | ~accepted | small_change
            x = torch.where(active[:, None], x_new, x)
            f = torch.where(active, f_new, f)
            g = torch.where(active[:, None], g_new, g)
            done = torch.where(active, stop, done)
            it = it + active.long()
    return BatchedOptResult(best_x, best_f, it, done, n_evals)
