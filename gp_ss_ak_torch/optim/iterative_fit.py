"""Matrix-free fit engine: hyperparameter value and gradient in the FLAT
space via CG + stochastic Lanczos (inference/iterative.py), chained back
through the metric map so the box-constrained optimizers (optim/lbfgsb.py,
optim/scg.py) drive it unchanged. Port of
gp_ss_ak_tpu/optim/iterative_fit.py.

  flat = [8 ExpAns params, bias, lik hypers]
  Xm(angles, widths)  = (X - mean X) @ M            (ops/fused.py)
  NLML(Xm, sigma, bias, sn2; g(y))                  (iterative.py)
  d NLML/d angles,widths = autograd of Xm's map against d NLML/d Xm
  d NLML/d sigma,bias,sn2 = direct from the engine

A warped model (WarpedGaussian) runs the engine on g(y) with
sn2 = exp(2 theta_last) and subtracts sum log g'(y); its likelihood
hypers take their gradient from the O(n) surrogate
alpha' g(y) - sum log g'(y) + dNLML/dsn2 * sn2 with alpha = A^-1 g(y)
and dNLML/dsn2 held fixed (A does not depend on the warp).

The SLQ and Hutchinson probes are drawn ONCE per fit, from `seed` on the
data's device (or injected), so the objective the line search sees is
deterministic: a biased but self-consistent estimate, the standard
BBMM/GPyTorch trick. (The JAX package gets the same by reusing one PRNG
key; a torch.Generator advances on every draw, so the port keeps the
drawn matrices instead.)
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.profiler import record_function

from gp_ss_ak_torch.inference.iterative import (
    IterativeGP,
    _effective_cg_tol,
    auto_precond_rank,
    choose_mode,
    nlml_and_grad_iterative,
    rademacher,
)
from gp_ss_ak_torch.inference.likelihoods import Gaussian, WarpedGaussian
from gp_ss_ak_torch.model import GPModel
from gp_ss_ak_torch.ops.fused import _is_flagship, mapped_points

#: above this N, fit(engine="auto") prefers the matrix-free route on a
#: GPU (iterative_fit.py:37-40: TPU-era, sized for a 16 GB chip; kept
#: for parity, still to be re-derived for an 80 GB H100)
DENSE_MAX_N = 16384


def supports_iterative(model: GPModel) -> bool:
    """The flagship Sum([ExpAns, Bias]) with a (warped) Gaussian
    likelihood and flat = [kernel params..., lik hypers] exactly (a
    model carrying mean hypers is refused)."""
    lik = model.likelihood
    return (_is_flagship(model.kernel)
            and isinstance(lik, (Gaussian, WarpedGaussian))
            and model.n_params == model.kernel.n_params + lik.n_hypers)


def fit_probes(seed: int, n: int, probes: int, slq_probes: int, device,
               Z_logdet=None, Z_trace=None):
    """The fixed probes of a fit, float32 on `device`: (Z_logdet (n,
    slq_probes), Z_trace (n, probes)), each as given, else drawn from a
    torch.Generator seeded with `seed` (SLQ) or `seed + 1` (Hutchinson)."""
    if Z_logdet is None:
        key = torch.Generator(device=device).manual_seed(seed)
        Z_logdet = rademacher(key, (n, slq_probes), device)
    if Z_trace is None:
        key = torch.Generator(device=device).manual_seed(seed + 1)
        Z_trace = rademacher(key, (n, probes), device)
    f32 = torch.float32
    return (torch.as_tensor(Z_logdet, dtype=f32, device=device),
            torch.as_tensor(Z_trace, dtype=f32, device=device))


def make_iterative_value_and_grad(
    model: GPModel,
    X,
    y,
    seed: int = 0,
    probes: int = 8,
    lanczos_iters: int = 32,
    cg_tol: float = 1e-4,
    cg_maxiter: int = 800,
    chunk: int = 1024,
    jitter: float = 0.0,
    precond_rank=None,
    slq_probes: int = 64,
    mode: str = "auto",
    warm_start: bool = False,
    Z_logdet=None,
    Z_trace=None,
):
    """Host-callable value_and_grad(flat numpy) -> (float, float64 grad)
    over the matrix-free engine, in float32 on the device of the model's
    parameters.

    `jitter` is folded into the operator's noise (sn2 + jitter).
    `precond_rank` > 0 preconditions every solve with a rank-k pivoted
    Cholesky (0 disables it; None picks auto_precond_rank(n)). `mode`
    selects the operator (inference.iterative.choose_mode). Z_logdet
    (n, slq_probes) and Z_trace (n, probes) inject the probes; otherwise
    they are drawn from `seed`. The closure carries `.last_cg_iters`,
    `.last_rel_residual`, `.cg_tol` (the tolerance its solves are held
    to, after gemm_bf16's floor), `.precond_rank` and `.prev_sols`, the
    last evaluation's solutions [alpha | A^-1 Z_trace] (n, 1 + probes;
    None after a chol-mode one). Each call is a torch.profiler range,
    "iterative_fit.value_and_grad", holding the engine's "iterative.*"
    ranges (inference/iterative.py) and "iterative_fit.chain_rule" (the
    surrogate's backward, the gradient's copy to the host and the reads
    of the solve's stats); none sits inside a per-step loop, so an
    evaluation opens at most 7. An evaluation whose solve failed is
    NaN (inference.iterative.nlml_and_grad_iterative); `optim.fit`
    reports the unconverged ones.

    `warm_start` starts each CG solve from `.prev_sols`, at the cost of
    one more operator pass for its true residual. Consecutive
    line-search points are close, so A^-1 b barely moves and the solve
    saves iterations; the convergence test (relative to ||b||) is
    unchanged. The solver path then depends on the history:
    re-evaluating a point after another one agrees to the CG tolerance,
    not bit for bit."""
    if not supports_iterative(model):
        raise ValueError(
            "iterative engine supports only Sum([ExpAns, Bias]) + "
            f"Gaussian likelihood; got {model.kernel!r} / "
            f"{type(model.likelihood).__name__}")
    f32 = torch.float32
    device = model.pack().device
    kernel = model.kernel
    likelihood = model.likelihood
    expans = kernel.children[0]
    nk = kernel.n_params
    nl = likelihood.n_hypers
    warped = isinstance(likelihood, WarpedGaussian)
    Xd = torch.as_tensor(X, dtype=f32, device=device)
    yd = torch.as_tensor(y, dtype=f32, device=device)
    ymax = torch.max(yd)
    n = Xd.shape[0]
    Z_logdet, Z_trace = fit_probes(seed, n, probes, slq_probes, device,
                                   Z_logdet, Z_trace)

    @record_function("iterative_fit.value_and_grad")
    def value_and_grad(x_np: np.ndarray):
        flat = torch.tensor(np.asarray(x_np, np.float64), dtype=f32,
                            device=device, requires_grad=True)
        ep, bp = kernel.unpack(flat[:nk])
        lh = flat[nk:nk + nl]
        if warped:
            gy, lgpy = likelihood.effective_target(lh, yd, ymax)
        else:
            gy = yd
        sn2 = likelihood.noise_variance(lh) + jitter
        Xm = mapped_points(expans, ep, Xd)
        it_gp = IterativeGP(Xm=Xm.detach(), sigma=ep["Sigma"].detach(),
                            bias=bp["Sigma"].detach(), sn2=sn2.detach())
        val, (ds, db, dsn2, dXm), stats = nlml_and_grad_iterative(
            it_gp, gy.detach(), None, None, cg_tol=cg_tol,
            cg_maxiter=cg_maxiter, probes=probes,
            lanczos_iters=lanczos_iters, chunk=chunk,
            precond_rank=precond_rank, slq_probes=slq_probes, mode=mode,
            Z_logdet=Z_logdet, Z_trace=Z_trace,
            X_prev=value_and_grad.prev_sols if warm_start else None)
        value_and_grad.prev_sols = stats.sols
        with record_function("iterative_fit.chain_rule"):
            # the chain rule in one backward: Xm's map (angles, widths)
            # plus the direct sigma / bias / sn2 terms
            surrogate = (torch.sum(Xm * dXm) + ep["Sigma"] * ds
                         + bp["Sigma"] * db + sn2 * dsn2)
            if warped:
                # NLML_w = NLML(g(y; w); sn2(w)) - sum log g'(y; w), and
                # d(fit)/dw = alpha' dg/dw with alpha = A^-1 g(y) fixed
                # (A does not depend on w); sn2's chain rides sn2 * dsn2
                val = val - torch.sum(lgpy.detach())
                surrogate = (surrogate
                             + torch.dot(stats.alpha.detach(), gy)
                             - torch.sum(lgpy))
            (g,) = torch.autograd.grad(surrogate, flat)
            value_and_grad.last_cg_iters = int(stats.cg_iters)
            value_and_grad.last_rel_residual = float(stats.rel_residual)
            return float(val), g.detach().cpu().numpy().astype(np.float64)

    value_and_grad.last_cg_iters = None
    value_and_grad.last_rel_residual = None
    value_and_grad.prev_sols = None
    value_and_grad.cg_tol = _effective_cg_tol(
        cg_tol, choose_mode(n, mode, device))
    value_and_grad.precond_rank = (
        auto_precond_rank(n) if precond_rank is None else precond_rank)
    return value_and_grad
