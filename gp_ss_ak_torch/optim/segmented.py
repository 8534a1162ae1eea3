"""The segmented matrix-free evaluator's entry point: the fused stream
evaluator (optim/iterative_fit.py) with a warm start, under the JAX
package's name and defaults. Port of gp_ss_ak_tpu/optim/segmented.py.

In the JAX package the segments exist to split one device dispatch: a
fused evaluation is a single XLA program of up to `cg_maxiter` streamed
Gram passes, which a worker's watchdog may kill, so that module runs CG
and Lanczos as bounded segments from the host. The port's fused
evaluator is a host loop already: its CG reads the host once per
iteration (inference.iterative.bcg_segment) and its Lanczos steps are
launched one at a time. Bounded segments would give the same bits as
one uninterrupted loop (the solver state is the loop carry), so
`seg_iters` has no counterpart, and neither have the tile sizes (tm,
tn) and `interpret`: K3 picks its own tiles and CPU tensors take its
plain version. Passing one is a TypeError.

What the JAX module adds to its fused evaluator, and this one keeps, is
the warm start: each CG solve starts from the previous evaluation's
solutions, carried into the new whitening basis as x0 = P^(1/2) x_prev
(make_iterative_value_and_grad(warm_start=True)). A warm start from
non-finite solutions starts cold (inference.iterative.
nlml_and_grad_iterative), where the JAX package's stays NaN.

The probes come from `optim.iterative_fit.fit_probes` (torch Generators
seeded from `seed`), as the fused evaluator draws them, or are injected
(Z_logdet=, Z_trace=).
"""

from __future__ import annotations

from gp_ss_ak_torch.inference.iterative import auto_precond_rank
from gp_ss_ak_torch.inference.likelihoods import Gaussian
from gp_ss_ak_torch.model import GPModel
from gp_ss_ak_torch.optim.iterative_fit import (
    make_iterative_value_and_grad,
    supports_iterative,
)


def make_segmented_value_and_grad(
    model: GPModel,
    X,
    y,
    seed: int = 0,
    probes: int = 8,
    lanczos_iters: int = 16,
    cg_tol: float = 1e-3,
    cg_maxiter: int = 800,
    chunk: int = 1024,
    jitter: float = 0.0,
    precond_rank=None,
    slq_probes: int = 32,
    warm_start: bool = True,
    Z_logdet=None,
    Z_trace=None,
):
    """make_iterative_value_and_grad(mode="stream",
    warm_start=warm_start) with the JAX segmented evaluator's defaults
    (those of its large-N stream runs, benchmarks/large_n.py
    STREAM_OPTS) and its checks: the flagship model with the plain
    Gaussian likelihood, and a whitened solve (`precond_rank` None picks
    auto_precond_rank(n); 0 is refused)."""
    if not (supports_iterative(model)
            and isinstance(model.likelihood, Gaussian)):
        raise ValueError(
            "segmented engine supports only Sum([ExpAns, Bias]) + "
            "plain Gaussian likelihood (the fused evaluator also "
            f"handles WarpedGaussian); got {model.kernel!r} / "
            f"{type(model.likelihood).__name__}")
    n = len(y)
    if not (auto_precond_rank(n) if precond_rank is None else precond_rank):
        raise ValueError("segmented evaluator requires precond_rank > 0")
    return make_iterative_value_and_grad(
        model, X, y, seed=seed, probes=probes, lanczos_iters=lanczos_iters,
        cg_tol=cg_tol, cg_maxiter=cg_maxiter, chunk=chunk, jitter=jitter,
        precond_rank=precond_rank, slq_probes=slq_probes, mode="stream",
        warm_start=warm_start, Z_logdet=Z_logdet, Z_trace=Z_trace)
