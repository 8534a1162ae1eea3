"""Ring-distributed training walkthrough, the route past the row-panel
wall. The counterpart of examples/ring_workflow.py.

fit_distributed (distributed_workflow) holds each rank's (n_local, N)
row panel of the kernel matrix; at N ~ 10^5 and beyond even the panel
does not fit. The ring route never holds more than an (n_local,
TILE_CHUNK) tile: X blocks rotate around the ranks, every solve is a
ring batched CG whitened by a ring-built pivoted Cholesky, and the
logdet comes from stochastic Lanczos on the whitened operator.

    python -m gp_ss_ak_torch.examples.ring_workflow [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gp_ss_ak_torch.examples import run, working_dtype
from gp_ss_ak_torch.model import default_model
from gp_ss_ak_torch.parallel import (
    fit_ring,
    make_mesh,
    make_ring_posterior_mean,
    shard_training_data,
)


def main(device="cuda", n: int = 512, iters: int = 25, nb: int = 16,
         precond_rank: int = 48, probes: int = 8, slq_probes: int = 16,
         lanczos_iters: int = 24, dtype=None) -> dict:
    """fit_ring on n noisy points of a smooth 3-D function, then the
    ring's posterior mean at 64 held-out points, whose MSE against the
    noise-free function must stay below 0.1. Returns the fit's OptResult,
    the MSE and the posterior mean's CG iterations and relative
    residual."""
    dtype = dtype or working_dtype(device)
    d = 3
    rng = np.random.default_rng(3)
    X = rng.uniform(-2.0, 2.0, size=(n, d))
    y = np.sin(2.0 * X[:, 0]) + 0.5 * np.cos(X[:, 1]) \
        + 0.05 * rng.standard_normal(n)

    mesh = make_mesh(device)
    model = default_model(input_dim=d, dtype=dtype, device=mesh.device)

    # --- train: L-BFGS-B over the ring matrix-free NLML ----------------
    fitted, res = fit_ring(model, X, y, mesh, nb=nb, iters=iters,
                           precond_rank=precond_rank, probes=probes,
                           slq_probes=slq_probes,
                           lanczos_iters=lanczos_iters, verbose=0)
    print(f"ring fit: NLML {res.trace[0]:.2f} -> {res.fun:.2f} "
          f"in {res.n_iters} iters / {res.n_evals} evals")

    # --- predict: ring CG posterior mean -------------------------------
    Xq = rng.uniform(-2.0, 2.0, size=(64, d))
    Xs, ys, ntrue, _ = shard_training_data(
        mesh, torch.as_tensor(X, dtype=dtype),
        torch.as_tensor(y, dtype=dtype), nb=nb)
    pm = make_ring_posterior_mean(fitted.kernel, mesh, n=ntrue, tol=1e-8)
    mu, it, resid = pm(fitted.pack(), Xs, ys,
                       torch.as_tensor(Xq, dtype=dtype, device=mesh.device))
    truth = np.sin(2.0 * Xq[:, 0]) + 0.5 * np.cos(Xq[:, 1])
    mse = float(np.mean((mu.cpu().numpy() - truth) ** 2))
    print(f"ring posterior mean on 64 held-out points: mse {mse:.4f} "
          f"(cg iters {int(it)})")
    if not mse < 0.1:
        raise AssertionError(f"ring posterior mean MSE {mse}")
    print("ok")
    return dict(res=res, mse=mse, cg_iters=int(it),
                cg_rel=float(resid) / float(np.linalg.norm(y)))


if __name__ == "__main__":
    sys.exit(run(main))
