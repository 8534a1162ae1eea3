"""Distributed training + serving walkthrough: the row-split exact fit
and predict, then the ring's posterior mean on the same model. The
counterpart of examples/distributed_workflow.py.

A plain process is a world of one rank (NCCL on the card, gloo on the
CPU); under torchrun (or parallel.launch_local) every rank runs it on
its own row block.

    python -m gp_ss_ak_torch.examples.distributed_workflow [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gp_ss_ak_torch.examples import run, working_dtype
from gp_ss_ak_torch.model import default_model
from gp_ss_ak_torch.parallel import (
    fit_distributed,
    make_dist_predict,
    make_mesh,
    make_ring_posterior_mean,
    shard_training_data,
)


def main(device="cuda", n: int = 512, iters: int = 30, nb: int = 64,
         dtype=None) -> dict:
    """fit_distributed (exact gradient) on n synthetic 3-D points, the
    distributed predict at 8 queries, and the ring's posterior mean
    there, which must agree with it within 1e-3. Returns the fit's
    OptResult and both means."""
    dtype = dtype or working_dtype(device)
    # synthetic 3-D ore-grade-like problem
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 10, (n, 3))
    y = np.sin(0.7 * X[:, 0]) + 0.5 * np.cos(0.5 * X[:, 1]) + 0.1 * X[:, 2]

    mesh = make_mesh(device)
    print(f"mesh: {mesh.size} ranks over {mesh.backend}")

    # --- distributed fit: row-split Gram + block Cholesky per eval -----
    model = default_model(input_dim=3, dtype=dtype, device=mesh.device)
    fitted, res = fit_distributed(model, X, y, mesh, nb=nb, iters=iters,
                                  grad_mode="exact")
    print(f"fit: NLML {res.trace[0]:.2f} -> {res.fun:.2f} "
          f"({res.n_iters} iters)")

    # --- distributed prediction ----------------------------------------
    Xs, ys, ntrue, _ = shard_training_data(
        mesh, torch.as_tensor(X, dtype=dtype),
        torch.as_tensor(y, dtype=dtype), nb=nb)
    predict = make_dist_predict(fitted.kernel, fitted.likelihood, mesh,
                                n=ntrue, nb=nb)
    Xq = torch.as_tensor(rng.uniform(0, 10, (8, 3)), dtype=dtype,
                         device=mesh.device)
    mu, _ = predict(fitted.pack(), Xs, ys, Xq)
    mu = mu.cpu().numpy()
    print("posterior mean:", np.round(mu, 3))

    # --- ring path: K never exists, not even as a row panel ------------
    ring_mean = make_ring_posterior_mean(fitted.kernel, mesh, n=ntrue,
                                         tol=1e-6)
    mu_ring, cg_iters, resid = ring_mean(fitted.pack(), Xs, ys, Xq)
    mu_ring = mu_ring.cpu().numpy()
    print(f"ring mean (CG {int(cg_iters)} iters): {np.round(mu_ring, 3)}")
    if not np.allclose(mu, mu_ring, atol=1e-3):
        raise AssertionError(f"distributed and ring means differ by "
                             f"{np.abs(mu - mu_ring).max():.3e}")
    print("distributed == ring: OK")
    return dict(res=res, mu=mu, mu_ring=mu_ring, cg_iters=int(cg_iters),
                resid=float(resid))


if __name__ == "__main__":
    sys.exit(run(main))
