"""Bayesian hyperposterior walkthrough: NUTS over the GP hypers,
convergence diagnostics, and predictive mixing. The counterpart of
examples/bayes_workflow.py.

    python -m gp_ss_ak_torch.examples.bayes_workflow [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from gp_ss_ak_torch.bayes import (
    predictive_mixture,
    sample_hyperposterior,
    summarize,
)
from gp_ss_ak_torch.examples import run, working_dtype
from gp_ss_ak_torch.model import default_model
from gp_ss_ak_torch.parallel import make_mesh


def main(device="cuda", n: int = 40, n_samples: int = 150,
         n_warmup: int = 150, n_chains: int = 4, dtype=None) -> dict:
    """NUTS with n_chains chains (split over the ranks of the mesh) on n
    points of a noisy sine, its split R-hat and ESS, and the predictive
    mean and sd mixed over every 5th sample at 9 queries. Returns the
    samples, the acceptance statistics and the printed numbers."""
    dtype = dtype or working_dtype(device)
    rng = np.random.default_rng(1)
    X = np.linspace(-1, 1, n).reshape(-1, 1)
    y = np.sin(3 * X[:, 0]) + 0.1 * rng.standard_normal(n)

    model = default_model(input_dim=1, dtype=dtype, device=device)

    # chains split over the mesh (embarrassingly parallel axis)
    mesh = make_mesh(device)
    theta, accept = sample_hyperposterior(
        model, X, y, 0, n_samples=n_samples, n_warmup=n_warmup,
        n_chains=n_chains, sampler="nuts", mesh=mesh)

    diag = summarize(theta.cpu().numpy())
    print("max R-hat:", float(np.max(diag["rhat"])))
    print("min bulk ESS:", float(np.min(diag["ess"])),
          "| min tail ESS:", float(np.min(diag["ess_tail"])))

    Xq = np.linspace(-1, 1, 9).reshape(-1, 1)
    mu, var = predictive_mixture(model, X, y, Xq, theta, thin=5)
    mu, var = mu.cpu().numpy(), var.cpu().numpy()
    print("mixed predictive mean:", np.round(mu, 3))
    print("mixed predictive sd:  ", np.round(np.sqrt(var), 3))
    return dict(theta=theta, accept=accept, diag=diag, mu=mu, var=var)


if __name__ == "__main__":
    sys.exit(run(main))
