"""End-to-end example: the reference's train/test workflow plus the
port's extensions (serving, Bayes, distributed). The counterpart of
examples/full_workflow.py.

    python -m gp_ss_ak_torch.examples.full_workflow [--device cpu]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from gp_ss_ak_torch.data import (
    MODE_SYMMETRIC,
    apply,
    prepare,
    read_data,
    unapply_y,
    write_data,
)
from gp_ss_ak_torch.examples import run, working_dtype
from gp_ss_ak_torch.model import default_model, save_model
from gp_ss_ak_torch.optim import fit
from gp_ss_ak_torch.serve import Predictor


def ore_body(n: int):
    """The example's synthetic ore body: n composites in [0, 500]^3 from
    numpy seed 0."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 500, size=(n, 3))
    y = 1.5 + np.sin(X @ np.array([0.01, 0.004, 0.02])) \
        + 0.05 * rng.normal(size=n)
    return X, y


def main(device="cuda", n: int = 300, n_train: int = 250, iters: int = 60,
         bayes_n: int = 80, n_samples: int = 80, n_warmup: int = 120,
         n_chains: int = 2, dtype=None) -> dict:
    """Train on the first n_train of n composites, write the model file,
    serve the rest, sample the hyperposterior on the first bayes_n
    standardized points; on a world of several ranks, also fit over the
    mesh. Returns the printed numbers (and the fitted model, its
    OptResult, the test predictions)."""
    dtype = dtype or working_dtype(device)
    X, y = ore_body(n)
    with tempfile.TemporaryDirectory() as work:
        train, test = (os.path.join(work, f"ex_{name}.txt")
                       for name in ("train", "test"))
        write_data(train, X[:n_train], y[:n_train])
        write_data(test, X[n_train:], y[n_train:])

        # --- train (symmetric standardization + ExpAns + Bias noise) ----
        Xtr, ytr = read_data(train)
        Xs, ys, stats = prepare(Xtr, ytr, MODE_SYMMETRIC)
        model, res = fit(default_model(input_dim=3, dtype=dtype,
                                       device=device), Xs, ys, iters=iters)
        save_model(model, os.path.join(work, "ex_model"))
        stats.save(os.path.join(work, "ex_model_Statistics.txt"))
        print(f"trained: -logL {res.trace[0]:.2f} -> {res.fun:.2f}")

        # --- serve ------------------------------------------------------
        Xte, yte = read_data(test)
    server = Predictor(model, Xs, ys)
    mu, var = server(apply(stats, Xte))
    yh = unapply_y(stats, mu)
    mse = float(np.mean((yh - yte) ** 2))
    print(f"test MSE {mse:.4f} (var {np.var(yte):.4f})")
    out = dict(model=model, res=res, mu=mu, var=var, yh=yh, mse=mse,
               var_y=float(np.var(yte)))

    # --- Bayesian hyperposterior ------------------------------------------
    from gp_ss_ak_torch.bayes import predictive_mixture, sample_hyperposterior

    Xb, yb = Xs[:bayes_n], ys[:bayes_n]
    theta, accept = sample_hyperposterior(model, Xb, yb, 0,
                                          n_samples=n_samples,
                                          n_warmup=n_warmup,
                                          n_chains=n_chains)
    mu_b, _ = predictive_mixture(model, Xb, yb, Xb, theta, thin=8)
    fit_mse = float(np.mean((mu_b.cpu().numpy() - yb) ** 2))
    out.update(theta=theta, accept=float(accept.mean()), bayes_mse=fit_mse)
    print(f"bayes: mean accept {out['accept']:.2f}, "
          f"posterior-mixed in-sample MSE {fit_mse:.4f}")

    # --- distributed (every rank of a launch) -----------------------------
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from gp_ss_ak_torch.parallel import fit_distributed, make_mesh

        mesh = make_mesh(device)
        _, dres = fit_distributed(default_model(3, dtype=dtype,
                                                device=device), Xs, ys, mesh,
                                  nb=32, iters=30)
        out["dist_fun"] = dres.fun
        print(f"distributed fit on {mesh.size} devices: "
              f"-logL -> {dres.fun:.2f}")
    return out


if __name__ == "__main__":
    sys.exit(run(main))
