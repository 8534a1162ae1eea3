"""The dense fit's objective evaluates in float64 on a float32 model.

`optim.make_value_and_grad`, which `fit(engine="dense")` and the CLI's
`train` call, takes the data and the point to float64
(`optim.api.OBJECTIVE_DTYPE`) whatever the model's dtype, and hands the
value and the gradient back rounded to the model's dtype. Held here, on
a float32 model at n = 1024 with sn2 from 1e-2 down to 1e-4, to the
benchmark's exact float64 reference (port_bench/reference/gp_dense.py:
its own standardization, a tiled Cholesky, A^-1 from the factor,
autograd of the Gram entries against W = A^-1 - alpha alpha').

Tolerances: the value to 1e-7 relative; the gradient to 1e-5 of
max(|g_ref| at the entry, the median |g_ref|), the benchmark's
`grad_rel`. The float32 arithmetic the objective had before
(`OBJECTIVE_DTYPE` set to float32) reads ~2e-4 on the CPU at this size,
and is asserted to fail it; on an H100 at N = 16384 it read up to 51.3
mid-fit (PERF.md, dense16k-fit).
"""

import numpy as np
import pytest
import torch

from gp_ss_ak_torch.cli import main as torch_main
from gp_ss_ak_torch.data import MODE_SYMMETRIC, prepare, write_data
from gp_ss_ak_torch.model import default_model, from_flat
from gp_ss_ak_torch.optim import api, fit, make_value_and_grad
from port_bench.reference import gp_dense as ref

# one intra-op thread per process: the suite runs on several workers
torch.set_num_threads(1)

N = 1024
VALUE_RTOL = 1e-7
GRAD_TOL = 1e-5


def problem(seed, sn2, n=N):
    """Raw composites of a smooth grade in a 300 m cube with noise, the
    port's standardization of them, and random hyperparameters around
    the benchmark's start with noise variance sn2, as float32 holds
    them (the point the float32 model evaluates)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 300.0, size=(n, 3))
    u = X / 150.0 - 1.0
    y = (1.2 + 0.6 * np.sin(1.7 * u[:, 0] + 0.4) * np.cos(1.3 * u[:, 1])
         + 0.4 * u[:, 2] + 0.05 * rng.normal(size=n))
    Xs, ys, _ = prepare(X, y, MODE_SYMMETRIC)
    theta = np.concatenate([rng.uniform(0.5, 1.8, 6),
                            rng.uniform(0.2, 0.6, 1), [0.6],
                            rng.uniform(0.05, 0.3, 1), [sn2]])
    theta = theta.astype(np.float32).astype(np.float64)
    return X, y, Xs, ys, theta


def errors(f, g, f_ref, g_ref):
    scale = np.maximum(np.abs(g_ref), np.median(np.abs(g_ref)))
    return abs(f - f_ref) / abs(f_ref), float(np.max(np.abs(g - g_ref)
                                                     / scale))


@pytest.mark.parametrize("seed,sn2", [(31, 1e-2), (32, 1e-3), (33, 1e-4)])
def test_float32_model_evaluates_in_float64(seed, sn2, monkeypatch):
    X, y, Xs, ys, theta = problem(seed, sn2)
    model = from_flat(["ExpAns", "Bias"], theta, theta[9:], 3,
                      torch.float32, "cpu")
    rXs, rys, _, _ = ref.standardize(X, y)
    f_ref, g_ref = ref.evaluate(torch.as_tensor(rXs), torch.as_tensor(rys),
                                theta, ref.F64, 256, 256)

    f, g = make_value_and_grad(model, Xs, ys)(theta)
    # handed back in float64, not rounded to the model's float32
    assert g.dtype == np.float64
    assert not np.array_equal(g.astype(np.float32), g)
    nlml_rel, grad_rel = errors(f, g, f_ref, g_ref)
    assert nlml_rel <= VALUE_RTOL and grad_rel <= GRAD_TOL, (nlml_rel,
                                                             grad_rel)

    # the old float32 arithmetic fails the same tolerance
    monkeypatch.setattr(api, "OBJECTIVE_DTYPE", torch.float32)
    f32, g32 = make_value_and_grad(model, Xs, ys)(theta)
    assert errors(f32, g32, f_ref, g_ref)[1] > GRAD_TOL


def test_dense_fit_records_float64_evaluations_and_returns_float32():
    X, y, Xs, ys, theta = problem(34, 3e-3, n=256)
    model = from_flat(["ExpAns", "Bias"], theta, theta[9:], 3,
                      torch.float32, "cpu")
    timing = {}
    fitted, res = fit(model, Xs, ys, iters=3, engine="dense",
                      timing=timing)
    assert fitted.pack().dtype == torch.float32
    evals = timing["evals"]
    # the start's evaluation counts in the first iteration's
    assert len(evals) == res.n_evals == sum(timing["evals_per_iter"])
    assert len(timing["evals_per_iter"]) == res.n_iters == 3
    assert all(np.isfinite(f) for _, f, _ in evals)
    vg = make_value_and_grad(model, Xs, ys)
    for x, f, g in evals[::2]:
        f2, g2 = vg(x)
        assert (f, g.tolist()) == (f2, g2.tolist())
    rXs, rys, _, _ = ref.standardize(X, y)
    x, f, g = evals[-1]
    f_ref, g_ref = ref.evaluate(torch.as_tensor(rXs), torch.as_tensor(rys),
                                x, ref.F64, 256, 256)
    nlml_rel, grad_rel = errors(f, g, f_ref, g_ref)
    assert nlml_rel <= VALUE_RTOL and grad_rel <= GRAD_TOL


def test_train_without_float64_writes_a_float32_model(tmp_path):
    rng = np.random.default_rng(35)
    X = rng.uniform(0.0, 300.0, size=(96, 3))
    y = np.sin(X[:, 0] / 60.0) + 0.05 * rng.normal(size=96)
    write_data(str(tmp_path / "train.txt"), X, y)
    path = str(tmp_path / "m")
    assert torch_main(["train", "--device", "cpu", "-#", "2",
                       str(tmp_path / "train.txt"), path]) == 0
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("Hyperparams_likelihood="):
                vals.append(float(line.split("=")[1]))
            elif line and "=" not in line and not line.startswith("#"):
                vals += [float(t) for t in line.split()]
    start = default_model(3, dtype=torch.float32, device="cpu").pack()
    assert len(vals) == start.numel()
    # every hyperparameter as float32 holds it, and the fit moved them
    assert all(float(np.float32(v)) == v for v in vals)
    assert not np.allclose(vals, start.numpy())
