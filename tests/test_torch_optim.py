"""Port parity: the host optimizers and the dense `fit`.

The optimizers are numpy-only copies of gp_ss_ak_tpu/optim: on the same
numpy objective they must take the same steps, so their results are
held EQUAL (iterates, trace, counts, stop reason) to the JAX package's.

`fit(engine="dense")` runs in float64 on the CPU at n = 128 in both
packages: the same optimizer on objectives whose values and gradients
agree to ~1e-12 (tests/test_torch_train_grad.py), so it takes the same
path. Held: the same stop reason, iterations and evaluations; the
hyperparameters within rtol 1e-6 (round-off grows along the trajectory,
see the BFGS line searches at ~10 evaluations an iteration).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_tpu.optim as jo
import gp_ss_ak_torch.model as tm
import gp_ss_ak_torch.optim as to
from gp_ss_ak_tpu.optim import linesearch as jls
from gp_ss_ak_torch.optim import linesearch as tls

CPU = torch.device("cpu")

# one intra-op thread per process: the suite runs on several workers at
# once, and torch's default (a thread per core in every worker)
# oversubscribes the cores and slows these small CPU ops many times over
torch.set_num_threads(1)


def rosen(x):
    """A shifted Rosenbrock inside the box [1e-4, 6]^p, NaN beyond x0 > 5
    (a failed Cholesky stands in): the optimizers must reject those
    steps."""
    x = np.asarray(x, np.float64)
    if x[0] > 5.0:
        return float("nan"), np.full_like(x, np.nan)
    a, b = x[:-1] - 1.0, x[1:] - 1.5
    f = np.sum(100.0 * (b - a * a) ** 2 + (1 - a) ** 2)
    g = np.zeros_like(x)
    g[:-1] += -400.0 * a * (b - a * a) - 2.0 * (1 - a)
    g[1:] += 200.0 * (b - a * a)
    return float(f), g


def same_result(rt, rj):
    np.testing.assert_array_equal(rt.x, rj.x)
    assert (rt.fun, rt.n_iters, rt.n_evals, rt.converged, rt.stop_reason) \
        == (rj.fun, rj.n_iters, rj.n_evals, rj.converged, rj.stop_reason)
    assert rt.trace == rj.trace


@pytest.mark.parametrize("make", [
    lambda m: m.LBFGSB(maxiter=60),
    lambda m: m.LBFGSB(maxiter=60, tol=1e-6, tol_iters=2),
    lambda m: m.DenseBFGS(maxiter=40),
    lambda m: m.DenseBFGS(maxiter=40, line_search="interp"),
    lambda m: m.DenseBFGS(maxiter=40, line_search="potra"),
    lambda m: m.SCG(maxiter=60),
], ids=["lbfgsb", "lbfgsb_tol", "bfgs_wolfe", "bfgs_interp", "bfgs_potra",
        "scg"])
def test_optimizers_take_the_jax_packages_steps(make):
    x0 = np.array([4.5, 0.3, 2.0, 3.7])
    seen_j, seen_t = [], []
    rj = make(jo).minimize(rosen, x0,
                           callback=lambda it, x, f: seen_j.append((it, f)))
    rt = make(to).minimize(rosen, x0,
                           callback=lambda it, x, f: seen_t.append((it, f)))
    same_result(rt, rj)
    assert seen_t == seen_j and rt.stop_reason


def test_potra_shi_line_search_matches_jax():
    x = np.array([2.0, 1.0, 3.0])
    f0, g0 = rosen(x)
    d = -g0 / np.linalg.norm(g0)
    lo, hi = np.full(3, 1e-4), np.full(3, 6.0)
    outs = [m.potra_shi_search(rosen, x, f0, g0, d, lo, hi)
            for m in (jls, tls)]
    assert repr(outs[0]) == repr(outs[1])


def models(seed=0):
    rng = np.random.default_rng(seed)
    mj = jm.default_model(3)
    flat = np.asarray(mj.pack()) * rng.uniform(0.9, 1.1, size=mj.n_params)
    mj = mj.unpack(jnp.asarray(flat))
    mt = tm.default_model(3, device=CPU).unpack(torch.from_numpy(flat.copy()))
    return mj, mt


def data(n=128, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 3))
    y = np.sin(X @ np.array([3.0, 1.0, 2.0])) + 0.05 * rng.normal(size=n)
    return X, y


@pytest.mark.parametrize("optimizer,iters", [("LBFGS", 25), ("BFGS", 6),
                                             ("SCG", 12)])
def test_dense_fit_matches_jax(optimizer, iters):
    mj, mt = models()
    X, y = data()
    fj, rj = jo.fit(mj, X, y, optimizer=optimizer, iters=iters,
                    engine="dense")
    ft, rt = to.fit(mt, X, y, optimizer=optimizer, iters=iters,
                    engine="dense")
    assert (rt.stop_reason, rt.n_iters, rt.n_evals) == \
        (rj.stop_reason, rj.n_iters, rj.n_evals)
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-6)
    assert rt.fun == pytest.approx(rj.fun, rel=1e-8)
    np.testing.assert_allclose(ft.pack().numpy(), np.asarray(fj.pack()),
                               rtol=1e-6)
    assert (ft.num_data, ft.input_dim) == (fj.num_data, fj.input_dim)
    assert ft.pack().dtype == torch.float64


def test_fit_timing_has_no_double_count():
    import time

    _, mt = models(seed=2)
    X, y = data(n=48)
    timing = {}
    calls = []
    t_before = time.perf_counter()
    to.fit(mt, X, y, iters=3, engine="dense", timing=timing,
           callback=lambda *a: calls.append(a))
    assert timing["n_evals"] == len(timing["eval_s"]) >= 4
    assert timing["eval_s_sum"] == pytest.approx(sum(timing["eval_s"]))
    # pre_first_eval_s starts where the backend touch ends (the JAX
    # package counts the touch in both, api.py:130-131, 298)
    first_start = timing["eval_spans"][0][0]
    assert timing["backend_touch_s"] >= 0 and timing["pre_first_eval_s"] >= 0
    assert timing["backend_touch_s"] + timing["pre_first_eval_s"] \
        <= first_start - t_before
    assert set(timing) >= {"backend_touch_s", "eval_s_first",
                           "eval_s_steady_median", "post_last_eval_s"}
    assert len(calls) == 3


def test_fit_refuses_what_is_not_ported():
    _, mt = models()
    X, y = data(n=16)
    with pytest.raises(NotImplementedError, match="optim/segmented.py"):
        to.fit(mt, X, y, iters=1, engine="iterative",
               engine_opts={"segmented": True})
    with pytest.raises(ValueError, match="engine"):
        to.fit(mt, X, y, iters=1, engine="ring")
    with pytest.raises(ValueError, match="optimiser"):
        to.fit(mt, X, y, iters=1, optimizer="Nelder")


def test_auto_engine_stays_dense_off_the_card(monkeypatch):
    # past DENSE_MAX_N auto picks the matrix-free engine only for a model
    # on a CUDA device; on the CPU it warns and stays dense, as the JAX
    # package does off the TPU
    from gp_ss_ak_torch.optim import api

    monkeypatch.setattr(api, "DENSE_MAX_N", 20)

    def refuse(*a, **k):
        raise AssertionError("auto picked the iterative engine")

    monkeypatch.setattr(api, "make_iterative_value_and_grad", refuse)
    _, mt = models()
    X, y = data(n=32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _, res = api.fit(mt, X, y, iters=2)
    assert any("picked the dense path" in str(x.message) for x in w)
    assert np.isfinite(res.fun)
