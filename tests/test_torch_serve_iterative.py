"""Port parity: the matrix-free server (serve.IterativePredictor), CPU.

Both servers run in float32 whatever the model's dtype; the JAX one
streams its Gram through the Pallas kernel in interpret mode, the port's
through the plain version of K3 (ops/matvec.py). The two CG runs see
float32 round-off in another order, so they agree at the solve
tolerance, not bitwise: mu within rtol/atol 2e-3 and var within rtol
5e-3, atol 5e-4 (the JAX test's own bounds against the dense
Predictor, tests/test_utils_serve.py), and the setup's iteration count
within 2 of JAX's. Cut short at 6 CG iterations the solves are
"unconverged" (inference.iterative.solve_state) and keep JAX's
predictions at those tolerances, with one warning per server; with no
iteration they "fail" and the port's means and variances are NaN where
JAX's stay finite.
"""

from dataclasses import replace

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_tpu.serve as jserve
import gp_ss_ak_torch.model as tm
import gp_ss_ak_torch.serve as tserve
from gp_ss_ak_tpu.inference import WarpedGaussian as JWarped
from gp_ss_ak_torch.inference import WarpedGaussian as TWarped
from gp_ss_ak_torch.inference.iterative import UnconvergedSolveWarning
from gp_ss_ak_torch.ops import matvec, pairwise

CPU = torch.device("cpu")


def make(n=384, d=3, seed=7, dtype=torch.float32):
    """The JAX test's data (test_utils_serve.py) and one flagship model
    for both packages from one flat numpy vector."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, d))
    y = np.sin(X @ np.array([3.0, 1.0, 2.0])[:d])
    mj = jm.default_model(input_dim=d, dtype=jnp.float32)
    flat = np.asarray(mj.pack(), np.float64)
    nk = mj.kernel.n_params
    mt = tm.from_flat(["ExpAns", "Bias"], flat[:nk], flat[nk:], d, dtype,
                      CPU)
    return mj, mt, X, y


@pytest.mark.parametrize("d", [3, 2], ids=["d3", "d2-padded"])
def test_matches_jax_iterative_predictor(d):
    mj, mt, X, y = make(d=d)
    Xs = np.random.default_rng(8).uniform(-1, 1, (64, d))
    kw = dict(precond_rank=64, cg_tol=1e-6, chunk=128)
    sj = jserve.IterativePredictor(mj, X, y, **kw)
    k1, k3 = pairwise.launches, matvec.launches
    st = tserve.IterativePredictor(mt, X, y, **kw)
    mu_j, var_j = sj(Xs, batch_size=64)
    mu_t, var_t = st(Xs, batch_size=64)
    assert (pairwise.launches, matvec.launches) == (k1, k3)   # CPU: plain
    assert mu_t.dtype == np.float32 and mu_t.shape == (64,)
    np.testing.assert_allclose(mu_t, mu_j, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(var_t, var_j, rtol=5e-3, atol=5e-4)
    assert abs(st.setup_cg_iters - sj.setup_cg_iters) <= 2
    assert st.setup_cg_iters > 0 and st.last_cg_iters > 0
    assert st.precond_rank == 64 and st.alpha.shape == (384,)


def test_matches_dense_predictor_in_float64():
    # the float64 model is served in float32, like the JAX class
    _, mt, X, y = make(dtype=torch.float64)
    Xs = np.random.default_rng(8).uniform(-1, 1, (64, 3))
    dense = tserve.Predictor(mt, X, y)
    it = tserve.IterativePredictor(mt, X, y, precond_rank=64, cg_tol=1e-6,
                                   chunk=128)
    assert it.alpha.dtype == torch.float32
    mu_d, var_d = dense(Xs)
    mu_i, var_i = it(Xs, batch_size=64)
    np.testing.assert_allclose(mu_i, mu_d, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(var_i, var_d, rtol=5e-3, atol=5e-4)


def test_default_rank_is_auto():
    _, mt, X, y = make(n=200)
    it = tserve.IterativePredictor(mt, X, y, cg_tol=1e-5, chunk=64)
    assert it.precond_rank == 64          # auto_precond_rank(200)


def test_mean_only_and_batching():
    _, mt, X, y = make(256)
    Xs = np.random.default_rng(9).uniform(-1, 1, (70, 3))
    it = tserve.IterativePredictor(mt, X, y, precond_rank=32, cg_tol=1e-6,
                                   chunk=128)
    mu1, var1 = it(Xs, batch_size=32)       # padded tail batch
    mu2, none = it(Xs, batch_size=128, mean_only=True)
    assert none is None
    np.testing.assert_allclose(mu1, mu2, rtol=1e-5, atol=1e-6)
    assert var1.shape == (70,)


def test_var_solve_column_chunking_is_invisible(monkeypatch):
    """SOLVE_COL_BLOCK is a pure memory knob: chunked variance solves
    with a padded tail block == one whole-batch solve."""
    _, mt, X, y = make(256)
    Xs = np.random.default_rng(12).uniform(-1, 1, (48, 3))
    it = tserve.IterativePredictor(mt, X, y, precond_rank=32, cg_tol=1e-8,
                                   chunk=128)
    _mu, var_whole = it(Xs, batch_size=64)
    monkeypatch.setattr(tserve.IterativePredictor, "SOLVE_COL_BLOCK", 20)
    _mu2, var_chunked = it(Xs, batch_size=64)  # 64 -> 4 blocks,
    # last padded from 4 to 20 zero columns
    # block-grouped CG stops per block: agreement is at the float32
    # solve floor, not bitwise
    np.testing.assert_allclose(var_chunked, var_whole, rtol=1e-3,
                               atol=1e-5)


def test_rank_zero_takes_plain_cg():
    mj, mt, X, y = make(128)
    Xs = np.random.default_rng(13).uniform(-1, 1, (16, 3))
    kw = dict(precond_rank=0, cg_tol=1e-6, chunk=64)
    mu_j, var_j = jserve.IterativePredictor(mj, X, y, **kw)(Xs, 16)
    mu_t, var_t = tserve.IterativePredictor(mt, X, y, **kw)(Xs, 16)
    np.testing.assert_allclose(mu_t, mu_j, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(var_t, var_j, rtol=5e-3, atol=5e-4)


def test_rejects_non_flagship():
    model = tm.default_model(3, kernel_names=["RBF"], device="cpu")
    with pytest.raises(ValueError):
        tserve.IterativePredictor(model, np.zeros((8, 3)), np.zeros(8))


def test_warped_is_not_ported():
    # asserts that the warped server IS ported: a WarpedGaussian model
    # on skewed positive targets (tests/test_utils_serve.py:227-261)
    # agrees with JAX's IterativePredictor at its tolerances, and the
    # warped mean_only mean equals the full call's
    mj, mt, X, y = make(320)
    lh = [0.2, 0.5, 0.1, -1.5]
    mj = replace(mj, likelihood=JWarped("tanh1", 1),
                 lik_hypers=jnp.asarray(lh, jnp.float32))
    mt = replace(mt, likelihood=TWarped("tanh1", 1),
                 lik_hypers=torch.tensor(lh, dtype=torch.float32))
    y = np.exp(0.8 * y)
    Xs = np.random.default_rng(11).uniform(-1, 1, (48, 3))
    kw = dict(precond_rank=64, cg_tol=1e-7, chunk=128)
    sj = jserve.IterativePredictor(mj, X, y, **kw)
    st = tserve.IterativePredictor(mt, X, y, **kw)
    assert st.warped and float(st.y_max) == np.float32(y.max())
    mu_j, var_j = sj(Xs, batch_size=64)
    mu_t, var_t = st(Xs, batch_size=64)
    np.testing.assert_allclose(mu_t, mu_j, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(var_t, var_j, rtol=5e-3, atol=5e-4)
    it_var = st.last_cg_iters
    mu_o, none = st(Xs, batch_size=64, mean_only=True)
    assert none is None and st.last_cg_iters == it_var
    np.testing.assert_allclose(mu_o, mu_t, rtol=1e-6, atol=1e-7)
    # latent=True: the unwarped Gaussian on g(y), as JAX's
    lat_j = sj(Xs, batch_size=64, latent=True)
    lat_t = st(Xs, batch_size=64, latent=True)
    for a, b in zip(lat_t, lat_j):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=2e-3)
    assert not np.allclose(lat_t[0], mu_t, rtol=1e-2)


def test_solves_cut_short_warn_once_or_give_nan():
    mj, mt, X, y = make()
    Xs = np.random.default_rng(8).uniform(-1, 1, (64, 3))
    kw = dict(precond_rank=64, cg_tol=1e-6, chunk=128, cg_maxiter=6)
    sj = jserve.IterativePredictor(mj, X, y, **kw)
    mu_j, var_j = sj(Xs, batch_size=32)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        st = tserve.IterativePredictor(mt, X, y, **kw)
        mu_t, var_t = st(Xs, batch_size=32)
    assert [w.category for w in seen] == [UnconvergedSolveWarning]
    assert str(seen[0].message).startswith("IterativePredictor (setup)")
    assert 1e-6 < st.setup_rel_residual < 1
    assert 1e-6 < st.last_rel_residual < 1
    assert st.setup_cg_iters == st.last_cg_iters == 6
    np.testing.assert_allclose(mu_t, mu_j, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(var_t, var_j, rtol=5e-3, atol=5e-4)

    kw["cg_maxiter"] = 0
    mu_j, var_j = jserve.IterativePredictor(mj, X, y, **kw)(Xs,
                                                          batch_size=64)
    st = tserve.IterativePredictor(mt, X, y, **kw)
    mu_t, var_t = st(Xs, batch_size=64)
    assert st.setup_rel_residual == st.last_rel_residual == 1.0
    assert np.isnan(mu_t).all() and np.isnan(var_t).all()
    assert np.isfinite(mu_j).all() and np.isfinite(var_j).all()
