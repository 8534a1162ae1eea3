"""Port parity: exact Gaussian inference (gp_ss_ak_torch.inference vs
gp_ss_ak_tpu.inference), float64 on the CPU.

The flagship model runs the JAX side with fused=True (Pallas K1 in
interpret mode); the port takes K1's plain version on CPU tensors. At
n=40 with moderate noise the two agree to rtol 1e-10; the golden
fixture is held to tests/test_golden.py's tolerances."""

import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.inference as ji
import gp_ss_ak_tpu.model as jm
import gp_ss_ak_torch.inference as ti
import gp_ss_ak_torch.model as tm
from gp_ss_ak_tpu.data import Statistics, apply, read_data, unapply_var, \
    unapply_y

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RTOL, ATOL = 1e-10, 1e-12
F64 = torch.float64
CPU = torch.device("cpu")


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def setup(kernels, d, n=40, m=13, seed=0):
    """Same model and data for both packages."""
    rng = np.random.default_rng(seed)
    mj = jm.default_model(d, kernel_names=kernels)
    flat = np.asarray(mj.pack()) * rng.uniform(0.8, 1.2, size=mj.n_params)
    mj = mj.unpack(jnp.asarray(flat))
    names = [type(c).__name__ for c in mj.kernel.children]
    names = ["Exp" if n == "Exponential" else n for n in names]
    nk = mj.kernel.n_params
    mt = tm.from_flat(names, flat[:nk], flat[nk:], d, F64, CPU)
    X = rng.uniform(-1.0, 1.0, size=(n, d)) + 2.0
    y = np.sin(2.0 * X[:, 0]) + 0.1 * rng.normal(size=n)
    Xs = rng.uniform(-1.0, 1.0, size=(m, d)) + 2.0
    return mj, mt, X, y, Xs


CASES = [(None, 3), (None, 4), (["RBF"], 3), (["Exp", "White"], 4)]
IDS = ["flagship-3d", "flagship-4d", "rbf+bias", "exp+white+bias"]


@pytest.mark.parametrize("kernels,d", CASES, ids=IDS)
def test_factorize_and_nlml_match_jax(kernels, d):
    mj, mt, X, y, _ = setup(kernels, d)
    pj = ji.factorize(mj.kernel, mj.kernel_params, mj.lik_hypers,
                      jnp.asarray(X), jnp.asarray(y), mj.likelihood,
                      fused=True)
    pt = ti.factorize(mt.kernel, mt.kernel_params, mt.lik_hypers, t64(X),
                      t64(y), mt.likelihood)
    np.testing.assert_allclose(pt.chol.numpy(), np.asarray(pj.chol),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pt.alpha.numpy(), np.asarray(pj.alpha),
                               rtol=RTOL, atol=ATOL)
    vj = float(ji.nlml(mj.kernel, mj.kernel_params, mj.lik_hypers,
                       jnp.asarray(X), jnp.asarray(y), mj.likelihood,
                       fused=True))
    vt = float(ti.nlml(mt.kernel, mt.kernel_params, mt.lik_hypers, t64(X),
                       t64(y), mt.likelihood))
    assert vt == pytest.approx(vj, rel=RTOL)


@pytest.mark.parametrize("full_cov", [False, True], ids=["diag", "full"])
@pytest.mark.parametrize("kernels,d", CASES, ids=IDS)
def test_posterior_mean_var_match_jax(kernels, d, full_cov):
    mj, mt, X, y, Xs = setup(kernels, d, seed=1)
    pj = ji.factorize(mj.kernel, mj.kernel_params, mj.lik_hypers,
                      jnp.asarray(X), jnp.asarray(y), mj.likelihood,
                      fused=True)
    pt = ti.factorize(mt.kernel, mt.kernel_params, mt.lik_hypers, t64(X),
                      t64(y), mt.likelihood)
    outj = ji.posterior_mean_var(mj.kernel, mj.kernel_params, mj.lik_hypers,
                                 jnp.asarray(X), pj, jnp.asarray(Xs),
                                 mj.likelihood, full_cov=full_cov,
                                 fused=True)
    outt = ti.posterior_mean_var(mt.kernel, mt.kernel_params, mt.lik_hypers,
                                 t64(X), pt, t64(Xs), mt.likelihood,
                                 full_cov=full_cov)
    assert len(outt) == len(outj)
    for a, b in zip(outt, outj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    assert (outt[1] > 0).all()


@pytest.mark.parametrize("kernels,d", CASES[:1] + CASES[2:3],
                         ids=[IDS[0], IDS[2]])
def test_predict_matches_jax(kernels, d):
    mj, mt, X, y, Xs = setup(kernels, d, seed=2)
    muj, varj = ji.predict(mj.kernel, mj.kernel_params, mj.lik_hypers,
                           jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xs),
                           mj.likelihood, fused=True)
    mut, vart = ti.predict(mt.kernel, mt.kernel_params, mt.lik_hypers,
                           t64(X), t64(y), t64(Xs), mt.likelihood)
    np.testing.assert_allclose(mut.numpy(), np.asarray(muj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(vart.numpy(), np.asarray(varj), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kernels,d", CASES[:1] + CASES[2:3],
                         ids=[IDS[0], IDS[2]])
def test_indefinite_A_gives_nan_nlml_in_both(kernels, d):
    mj, mt, X, y, _ = setup(kernels, d, seed=3)
    mj = replace(mj, lik_hypers=jnp.asarray([-5.0]))
    mt = replace(mt, lik_hypers=t64([-5.0]))
    vj = float(ji.nlml(mj.kernel, mj.kernel_params, mj.lik_hypers,
                       jnp.asarray(X), jnp.asarray(y), mj.likelihood,
                       fused=True))
    vt = float(ti.nlml(mt.kernel, mt.kernel_params, mt.lik_hypers, t64(X),
                       t64(y), mt.likelihood))
    assert np.isnan(vj) and np.isnan(vt)


class TestGolden:
    """tests/golden through the port (same tolerances as test_golden)."""

    def setup_method(self):
        self.model = tm.load_model(os.path.join(GOLDEN, "model"), device="cpu")
        self.stats = Statistics.load(
            os.path.join(GOLDEN, "model_Statistics.txt"))
        Xtr, ytr = read_data(os.path.join(GOLDEN, "train.txt"))
        Xte, _ = read_data(os.path.join(GOLDEN, "test.txt"))
        self.Xtrs, self.ytrs = apply(self.stats, Xtr, ytr)
        self.Xtes = apply(self.stats, Xte)
        self.z = np.load(os.path.join(GOLDEN, "expected.npz"))

    def test_nlml_matches_stored_value(self):
        m = self.model
        val = float(ti.nlml(m.kernel, m.kernel_params, m.lik_hypers,
                            t64(self.Xtrs), t64(self.ytrs), m.likelihood))
        np.testing.assert_allclose(val, float(self.z["nlml"]), rtol=1e-8)

    def test_predictions_match_stored_values(self):
        m = self.model
        mu, var = ti.predict(m.kernel, m.kernel_params, m.lik_hypers,
                             t64(self.Xtrs), t64(self.ytrs),
                             t64(self.Xtes), m.likelihood)
        yh = unapply_y(self.stats, mu.numpy())
        std = unapply_var(self.stats, var.numpy())
        np.testing.assert_allclose(yh, self.z["mu"], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(std, self.z["std"], rtol=1e-7,
                                   atol=1e-10)
