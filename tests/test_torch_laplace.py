"""Port parity: Laplace (IRLS) inference (inference/laplace.py) and
`Gaussian.log_prob`, float64 on the CPU.

The same numpy inputs (n = 16) go through the JAX package and the port
for three log-likelihoods: the Gaussian (the Newton iteration converges
in one step), the warped Gaussian on a skewed target, and a Student-t
written in the test in both frameworks, with outliers in y, so that the
iteration takes many Newton steps and its halving line search backs off
(the likelihood is not log-concave there, and W is clamped at zero).
JAX's Newton steps are counted by wrapping its Cholesky (one per step)
and its psi (one per line-search evaluation, plus the start) in
`jax.debug.callback`: the Newton steps must equal the port's `stats`,
and for the Student-t the line-search evaluations too.
Tolerance: rtol 1e-9 of each result's largest entry.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import gammaln

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_torch.model as tm
from gp_ss_ak_tpu.inference import laplace as jl
from gp_ss_ak_tpu.inference import likelihoods as jlik
from gp_ss_ak_torch.inference import gaussian as tg
from gp_ss_ak_torch.inference import laplace as tl
from gp_ss_ak_torch.inference import likelihoods as tlik

F64 = torch.float64
RTOL = 1e-9
NU, SCALE = 3.0, 0.1            # the Student-t's degrees of freedom, scale
WARP = np.array([0.8, 1.2, 0.1, np.log(0.2)])   # tanh1 a, b, c; noise

# one intra-op thread per process: the suite runs on several workers at
# once, and torch's default (a thread per core in every worker)
# oversubscribes the cores and slows these small CPU ops many times over
torch.set_num_threads(1)


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def problem(n=16, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 3))
    y = np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n)
    y_out = y.copy()
    y_out[[2, 7, 11]] += np.array([3.0, -4.0, 5.0])
    mj = jm.default_model(3, dtype=jnp.float64)
    mt = tm.default_model(3, dtype=F64, device="cpu")
    return X, y, y_out, mj, mt


def student_j(y, f):
    r = y - f
    return (gammaln((NU + 1) / 2) - gammaln(NU / 2)
            - 0.5 * jnp.log(NU * math.pi * SCALE ** 2)
            - (NU + 1) / 2 * jnp.log1p(r * r / (NU * SCALE ** 2)))


def student_t(y, f):
    r = y - f
    return (math.lgamma((NU + 1) / 2) - math.lgamma(NU / 2)
            - 0.5 * math.log(NU * math.pi * SCALE ** 2)
            - (NU + 1) / 2 * torch.log1p(r * r / (NU * SCALE ** 2)))


def log_probs(kind, mj):
    """(JAX log_prob(y, f), port log_prob(y, f), the target in use)."""
    sn2 = float(mj.lik_hypers[0])
    if kind == "gauss":
        hj, ht = jnp.asarray([sn2]), torch.tensor([sn2], dtype=F64)
        return (lambda y, f: jlik.Gaussian.log_prob(hj, y, f),
                lambda y, f: tlik.Gaussian.log_prob(ht, y, f), "y")
    if kind == "warped":
        wj, wt = jlik.WarpedGaussian(), tlik.WarpedGaussian()
        hj, ht = jnp.asarray(WARP), torch.tensor(WARP, dtype=F64)
        return (lambda y, f: wj.log_prob(hj, y, f),
                lambda y, f: wt.log_prob(ht, y, f), "skewed")
    return student_j, student_t, "outliers"


def targets(y, y_out):
    return {"y": y, "skewed": np.exp(0.8 * y), "outliers": y_out}


@pytest.fixture
def jax_counts(monkeypatch):
    """Counts of JAX's Newton steps (Choleskys) and psi evaluations."""
    counts = {"chol": 0, "psi": 0}
    chol, psi = jl._cholesky, jl._psi

    def bump(name):
        jax.debug.callback(lambda: counts.__setitem__(name, counts[name] + 1))

    def counted_chol(B):
        bump("chol")
        return chol(B)

    def counted_psi(*args):
        bump("psi")
        return psi(*args)

    monkeypatch.setattr(jl, "_cholesky", counted_chol)
    monkeypatch.setattr(jl, "_psi", counted_psi)
    return counts


def test_gaussian_log_prob_matches_jax():
    rng = np.random.default_rng(0)
    y, f = rng.normal(size=20), rng.normal(size=20)
    for sn2 in (0.016, 1.3):
        close(tlik.Gaussian.log_prob(torch.tensor([sn2], dtype=F64),
                                     torch.tensor(y),
                                     torch.tensor(f)).numpy(),
              jlik.Gaussian.log_prob(jnp.asarray([sn2]), jnp.asarray(y),
                                     jnp.asarray(f)))


@pytest.mark.parametrize("kind", ["gauss", "warped", "student"])
def test_fit_latent_and_nlml_match_jax(kind, jax_counts):
    X, y, y_out, mj, _ = problem()
    lpj, lpt, target = log_probs(kind, mj)
    yy = targets(y, y_out)[target]
    K = np.asarray(mj.kernel.matrix(mj.kernel_params, jnp.asarray(X),
                                    jnp.asarray(X), same=True))
    aj, fj, pj = jl.fit_latent(jnp.asarray(K), jnp.asarray(yy), lpj)
    jax.effects_barrier()
    stats = {}
    at, ft, pt = tl.fit_latent(torch.tensor(K), torch.tensor(yy), lpt,
                               stats=stats)
    close(at.numpy(), aj)
    close(ft.numpy(), fj)
    close(float(pt), float(pj))
    assert torch.equal(stats["alpha"], at)
    # the same Newton steps; for the Student-t also the same line-search
    # evaluations. The conjugate cases converge in one real step, and the
    # next one's search compares psi at its round-off, where either
    # package may find a point better by an ulp
    assert stats["newton_iters"] == jax_counts["chol"]
    if kind == "student":
        assert 1 + stats["newton_iters"] + stats["halvings"] \
            == jax_counts["psi"]
        assert stats["newton_iters"] > 2 and stats["halvings"] >= 1
    nj = jl.nlml(jnp.asarray(K), jnp.asarray(yy), lpj)
    nt = tl.nlml(torch.tensor(K), torch.tensor(yy), lpt)
    close(float(nt), float(nj))


@pytest.mark.parametrize("kind", ["gauss", "warped", "student"])
def test_predict_latent_matches_jax(kind):
    X, y, y_out, mj, mt = problem()
    lpj, lpt, target = log_probs(kind, mj)
    yy = targets(y, y_out)[target]
    Xs = np.random.default_rng(9).uniform(-1, 1, size=(7, 3))
    muj, varj = jl.predict_latent(mj.kernel, mj.kernel_params,
                                  jnp.asarray(X), jnp.asarray(yy), lpj,
                                  jnp.asarray(Xs))
    mut, vart = tl.predict_latent(mt.kernel, mt.kernel_params,
                                  torch.tensor(X), torch.tensor(yy), lpt,
                                  torch.tensor(Xs))
    close(mut.numpy(), muj)
    close(vart.numpy(), varj)


@pytest.mark.parametrize("kind", ["gauss", "warped"])
def test_laplace_nlml_equals_the_exact_nlml(kind):
    # for the (warped) Gaussian the Laplace mode is exact: psi + 1/2 log
    # det B is the exact NLML, held at 1e-8 as the card's smoke holds it
    X, y, _, mj, mt = problem()
    lpj, lpt, target = log_probs(kind, mj)
    yy = torch.tensor(targets(y, None)[target])
    Xt = torch.tensor(X)
    K = mt.kernel.matrix(mt.kernel_params, Xt, Xt, same=True)
    if kind == "gauss":
        lik, hypers = tlik.Gaussian(), mt.lik_hypers
    else:
        lik, hypers = tlik.WarpedGaussian(), torch.tensor(WARP, dtype=F64)
    exact = tg.nlml(mt.kernel, mt.kernel_params, hypers, Xt, yy, lik)
    close(float(tl.nlml(K, yy, lpt)), float(exact), rtol=1e-8)
    # and the latent prediction, with the noise, is the exact predictive
    # (the plain Gaussian's)
    if kind == "gauss":
        Xs = torch.tensor(np.random.default_rng(3).uniform(-1, 1, (5, 3)))
        mu, var = tl.predict_latent(mt.kernel, mt.kernel_params, Xt, yy,
                                    lpt, Xs)
        mu_e, var_e = tg.predict(mt.kernel, mt.kernel_params, hypers, Xt,
                                 yy, Xs, lik)
        close(mu.numpy(), mu_e.numpy(), rtol=1e-8)
        close((var + hypers[0]).numpy(), var_e.numpy(), rtol=1e-8)
