"""Port parity: the warp families, their inverse and the Gauss-Hermite
mix (gp_ss_ak_torch.inference.{warping,quadrature,likelihoods}) against
the JAX package, float64 on the CPU.

Both sides run the same elementwise algebra, so g(y), log g'(y), the
inverse and the mix agree to rtol 1e-12, and the inverse's bracketing
loops take the same number of steps (the JAX loops replayed step by
step through JAX's own `warp`). Gradients of the warp in its hypers:
torch autograd against jax.grad at rtol 1e-10.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_ss_ak_tpu.inference import gaussian as jg
from gp_ss_ak_tpu.inference import likelihoods as jl
from gp_ss_ak_tpu.inference import quadrature as jq
from gp_ss_ak_tpu.inference import warping as jw
from gp_ss_ak_torch.inference import gaussian as tg
from gp_ss_ak_torch.inference import likelihoods as tl
from gp_ss_ak_torch.inference import quadrature as tq
from gp_ss_ak_torch.inference import warping as tw

RTOL = 1e-12
F64 = torch.float64

# one intra-op thread per process: the suite runs on several workers at
# once, and torch's default (a thread per core in every worker)
# oversubscribes the cores and slows these small CPU ops many times over
torch.set_num_threads(1)

#: (family, warp hypers): tanh1 with one and two triplets, rbf, and srbf
#: with small direct amplitudes (its derivative stays positive)
CASES = {
    "tanh1-1": ("tanh1", [0.3, -0.2, 0.5]),
    "tanh1-2": ("tanh1", [0.3, -0.4, -0.2, 0.6, 0.5, -0.7]),
    "rbf-1": ("rbf", [-0.5, 0.2, 0.4]),
    "srbf-1": ("srbf", [0.2, 1.3, 0.4]),
}


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_gauss_hermite_is_the_same_copy():
    for n in (5, 20):
        xt, wt = tq.gauss_hermite(n)
        xj, wj = jq.gauss_hermite(n)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(wt, wj)
        assert wt.sum() == pytest.approx(1.0, rel=1e-14)


@pytest.mark.parametrize("case", list(CASES))
def test_warp_matches_jax(case):
    family, theta = CASES[case]
    y = np.random.default_rng(1).uniform(-2.0, 2.5, size=(7, 5))
    ymax = 1.7
    gj, lj = jw.warp(family, jnp.asarray(theta), jnp.asarray(y), ymax)
    gt, lt = tw.warp(family, t64(theta), t64(y), ymax)
    close(gt.numpy(), gj)
    close(lt.numpy(), lj)
    assert np.all(np.isfinite(lt.numpy()))


@pytest.mark.parametrize("case", list(CASES))
def test_warp_gradient_matches_jax(case):
    family, theta = CASES[case]
    y = np.random.default_rng(2).uniform(-1.5, 1.5, size=40)
    ymax = 0.4          # below exp(-t2): rbf's centre takes the hyper

    def fj(th):
        g, lg = jw.warp(family, th, jnp.asarray(y), ymax)
        return jnp.sum(jnp.sin(g)) + jnp.sum(lg)

    gj = jax.grad(fj)(jnp.asarray(theta))
    th = t64(theta).requires_grad_()
    g, lg = tw.warp(family, th, t64(y), ymax)
    (gt,) = torch.autograd.grad(torch.sum(torch.sin(g)) + torch.sum(lg), th)
    close(gt.numpy(), gj, rtol=1e-10)


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown warp family"):
        tw.warp("cubic", t64([0.1, 0.2, 0.3]), t64([0.0]))


def _jax_bracket_steps(family, theta, z, ymax):
    """The JAX package's bracketing loops (warping.py:114-139) replayed
    one step at a time through its own `warp`: (lower, upper) steps."""
    theta, z = jnp.asarray(theta), jnp.asarray(z)

    def residual(y):
        return jw.warp(family, theta, y, ymax)[0] - z

    dz = jnp.maximum(jnp.max(jnp.abs(z)), 1.0)
    counts = []
    for sign in (1.0, -1.0):
        y, r, k = z, residual(z), 0
        while bool(jnp.any(sign * r > 0)):
            y = jnp.where(sign * r > 0, y - sign * dz, y)
            r = residual(y)
            k += 1
        counts.append(k)
    return tuple(counts)


@pytest.mark.parametrize("case", ["tanh1-1", "tanh1-2", "rbf-1"])
def test_inverse_matches_jax(case):
    family, theta = CASES[case]
    rng = np.random.default_rng(3)
    ymax = 1.1
    y = rng.uniform(-3.0, 3.0, size=(16, 20))
    z = np.array(jw.warp(family, jnp.asarray(theta), jnp.asarray(y),
                         ymax)[0])
    # points far outside [-max|z|, max|z|] make the bracket step
    z[0, :3] = [4.0 * np.abs(z).max(), -3.5 * np.abs(z).max(), 0.0]
    yj = jw.inverse(family, jnp.asarray(theta), jnp.asarray(z),
                    y_train_max=ymax)
    yt = tw.inverse(family, t64(theta), t64(z), y_train_max=ymax)
    close(yt.numpy(), yj)
    close(tw.warp(family, t64(theta), yt, ymax)[0].numpy(), z, rtol=1e-12)
    _, _, n_low, n_up = tw.bracket(family, t64(theta), t64(z), ymax)
    assert (n_low, n_up) == _jax_bracket_steps(family, theta, z, ymax)
    assert n_low > 0        # (rbf only adds to y: g(y) >= y, no up step)


def test_inverse_of_all_zero_targets_terminates():
    theta = CASES["tanh1-1"][1]
    z = np.zeros((3, 4))
    yt = tw.inverse("tanh1", t64(theta), t64(z))
    yj = jw.inverse("tanh1", jnp.asarray(theta), jnp.asarray(z))
    close(yt.numpy(), yj)


def test_srbf_inverse_keeps_the_reference_chain():
    # exp'd hypers, the centre clamp and only the last triplet surviving
    theta = [-0.3, 0.1, 0.2, 0.4, -0.5, 0.3]
    z = np.random.default_rng(4).uniform(0.05, 0.6, size=(5, 3))
    yj = jw.inverse("srbf", jnp.asarray(theta), jnp.asarray(z),
                    y_train_max=0.9)
    yt = tw.inverse("srbf", t64(theta), t64(z), y_train_max=0.9)
    close(yt.numpy(), yj)
    a, s = math.exp(theta[1]), math.exp(theta[3])
    c = max(0.9, math.exp(-theta[5]))
    close(yt.numpy(), np.sqrt(-(s * s) * np.log(z / (a * a))) + c)


@pytest.mark.parametrize("case", ["tanh1-1", "tanh1-2", "rbf-1"])
def test_warped_likelihood_and_mix_match_jax(case):
    family, theta = CASES[case]
    m = len(theta) // 3
    lh = theta + [0.5 * math.log(0.05)]
    rng = np.random.default_rng(5)
    y = np.exp(0.8 * rng.normal(size=30))
    f = rng.normal(size=30)
    lj, lt = jl.WarpedGaussian(family, m), tl.WarpedGaussian(family, m)
    assert lt.n_hypers == lj.n_hypers == 3 * m + 1
    assert lt.kind == lj.kind == tl.LIK_WARPGAUSS
    assert lt == tl.make_likelihood(tl.LIK_WARPGAUSS, family, m)
    close(lt.default_hypers(F64, torch.device("cpu")).numpy(),
          lj.default_hypers(jnp.float64))
    assert float(lt.noise_variance(t64(lh))) == pytest.approx(
        float(lj.noise_variance(jnp.asarray(lh))), rel=RTOL)
    for a, b in zip(lt.effective_target(t64(lh), t64(y)),
                    lj.effective_target(jnp.asarray(lh), jnp.asarray(y))):
        close(a.numpy(), b)
    close(lt.log_prob(t64(lh), t64(y), t64(f)).numpy(),
          lj.log_prob(jnp.asarray(lh), jnp.asarray(y), jnp.asarray(f)))
    # the Gauss-Hermite push of a latent Gaussian through g^-1
    mu, var = rng.normal(size=12), rng.uniform(0.05, 0.8, size=12)
    mwj, vwj = jg.warped_predictive_mix(lj, jnp.asarray(lh), jnp.asarray(mu),
                                        jnp.asarray(var), 2.0)
    mwt, vwt = tg.warped_predictive_mix(lt, t64(lh), t64(mu), t64(var),
                                        torch.tensor(2.0, dtype=F64))
    close(mwt.numpy(), mwj)
    close(vwt.numpy(), vwj)
