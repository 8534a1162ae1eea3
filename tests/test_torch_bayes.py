"""Port parity: the Bayesian hyperposterior path (bayes/).

float64 on the CPU, inputs made with numpy from a seed. JAX's random
streams cannot be matched by a torch.Generator, so a transition's parity
is shown by replaying JAX's draws: `Replay` splits each chain's key
exactly as `_hmc_transition` / `_nuts_transition` do, draws with
`jax.random`, and hands the draws to the port's transition by name. The
samplers' moments are checked statistically, within Monte-Carlo error.
JAX's full samplers are not run here: their compiles cost the suite's
time.

Tolerances: the box transform, priors, dual averaging and diagnostics
are the same arithmetic (1e-12); a transition is the same function of
the same draws, so its position and accept statistic agree to 1e-10
(the port carries (log p, grad) between leapfrogs where JAX recomputes
them at the same points); mixed predictions 1e-8, as the dense predict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.bayes.diagnostics as jdiag
import gp_ss_ak_tpu.bayes.hmc as jhmc
import gp_ss_ak_tpu.bayes.priors as jpri
import gp_ss_ak_tpu.model as jm
import gp_ss_ak_torch.bayes.api as tapi
import gp_ss_ak_torch.bayes.diagnostics as tdiag
import gp_ss_ak_torch.bayes.hmc as thmc
import gp_ss_ak_torch.bayes.priors as tpri
import gp_ss_ak_torch.model as tm
from gp_ss_ak_tpu.bayes import predictive_mixture as jax_mixture
from gp_ss_ak_tpu.optim.api import flat_nlml_fn as jax_flat_nlml_fn
from gp_ss_ak_torch.bayes import (hmc_sample, nuts_sample,
                                  predictive_mixture, sample_hyperposterior)
from gp_ss_ak_torch.optim.api import batched_nlml_fn

# one intra-op thread per process: the suite runs on several workers
torch.set_num_threads(1)

F64 = torch.float64


def t64(a):
    return torch.as_tensor(np.array(a), dtype=F64)


class Replay:
    """JAX's draws for a batch of chains, one key each, named as the
    port's transitions ask for them (bayes/hmc.GeneratorDraws)."""

    def __init__(self, keys, dim, sampler):
        self.dim = dim
        self.draws = [self._chain(k, dim, sampler) for k in keys]

    @staticmethod
    def _chain(key, dim, sampler):
        if sampler == "hmc":
            k_mom, k_acc = jax.random.split(key)
            return {"momentum": jax.random.normal(k_mom, (dim,), jnp.float64),
                    ("accept",): jax.random.uniform(k_acc)}
        k_mom, key = jax.random.split(key)
        out = {"momentum": jax.random.normal(k_mom, (dim,), jnp.float64)}
        for depth in range(4):
            key, k_dir, k_sub, k_acc = jax.random.split(key, 4)
            # bernoulli(k) is uniform(k) < 0.5: replay its outcome
            out[("direction", depth)] = 0.0 if jax.random.bernoulli(
                k_dir) else 1.0
            out[("accept", depth)] = jax.random.uniform(k_acc)
            ks = k_sub
            for i in range(1 << depth):
                ks, k1 = jax.random.split(ks)
                out[("leaf", depth, i)] = jax.random.uniform(k1)
        return out

    def momentum(self):
        return t64(np.stack([np.asarray(d["momentum"]) for d in self.draws]))

    def uniform(self, *name):
        return t64([float(d[name]) for d in self.draws])


# -- targets -----------------------------------------------------------

COV = np.array([[1.0, 0.6], [0.6, 2.0]])
PREC = np.linalg.inv(COV)


def gauss_jax(z):
    return -0.5 * z @ jnp.asarray(PREC) @ z


def gauss_torch(z):
    return -0.5 * torch.einsum("ci,ij,cj->c", z, t64(PREC), z)


def gp_data(n=20, d=2, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, d))
    y = np.sin(2.0 * X[:, 0]) + 0.1 * rng.normal(size=n)
    return X, y


def gp_targets(n=20, d=2):
    X, y = gp_data(n, d)
    mj, mt = jm.default_model(d), tm.default_model(d, device="cpu")
    p = mj.n_params
    jf = jax_flat_nlml_fn(mj)
    jlp = jpri.make_log_posterior(
        lambda t: jf(t, jnp.asarray(X), jnp.asarray(y)),
        jpri.default_box(p))
    tf = batched_nlml_fn(mt)
    tlp = tpri.make_log_posterior(
        lambda t: tf(t, t64(X).expand(t.shape[0], n, d),
                     t64(y).expand(t.shape[0], n)),
        tpri.default_box(p))
    z0 = np.asarray(jpri.default_box(p).inverse(mj.pack()))
    return jlp, tlp, z0


def jax_lpg(log_post):
    lp_grad = jax.value_and_grad(log_post)

    def lpg(z):
        v, g = lp_grad(z)
        return (jnp.where(jnp.isnan(v), -jnp.inf, v),
                jnp.where(jnp.isnan(g), 0.0, g))
    return lpg


def jax_subtree_time_ordered(log_post_grad, z0, r0, depth_max, n_leaf, eps,
                             H0, inv_mass, key):
    """gp_ss_ak_tpu/bayes/hmc.py::_build_subtree with the one repair the
    port makes (bayes/hmc.py's docstring): a checkpoint and the new leaf
    are U-turn-checked in time order, so a subtree built backward
    (eps < 0) takes the new leaf as its earlier end. Everything else is
    the JAX code as it stands."""
    from jax import lax

    dim = z0.shape[0]
    dtype = z0.dtype
    zc = jnp.zeros((depth_max + 1, dim), dtype)
    rc = jnp.zeros((depth_max + 1, dim), dtype)

    def body(carry):
        (i, z, r, zc, rc, st, key) = carry
        z, r, lp, _ = jhmc._leapfrog(log_post_grad, z, r, eps, inv_mass)
        H = -lp + jhmc._kinetic(r, inv_mass)
        dH = H0 - H
        diverge = (dH < -1000.0) | jnp.isnan(dH)
        log_w_leaf = jnp.where(diverge, -jnp.inf, dH)
        accept = jnp.exp(jnp.minimum(dH, 0.0))
        accept = jnp.where(jnp.isnan(accept), 0.0, accept)
        log_w_new = jnp.logaddexp(st.log_w, log_w_leaf)
        key, k1 = jax.random.split(key)
        take = jnp.log(jax.random.uniform(k1)) < (log_w_leaf - st.log_w)
        z_prop = jnp.where(take, z, st.z_prop)
        is_even = (i % 2) == 0
        pos = jhmc._popcount(i)
        zc = jnp.where(is_even, zc.at[pos].set(z), zc)
        rc = jnp.where(is_even, rc.at[pos].set(r), rc)
        idx_max = pos - 1
        idx_min = pos - jhmc._trailing_ones(i)

        def chk(j, t):
            active = (j >= idx_min) & (j <= idx_max)
            t_j = jnp.where(eps > 0,
                            jhmc._uturn(zc[j], rc[j], z, r, inv_mass),
                            jhmc._uturn(z, r, zc[j], rc[j], inv_mass))
            return t | (active & t_j)

        turning = jnp.where(is_even, st.turning, st.turning | lax.fori_loop(
            0, depth_max + 1, chk, jnp.asarray(False)))
        st = jhmc._TreeState(z_prop=z_prop, log_w=log_w_new, z_end=z,
                             r_end=r, turning=turning,
                             diverging=st.diverging | diverge,
                             sum_accept=st.sum_accept + accept,
                             n_leaves=st.n_leaves + 1)
        return (i + 1, z, r, zc, rc, st, key)

    def cond(carry):
        i, _, _, _, _, st, _ = carry
        return (i < n_leaf) & (~st.turning) & (~st.diverging)

    st0 = jhmc._TreeState(z_prop=z0, log_w=-jnp.inf, z_end=z0, r_end=r0,
                          turning=jnp.asarray(False),
                          diverging=jnp.asarray(False),
                          sum_accept=jnp.zeros(()), n_leaves=jnp.zeros(()))
    out = lax.while_loop(cond, body, (jnp.asarray(0, jnp.int32), z0, r0, zc,
                                      rc, st0, key))
    return out[5]


# -- priors, dual averaging, tree helpers, diagnostics ------------------

def test_box_transform_and_priors_match_jax():
    rng = np.random.default_rng(0)
    p = 6
    jb, tb = jpri.default_box(p), tpri.default_box(p)
    theta = rng.uniform(1e-4, 6.0, (3, p))
    theta[0, 0] = 1e-4                           # clipped at the bound
    z = rng.normal(size=(3, p)) * 3
    for fj, ft, a in ((jb.forward, tb.forward, z),
                      (jb.inverse, tb.inverse, theta)):
        np.testing.assert_allclose(ft(t64(a)).numpy(),
                                   np.asarray(fj(jnp.asarray(a))),
                                   rtol=1e-12)
    for c in range(3):
        np.testing.assert_allclose(
            tb.log_det_jacobian(t64(z))[c].item(),
            float(jb.log_det_jacobian(jnp.asarray(z[c]))), rtol=1e-12)
        np.testing.assert_allclose(
            tpri.lognormal_log_prior(t64(theta), 0.3, 1.7)[c].item(),
            float(jpri.lognormal_log_prior(jnp.asarray(theta[c]), 0.3, 1.7)),
            rtol=1e-12)
    assert tpri.uniform_box_log_prior(t64(theta), tb).shape == (3,)

    def nl_j(t):
        return jnp.sum(t ** 2)

    def nl_t(t):
        return torch.sum(t ** 2, dim=-1)

    lj = jpri.make_log_posterior(nl_j, jb, jpri.lognormal_log_prior)
    lt = tpri.make_log_posterior(nl_t, tb, tpri.lognormal_log_prior)
    for c in range(3):
        np.testing.assert_allclose(lt(t64(z))[c].item(),
                                   float(lj(jnp.asarray(z[c]))), rtol=1e-12)


def test_dual_averaging_sequence_matches_jax():
    rng = np.random.default_rng(1)
    aps = rng.uniform(0, 1, (40, 3))
    sj = jhmc._da_init(jnp.asarray(0.1))
    st = thmc._da_init(t64(np.full(3, 0.1)))
    for row in aps:
        st = thmc._da_update(st, t64(row))
        sj = jhmc._da_update(sj, jnp.asarray(row[0]))
        for a, b in zip(st, sj):
            np.testing.assert_allclose(a[0].item(), float(b), rtol=1e-12)
    # the three chains adapt independently: chain 2 alone agrees too
    s2 = jhmc._da_init(jnp.asarray(0.1))
    for row in aps:
        s2 = jhmc._da_update(s2, jnp.asarray(row[2]))
    np.testing.assert_allclose(st.log_eps_bar[2].item(), float(s2.log_eps_bar),
                               rtol=1e-12)


def test_tree_helpers_match_jax():
    xs = np.arange(0, 300, dtype=np.int32)
    assert [thmc._popcount(int(x)) for x in xs] == \
        np.asarray(jhmc._popcount(jnp.asarray(xs))).tolist()
    assert [thmc._trailing_ones(int(x)) for x in xs] == \
        np.asarray(jhmc._trailing_ones(jnp.asarray(xs))).tolist()
    rng = np.random.default_rng(2)
    za, ra, zb, rb = rng.normal(size=(4, 50, 3))
    im = rng.uniform(0.5, 2.0, (50, 3))
    ut = thmc._uturn(t64(za), t64(ra), t64(zb), t64(rb), t64(im)).numpy()
    uj = [bool(jhmc._uturn(*(jnp.asarray(a[c]) for a in (za, ra, zb, rb,
                                                           im))))
          for c in range(50)]
    assert ut.tolist() == uj and 0 < sum(uj) < 50


def test_diagnostics_equal_jax_modules():
    rng = np.random.default_rng(3)
    th = np.cumsum(rng.normal(size=(4, 200, 3)), axis=1) * 0.1 + \
        rng.normal(size=(4, 200, 3))
    th[:, :, 2] = np.round(th[:, :, 2])          # ties
    for name in ("split_rhat", "ess_bulk", "ess_tail"):
        np.testing.assert_allclose(getattr(tdiag, name)(th),
                                   getattr(jdiag, name)(th), rtol=1e-12)
    np.testing.assert_allclose(tdiag.split_rhat(th, rank_normalized=False),
                               jdiag.split_rhat(th, rank_normalized=False),
                               rtol=1e-12)
    a, b = tdiag.summarize(th, names="abc"), jdiag.summarize(th, names="abc")
    for k in ("rhat", "ess", "ess_tail", "mean", "std"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12)
    assert a["names"] == b["names"]


# -- one transition, JAX's draws replayed -------------------------------

def _port_transition(kind, tlp, z, keys, eps, inv_mass, **kw):
    counts = {}
    lpg = thmc.log_post_grad_fn(tlp, counts)
    lp, g = lpg(t64(z))
    draws = Replay(keys, z.shape[1], kind)
    C = z.shape[0]
    eps_t, im_t = t64(np.full(C, eps)), t64(np.broadcast_to(inv_mass, z.shape))
    if kind == "hmc":
        out = thmc._hmc_transition(lpg, t64(z), lp, g, eps_t, kw["L"], im_t,
                                   draws)
    else:
        out = thmc._nuts_transition(lpg, t64(z), lp, g, eps_t, im_t, draws,
                                    kw["max_depth"])
    return out, counts["evals"] - 1, lpg


@pytest.mark.parametrize("target", ["gauss", "gp"])
def test_hmc_transition_replays_jax(target):
    C = 2
    if target == "gauss":
        jlp, tlp = gauss_jax, gauss_torch
        z = np.array([[0.3, -1.2], [1.5, 0.4]])
        eps, L = 0.4, 5
    else:
        jlp, tlp, z0 = gp_targets()
        z = z0[None] + 0.3 * np.random.default_rng(4).normal(size=(C,
                                                                  z0.size))
        eps, L = 0.02, 4
    im = np.linspace(0.8, 1.3, z.shape[1])
    keys = jax.random.split(jax.random.PRNGKey(7), C)
    (zt, lpt, gt, apt, leaves), evals, lpg = _port_transition(
        "hmc", tlp, z, keys, eps, im, L=L)
    assert evals == L and leaves.tolist() == [L] * C   # L evaluations
    step = jax.jit(lambda z, k: jhmc._hmc_transition(
        jax_lpg(jlp), z, k, eps, L, jnp.asarray(im)))
    for c in range(C):
        zj, apj = step(jnp.asarray(z[c]), keys[c])
        np.testing.assert_allclose(zt[c].numpy(), np.asarray(zj),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(apt[c].item(), float(apj), rtol=1e-10,
                                   atol=1e-12)
    # the carried (log p, grad) is the target's at the returned position
    lp2, g2 = lpg(zt)
    np.testing.assert_allclose(lpt.numpy(), lp2.numpy(), rtol=1e-12)
    np.testing.assert_allclose(gt.numpy(), g2.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_backward_subtree_turns_only_when_it_turns():
    # two leapfrogs backward at a small step on a Gaussian: the trajectory
    # has not turned. The JAX package's subtree reports a U-turn (its
    # pair is in build order); the port's does not, nor does the repaired
    # JAX reference the replay test below holds the port to
    lpg_j = jax_lpg(gauss_jax)
    z0, r0 = jnp.asarray([0.3, -0.2]), jnp.asarray([0.5, 1.0])
    lp0, _ = lpg_j(z0)
    H0 = -lp0 + jhmc._kinetic(r0, jnp.ones(2))
    key = jax.random.PRNGKey(0)
    for build, turns in ((jhmc._build_subtree, True),
                         (jax_subtree_time_ordered, False)):
        st = build(lpg_j, z0, r0, 3, 2, -0.01, H0, jnp.ones(2), key)
        assert bool(st.turning) is turns and float(st.n_leaves) == 2.0
    lpg = thmc.log_post_grad_fn(gauss_torch)
    lp, g = lpg(t64([[0.3, -0.2]]))
    start = thmc._Point(t64([[0.3, -0.2]]), t64([[0.5, 1.0]]), lp, g)
    H0t = -lp + thmc._kinetic(start.r, torch.ones(1, 2, dtype=F64))
    st = thmc._build_subtree(lpg, start, torch.ones(1, dtype=torch.bool), 3,
                             1, t64([-0.01]), H0t,
                             torch.ones(1, 2, dtype=F64),
                             Replay([key], 2, "nuts"))
    assert not bool(st.turning[0]) and st.n_leaves.item() == 2.0


@pytest.mark.parametrize("target", ["gauss", "gp"])
def test_nuts_transition_replays_jax(target, monkeypatch):
    C = 3
    if target == "gauss":
        jlp, tlp = gauss_jax, gauss_torch
        z = np.array([[0.3, -1.2], [1.5, 0.4], [-0.7, 2.0]])
        eps = 0.35
    else:
        jlp, tlp, z0 = gp_targets()
        z = z0[None] + 0.3 * np.random.default_rng(5).normal(size=(C,
                                                                  z0.size))
        eps = 0.05
    im = np.linspace(0.8, 1.3, z.shape[1])
    max_depth = 4
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    (zt, lpt, gt, act, leaves), evals, lpg = _port_transition(
        "nuts", tlp, z, keys, eps, im, max_depth=max_depth)
    monkeypatch.setattr(jhmc, "_build_subtree", jax_subtree_time_ordered)
    step = jax.jit(lambda z, k: jhmc._nuts_transition(
        jax_lpg(jlp), z, k, eps, jnp.asarray(im), max_depth))
    for c in range(C):
        zj, acj = step(jnp.asarray(z[c]), keys[c])
        np.testing.assert_allclose(zt[c].numpy(), np.asarray(zj),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(act[c].item(), float(acj), rtol=1e-10,
                                   atol=1e-12)
    # one evaluation per leaf: a lone chain's count is its leaves
    (_, _, _, _, one), evals1, _ = _port_transition(
        "nuts", tlp, z[:1], keys[:1], eps, im, max_depth=max_depth)
    assert evals1 == int(one.item()) >= 1
    assert evals >= int(leaves.max().item())
    lp2, g2 = lpg(zt)
    np.testing.assert_allclose(lpt.numpy(), lp2.numpy(), rtol=1e-12)


def test_a_failed_chain_leaves_the_others_alone():
    # a NaN value in one chain becomes -inf (gradient 0) in that chain only
    def lp(z):
        v = gauss_torch(z)
        return torch.where(z[:, 0] > 5.0, torch.nan, v)

    lpg = thmc.log_post_grad_fn(lp)
    v, g = lpg(t64([[0.2, 0.1], [6.0, 0.0], [1.0, -1.0]]))
    assert v[1].item() == -np.inf and (g[1] == 0).all()
    ref, gref = lpg(t64([[0.2, 0.1], [1.0, -1.0]]))
    np.testing.assert_array_equal(v[[0, 2]].numpy(), ref.numpy())
    np.testing.assert_array_equal(g[[0, 2]].numpy(), gref.numpy())


# -- the samplers --------------------------------------------------------

@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_samplers_recover_a_correlated_gaussian(sampler):
    gen = torch.Generator().manual_seed(0)
    stats = {}
    run = hmc_sample if sampler == "hmc" else nuts_sample
    # 3 leapfrogs: the step adapts to ~1 here, where 5 to 8 leapfrogs
    # come near half a period of the target and HMC mixes poorly
    kw = {"n_leapfrog": 3} if sampler == "hmc" else {}
    s, aps = run(gauss_torch, torch.zeros(4, 2, dtype=F64), gen,
                 n_samples=400, n_warmup=200, stats=stats, **kw)
    assert s.shape == (4, 400, 2) and aps.shape == (4, 400)
    flat = s.reshape(-1, 2).numpy()
    assert float(aps.mean()) > 0.5
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.35)
    leaves = stats["leaves"]
    assert leaves.shape == (4, 600)
    if sampler == "hmc":          # L evaluations a transition, one to start
        assert stats["evals"] == 1 + 600 * 3
    else:                         # at most one per leaf of the deepest chain
        assert 1 + 600 <= stats["evals"] <= 1 + leaves.sum().item()
        assert stats["evals"] >= 1 + leaves.max(dim=0).values.sum().item()


def test_one_chain_without_a_batch_axis():
    s, aps = nuts_sample(gauss_torch, torch.zeros(2, dtype=F64),
                         torch.Generator().manual_seed(1), n_samples=20,
                         n_warmup=10)
    assert s.shape == (20, 2) and aps.shape == (20,)


def test_sample_hyperposterior_and_predictive_mixture():
    rng = np.random.default_rng(17)
    n = 25
    X = np.linspace(-1, 1, n).reshape(-1, 1)
    y = np.sin(3 * X[:, 0]) + 0.1 * rng.normal(size=n)
    model = tm.default_model(1, device="cpu")
    stats = {}
    theta, aps = sample_hyperposterior(model, X, y, 0, n_samples=12,
                                       n_warmup=12, n_chains=2,
                                       sampler="nuts", stats=stats)
    th = theta.numpy()
    assert th.shape == (2, 12, 10) and aps.shape == (2, 12)
    assert np.isfinite(th).all()
    assert th.min() >= 1e-4 - 1e-9 and th.max() <= 6.0 + 1e-9
    assert stats["evals"] > 24
    mu, var = predictive_mixture(model, X, y, X, theta, thin=10)
    assert np.isfinite(mu.numpy()).all() and (var.numpy() >= 0).all()
    assert float(np.mean((mu.numpy() - y) ** 2)) < 0.5
    # HMC through the same entry point, seeded by a Generator
    th2, _ = sample_hyperposterior(model, X, y, torch.Generator()
                                   .manual_seed(3), n_samples=5,
                                   n_warmup=5, n_chains=2, sampler="hmc")
    assert th2.shape == (2, 5, 10) and torch.isfinite(th2).all()


def test_predictive_mixture_matches_jax(monkeypatch):
    X, y = gp_data(n=30, d=3)
    Xs = np.random.default_rng(6).uniform(-1, 1, (9, 3))
    mj, mt = jm.default_model(3), tm.default_model(3, device="cpu")
    rng = np.random.default_rng(7)
    theta = np.asarray(mj.pack())[None, None] * rng.uniform(
        0.7, 1.3, (2, 10, 10))
    mu_j, var_j = jax_mixture(mj, X, y, Xs, jnp.asarray(theta), thin=3)
    # 7 samples in chunks of 3: the sums run across chunks
    monkeypatch.setattr(tapi, "MIXTURE_CHUNK", 3)
    mu_t, var_t = predictive_mixture(mt, X, y, Xs, theta, thin=3)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=1e-8,
                               atol=1e-10)


def test_the_hooks_of_parallel_raise():
    X, y = gp_data()
    model = tm.default_model(2, device="cpu")
    for kw in ({"mesh": object()}, {"nlml_value_and_grad": lambda t: t}):
        with pytest.raises(NotImplementedError, match="parallel/"):
            sample_hyperposterior(model, X, y, 0, n_samples=1, n_warmup=1,
                                  **kw)
