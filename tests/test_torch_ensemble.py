"""Port parity: the batched paths of the ensemble and `-o JIT` fits.

The same inputs, made with numpy from a seed, go through the JAX package
and the port, float64 on the CPU: K1's plain version with a batch axis
against the Pallas kernel (interpret mode) per member; the batched NLML
and its gradient against `jax.vmap(jax.value_and_grad(flat_nlml_fn))`,
with one member's factor failing; the batched L-BFGS against
`jax_lbfgs.minimize` under `jax.vmap`; `fit_ensemble`,
`predict_ensemble` and `fit(optimizer="JIT")` against theirs.

Tolerances: the Gram's expansion and the NLML's algebra are the same
operations in both packages, so members agree to round-off (rtol 1e-12
for the Gram, 1e-10 for values and gradients). The L-BFGS takes the
same steps, so the iteration counts and stop flags are equal and the
points agree to rtol 1e-6, the values to 1e-8. That holds only where
the fit itself is stable under round-off: on `batch(seed=23)` (the JAX
package's own test data) JAX's fit of member 1 moves by 5e-4 at
iteration 20 when y changes by one part in 1e15, so no second
implementation can agree there to 1e-6 (the port differs by 7e-5). The
parity test runs on `batch(seed=0)`, where that sensitivity is below
1e-8, and checks it first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_torch.model as tm
from gp_ss_ak_tpu.ensemble import fit_ensemble as jax_fit_ensemble
from gp_ss_ak_tpu.ensemble import predict_ensemble as jax_predict_ensemble
from gp_ss_ak_tpu.optim import fit as jax_fit
from gp_ss_ak_tpu.optim import jax_lbfgs
from gp_ss_ak_tpu.optim.api import flat_nlml_fn as jax_flat_nlml_fn
from gp_ss_ak_tpu.ops.pairwise import expans_bias_gram as jax_gram
from gp_ss_ak_torch.ensemble import (EnsembleFit, fit_ensemble,
                                     predict_ensemble)
from gp_ss_ak_torch.ops import fused, pairwise
from gp_ss_ak_torch.optim import batched_lbfgs, fit
from gp_ss_ak_torch.optim.api import (batched_nlml_fn,
                                      batched_value_and_grad, flat_nlml_fn,
                                      unpack_batched)

# one intra-op thread per process: the suite runs on several workers
torch.set_num_threads(1)

F64 = torch.float64
CPU = torch.device("cpu")


def t64(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def batch(B=3, n=24, d=2, seed=23):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(B, n, d))
    freqs = np.linspace(1.0, 3.0, B)
    y = np.stack([np.sin(f * X[b, :, 0]) + 0.05 * rng.normal(size=n)
                  for b, f in enumerate(freqs)])
    return X, y


def models(d):
    return jm.default_model(d), tm.default_model(d, device="cpu")


@pytest.mark.parametrize("d", [3, 4])
@pytest.mark.parametrize("n,m", [(37, None), (20, 11)])
def test_batched_plain_gram_matches_pallas_per_member(n, m, d):
    rng = np.random.default_rng(n + d)
    B = 3
    X = rng.normal(size=(B, n, d))
    Y = None if m is None else rng.normal(size=(B, m, d))
    sig, bia = rng.uniform(0.3, 1.0, B), rng.uniform(0.05, 0.4, B)
    sn2 = rng.uniform(0.01, 0.1, B) if m is None else None
    K = pairwise.expans_bias_gram(
        t64(X), t64(sig), t64(bia), None if sn2 is None else t64(sn2),
        None if Y is None else t64(Y))
    assert tuple(K.shape) == (B, n, n if m is None else m)
    for b in range(B):
        args = (sig[b], bia[b], None if sn2 is None else sn2[b])
        Kj = np.asarray(jax_gram(jnp.asarray(X[b]), *args,
                                 None if Y is None else jnp.asarray(Y[b]),
                                 interpret=True))
        np.testing.assert_allclose(K[b].numpy(), Kj, rtol=1e-12,
                                   atol=1e-14)
        K2 = pairwise.expans_bias_gram_plain(
            t64(X[b]), *(None if a is None else float(a) for a in args),
            None if Y is None else t64(Y[b]))
        np.testing.assert_allclose(K[b].numpy(), K2.numpy(), rtol=1e-12,
                                   atol=1e-14)


def test_batched_mapping_and_autograd_equal_each_member():
    # mapped_points by each member's mean and metric (d = 4: the rock-type
    # dimension), the cross build by each member's combined mean, and the
    # batched backward against the 2-D one, member by member
    rng = np.random.default_rng(4)
    B, n, d = 3, 15, 4
    _, mt = models(d)
    flats = mt.pack()[None] * t64(rng.uniform(0.7, 1.3, (B, mt.n_params)))
    X, Xs = t64(rng.normal(size=(B, n, d))), t64(rng.normal(size=(B, 6, d)))
    kp, lh = unpack_batched(mt, flats)
    ex = mt.kernel.children[0]
    Xm = fused.mapped_points(ex, kp[0], X)
    Kx = fused.maybe_fused_cross(mt.kernel, kp, X, Xs)
    G = t64(rng.normal(size=(B, n, n)))
    leaves = [Xm.detach().requires_grad_(), kp[0]["Sigma"].detach()
              .requires_grad_(), kp[1]["Sigma"].detach().requires_grad_(),
              lh[0].detach().requires_grad_()]
    grads = torch.autograd.grad((fused.fused_expans_bias_A(*leaves) * G)
                                .sum(), leaves)
    for b in range(B):
        kb = mt.kernel.unpack(flats[b, :mt.kernel.n_params])
        np.testing.assert_allclose(
            Xm[b].numpy(), fused.mapped_points(ex, kb[0], X[b]).numpy(),
            rtol=1e-13, atol=1e-14)
        np.testing.assert_allclose(
            Kx[b].numpy(),
            fused.maybe_fused_cross(mt.kernel, kb, X[b], Xs[b]).numpy(),
            rtol=1e-13, atol=1e-14)
        one = [leaf[b].detach().requires_grad_() for leaf in leaves]
        g1 = torch.autograd.grad((fused.fused_expans_bias_A(*one) * G[b])
                                 .sum(), one)
        for gb, g in zip(grads, g1):
            np.testing.assert_allclose(gb[b].numpy(), g.numpy(), rtol=1e-12,
                                       atol=1e-12)


def test_batched_nlml_and_gradient_match_jax_vmap_with_a_failed_member():
    X, y = batch()
    mj, mt = models(2)
    rng = np.random.default_rng(1)
    flats = np.asarray(mj.pack())[None] * rng.uniform(0.8, 1.2, (3, 10))
    flats[1, 9] = -0.5                    # negative noise: a failed factor
    vj, gj = jax.vmap(jax.value_and_grad(jax_flat_nlml_fn(mj)))(
        jnp.asarray(flats), jnp.asarray(X), jnp.asarray(y))
    vj, gj = np.asarray(vj), np.asarray(gj)
    vg = batched_value_and_grad(batched_nlml_fn(mt), t64(X), t64(y))
    v, g = vg(t64(flats))
    assert np.isnan(v[1].item()) and np.isnan(vj[1])
    # NaN in every entry the objective depends on (not InversewidthR at d=2)
    np.testing.assert_array_equal(np.isnan(g[1].numpy()), np.isnan(gj[1]))
    assert int(torch.isnan(g[1]).sum()) == 9
    keep = [0, 2]
    np.testing.assert_allclose(v.numpy()[keep], vj[keep], rtol=1e-10)
    np.testing.assert_allclose(g.numpy()[keep], gj[keep], rtol=1e-10,
                               atol=1e-10)
    # the other members equal their own evaluation without the failure
    v_ok, g_ok = vg(t64(flats[keep[0]:keep[0] + 1].repeat(3, 0)))
    assert v[0].item() == v_ok[0].item()


def test_other_models_loop_over_the_members():
    # a kernel without a fused path: the batched objective stacks the
    # unbatched one, member by member
    X, y = batch(B=2, n=12)
    mt = tm.default_model(2, kernel_names=["RBF"], device="cpu")
    flats = mt.pack()[None].repeat(2, 1) * t64([[1.0], [1.1]])
    v = batched_nlml_fn(mt)(flats, t64(X), t64(y))
    single = flat_nlml_fn(mt)
    for b in range(2):
        assert v[b].item() == single(flats[b], t64(X[b]), t64(y[b])).item()


def _quadratic(centres, scales):
    def f(x):
        return jnp.sum(scales * (x - centres) ** 2) + jnp.sum(jnp.sin(x))

    def tf(x):
        c, s = t64(np.asarray(centres)), t64(np.asarray(scales))
        return torch.sum(s * (x - c) ** 2, dim=-1) + torch.sum(torch.sin(x),
                                                               dim=-1)
    return f, tf


def test_batched_lbfgs_matches_jax_on_a_boxed_quadratic():
    rng = np.random.default_rng(2)
    B, p = 4, 5
    centres = rng.uniform(-3, 3, (B, p))           # some outside the box
    scales = rng.uniform(0.2, 5.0, (B, p))
    x0 = rng.uniform(-1, 1, (B, p))
    lb, ub = -np.ones(p) * 2.0, np.ones(p) * 1.5

    def one(c, s, x):
        f, _ = _quadratic(c, s)
        r = jax_lbfgs.minimize(jax.value_and_grad(f), x, jnp.asarray(lb),
                               jnp.asarray(ub), maxiter=40)
        return r.x, r.fun, r.n_iters, r.converged

    xj, fj, ij, cj = (np.asarray(a) for a in jax.vmap(one)(
        jnp.asarray(centres), jnp.asarray(scales), jnp.asarray(x0)))

    def vg(x):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            _, tf = _quadratic(centres, scales)
            v = tf(xx)
            (g,) = torch.autograd.grad(v.sum(), xx)
        return v.detach(), g

    res = batched_lbfgs.minimize(vg, t64(x0), t64(lb), t64(ub), maxiter=40)
    np.testing.assert_array_equal(res.n_iters.numpy(), ij)
    np.testing.assert_array_equal(res.converged.numpy(), cj)
    np.testing.assert_allclose(res.x.numpy(), xj, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(res.fun.numpy(), fj, rtol=1e-8)
    assert (res.x.numpy() >= lb).all() and (res.x.numpy() <= ub).all()


def test_fit_ensemble_and_predict_match_jax():
    X, y = batch(seed=0)
    mj, mt = models(2)
    rj = jax_fit_ensemble(mj, X, y, maxiter=20)
    # the premise: JAX's own fit is stable under round-off on this data
    again = jax_fit_ensemble(mj, X, y * (1.0 + 1e-15), maxiter=20)
    assert np.abs(np.asarray(again.flat) / np.asarray(rj.flat)
                  - 1.0).max() < 1e-8
    rt = fit_ensemble(mt, X, y, maxiter=20)
    assert rt.flat.shape == (3, 10) and rt.n_evals > 20
    np.testing.assert_array_equal(rt.n_iters.numpy(), np.asarray(rj.n_iters))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_allclose(rt.flat.numpy(), np.asarray(rj.flat),
                               rtol=1e-6)
    np.testing.assert_allclose(rt.fun.numpy(), np.asarray(rj.fun), rtol=1e-8)
    # every deposit below its start
    start = batched_nlml_fn(mt)(mt.pack()[None].repeat(3, 1), t64(X), t64(y))
    assert (rt.fun < start).all()

    # predictions on the same hyperparameters: JAX's flats in both
    Xs = np.random.default_rng(9).uniform(-1, 1, (3, 7, 2))
    mu_j, var_j = jax_predict_ensemble(mj, rj, X, y, Xs)
    fit_j = EnsembleFit(t64(rj.flat), t64(rj.fun), torch.as_tensor(
        np.asarray(rj.n_iters)), torch.as_tensor(np.asarray(rj.converged)))
    mu_t, var_t = predict_ensemble(mt, fit_j, X, y, Xs)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=1e-8)
    mu_fit, _ = predict_ensemble(mt, rt, X, y, X)
    assert (((mu_fit.numpy() - y) ** 2).mean(axis=1) < 0.1).all()


def test_predict_ensemble_loops_for_other_models():
    X, y = batch(B=2, n=12)
    mt = tm.default_model(2, kernel_names=["RBF"], device="cpu")
    flats = mt.pack()[None].repeat(2, 1)
    fit_ = EnsembleFit(flats, torch.zeros(2), torch.zeros(2), torch.ones(2))
    mu, var = predict_ensemble(mt, fit_, X, y, X[:, :5])
    from gp_ss_ak_torch.inference import predict
    kp = mt.kernel.unpack(flats[1, :mt.kernel.n_params])
    mu1, var1 = predict(mt.kernel, kp, flats[1, -1:], t64(X[1]), t64(y[1]),
                        t64(X[1, :5]), mt.likelihood)
    np.testing.assert_array_equal(mu[1].numpy(), mu1.numpy())
    np.testing.assert_array_equal(var[1].numpy(), var1.numpy())


def test_fit_jit_matches_jax_fit_jit():
    X, y = batch(B=1, n=40, d=3, seed=5)
    mj, mt = models(3)
    timing = {}
    fj, rj = jax_fit(mj, X[0], y[0], optimizer="JIT", iters=15)
    ft, rt = fit(mt, X[0], y[0], optimizer="JIT", iters=15, timing=timing)
    assert (rt.n_iters, rt.n_evals, rt.converged, rt.stop_reason) == \
        (rj.n_iters, rj.n_evals, rj.converged, rj.stop_reason)
    assert rt.n_evals == -1 and rt.trace == [rt.fun]
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-6)
    assert rt.fun == pytest.approx(rj.fun, rel=1e-8)
    np.testing.assert_allclose(ft.pack().numpy(), np.asarray(fj.pack()),
                               rtol=1e-6)
    assert ft.num_data == 40 and timing["total_wall_s"] > 0


def test_mesh_waits_for_the_port_of_parallel():
    # named when mesh= raised: parallel/ is ported, and the deposits
    # split over a mesh of one rank give the plain fit bit for bit (at 2
    # and 4 ranks: tests/test_torch_parallel.py)
    from gp_ss_ak_torch.parallel import make_mesh

    X, y = batch(B=2, n=8)
    _, mt = models(2)
    plain = fit_ensemble(mt, X, y, maxiter=3)
    split = fit_ensemble(mt, X, y, maxiter=3, mesh=make_mesh("cpu"))
    for a, b in zip(plain, split):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
