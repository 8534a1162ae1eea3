"""Port parity: sparse GP regression (inference/sgpr.py) and the
differentiable cross-Gram it builds Kmn with (ops/fused.py,
FusedExpansBiasCross), float64 on the CPU.

The same numpy inputs go through the JAX package and the port. The
inducing points start as a subset of the data (`init_inducing`), so
K(Z, X) holds coincident pairs, and the tests keep them. Tolerance:
rtol 1e-9 of each result's largest entry, with two stated exceptions,
both from those pairs. There the Gram expansion |z|^2 + |x|^2 - 2 z.x
leaves either an exact zero or a round-off of ~1e-16 in d^2, by the
luck of the sums, and each package's expansion (JAX's `kernel.matrix`,
the port's K1 plain version) leaves it at other pairs:
  * K itself then differs by s^2 sqrt(1e-16) ~ 1e-8 at such a pair, and
    the ELBO's gradient in Z and the predictions, which the m x m
    algebra couples to every entry, move by up to ~1e-8 of their
    largest entry: they are held within 1e-7 of it (measured 1e-8 and
    3e-9). The value and the hyperparameter gradient hold at 1e-9.
  * With G given, autograd through the expansion (the reference of the
    cross-Gram backward) multiplies a near-zero difference by 1/(2r)
    ~ 1e8 and returns noise of ~sqrt(eps) of that point's gradient,
    where the port's closed form gives the pair its zero gradient (r by
    direct differences, as K1 computes it on the card). Those rows,
    found from the reference's own Gram, are held within 1e-7 of the
    largest entry, the others at 1e-9; the test asserts that it meets
    coincident pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_torch.model as tm
from gp_ss_ak_tpu.inference import nlml as j_nlml
from gp_ss_ak_tpu.inference import sgpr as js
from gp_ss_ak_tpu.ops import fused as jf
from gp_ss_ak_torch.inference import gaussian as tg
from gp_ss_ak_torch.inference import sgpr as ts
from gp_ss_ak_torch.ops import fused as tf
from gp_ss_ak_torch.ops.pairwise import expans_bias_gram

F64 = torch.float64
RTOL = 1e-9
NOISY_RTOL = 1e-7

# one intra-op thread per process: the suite runs on several workers at
# once, and torch's default (a thread per core in every worker)
# oversubscribes the cores and slows these small CPU ops many times over
torch.set_num_threads(1)


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def problem(n=150, m=24, d=2, seed=61, kernels=None):
    """Data, JAX's inducing subset of it (the one `fit_sgpr` draws, seed
    0), and the default model in both packages (the flagship
    Sum([ExpAns, Bias]), or `kernels`)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, d))
    y = np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n)
    Z = np.asarray(js.init_inducing(jnp.asarray(X), m))
    knoise = kernels is None
    names = kernels or ["ExpAns"]
    mj = jm.default_model(input_dim=d, kernel_names=names, knoise=knoise,
                          dtype=jnp.float64)
    mt = tm.default_model(d, names, knoise=knoise, dtype=F64, device="cpu")
    return X, y, Z, mj, mt


def flat_of(mj):
    return np.asarray(jnp.concatenate([mj.kernel.pack(mj.kernel_params),
                                       mj.lik_hypers]))


def coincident_rows(K, scale):
    """Rows of K(Z, X) with a coincident pair, and the rows where the
    expansion left round-off there (|K - scale| tiny but nonzero)."""
    gap = np.abs(np.asarray(K) - scale)
    near = gap < 1e-6
    return (np.flatnonzero(near.any(axis=1)),
            np.flatnonzero((near & (gap > 0)).any(axis=1)))


def close_rows(got, want, noisy):
    """rtol 1e-9 of the largest entry, except the `noisy` rows (module
    docstring), held within 1e-7 of it."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    ok = np.setdiff1d(np.arange(want.shape[0]), noisy)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(got[noisy], want[noisy], rtol=0,
                               atol=NOISY_RTOL * scale)


@pytest.mark.parametrize("kernels", [None, ["ExpAns"]],
                         ids=["flagship", "generic"])
def test_neg_elbo_and_its_gradients_match_jax(kernels):
    X, y, Z, mj, mt = problem(kernels=kernels)
    flat = flat_of(mj)

    def jobj(f, Zj):
        kp = mj.kernel.unpack(f[:-1])
        return js.neg_elbo(mj.kernel, kp, f[-1:], jnp.asarray(X),
                           jnp.asarray(y), Zj)

    vj, (gfj, gZj) = jax.value_and_grad(jobj, argnums=(0, 1))(
        jnp.asarray(flat), jnp.asarray(Z))
    ft = torch.tensor(flat, requires_grad=True)
    Zt = torch.tensor(Z, requires_grad=True)
    kp = mt.kernel.unpack(ft[:-1])
    vt = ts.neg_elbo(mt.kernel, kp, ft[-1:], torch.tensor(X),
                     torch.tensor(y), Zt)
    gft, gZt = torch.autograd.grad(vt, [ft, Zt])
    et = ts.elbo(mt.kernel, kp, ft[-1:], torch.tensor(X), torch.tensor(y),
                 Zt)
    assert float(et.detach()) == -float(vt.detach())
    close(float(vt.detach()), float(vj))
    close(gft.numpy(), gfj)
    close(gZt.numpy(), gZj, rtol=NOISY_RTOL)
    assert np.abs(gZt.numpy()).max() > 0


def test_predict_matches_jax():
    X, y, Z, mj, mt = problem(n=100, m=40)
    Xs = np.random.default_rng(7).uniform(-1, 1, size=(15, 2))
    for with_noise in (True, False):
        muj, varj = js.predict(mj.kernel, mj.kernel_params, mj.lik_hypers,
                               jnp.asarray(X), jnp.asarray(y),
                               jnp.asarray(Z), jnp.asarray(Xs),
                               with_noise=with_noise)
        mut, vart = ts.predict(mt.kernel, mt.kernel_params, mt.lik_hypers,
                               torch.tensor(X), torch.tensor(y),
                               torch.tensor(Z), torch.tensor(Xs),
                               with_noise=with_noise)
        close(mut.numpy(), muj, rtol=NOISY_RTOL)
        close(vart.numpy(), varj, rtol=NOISY_RTOL)
        assert (vart.numpy() >= 0).all()


@pytest.mark.parametrize("optimize_z", [True, False])
def test_fit_sgpr_matches_jax(optimize_z, monkeypatch):
    # JAX's inducing subset is injected into the port, whose
    # init_inducing draws from a torch.Generator
    X, y, Z, mj, mt = problem()
    monkeypatch.setattr(ts, "init_inducing",
                        lambda X_, m, seed=0: torch.tensor(Z))
    fj, Zj, rj = js.fit_sgpr(mj, jnp.asarray(X), jnp.asarray(y), m=24,
                             iters=30, optimize_z=optimize_z)
    ft, Zt, rt = ts.fit_sgpr(mt, torch.tensor(X), torch.tensor(y), m=24,
                             iters=30, optimize_z=optimize_z)
    assert (rt.n_iters, rt.stop_reason) == (rj.n_iters, rj.stop_reason)
    assert rt.fun == pytest.approx(rj.fun, rel=1e-6)
    assert rt.fun < rt.trace[0] - 1.0
    assert rt.x.shape == rj.x.shape
    close(Zt.numpy(), Zj, rtol=1e-6)
    if not optimize_z:
        np.testing.assert_array_equal(Zt.numpy(), Z)
    close(ft.pack().numpy(), np.asarray(fj.pack()), rtol=1e-6)
    assert (ft.num_data, ft.input_dim) == (fj.num_data, fj.input_dim)


def test_elbo_is_a_lower_bound_on_the_evidence():
    X, y, _, _, mt = problem(n=80)
    Z = ts.init_inducing(torch.tensor(X), 20)
    args = (mt.kernel, mt.kernel_params, mt.lik_hypers, torch.tensor(X),
            torch.tensor(y))
    bound = float(ts.elbo(*args, Z))
    log_ev = -float(tg.nlml(*args, mt.likelihood))
    assert bound <= log_ev + 1e-6
    # and the JAX evidence agrees with the port's
    _, _, _, mj, _ = problem(n=80)
    close(-log_ev, float(j_nlml(mj.kernel, mj.kernel_params, mj.lik_hypers,
                                jnp.asarray(X), jnp.asarray(y))))


def test_tight_when_inducing_equals_data():
    X, y, _, _, mt = problem(n=40)
    Xt = torch.tensor(X)
    args = (mt.kernel, mt.kernel_params, mt.lik_hypers, Xt,
            torch.tensor(y))
    bound = float(ts.elbo(*args, Xt, jitter=1e-10))
    log_ev = -float(tg.nlml(*args, mt.likelihood))
    assert bound == pytest.approx(log_ev, abs=1e-3)


def test_init_inducing_is_a_seeded_subset():
    X = torch.tensor(np.random.default_rng(0).uniform(-1, 1, (50, 3)))
    Z = ts.init_inducing(X, 20, seed=3)
    rows = {tuple(r) for r in X.tolist()}
    assert Z.shape == (20, 3)
    assert len({tuple(r) for r in Z.tolist()}) == 20
    assert all(tuple(r) in rows for r in Z.tolist())
    assert torch.equal(Z, ts.init_inducing(X, 20, seed=3))
    assert not torch.equal(Z, ts.init_inducing(X, 20, seed=4))
    assert ts.init_inducing(X, 80).shape == (50, 3)


def _cross_inputs(d, seed, coincident):
    rng = np.random.default_rng(seed)
    Xi = rng.uniform(-1.5, 1.5, size=(24, d))
    Xj = rng.uniform(-1.5, 1.5, size=(40, d))
    if coincident:
        Xi[::3] = Xj[1:17:2]        # 8 exact coincident pairs
    G = rng.normal(size=(24, 40))
    return Xi, Xj, G


@pytest.mark.parametrize("d", [3, 4])
def test_cross_backward_matches_jax_vjp(d):
    # JAX's custom VJP (fused.py:64-95, its Pallas forward in interpret
    # mode) at distinct points
    Xi, Xj, G = _cross_inputs(d, seed=d, coincident=False)
    s, b = 0.7, 0.25
    Kj, vjp = jax.vjp(jf.fused_expans_bias_cross, jnp.asarray(Xi),
                      jnp.asarray(Xj), s, b)
    gj = vjp(jnp.asarray(G))
    leaves = [torch.tensor(v, dtype=F64, requires_grad=True)
              for v in (Xi, Xj, s, b)]
    Kt = tf.fused_expans_bias_cross(*leaves)
    gt = torch.autograd.grad((Kt * torch.from_numpy(G)).sum(), leaves)
    close(Kt.detach().numpy(), Kj)
    for a, c in zip(gt, gj):
        close(a.numpy(), c)


def test_cross_backward_matches_autograd_through_kernel_matrix():
    """The flagship's cross-Gram through K1's plain version and the
    closed-form backward (`maybe_fused_cross`) against autograd through
    the generic Gram (`kernel.matrix`) of the same model, in every
    hyperparameter and both point sets, with coincident pairs."""
    Xi, Xj, G = _cross_inputs(3, seed=11, coincident=True)
    mt = tm.default_model(3, dtype=F64, device="cpu")
    flat = mt.pack().detach()

    def grads(build):
        f = flat.clone().requires_grad_(True)
        A = torch.tensor(Xi, requires_grad=True)
        B = torch.tensor(Xj, requires_grad=True)
        K = build(mt.kernel, mt.kernel.unpack(f[:mt.kernel.n_params]), A, B)
        return (K.detach(),) + torch.autograd.grad(
            (K * torch.from_numpy(G)).sum(), [f, A, B])

    fused = grads(tf.maybe_fused_cross)
    ref = grads(lambda k, p, A, B: k.matrix(p, A, B, same=False))
    close(fused[0].numpy(), ref[0].numpy())
    close(fused[1].numpy(), ref[1].numpy())
    s2b = float(mt.kernel.diag(mt.kernel_params, torch.tensor(Xi[:1]))[0])
    rows, noisy_i = coincident_rows(ref[0].numpy(), s2b)
    assert len(rows) == 8
    _, noisy_j = coincident_rows(ref[0].numpy().T, s2b)
    close_rows(fused[2].numpy(), ref[2].numpy(), noisy_i)
    close_rows(fused[3].numpy(), ref[3].numpy(), noisy_j)
    # no NaN or inf reaches the gradient at the coincident pairs
    assert all(np.isfinite(g.numpy()).all() for g in fused[1:])


def test_cross_gradcheck_and_serving_entry_agree():
    Xi, Xj, _ = _cross_inputs(3, seed=2, coincident=False)
    args = [torch.tensor(v, dtype=F64, requires_grad=True)
            for v in (Xi[:6], Xj[:7], 0.8, 0.3)]
    assert torch.autograd.gradcheck(tf.fused_expans_bias_cross, args)
    # the serving entry (gaussian._cross_gram, through the
    # differentiable cross) gives the bits of K1's cross entry on the
    # mapped points
    mt = tm.default_model(3, dtype=F64, device="cpu")
    A, B = torch.tensor(Xi), torch.tensor(Xj)
    kp = mt.kernel_params
    with torch.no_grad():
        Am, Bm = tf._cross_points(mt.kernel, kp, A, B)
        assert torch.equal(
            tg._cross_gram(mt.kernel, kp, A, B),
            expans_bias_gram(Am, kp[0]["Sigma"], kp[1]["Sigma"], None,
                             Xm2=Bm))
    generic = tm.default_model(3, knoise=False, dtype=F64, device="cpu")
    assert tf.maybe_fused_cross(generic.kernel, generic.kernel_params, A,
                                B) is None
