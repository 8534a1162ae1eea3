"""Port parity: the fused Gram build (K1) and its dispatch.

On the CPU the port's wrapper runs K1's plain torch version; the JAX
side runs the Pallas kernel itself in interpret mode (as
tests/test_ops.py does). Both use the |xi|^2 + |xj|^2 - 2 xi.xj
expansion, so they agree to rtol 1e-9 (test_ops.py's own tolerance for
the Pallas kernel against the XLA Gram), float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_torch.model as tm
from gp_ss_ak_tpu.ops import fused as jfused
from gp_ss_ak_tpu.ops.pairwise import expans_bias_gram as jax_gram
from gp_ss_ak_torch.ops import cholesky, fused as tfused, pairwise

RTOL, ATOL = 1e-9, 1e-11
F64 = torch.float64
CPU = torch.device("cpu")


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def models(d, seed=0):
    rng = np.random.default_rng(seed)
    mj = jm.default_model(d)
    flat = np.asarray(mj.pack()) * rng.uniform(0.7, 1.3, size=mj.n_params)
    mj = mj.unpack(jnp.asarray(flat))
    mt = tm.from_flat(["ExpAns", "Bias"], flat, flat[-1:], d, F64, CPU)
    return mj, mt


@pytest.mark.parametrize("d", [3, 4])
@pytest.mark.parametrize("n,m", [(40, None), (37, None), (37, 17),
                                 (64, 64), (1, 5)])
def test_plain_gram_matches_pallas_interpret(n, m, d):
    rng = np.random.default_rng(n * 10 + d)
    X = rng.normal(size=(n, d))
    Y = None if m is None else rng.normal(size=(m, d))
    sigma, bias = 0.7, 0.2
    sn2 = 0.05 if m is None else None
    Kj = np.asarray(jax_gram(jnp.asarray(X), sigma, bias, sn2,
                             None if Y is None else jnp.asarray(Y),
                             interpret=True))
    before = pairwise.launches
    Kt = pairwise.expans_bias_gram(t64(X), t64(sigma), t64(bias),
                                   None if sn2 is None else t64(sn2),
                                   None if Y is None else t64(Y))
    assert pairwise.launches == before    # CPU tensors never launch
    assert tuple(Kt.shape) == Kj.shape and Kt.dtype == F64
    np.testing.assert_allclose(Kt.numpy(), Kj, rtol=RTOL, atol=ATOL)
    if m is None:   # the exact diagonal of the square build
        np.testing.assert_array_equal(torch.diagonal(Kt).numpy(),
                                      sigma * sigma + bias + sn2)


def test_cross_gram_has_no_diagonal_term():
    # even with sn2 given and X* = X, a cross build adds no sn2; atol
    # 1e-7 is the expansion's sqrt of round-off at coincident points
    X = t64(np.random.default_rng(2).normal(size=(9, 3)))
    K = pairwise.expans_bias_gram(X, 0.5, 0.1, 0.5, X.clone())
    np.testing.assert_allclose(torch.diagonal(K).numpy(), 0.25 + 0.1,
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("d", [1, 3, 4])
def test_maybe_fused_A_matches_jax(d):
    mj, mt = models(d, seed=d)
    X = np.random.default_rng(d).normal(size=(37, d)) + 3.0
    sn2 = float(mj.lik_hypers[0])
    Aj = np.asarray(jfused.maybe_fused_A(mj.kernel, mj.kernel_params, sn2,
                                         jnp.asarray(X), jitter=1e-6,
                                         fused=True))
    At = tfused.maybe_fused_A(mt.kernel, mt.kernel_params, t64(sn2), t64(X),
                              jitter=1e-6)
    np.testing.assert_allclose(At.numpy(), Aj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tfused.mapped_points(mt.kernel.children[0], mt.kernel_params[0],
                             t64(X)).numpy(),
        np.asarray(jfused.mapped_points(mj.kernel.children[0],
                                        mj.kernel_params[0],
                                        jnp.asarray(X))),
        rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("d", [3, 4])
def test_fused_cross_gram_matches_jax(d):
    mj, mt = models(d, seed=10 + d)
    rng = np.random.default_rng(d)
    X = rng.normal(size=(33, d)) + 3.0
    Xs = rng.normal(size=(17, d)) + 3.0
    Kj = np.asarray(jfused.fused_cross_gram(mj.kernel, mj.kernel_params,
                                            jnp.asarray(X), jnp.asarray(Xs)))
    Kt = tfused.maybe_fused_cross(mt.kernel, mt.kernel_params, t64(X),
                                  t64(Xs)).detach()
    np.testing.assert_allclose(Kt.numpy(), Kj, rtol=RTOL, atol=ATOL)
    # and both equal the generic Gram (combined-mean recentring)
    Kg = mt.kernel.matrix(mt.kernel_params, t64(X), t64(Xs))
    np.testing.assert_allclose(Kt.numpy(), Kg.numpy(), rtol=RTOL, atol=ATOL)


def test_non_flagship_takes_the_generic_path():
    m = tm.default_model(3, kernel_names=["RBF"], device="cpu")
    X = torch.zeros((8, 3), dtype=F64)
    assert tfused.maybe_fused_A(m.kernel, m.kernel_params, 0.1, X) is None
    assert tfused.maybe_fused_cross(m.kernel, m.kernel_params, X, X) is None


def test_wrapper_never_falls_back_off_cpu():
    X = torch.empty((4, 3), dtype=F64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pairwise.expans_bias_gram(X, 0.5, 0.1, 0.01)


def test_cholesky_nan_on_indefinite_and_lapack_otherwise():
    rng = np.random.default_rng(0)
    B = rng.normal(size=(6, 6))
    A = B @ B.T + 6 * np.eye(6)
    L = cholesky(t64(A))
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(A),
                               rtol=1e-13)
    # same failure form as JAX's: NaN lower triangle, zeros above
    bad = cholesky(t64(A - 50 * np.eye(6))).numpy()
    np.testing.assert_array_equal(bad, np.asarray(jnp.linalg.cholesky(
        jnp.asarray(A - 50 * np.eye(6)))))
    assert np.isnan(bad[np.tril_indices(6)]).all()
