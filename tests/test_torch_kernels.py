"""Port parity: the kernel library (gp_ss_ak_torch.kernels vs
gp_ss_ak_tpu.kernels), float64 on the CPU.

Both packages evaluate the same closed forms with the same Gram
expansion; only the summation order inside the small matmuls may
differ, so matrices agree to rtol 1e-12 (atol 1e-15 covers entries
that underflow toward zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.kernels as jk
import gp_ss_ak_torch.kernels as tk
from gp_ss_ak_tpu.kernels import distance as jdist
from gp_ss_ak_torch.kernels import distance as tdist

RTOL, ATOL = 1e-12, 1e-15
F64 = torch.float64
CPU = torch.device("cpu")

SPECS = {
    "ExpAns": ["ExpAns"],
    "Bias": ["Bias"],
    "White": ["White"],
    "RBF": ["RBF"],
    "Exp": ["Exp"],
    "Sum(ExpAns,Bias)": ["ExpAns", "Bias"],
    "Sum(RBF,Exp,White)": ["RBF", "Exp", "White"],
}


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def pair(spec, seed):
    """The same kernel in both packages with the same random params."""
    names = SPECS[spec]
    if len(names) == 1:
        kj, kt = jk.make_kernel(names[0]), tk.make_kernel(names[0])
    else:
        kj = jk.Sum([jk.make_kernel(n) for n in names])
        kt = tk.Sum([tk.make_kernel(n) for n in names])
    rng = np.random.default_rng(seed)
    flat0 = np.asarray(kj.pack(kj.init_params(jnp.float64)))
    flat = flat0 * (1.0 + 0.3 * rng.uniform(-1.0, 1.0, size=flat0.shape))
    return kj, kj.unpack(jnp.asarray(flat)), kt, kt.unpack(t64(flat)), flat


@pytest.mark.parametrize("same", [True, False], ids=["same", "cross"])
@pytest.mark.parametrize("d", [1, 3, 4])
@pytest.mark.parametrize("spec", list(SPECS))
def test_matrix_and_diag_match_jax(spec, d, same):
    kj, pj, kt, pt, _ = pair(spec, seed=d)
    rng = np.random.default_rng(7 + d)
    X1 = rng.normal(size=(23, d)) + 5.0   # a common offset, as in UTM data
    X2 = X1 if same else rng.normal(size=(11, d)) + 5.0
    Kj = np.asarray(kj.matrix(pj, jnp.asarray(X1), jnp.asarray(X2), same))
    Kt = kt.matrix(pt, t64(X1), t64(X2), same)
    assert Kt.dtype == F64 and tuple(Kt.shape) == Kj.shape
    np.testing.assert_allclose(Kt.numpy(), Kj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(kt.diag(pt, t64(X1)).numpy(),
                               np.asarray(kj.diag(pj, jnp.asarray(X1))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("spec", list(SPECS))
def test_metadata_and_packing_match_jax(spec):
    kj, _, kt, pt, flat = pair(spec, seed=0)
    assert kt.name == kj.name
    assert kt.n_params == kj.n_params
    assert tuple(kt.param_names) == tuple(kj.param_names)
    assert tuple(kt.file_param_names()) == tuple(kj.file_param_names())
    np.testing.assert_array_equal(kt.pack(pt).numpy(), flat)
    init_j = np.asarray(kj.pack(kj.init_params(jnp.float64)))
    init_t = kt.pack(kt.init_params(F64, CPU)).numpy()
    np.testing.assert_array_equal(init_t, init_j)


@pytest.mark.parametrize("seed", range(4))
def test_rotation_matrix_matches_jax(seed):
    a, b, c = np.random.default_rng(seed).uniform(-np.pi, np.pi, size=3)
    Rj = np.asarray(jdist.rotation_matrix_3d(jnp.float64(a), jnp.float64(b),
                                             jnp.float64(c)))
    Rt = tdist.rotation_matrix_3d(t64(a), t64(b), t64(c))
    np.testing.assert_allclose(Rt.numpy(), Rj, rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("d", [1, 3, 4, 6])
def test_anisotropic_metric_matches_jax(d):
    _, pj, _, pt, _ = pair("ExpAns", seed=10 + d)
    Mj = np.asarray(jdist.anisotropic_metric(pj, d))
    Mt = tdist.anisotropic_metric(pt, d)
    assert tuple(Mt.shape) == (max(d, 3),) * 2
    np.testing.assert_allclose(Mt.numpy(), Mj, rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("same", [True, False], ids=["same", "cross"])
def test_distance_helpers_match_jax(same):
    rng = np.random.default_rng(3)
    A1 = rng.normal(size=(19, 3))
    A2 = A1 if same else rng.normal(size=(8, 3))
    D = tdist.gram_sqdist(t64(A1), t64(A2), same)
    np.testing.assert_allclose(
        D.numpy(), np.asarray(jdist.gram_sqdist(jnp.asarray(A1),
                                                jnp.asarray(A2), same)),
        rtol=RTOL, atol=1e-14)
    if same:
        assert (torch.diagonal(D) == 0).all()
    hyp = 0.7
    np.testing.assert_allclose(
        tdist.sq_euclidean(t64(A1), t64(A2), t64(hyp), same).numpy(),
        np.asarray(jdist.sq_euclidean(jnp.asarray(A1), jnp.asarray(A2),
                                      jnp.float64(hyp), same)),
        rtol=RTOL, atol=1e-14)
    x = np.array([0.0, 1e-30, 2.0, 9.0])
    # XLA's CPU sqrt may differ from torch's by one ulp
    np.testing.assert_allclose(tdist.safe_sqrt(t64(x)).numpy(),
                               np.asarray(jdist.safe_sqrt(jnp.asarray(x))),
                               rtol=4e-16, atol=0)
    for d in (1, 2, 3, 5):
        Z = rng.normal(size=(4, d))
        np.testing.assert_array_equal(
            tdist.pad_to_3d(t64(Z)).numpy(),
            np.asarray(jdist.pad_to_3d(jnp.asarray(Z))))


def test_registry_names_and_default_kernel():
    assert set(tk.available_kernels()) == set(jk.available_kernels())
    for name in jk.available_kernels():
        assert type(tk.make_kernel(name)).__name__ == \
            type(jk.make_kernel(name)).__name__
    assert repr(tk.default_train_kernel()) == repr(jk.default_train_kernel())
    with pytest.raises(ValueError):
        tk.make_kernel("Matern")


def test_bias_is_not_squared():
    k = tk.Bias()
    p = k.unpack(t64([0.3]))
    K = k.matrix(p, torch.zeros(4, 3, dtype=F64), torch.zeros(2, 3,
                                                             dtype=F64))
    assert torch.all(K == 0.3)


@pytest.mark.parametrize("drop", [None, "Sigma"])
def test_check_params_matches_jax(drop):
    """kernels.base.check_params: silent on complete parameters, the
    same ValueError text as JAX's on missing ones."""
    from gp_ss_ak_tpu.kernels.base import check_params as j_check
    from gp_ss_ak_torch.kernels.base import check_params as t_check

    jker, tker = jk.ExpAns(), tk.ExpAns()
    jp = {k: v for k, v in jker.init_params(jnp.float64).items()
          if k != drop}
    tp = {k: v for k, v in tker.init_params(torch.float64,
                                            torch.device("cpu")).items()
          if k != drop}
    if drop is None:
        assert j_check(jker, jp) is None and t_check(tker, tp) is None
        return
    with pytest.raises(ValueError) as je:
        j_check(jker, jp)
    with pytest.raises(ValueError) as te:
        t_check(tker, tp)
    assert str(te.value) == str(je.value) == "ExpAns: missing params ['Sigma']"
