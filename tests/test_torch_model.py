"""Port parity: GPModel and reference-format model files
(gp_ss_ak_torch.model vs gp_ss_ak_tpu.model). Files must be
byte-identical; packed vectors exactly equal."""

import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_torch.model as tm
from gp_ss_ak_tpu.inference import WarpedGaussian
from gp_ss_ak_torch.inference import LIK_WARPGAUSS, make_likelihood
from gp_ss_ak_torch.inference import WarpedGaussian as TWarped

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "model")
F64 = torch.float64
CPU = torch.device("cpu")


def test_golden_model_loads_to_the_same_flat_vector():
    mj = jm.load_model(GOLDEN)
    mt = tm.load_model(GOLDEN, device="cpu")
    np.testing.assert_array_equal(mt.pack().numpy(), np.asarray(mj.pack()))
    assert repr(mt.kernel) == repr(mj.kernel)
    assert (mt.input_dim, mt.output_dim, mt.num_data) == \
        (mj.input_dim, mj.output_dim, mj.num_data)
    assert (mt.inference, mt.mean_function, mt.n_params) == \
        (mj.inference, mj.mean_function, mj.n_params)
    assert mt.pack().dtype == F64


@pytest.mark.parametrize("case", ["golden", "default3", "default4",
                                  "rbf_exp_white", "float32"])
def test_save_model_byte_identical(case, tmp_path):
    rng = np.random.default_rng(5)
    if case == "golden":
        mj, mt = jm.load_model(GOLDEN), tm.load_model(GOLDEN, device="cpu")
    elif case == "float32":
        mj = jm.default_model(3, dtype=jnp.float32)
        mt = tm.default_model(3, dtype=torch.float32, device=CPU)
    else:
        d = 4 if case == "default4" else 3
        names = ["RBF", "Exp", "White"] if case == "rbf_exp_white" else None
        mj = jm.default_model(d, kernel_names=names)
        flat = np.asarray(mj.pack()) * rng.uniform(0.5, 1.5,
                                                  size=mj.n_params)
        mj = mj.unpack(jnp.asarray(flat))
        mt = tm.default_model(d, kernel_names=names, device="cpu").unpack(
            torch.as_tensor(flat, dtype=F64))
    jm.save_model(mj, str(tmp_path / "j"))
    tm.save_model(mt, str(tmp_path / "t"))
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    back = tm.load_model(str(tmp_path / "t"), device="cpu")
    np.testing.assert_array_equal(back.pack().numpy(),
                                  mt.pack().to(F64).numpy())


def test_golden_file_roundtrips_byte_identical(tmp_path):
    tm.save_model(tm.load_model(GOLDEN, device="cpu"), str(tmp_path / "m"))
    with open(GOLDEN, "rb") as f:
        assert (tmp_path / "m").read_bytes() == f.read()


@pytest.mark.parametrize("d", [3, 4])
def test_from_flat_reproduces_jax_gram(d):
    rng = np.random.default_rng(d)
    mj = jm.default_model(d)
    flat = np.asarray(mj.pack()) * rng.uniform(0.7, 1.3, size=mj.n_params)
    mj = mj.unpack(jnp.asarray(flat))
    mt = tm.from_flat(["ExpAns", "Bias"], np.asarray(mj.pack()),
                      np.asarray(mj.lik_hypers), d, F64, CPU)
    np.testing.assert_array_equal(mt.pack().numpy(), np.asarray(mj.pack()))
    X = rng.normal(size=(30, d))
    Kj = np.asarray(mj.kernel.matrix(mj.kernel_params, jnp.asarray(X),
                                     jnp.asarray(X), True))
    Kt = mt.kernel.matrix(mt.kernel_params, torch.as_tensor(X),
                          torch.as_tensor(X), True)
    np.testing.assert_allclose(Kt.numpy(), Kj, rtol=1e-12, atol=1e-15)


def test_from_flat_rejects_short_vector():
    with pytest.raises(ValueError):
        tm.from_flat(["ExpAns", "Bias"], np.ones(5), [0.1], 3, F64, CPU)


def test_pack_unpack_to():
    m = tm.default_model(3, device="cpu")
    flat = m.pack()
    assert m.n_params == flat.numel() == 10
    m2 = m.unpack(flat * 2.0)
    np.testing.assert_array_equal(m2.pack().numpy(), flat.numpy() * 2.0)
    m32 = m.to(torch.float32, CPU)
    assert m32.pack().dtype == torch.float32
    assert m32.lik_hypers.dtype == torch.float32
    assert m32.kernel_params[0]["Sigma"].dtype == torch.float32
    np.testing.assert_allclose(m32.pack().numpy(), flat.numpy(), rtol=1e-7)


def test_warped_model_file_is_not_ported(tmp_path):
    # asserts that the warped model file IS ported: a JAX-written file
    # loads in the port (family and triplets from its comment line) and
    # is written back byte for byte
    for family, m in (("tanh1", 1), ("rbf", 2), ("srbf", 1)):
        _warped_file_round_trip(tmp_path, family, m)
    with pytest.raises(ValueError):
        make_likelihood(5)


def _warped_file_round_trip(tmp_path, family, m):
    mj = jm.default_model(3)
    wlik = WarpedGaussian(family=family, n_triplets=m)
    lh = np.linspace(-0.7, 0.9, wlik.n_hypers)
    mj = replace(mj, likelihood=wlik, lik_hypers=jnp.asarray(lh))
    jm.save_model(mj, str(tmp_path / "w"))
    mt = tm.load_model(str(tmp_path / "w"), device="cpu")
    assert mt.likelihood == TWarped(family, m)
    assert mt.likelihood == make_likelihood(LIK_WARPGAUSS, family, m)
    np.testing.assert_array_equal(mt.pack().numpy(), np.asarray(mj.pack()))
    tm.save_model(mt, str(tmp_path / "t"))
    assert (tmp_path / "t").read_bytes() == (tmp_path / "w").read_bytes()
    # from_flat carries the same warped model across
    nk = mj.kernel.n_params
    flat = np.asarray(mj.pack())
    mf = tm.from_flat(["ExpAns", "Bias"], flat[:nk], flat[nk:], 3,
                      F64, CPU, likelihood=TWarped(family, m))
    tm.save_model(mf, str(tmp_path / "f"))
    assert (tmp_path / "f").read_bytes() == (tmp_path / "w").read_bytes()
