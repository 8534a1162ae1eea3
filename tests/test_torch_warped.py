"""Port parity: the warped-Gaussian likelihood end to end (dense NLML and
its gradients, dense prediction, the matrix-free value and gradient),
the jitter-retry factorization, and the CLI `train`'s training-set
predict, against the JAX package on the CPU.

Tolerances, float64 unless stated:
  * the warped NLML: value rtol 1e-10 in both grad modes; gradients over
    the kernel's and the warp's hypers, QW vs autodiff vs jax.grad, rtol
    1e-8 (the same algebra; round-off amplified by the conditioning of
    A, as tests/test_torch_train_grad.py explains);
  * warped predict / posterior_mean_var: mu and var rtol 1e-8;
  * robust_cholesky on one matrix: the same nugget (rel 1e-13: the
    scale is a mean summed in another order), L rtol 1e-10 where a
    nugget was added; a singular A that potrf still factors gives a
    factor whose trailing entries are round-off, held by L L^T = A;
  * the matrix-free value and gradient (float32, the same probes): the
    two-mode tolerances of tests/test_torch_iterative_train.py (value
    rel 1e-4 + 0.05, gradient rtol 1e-3 of its largest entry);
  * the CLI from the same starting model (`-# 0`): model files byte for
    byte; the training MSE equal to the full dense predict's (the route
    before the training-set predict was bounded) at rtol 1e-10, and to
    the JAX CLI's at rtol 1e-6: at the training inputs the cross-Gram's
    diagonal holds coincident points, where both packages' expansion
    of the squared distance leaves sqrt(round-off) ~ 1e-8 of K, in
    another amount in each (mu differs by ~2e-8 there, and by ~1e-12 a
    millimetre away); `test` output rtol 1e-8.
"""

import math
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_torch.model as tm
from gp_ss_ak_tpu.cli import main as jax_main
from gp_ss_ak_tpu.inference import WarpedGaussian as JW
from gp_ss_ak_tpu.inference import posterior_mean_var as j_pmv
from gp_ss_ak_tpu.inference import predict as j_predict
from gp_ss_ak_tpu.inference import nlml as j_nlml
from gp_ss_ak_tpu.optim import flat_nlml_fn as j_flat_nlml_fn
from gp_ss_ak_tpu.optim.iterative_fit import (
    make_iterative_value_and_grad as j_make_vg,
)
from gp_ss_ak_tpu.serve import Predictor as JPredictor
from gp_ss_ak_tpu.utils import robust_cholesky as j_robust
from gp_ss_ak_torch import cli, serve
from gp_ss_ak_torch.cli import main as torch_main
from gp_ss_ak_torch.data import prepare, read_data, unapply_y, write_data
from gp_ss_ak_torch.inference import WarpedGaussian as TW
from gp_ss_ak_torch.inference import factorize, posterior_mean
from gp_ss_ak_torch.inference import iterative as ti
from gp_ss_ak_torch.inference import nlml as t_nlml
from gp_ss_ak_torch.inference import posterior_mean_var as t_pmv
from gp_ss_ak_torch.inference import predict as t_predict
from gp_ss_ak_torch.optim import flat_nlml_fn as t_flat_nlml_fn
from gp_ss_ak_torch.optim.iterative_fit import (
    make_iterative_value_and_grad as t_make_vg,
)
from gp_ss_ak_torch.utils import is_spd_cholesky, robust_cholesky

F64 = torch.float64
CPU = torch.device("cpu")
NAMES = ["ExpAns", "Bias"]

# one intra-op thread per process: the suite runs on several workers at
# once, and torch's default (a thread per core in every worker)
# oversubscribes the cores and slows these small CPU ops many times over
torch.set_num_threads(1)

#: (family, triplets, warp hypers + noise theta)
WARPS = {
    "tanh1-1": ("tanh1", 1, [0.2, 0.5, 0.1, -1.5]),
    "tanh1-2": ("tanh1", 2, [0.2, -0.3, 0.5, 0.2, 0.1, -0.4, -1.5]),
    "rbf-1": ("rbf", 1, [-0.4, 0.3, 0.2, -1.5]),
}


def close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def warped_models(case, dtype=F64, seed=0):
    """The JAX and torch flagship models with the same perturbed kernel
    hypers and the warped likelihood of `case`."""
    family, m, lh = WARPS[case]
    rng = np.random.default_rng(seed)
    mj = jm.default_model(3)
    kflat = np.asarray(mj.kernel.pack(mj.kernel_params)) * rng.uniform(
        0.8, 1.2, size=mj.kernel.n_params)
    mj = replace(mj, kernel_params=mj.kernel.unpack(jnp.asarray(kflat)),
                 likelihood=JW(family, m), lik_hypers=jnp.asarray(lh))
    mt = tm.from_flat(NAMES, kflat, lh, 3, dtype, CPU,
                      likelihood=TW(family, m))
    return mj, mt, np.concatenate([kflat, lh])


def skewed(n, seed):
    """Points in [-1, 1]^3 and a skewed positive grade exp(0.8 f)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 3))
    return X, np.exp(0.8 * np.sin(X @ np.array([3.0, 1.0, 2.0])))


@pytest.mark.parametrize("case", list(WARPS))
def test_warped_nlml_and_gradients_match_jax(case):
    mj, mt, flat = warped_models(case)
    X, y = skewed(48, seed=1)
    fj = j_flat_nlml_fn(mj, grad_mode="autodiff")
    vj, gj = jax.value_and_grad(lambda p: fj(p, jnp.asarray(X),
                                             jnp.asarray(y)))(
        jnp.asarray(flat))
    for mode in ("qw", "autodiff"):
        p = torch.tensor(flat, dtype=F64, requires_grad=True)
        v = t_flat_nlml_fn(mt, grad_mode=mode)(p, torch.from_numpy(X),
                                               torch.from_numpy(y))
        (g,) = torch.autograd.grad(v, p)
        assert float(v.detach()) == pytest.approx(float(vj), rel=1e-10)
        close(g.numpy(), gj, rtol=1e-8)
    # the warp's amplitude and the noise carry gradient (rbf's centre
    # hyper only while exp(-t2) lies above max(y))
    assert abs(float(gj[9])) > 0 and abs(float(gj[-1])) > 0


@pytest.mark.parametrize("case", list(WARPS))
def test_warped_predict_matches_jax(case):
    mj, mt, _ = warped_models(case, seed=2)
    X, y = skewed(40, seed=3)
    Xs = np.random.default_rng(4).uniform(-1, 1, size=(9, 3))
    mu_j, var_j = j_predict(mj.kernel, mj.kernel_params, mj.lik_hypers,
                            jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xs),
                            mj.likelihood)
    Xt, yt, Xst = (torch.from_numpy(a) for a in (X, y, Xs))
    mu_t, var_t = t_predict(mt.kernel, mt.kernel_params, mt.lik_hypers, Xt,
                            yt, Xst, mt.likelihood)
    close(mu_t.numpy(), mu_j, rtol=1e-8)
    close(var_t.numpy(), var_j, rtol=1e-8)
    post = factorize(mt.kernel, mt.kernel_params, mt.lik_hypers, Xt, yt,
                     mt.likelihood)
    assert float(post.y_max) == y.max() and post.nugget is None
    mu_f, var_f, none = t_pmv(mt.kernel, mt.kernel_params, mt.lik_hypers, Xt,
                              post, Xst, mt.likelihood, full_cov=True)
    assert none is None
    jpost = jax_factorize(mj, X, y)
    mu_fj, var_fj, _ = j_pmv(mj.kernel, mj.kernel_params, mj.lik_hypers,
                             jnp.asarray(X), jpost, jnp.asarray(Xs),
                             mj.likelihood, full_cov=True)
    close(mu_f.numpy(), mu_fj, rtol=1e-8)
    close(var_f.numpy(), var_fj, rtol=1e-8)
    # the chunked mean (the CLI's training-set predict) is the same mean
    mu_c = posterior_mean(mt.kernel, mt.kernel_params, mt.lik_hypers, Xt,
                          post, Xst, mt.likelihood, chunk=4)
    close(mu_c.numpy(), mu_t.numpy(), rtol=1e-12)


def jax_factorize(mj, X, y):
    from gp_ss_ak_tpu.inference import factorize as jf

    return jf(mj.kernel, mj.kernel_params, mj.lik_hypers, jnp.asarray(X),
              jnp.asarray(y), mj.likelihood)


def test_gaussian_posterior_mean_is_predicts_mean():
    mt = tm.default_model(3, device=CPU)
    X, y = skewed(50, seed=5)
    Xs = np.random.default_rng(6).uniform(-1, 1, size=(23, 3))
    Xt, yt, Xst = (torch.from_numpy(a) for a in (X, y, Xs))
    post = factorize(mt.kernel, mt.kernel_params, mt.lik_hypers, Xt, yt)
    mu, _ = t_pmv(mt.kernel, mt.kernel_params, mt.lik_hypers, Xt, post, Xst)
    for chunk in (5, 4096):
        close(posterior_mean(mt.kernel, mt.kernel_params, mt.lik_hypers, Xt,
                             post, Xst, chunk=chunk).numpy(), mu.numpy(),
              rtol=1e-12)


def test_identity_like_warp_matches_the_plain_gaussian():
    # a = exp(-12) makes the tanh warp numerically the identity; the
    # noise theta gives exp(2 theta) = 0.016 (tests/test_inference.py:
    # 138-147)
    X, y = skewed(30, seed=7)
    mg = tm.default_model(3, device=CPU)
    lh = [-12.0, 0.0, 0.0, 0.5 * math.log(0.016)]
    mw = replace(mg, likelihood=TW("tanh1", 1),
                 lik_hypers=torch.tensor(lh, dtype=F64))
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    for mode in ("qw", "autodiff"):
        vw = t_nlml(mw.kernel, mw.kernel_params, mw.lik_hypers, Xt, yt,
                    mw.likelihood, grad_mode=mode)
        vg = t_nlml(mg.kernel, mg.kernel_params, mg.lik_hypers, Xt, yt,
                    grad_mode=mode)
        assert float(vw) == pytest.approx(float(vg), rel=1e-5)
    vj = j_nlml(*_jax_flagship(lh), jnp.asarray(X), jnp.asarray(y),
                likelihood=JW("tanh1", 1))
    assert float(vw) == pytest.approx(float(vj), rel=1e-10)
    Xs = torch.from_numpy(X[:6] + 0.05)
    mu_w, var_w = t_predict(mw.kernel, mw.kernel_params, mw.lik_hypers, Xt,
                            yt, Xs, mw.likelihood)
    mu_g, var_g = t_predict(mg.kernel, mg.kernel_params, mg.lik_hypers, Xt,
                            yt, Xs)
    # the mix measures its spread around the latent mean with weights
    # of variance 1/2 (quadrature.py): var_w = var / 2, mu_w = mu
    close(mu_w.numpy(), mu_g.numpy(), rtol=1e-4)
    close(var_w.numpy(), 0.5 * var_g.numpy(), rtol=1e-4)


def _jax_flagship(lh):
    mj = jm.default_model(3)
    return mj.kernel, mj.kernel_params, jnp.asarray(lh)


@pytest.mark.parametrize("noise", [1e-12, -1e-9, -1e-6])
def test_robust_cholesky_on_degenerate_duplicates_matches_jax(noise):
    # tests/test_utils_serve.py:108-119's case: exact duplicate inputs
    # make K singular; with the noise 1e-12 (that test's) potrf still
    # succeeds in float64, a negative one takes one or more retries. One
    # matrix goes to both packages
    X = np.random.default_rng(53).normal(size=(30, 3))
    X[15:] = X[:15]
    mj = jm.default_model(3)
    A = np.asarray(mj.kernel.matrix(mj.kernel_params, jnp.asarray(X),
                                    jnp.asarray(X), True)) + noise * np.eye(30)
    Lj, nj = j_robust(jnp.asarray(A))
    Lt, nt = robust_cholesky(torch.from_numpy(A))
    assert bool(is_spd_cholesky(Lt))
    assert float(nt) == pytest.approx(float(nj), rel=1e-13)
    assert (float(nt) > 0.0) == (noise < 0)
    if noise < 0:
        close(Lt.numpy(), Lj, rtol=1e-10)
    else:
        close((Lt @ Lt.T).numpy(), A, rtol=1e-12)
    # an SPD matrix takes no nugget; a hopeless one stays NaN
    B = np.random.default_rng(1).normal(size=(20, 20))
    L, nug = robust_cholesky(torch.from_numpy(B @ B.T + 20 * np.eye(20)))
    assert float(nug) == 0.0 and bool(is_spd_cholesky(L))
    L, _ = robust_cholesky(-torch.eye(10, dtype=F64), max_attempts=3)
    assert not bool(is_spd_cholesky(L))


@pytest.mark.parametrize("noise", [1e-12, -1e-6])
def test_robust_predictor_serves_degenerate_duplicates(noise):
    rng = np.random.default_rng(53)
    X = rng.normal(size=(30, 3))
    X[15:] = X[:15]
    y = np.sin(X[:, 0])
    mt = replace(tm.default_model(3, device=CPU),
                 lik_hypers=torch.tensor([noise], dtype=F64))
    server = serve.Predictor(mt, X, y, robust=True)
    mu, var = server(X[:5])
    assert np.isfinite(mu).all() and np.isfinite(var).all()
    mj = replace(jm.default_model(3), lik_hypers=jnp.asarray([noise]))
    jserver = JPredictor(mj, X, y, robust=True)
    assert float(server.nugget) == pytest.approx(float(jserver.nugget),
                                                 rel=1e-12)
    assert (float(server.nugget) > 0.0) == (noise < 0)
    # at the duplicated training inputs the variance is round-off:
    # sqrt(round-off) ~ 3e-8 of K at coincident points (module doc)
    mu_j, var_j = jserver(X[:5])
    close(mu, mu_j, rtol=1e-6)
    np.testing.assert_allclose(var, var_j, rtol=0, atol=1e-7)
    # the plain path adds none and reports a zero nugget
    assert float(serve.Predictor(mt, X, y).nugget) == 0.0


@pytest.mark.parametrize("mode,rank", [("chol", None), ("stream", 0),
                                       ("stream", 32)])
def test_warped_iterative_value_and_grad_matches_jax(mode, rank):
    def rademacher(key, shape):     # the probes JAX draws from `key`
        return torch.tensor(np.asarray(jax.random.rademacher(
            key, shape, jnp.float32)))

    X, y = skewed(160, seed=8)
    family, m, lh = WARPS["tanh1-1"]
    mj = replace(jm.default_model(3, dtype=jnp.float32),
                 likelihood=JW(family, m),
                 lik_hypers=jnp.asarray(lh, jnp.float32))
    mt = replace(tm.default_model(3, dtype=torch.float32, device=CPU),
                 likelihood=TW(family, m),
                 lik_hypers=torch.tensor(lh, dtype=torch.float32))
    kw = dict(seed=3, probes=4, lanczos_iters=12, cg_tol=1e-5, chunk=64,
              precond_rank=rank, slq_probes=8, mode=mode)
    vg_j = j_make_vg(mj, X, y, tm=128, tn=128, **kw)
    k_ld, k_tr = jax.random.split(jax.random.PRNGKey(3))
    vg_t = t_make_vg(mt, X, y, Z_logdet=rademacher(k_ld, (160, 8)),
                     Z_trace=rademacher(k_tr, (160, 4)), **kw)
    x = np.asarray(mj.pack(), np.float64) * 1.05
    vj, g_j = vg_j(x)
    vt, g_t = vg_t(x)
    assert vt == pytest.approx(vj, rel=1e-4, abs=0.05)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-3,
                               atol=1e-3 * np.abs(g_j).max())
    assert g_t.shape == (13,) and np.all(np.abs(g_t[9:]) > 0)
    assert abs(vg_t.last_cg_iters - vg_j.last_cg_iters) <= 1


# --- the CLI ----------------------------------------------------------------

@pytest.fixture()
def grades(tmp_path):
    """160 training and 40 test points of a skewed grade on a smooth
    synthetic ore body: exp(0.8 y) of tests/test_torch_train_cli.py's."""
    rng = np.random.default_rng(21)
    X = rng.uniform(0.0, 300.0, size=(200, 3))
    u = X / 150.0 - 1.0
    y = np.exp(0.8 * (1.2 + 0.6 * np.sin(1.7 * u[:, 0] + 0.4)
                      * np.cos(1.3 * u[:, 1]) + 0.4 * u[:, 2]
                      + 0.05 * rng.normal(size=200)))
    write_data(str(tmp_path / "train.txt"), X[:160], y[:160])
    write_data(str(tmp_path / "test.txt"), X[160:], y[160:])
    return tmp_path


def _numbers(text):
    return [float(v) for v in text.strip().splitlines()[-2:]]


@pytest.mark.parametrize("lf", ["Gauss", "WarpGauss:tanh1:1",
                                "WarpGauss:rbf:1"])
def test_cli_from_the_same_start_matches_jax_byte_for_byte(grades, capsys,
                                                           lf):
    train, test = str(grades / "train.txt"), str(grades / "test.txt")
    jmod, tmod = str(grades / "j"), str(grades / "t")
    args = ["train", "--float64", "-#", "0", "-lf", lf, "--init-lik", "0.05",
            train]
    assert jax_main(args + [jmod]) == 0
    jax_train = _numbers(capsys.readouterr().out)
    assert torch_main(args[:1] + ["--device", "cpu"] + args[1:]
                      + [tmod]) == 0
    torch_train = _numbers(capsys.readouterr().out)
    with open(tmod, "rb") as a, open(jmod, "rb") as b:
        assert a.read() == b.read()
    # the bounded training-set predict prints the full dense predict's
    # MSE, and the JAX CLI's
    X, y = read_data(train)
    Xs, ys, stats = prepare(X, y, 1)
    model = tm.load_model(tmod, F64, CPU)
    mu, _ = t_predict(model.kernel, model.kernel_params, model.lik_hypers,
                      torch.from_numpy(Xs), torch.from_numpy(ys),
                      torch.from_numpy(Xs), model.likelihood)
    mse = float(np.mean((y - unapply_y(stats, mu.numpy())) ** 2))
    assert torch_train[0] == pytest.approx(mse, rel=1e-10)
    np.testing.assert_allclose(torch_train, jax_train, rtol=1e-6)
    assert jax_main(["test", "--no-plot", "--float64", test, jmod, train,
                     str(grades / "jp.txt")]) == 0
    jax_test = _numbers(capsys.readouterr().out)
    assert torch_main(["test", "--no-plot", "--float64", "--device", "cpu",
                       test, tmod, train, str(grades / "tp.txt")]) == 0
    np.testing.assert_allclose(_numbers(capsys.readouterr().out), jax_test,
                               rtol=1e-8)
    np.testing.assert_allclose(np.loadtxt(grades / "tp.txt"),
                               np.loadtxt(grades / "jp.txt"), rtol=1e-8,
                               atol=1e-10)


def test_cli_train_predict_takes_the_engine_the_fit_ran(grades, capsys,
                                                        monkeypatch):
    """Dense and chol-mode fits predict densely; past chol mode's
    threshold (lowered here) the matrix-free server gives the mean."""
    train = str(grades / "train.txt")
    made = []

    class Spy(serve.IterativePredictor):
        def __init__(self, *a, **k):
            made.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(serve, "IterativePredictor", Spy)
    for lf in ("Gauss", "WarpGauss"):
        args = ["train", "--device", "cpu", "--engine", "iterative", "-#",
                "1", "-lf", lf, train]
        assert torch_main(args + [str(grades / "chol")]) == 0
        mse_chol, var_y = _numbers(capsys.readouterr().out)
        assert made == []                       # chol mode: dense predict
        monkeypatch.setattr(ti, "_mode_thresholds", lambda device=None:
                            (64, 128))
        assert ti.choose_mode(160, "auto", CPU) == "stream"
        assert torch_main(args + [str(grades / "stream")]) == 0
        mse_stream, _ = _numbers(capsys.readouterr().out)
        assert made == [1]
        monkeypatch.undo()
        monkeypatch.setattr(serve, "IterativePredictor", Spy)
        made.clear()
        assert np.isfinite(mse_stream) and mse_stream < var_y
        assert np.isfinite(mse_chol) and mse_chol < var_y


def test_cli_train_predict_keeps_its_profiler_range(grades, capsys):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch_main(["train", "--device", "cpu", "-#", "0",
                           str(grades / "train.txt"),
                           str(grades / "m")]) == 0
    capsys.readouterr()
    names = {e.name for e in prof.events()}
    assert "cmd_train.predict" in names


def test_warp_family_and_init_lik_parse_as_the_jax_cli(grades, capsys,
                                                     monkeypatch):
    train = str(grades / "train.txt")
    seen = []
    monkeypatch.setattr(cli, "_training_mean",
                        lambda model, *a: seen.append(model) or np.zeros(160))
    args = ["train", "--float64", "-#", "0", "-lf", "WarpGauss:tanh1:2",
            "--init-lik", "0.05", train]
    assert torch_main(args[:1] + ["--device", "cpu"] + args[1:]
                      + [str(grades / "s")]) == 0
    assert jax_main(args + [str(grades / "sj")]) == 0
    capsys.readouterr()
    # the starting model: the warp's defaults, the noise written as
    # 0.5 log(sn2) into the last hyper (then clipped into the box)
    assert seen[0].likelihood == TW("tanh1", 2)
    assert seen[0].lik_hypers.numel() == 7
    with open(grades / "s", "rb") as a, open(grades / "sj", "rb") as b:
        text = a.read()
        assert text == b.read()
    assert b"# WarpFamily=tanh1 Triplets=2\n" in text
    model = tm.load_model(str(grades / "s"), device=CPU)
    assert model.likelihood == TW("tanh1", 2)
    assert torch_main(["train", "--device", "cpu", "-lf", "WarpGauss:cubic",
                       train, str(grades / "c")]) == 1
    assert "unknown warp family 'cubic'" in capsys.readouterr().err
    assert not os.path.exists(grades / "c")
    assert cli.main(["train", "--device", "cpu", "-lf", "Student", train,
                     str(grades / "u")]) == 1
