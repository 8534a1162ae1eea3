"""Port parity: the dense Predictor and the `test` CLI, plus the guard
that the port never imports jax or gp_ss_ak_tpu. Float64 on the CPU."""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_tpu.serve as jserve
import gp_ss_ak_torch.model as tm
import gp_ss_ak_torch.serve as tserve
from gp_ss_ak_tpu.cli import main as jax_main
from gp_ss_ak_torch.cli import main as torch_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
F64 = torch.float64
CPU = torch.device("cpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def models(kernels=None, d=3, seed=0):
    rng = np.random.default_rng(seed)
    mj = jm.default_model(d, kernel_names=kernels)
    flat = np.asarray(mj.pack()) * rng.uniform(0.8, 1.2, size=mj.n_params)
    mj = mj.unpack(jnp.asarray(flat))
    nk = mj.kernel.n_params
    names = (kernels or ["ExpAns"]) + ["Bias"]
    return mj, tm.from_flat(names, flat[:nk], flat[nk:], d, F64, CPU)


@pytest.mark.parametrize("batch_size", [None, 16], ids=["whole", "batched"])
@pytest.mark.parametrize("kernels", [None, ["RBF"]], ids=["flagship", "rbf"])
def test_predictor_matches_jax(kernels, batch_size):
    mj, mt = models(kernels)
    rng = np.random.default_rng(4)
    X = rng.uniform(-1, 1, size=(50, 3))
    y = np.sin(2 * X.sum(1))
    Xq = rng.uniform(-1, 1, size=(53, 3))   # not a multiple of 16
    sj = jserve.Predictor(mj, X, y)
    st = tserve.Predictor(mt, X, y)
    assert st.post.linv is not None
    muj, varj = sj(Xq, batch_size=batch_size)
    mut, vart = st(Xq, batch_size=batch_size)
    assert isinstance(mut, np.ndarray) and mut.shape == (53,)
    # rtol 1e-10: the same algebra, round-off from the L^-1 GEMM only
    np.testing.assert_allclose(mut, muj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(vart, varj, rtol=1e-10, atol=1e-12)


def test_predictor_without_inverse_matches_with():
    _, mt = models(seed=1)
    rng = np.random.default_rng(5)
    X = rng.uniform(-1, 1, size=(60, 3))
    y = np.cos(3 * X[:, 1])
    Xq = rng.uniform(-1, 1, size=(20, 3))
    fast = tserve.Predictor(mt, X, y, precompute_inverse=True)
    slow = tserve.Predictor(mt, X, y, precompute_inverse=False)
    assert slow.post.linv is None
    mu_f, var_f = fast(Xq)
    mu_s, var_s = slow(Xq)
    np.testing.assert_allclose(mu_f, mu_s, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(var_f, var_s, rtol=1e-8, atol=1e-11)


@pytest.fixture()
def golden_case(tmp_path):
    for name in ("model", "model_Statistics.txt", "train.txt", "test.txt"):
        shutil.copy(os.path.join(GOLDEN, name), tmp_path / name)
    return (str(tmp_path / "test.txt"), str(tmp_path / "model"),
            str(tmp_path / "train.txt"), tmp_path)


def test_cli_test_matches_jax_cli(golden_case, capsys):
    test, model, train, tmp = golden_case
    rc = jax_main(["test", "--no-plot", "--float64", test, model, train,
                   str(tmp / "jax_pred.txt")])
    assert rc == 0
    jax_lines = capsys.readouterr().out.strip().splitlines()[-2:]
    proc = subprocess.run(
        [sys.executable, "-m", "gp_ss_ak_torch", "test", "--float64",
         "--no-plot", test, model, train, str(tmp / "torch_pred.txt")],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    torch_lines = proc.stdout.strip().splitlines()[-2:]
    # printed MSE and var(y): rtol 1e-8
    np.testing.assert_allclose([float(v) for v in torch_lines],
                               [float(v) for v in jax_lines], rtol=1e-8)
    with open(tmp / "torch_pred.txt") as f_t, \
            open(tmp / "jax_pred.txt") as f_j:
        assert f_t.readline() == f_j.readline() \
            == "# SampleNo, Y,  Yh, StdYh, Inputs\n"
    pt = np.loadtxt(tmp / "torch_pred.txt")
    pj = np.loadtxt(tmp / "jax_pred.txt")
    np.testing.assert_allclose(pt, pj, rtol=1e-8, atol=1e-10)


def test_cli_verbose_labels_and_default_output(golden_case, capsys):
    test, model, train, _ = golden_case
    assert torch_main(["-v", "1", "test", "--no-plot", "--float64", test,
                       model, train]) == 0
    out = capsys.readouterr().out
    assert "Mean Square Error of testing: " in out
    assert "Var MSE Test: " in out
    assert os.path.exists(model + "_predict.txt")


def test_cli_iterative_engine_is_not_ported(golden_case, capsys):
    test, model, train, tmp = golden_case
    rc = torch_main(["test", "--no-plot", "--engine", "iterative", test,
                     model, train, str(tmp / "p.txt")])
    assert rc == 1
    assert "not ported" in capsys.readouterr().err
    assert not (tmp / "p.txt").exists()    # it did not silently run dense


def test_cli_user_errors_exit_1(golden_case, tmp_path, capsys):
    test, model, train, _ = golden_case
    bad = tmp_path / "bad.txt"
    bad.write_text("1\t2\t0.5\n3\t4\t0.7\n")   # 2 inputs, model has 3
    assert torch_main(["test", "--no-plot", str(bad), model, train]) == 1
    assert "Incorrect dimension" in capsys.readouterr().err
    assert torch_main(["test", "--no-plot", str(tmp_path / "nope.txt"),
                       model, train]) == 1
    err = capsys.readouterr().err
    assert "Error" in err and "Traceback" not in err


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gp_ss_ak_tpu'] = None\n"
        "import gp_ss_ak_torch, gp_ss_ak_torch.cli, gp_ss_ak_torch.serve\n"
        "import gp_ss_ak_torch.ops._build\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'jaxlib',"
        " 'gp_ss_ak_tpu')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
