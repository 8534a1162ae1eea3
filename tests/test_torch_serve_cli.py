"""Port parity: the dense Predictor and the `test` CLI (dense in float64,
the matrix-free engine in float32), plus the guard that the port never
imports jax or gp_ss_ak_tpu."""

import dataclasses
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


def _ranges(prof, prefix):
    return [e for e in prof.events() if e.name.startswith(prefix)]


def _inside(child, parent):
    return (child.thread == parent.thread
            and parent.time_range.start <= child.time_range.start
            and child.time_range.end <= parent.time_range.end)


@pytest.mark.parametrize("batch_size,batches", [(None, 1), (8, 3)],
                         ids=["one-batch", "three-batches"])
@pytest.mark.parametrize("stage", ["serve.to_device", "serve.posterior",
                                   "serve.to_host"])
def test_predictor_request_holds_its_stage_ranges(stage, batch_size,
                                                  batches):
    """A request is one range, "serve.request", holding the upload, the
    posterior and the copy to the host once for each batch: 4 ranges
    for one batch, 3 more for each further batch."""
    from torch.profiler import ProfilerActivity, profile

    _, mt = models()
    rng = np.random.default_rng(6)
    X = rng.uniform(-1, 1, size=(40, 3))
    st = tserve.Predictor(mt, X, np.sin(X.sum(1)))
    Xq = rng.uniform(-1, 1, size=(20, 3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st(Xq, batch_size=batch_size)
    (req,) = _ranges(prof, "serve.request")
    got = _ranges(prof, stage)
    assert len(got) == batches
    assert all(_inside(e, req) for e in got)
    assert len(_ranges(prof, "serve.")) == 4 + 3 * (batches - 1)


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
         "--device", "cpu", "--no-plot", test, model, train,
         str(tmp / "torch_pred.txt")],
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
    assert torch_main(["-v", "1", "test", "--no-plot", "--float64",
                       "--device", "cpu", test, model, train]) == 0
    out = capsys.readouterr().out
    assert "Mean Square Error of testing: " in out
    assert "Var MSE Test: " in out
    assert os.path.exists(model + "_predict.txt")


def test_cli_iterative_engine_is_not_ported(golden_case, capsys):
    # asserts that the engine IS ported: --engine iterative runs the
    # IterativePredictor, exits 0 and writes its predictions
    test, model, train, tmp = golden_case
    rc = torch_main(["test", "--no-plot", "--engine", "iterative",
                     "--device", "cpu", test, model, train,
                     str(tmp / "p.txt")])
    assert rc == 0
    assert "not ported" not in capsys.readouterr().err
    table = np.loadtxt(tmp / "p.txt")
    assert table.shape[0] == 40 and np.all(np.isfinite(table[:, 2]))


@pytest.fixture()
def ore_case(tmp_path):
    """400 training and 100 test points of a smooth synthetic ore body,
    symmetric statistics, and the golden model's kernel with the
    reference's default noise sn2 = 0.016 (the golden 1e-4 is too
    ill-conditioned for a float32 CG comparison at 1e-3)."""
    from gp_ss_ak_torch.data import MODE_SYMMETRIC, prepare, write_data

    rng = np.random.default_rng(11)
    X = rng.uniform(0.0, 300.0, size=(500, 3))
    u = X / 150.0 - 1.0
    y = (1.2 + 0.6 * np.sin(1.7 * u[:, 0] + 0.4) * np.cos(1.3 * u[:, 1])
         + 0.4 * u[:, 2] + 0.05 * rng.normal(size=500))
    write_data(str(tmp_path / "train.txt"), X[:400], y[:400])
    write_data(str(tmp_path / "test.txt"), X[400:], y[400:])
    _, _, stats = prepare(X[:400], y[:400], MODE_SYMMETRIC)
    stats.save(str(tmp_path / "model_Statistics.txt"))
    golden = tm.load_model(os.path.join(GOLDEN, "model"), device="cpu")
    tm.save_model(dataclasses.replace(
        golden, num_data=400,
        lik_hypers=torch.tensor([0.016], dtype=F64)),
        str(tmp_path / "model"))
    return (str(tmp_path / "test.txt"), str(tmp_path / "model"),
            str(tmp_path / "train.txt"), tmp_path)


def test_cli_iterative_matches_jax_cli(ore_case, capsys):
    test, model, train, tmp = ore_case
    args = ["test", "--no-plot", "--engine", "iterative", test, model,
            train]
    assert jax_main(args + [str(tmp / "jax_pred.txt")]) == 0
    jax_lines = capsys.readouterr().out.strip().splitlines()[-2:]
    proc = subprocess.run(
        [sys.executable, "-m", "gp_ss_ak_torch", *args[:1], "--device",
         "cpu", *args[1:], str(tmp / "torch_pred.txt")],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    torch_lines = proc.stdout.strip().splitlines()[-2:]
    # both float32 CG solves to the server's default tol 1e-4: MSE and
    # Yh within 1e-3, StdYh (a solve per query) within 5e-3; var(y) is
    # data only
    mse_t, var_t = (float(v) for v in torch_lines)
    mse_j, var_j = (float(v) for v in jax_lines)
    assert mse_t == pytest.approx(mse_j, rel=1e-3)
    assert var_t == pytest.approx(var_j, rel=1e-12)
    with open(tmp / "torch_pred.txt") as f_t, \
            open(tmp / "jax_pred.txt") as f_j:
        assert f_t.readline() == f_j.readline() \
            == "# SampleNo, Y,  Yh, StdYh, Inputs\n"
    pt = np.loadtxt(tmp / "torch_pred.txt")
    pj = np.loadtxt(tmp / "jax_pred.txt")
    # the same rows in the same order (sorted by observed y)
    np.testing.assert_array_equal(pt[:, [0, 1, 4, 5, 6]],
                                  pj[:, [0, 1, 4, 5, 6]])
    np.testing.assert_allclose(pt[:, 2], pj[:, 2], rtol=1e-3)
    np.testing.assert_allclose(pt[:, 3], pj[:, 3], rtol=5e-3)


def test_cli_auto_engine_below_threshold_runs_dense(ore_case, monkeypatch):
    from gp_ss_ak_torch import cli, serve

    def refuse(*a, **k):
        raise AssertionError("auto picked the iterative server")

    monkeypatch.setattr(serve, "IterativePredictor", refuse)
    test, model, train, tmp = ore_case
    assert 400 <= cli.ITERATIVE_MIN_N
    assert torch_main(["test", "--no-plot", "--device", "cpu", test, model,
                       train, str(tmp / "auto.txt")]) == 0
    # and past the threshold auto does pick it
    monkeypatch.setattr(cli, "ITERATIVE_MIN_N", 399)
    with pytest.raises(AssertionError, match="picked the iterative"):
        cli.cmd_test(cli._build_parser().parse_args(
            ["test", "--no-plot", "--device", "cpu", test, model, train,
             str(tmp / "auto2.txt")]))


def test_cli_user_errors_exit_1(golden_case, tmp_path, capsys):
    test, model, train, _ = golden_case
    bad = tmp_path / "bad.txt"
    bad.write_text("1\t2\t0.5\n3\t4\t0.7\n")   # 2 inputs, model has 3
    assert torch_main(["test", "--no-plot", "--device", "cpu", str(bad),
                       model, train]) == 1
    assert "Incorrect dimension" in capsys.readouterr().err
    assert torch_main(["test", "--no-plot", "--device", "cpu",
                       str(tmp_path / "nope.txt"), model, train]) == 1
    err = capsys.readouterr().err
    assert "Error" in err and "Traceback" not in err


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gp_ss_ak_tpu'] = None\n"
        "import gp_ss_ak_torch, gp_ss_ak_torch.cli, gp_ss_ak_torch.serve\n"
        "import gp_ss_ak_torch.ops._build, gp_ss_ak_torch.ops.matvec\n"
        "import gp_ss_ak_torch.inference.iterative, gp_ss_ak_torch.optim\n"
        "import gp_ss_ak_torch.entry, gp_ss_ak_torch.utils\n"
        "import gp_ss_ak_torch.inference.warping\n"
        "import gp_ss_ak_torch.inference.quadrature\n"
        "import gp_ss_ak_torch.utils.psd, gp_ss_ak_torch.native.loader\n"
        "import gp_ss_ak_torch.ensemble, gp_ss_ak_torch.bayes\n"
        "import gp_ss_ak_torch.optim.batched_lbfgs\n"
        "import gp_ss_ak_torch.optim.segmented\n"
        "import gp_ss_ak_torch.inference.sgpr\n"
        "import gp_ss_ak_torch.inference.laplace\n"
        "import gp_ss_ak_torch.utils.checkpoint\n"
        "import gp_ss_ak_torch.utils.profiling, gp_ss_ak_torch.utils.debug\n"
        "import gp_ss_ak_torch.parallel, gp_ss_ak_torch.parallel.mesh\n"
        "import gp_ss_ak_torch.parallel.comm\n"
        "import gp_ss_ak_torch.parallel.multihost\n"
        "import gp_ss_ak_torch.parallel.pchol, gp_ss_ak_torch.parallel.nlml\n"
        "import gp_ss_ak_torch.parallel.fit, gp_ss_ak_torch.parallel.ring\n"
        "import gp_ss_ak_torch.examples.full_workflow\n"
        "import gp_ss_ak_torch.examples.bayes_workflow\n"
        "import gp_ss_ak_torch.examples.distributed_workflow\n"
        "import gp_ss_ak_torch.examples.ring_workflow\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'jaxlib',"
        " 'gp_ss_ak_tpu')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
