"""Port parity: the CLI's `train` -> `test` round trip against the JAX CLI,
float64 on the CPU (`--float64 --device cpu`), on 160 training and 40 test
points of a smooth synthetic ore body.

Tolerances: the two fits take the same optimizer path (same iteration
and evaluation counts, tests/test_torch_optim.py) over objectives that
agree to ~1e-12, so the model files' hyperparameters agree to rtol 1e-6
and every printed number and prediction to rtol 1e-6, except the
training MSE: the fit nearly interpolates, so that MSE is a cancellation
of ~1e-7 var(y) and is held to 1e-6 var(y) absolute. The statistics
files are byte for byte the same.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gp_ss_ak_tpu.cli import main as jax_main
from gp_ss_ak_torch.cli import main as torch_main
from gp_ss_ak_torch.data import write_data
from gp_ss_ak_torch.parallel import ring

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6

# one intra-op thread per process: the suite runs on several workers at
# once, and torch's default (a thread per core in every worker)
# oversubscribes the cores and slows these small CPU ops many times over
torch.set_num_threads(1)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture()
def ore(tmp_path):
    rng = np.random.default_rng(21)
    X = rng.uniform(0.0, 300.0, size=(200, 3))
    u = X / 150.0 - 1.0
    y = (1.2 + 0.6 * np.sin(1.7 * u[:, 0] + 0.4) * np.cos(1.3 * u[:, 1])
         + 0.4 * u[:, 2] + 0.05 * rng.normal(size=200))
    write_data(str(tmp_path / "train.txt"), X[:160], y[:160])
    write_data(str(tmp_path / "test.txt"), X[160:], y[160:])
    return tmp_path


def _numbers(text):
    return [float(v) for v in text.strip().splitlines()[-2:]]


def _model_values(path):
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("Hyperparams_likelihood="):
                vals.append(float(line.split("=")[1]))
            elif line and "=" not in line and not line.startswith("#"):
                vals += [float(t) for t in line.split()]
    return np.array(vals)


def _structure(path):
    with open(path) as f:
        return [line for line in f if "=" in line
                and not line.startswith("Hyperparams")]


@pytest.mark.parametrize("opt", ["LBFGS", "SCG"])
def test_train_then_test_matches_jax_cli(ore, capsys, opt):
    train, test = str(ore / "train.txt"), str(ore / "test.txt")
    jm, tm = str(ore / "jax_model"), str(ore / "torch_model")
    args = ["train", "--float64", "-o", opt, "-#", "15", train]
    assert jax_main(args + [jm]) == 0
    jax_train = _numbers(capsys.readouterr().out)
    assert torch_main(args[:1] + ["--device", "cpu"] + args[1:] + [tm]) == 0
    torch_train = _numbers(capsys.readouterr().out)
    # the training MSE (~1e-7 of var(y)) is a cancellation y - yh: held
    # to 1e-6 var(y) absolute; var(y) is data only
    np.testing.assert_allclose(torch_train, jax_train, rtol=RTOL,
                               atol=RTOL * jax_train[1])
    assert _structure(tm) == _structure(jm)
    np.testing.assert_allclose(_model_values(tm), _model_values(jm),
                               rtol=RTOL)
    with open(tm + "_Statistics.txt") as a, open(jm + "_Statistics.txt") as b:
        assert a.read() == b.read()
    with open(tm + "_metrics.json") as f, open(jm + "_metrics.json") as g:
        metrics, jmetrics = json.load(f), json.load(g)
    assert 1 <= metrics["summary"]["iters"] == jmetrics["summary"]["iters"]
    assert metrics["summary"]["nlml_final"] < metrics["summary"]["nlml_first"]
    assert metrics["summary"]["nlml_final"] == pytest.approx(
        jmetrics["summary"]["nlml_final"], rel=1e-10)

    # the round trip: each CLI serves its own model
    assert jax_main(["test", "--no-plot", "--float64", test, jm, train,
                     str(ore / "jp.txt")]) == 0
    jax_test = _numbers(capsys.readouterr().out)
    assert torch_main(["test", "--no-plot", "--float64", "--device", "cpu",
                       test, tm, train, str(ore / "tp.txt")]) == 0
    torch_test = _numbers(capsys.readouterr().out)
    np.testing.assert_allclose(torch_test, jax_test, rtol=RTOL)
    np.testing.assert_allclose(np.loadtxt(ore / "tp.txt"),
                               np.loadtxt(ore / "jp.txt"), rtol=RTOL,
                               atol=1e-9)


def test_train_verbose_prints_the_stop_reason(ore, capsys):
    assert torch_main(["-v", "1", "train", "--float64", "--device", "cpu",
                       "-#", "3", str(ore / "train.txt"),
                       str(ore / "m")]) == 0
    out = capsys.readouterr().out
    assert "Read 160 points, 3 features" in out
    assert "stop: maxiter" in out
    assert "Mean Square Error of training: " in out
    assert "Var MSE Train: " in out


def test_train_iterative_engine_on_the_cpu(ore, capsys):
    assert torch_main(["train", "--device", "cpu", "--engine", "iterative",
                       "-#", "2", str(ore / "train.txt"),
                       str(ore / "mi")]) == 0
    mse, var_y = _numbers(capsys.readouterr().out)
    assert np.isfinite(mse) and mse < 0.2 * var_y
    assert np.all(np.isfinite(_model_values(ore / "mi")))


def test_train_prints_unconverged_solves_on_stderr(ore, capsys,
                                                  monkeypatch):
    """A segmented fit (stream mode at any N) whose CG is cut at 3
    iterations under a rank-8 preconditioner: the CLI prints the fit's
    UnconvergedSolveWarning as one line on stderr, stdout keeps its two
    numbers (the JAX CLI's layout), and the training-set server's own
    cut-short solve warns once more."""
    import gp_ss_ak_torch.optim as optim
    from gp_ss_ak_torch import serve

    fit, server = optim.fit, serve.IterativePredictor
    short = dict(cg_maxiter=3, precond_rank=8)

    def short_fit(*args, **kw):
        kw["engine_opts"] = dict(kw.get("engine_opts") or {}, **short)
        return fit(*args, **kw)

    def short_server(*args, **kw):
        return server(*args, **short, **kw)

    monkeypatch.setattr(optim, "fit", short_fit)
    monkeypatch.setattr(serve, "IterativePredictor", short_server)
    assert torch_main(["train", "--device", "cpu", "--engine", "iterative",
                       "--segmented", "-#", "2", str(ore / "train.txt"),
                       str(ore / "mi")]) == 0
    captured = capsys.readouterr()
    _numbers(captured.out)
    assert len(captured.out.strip().splitlines()) == 2
    err = captured.err.strip().splitlines()
    assert len(err) == 2, err
    assert re.fullmatch(r"Warning: fit: \d+ of \d+ CG solves ended "
                        r"unconverged, largest relative residual \S+ > "
                        r"cg_tol 0.001 \(.*\)", err[0]), err[0]
    assert err[1].startswith("Warning: IterativePredictor (setup): 1 of 1")


@pytest.mark.parametrize("lf", ["WarpGauss", "WarpGauss:tanh1:2"],
                         ids=["warp", "warp_family"])
def test_train_warped_matches_jax_cli(ore, capsys, lf):
    """`-lf WarpGauss[:family[:m]]` trains the warped likelihood as the
    JAX CLI does, float64: the same model structure, hyperparameters
    and printed numbers at RTOL, then `test` serves each CLI's model."""
    train, test = str(ore / "train.txt"), str(ore / "test.txt")
    jm, tm = str(ore / "jax_model"), str(ore / "torch_model")
    args = ["train", "--float64", "-#", "6", "-lf", lf, train]
    assert jax_main(args + [jm]) == 0
    jax_train = _numbers(capsys.readouterr().out)
    assert torch_main(args[:1] + ["--device", "cpu"] + args[1:] + [tm]) == 0
    torch_train = _numbers(capsys.readouterr().out)
    np.testing.assert_allclose(torch_train, jax_train, rtol=RTOL)
    assert _structure(tm) == _structure(jm)
    np.testing.assert_allclose(_model_values(tm), _model_values(jm),
                               rtol=RTOL)
    with open(tm) as f:
        m = 2 if lf.endswith(":2") else 1
        assert f"# WarpFamily=tanh1 Triplets={m}\n" in f.read()
    assert _model_values(tm).shape == (9 + 3 * m + 1,)
    assert jax_main(["test", "--no-plot", "--float64", test, jm, train,
                     str(ore / "jp.txt")]) == 0
    jax_test = _numbers(capsys.readouterr().out)
    assert torch_main(["test", "--no-plot", "--float64", "--device", "cpu",
                       test, tm, train, str(ore / "tp.txt")]) == 0
    np.testing.assert_allclose(_numbers(capsys.readouterr().out), jax_test,
                               rtol=RTOL)
    np.testing.assert_allclose(np.loadtxt(ore / "tp.txt"),
                               np.loadtxt(ore / "jp.txt"), rtol=RTOL,
                               atol=1e-9)
    # and the matrix-free engine serves the warped model
    assert torch_main(["test", "--no-plot", "--engine", "iterative",
                       "--device", "cpu", test, tm, train,
                       str(ore / "ti.txt")]) == 0
    mse, var_y = _numbers(capsys.readouterr().out)
    assert np.isfinite(mse) and mse < var_y


def test_train_jit_matches_jax_cli(ore, capsys):
    # -o JIT: the port's batched L-BFGS on one problem against the JAX
    # package's whole-fit device optimizer (optim/jax_lbfgs.py)
    train = str(ore / "train.txt")
    jm, tm = str(ore / "jax_jit"), str(ore / "torch_jit")
    args = ["train", "--float64", "-o", "JIT", "-#", "10", train]
    assert jax_main(["-v", "1", *args, jm]) == 0
    jax_out = capsys.readouterr().out
    assert torch_main(["-v", "1", *args[:1], "--device", "cpu", *args[1:],
                       tm]) == 0
    torch_out = capsys.readouterr().out
    pat = r"-logL: (\S+) -> (\S+) \((\d+) iters, (-?\d+) evals"
    (j0, j1, ji, je), (t0, t1, ti, te) = (
        re.search(pat, out).groups() for out in (jax_out, torch_out))
    assert (ti, te) == (ji, je) and te == "-1"
    np.testing.assert_allclose([float(t0), float(t1)],
                               [float(j0), float(j1)], rtol=RTOL)
    assert _structure(tm) == _structure(jm)
    np.testing.assert_allclose(_model_values(tm), _model_values(jm),
                               rtol=RTOL)
    nums = [[float(v) for v in re.findall(
        r"(?:Mean Square Error of training|Var MSE Train): (\S+)", out)]
        for out in (jax_out, torch_out)]
    np.testing.assert_allclose(nums[1], nums[0], rtol=RTOL,
                               atol=RTOL * nums[0][1])


def _mesh_train(ore, capsys, engine, iters):
    """`train --engine ENGINE -# ITERS --float64 -v 1` through both CLIs:
    the JAX CLI on a mesh of every CPU device tests/conftest.py forces
    (8), the port's on a mesh of one rank (gloo on the CPU). Returns the
    two (stdout, model path) pairs."""
    train = str(ore / "train.txt")
    runs = []
    for main, name, extra in ((jax_main, "jax_" + engine, []),
                              (torch_main, "torch_" + engine,
                               ["--device", "cpu"])):
        assert main(["-v", "1", "train", *extra, "--float64", "--engine",
                     engine, "-#", str(iters), train,
                     str(ore / name)]) == 0
        runs.append((capsys.readouterr().out, str(ore / name)))
    return runs


def _mesh_checks(runs, iters):
    """The -logL trajectory, iterations and evaluations, the model file
    and the metrics trace at RTOL; returns the two training MSEs."""
    (jout, jm), (tout, tm) = runs
    pat = r"-logL: (\S+) -> (\S+) \((\d+) iters, (\d+) evals"
    (j0, j1, ji, je), (t0, t1, ti, te) = (re.search(pat, out).groups()
                                          for out in (jout, tout))
    assert (ti, te) == (ji, je) and int(ti) == iters
    np.testing.assert_allclose([float(t0), float(t1)],
                               [float(j0), float(j1)], rtol=RTOL)
    assert _structure(tm) == _structure(jm)
    np.testing.assert_allclose(_model_values(tm), _model_values(jm),
                               rtol=RTOL)
    with open(tm + "_metrics.json") as f, open(jm + "_metrics.json") as g:
        trace = [[r["nlml"] for r in json.load(h)["trace"]] for h in (f, g)]
    np.testing.assert_allclose(trace[0], trace[1], rtol=RTOL)
    with open(tm + "_Statistics.txt") as a, open(jm + "_Statistics.txt") as b:
        assert a.read() == b.read()
    return [float(re.search(r"Mean Square Error of training: (\S+)",
                            out).group(1)) for out in (jout, tout)]


def test_train_dist_matches_jax_cli(ore, capsys):
    """`train --engine dist`: the row-split exact fit (the exact gradient
    at this N). The training MSE differs by construction: the port
    predicts by the mesh engine (`cli._training_mean_mesh`), the JAX CLI
    densely; both are the exact posterior mean, held at 1e-6 var(y)
    (the MSE is a cancellation of ~1e-7 var(y))."""
    runs = _mesh_train(ore, capsys, "dist", 2)
    mse_j, mse_t = _mesh_checks(runs, 2)
    var_y = float(re.search(r"Var MSE Train: (\S+)", runs[0][0]).group(1))
    assert abs(mse_t - mse_j) < RTOL * var_y
    # and, as the other engines, the card unless the CPU is asked for
    assert torch_main(["train", "--engine", "dist", str(ore / "train.txt"),
                       str(ore / "nocard")]) == 1
    assert "no usable CUDA device" in capsys.readouterr().err


def test_train_ring_matches_jax_cli(ore, capsys, monkeypatch):
    """`train --engine ring`, the matrix-free fit on the ring, both CLIs
    on JAX's probes: the JAX CLI's mesh pads the 160 rows to 8 x 256, and
    the port is handed those draws' true rows through the probe draw
    fit_ring makes (parallel.ring.draw_probes). The training MSE is the
    port's ring posterior mean (CG to 1e-6), the JAX CLI's a dense
    predict: held to 0.2 var(y) only."""
    k_tr, k_ld = jax.random.split(jax.random.PRNGKey(0))
    Z, Zl = (np.asarray(jax.random.rademacher(k, (2048, p), jnp.float64))
             [:160] for k, p in ((k_tr, 8), (k_ld, 16)))
    monkeypatch.setattr(ring, "draw_probes", lambda seed, n, p, s: (Z, Zl))
    runs = _mesh_train(ore, capsys, "ring", 2)
    _, mse_t = _mesh_checks(runs, 2)
    var_y = float(re.search(r"Var MSE Train: (\S+)", runs[0][0]).group(1))
    assert np.isfinite(mse_t) and mse_t < 0.2 * var_y


def test_train_segmented_matches_jax_cli(ore, capsys, monkeypatch):
    """`train --engine iterative --segmented` (float32, the segmented
    evaluator's defaults) in both CLIs on JAX's probes, handed to the
    port through the probe draw the evaluator makes
    (optim.iterative_fit.fit_probes), then `test` on each CLI's model.

    -# 4: the two fits take the same path (4 iterations, 10 evaluations
    at this case; the JAX CLI prints no stop reason, and the port's is
    maxiter) and their hyperparameters agree to 2.2e-5 relative; held to
    1e-4. Past ~5 iterations the float32 objectives, whose solves stop
    at cg_tol = 1e-3, send the line searches apart (0.1 relative at
    -# 6)."""
    from gp_ss_ak_torch.optim import iterative_fit

    train, test = str(ore / "train.txt"), str(ore / "test.txt")
    jm, tm = str(ore / "jax_model"), str(ore / "torch_model")
    k_ld, k_tr = jax.random.split(jax.random.PRNGKey(0))
    Zl = np.array(jax.random.rademacher(k_ld, (160, 32), jnp.float32))
    Zt = np.array(jax.random.rademacher(k_tr, (160, 8), jnp.float32))
    draw = iterative_fit.fit_probes
    monkeypatch.setattr(iterative_fit, "fit_probes",
                        lambda seed, n, p, s, device, *_: draw(
                            seed, n, p, s, device, Zl, Zt))
    args = ["-v", "1", "train", "-#", "4", "--engine", "iterative",
            "--segmented", train]
    assert jax_main(args + [jm]) == 0
    jax_out = capsys.readouterr().out
    assert torch_main(args[:2] + ["train", "--device", "cpu"] + args[3:]
                      + [tm]) == 0
    torch_out = capsys.readouterr().out
    pat = r"-logL: \S+ -> \S+ \((\d+) iters, (\d+) evals"
    assert re.search(pat, torch_out).groups() \
        == re.search(pat, jax_out).groups() == ("4", "10")
    assert "stop: maxiter" in torch_out
    assert _structure(tm) == _structure(jm)
    np.testing.assert_allclose(_model_values(tm), _model_values(jm),
                               rtol=1e-4)
    mse, var_y = (float(re.search(rf"{k}: (\S+)", torch_out).group(1))
                  for k in ("Mean Square Error of training",
                            "Var MSE Train"))
    assert np.isfinite(mse) and mse < var_y
    assert jax_main(["test", "--no-plot", test, jm, train]) == 0
    jax_test = _numbers(capsys.readouterr().out)
    assert torch_main(["test", "--no-plot", "--device", "cpu", test, tm,
                       train]) == 0
    torch_test = _numbers(capsys.readouterr().out)
    for mse, var_y in (jax_test, torch_test):
        assert np.isfinite(mse) and mse < var_y


@pytest.mark.parametrize("extra,msg", [
    (["-lf", "Student"], "Unknown likelihood function"),
    (["--init-params", "1,2"], "--init-params needs 9 values"),
], ids=["unknown_lik", "init_params"])
def test_train_refusals_exit_1(ore, capsys, extra, msg):
    rc = torch_main(["train", "--device", "cpu", *extra,
                     str(ore / "train.txt"), str(ore / "m")])
    assert rc == 1
    err = capsys.readouterr().err
    assert msg in err and "Traceback" not in err


def test_init_params_and_lik_set_the_start(ore, capsys):
    vals = "1,1.5,1,1.5,1,1.3,0.9,0.6,0.2"
    assert torch_main(["train", "--device", "cpu", "--float64", "-#", "0",
                       "--init-params", vals, "--init-lik", "0.05",
                       str(ore / "train.txt"), str(ore / "m0")]) == 0
    assert jax_main(["train", "--float64", "-#", "0", "--init-params", vals,
                     "--init-lik", "0.05", str(ore / "train.txt"),
                     str(ore / "j0")]) == 0
    np.testing.assert_allclose(_model_values(ore / "m0"),
                               _model_values(ore / "j0"), rtol=1e-12)


def test_cli_without_a_card_exits_nonzero_unless_asked_for_cpu(ore):
    # no CUDA device visible to the subprocess: the default
    # `--device cuda` must refuse, not fall back to the CPU
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    for cmd in (["train", str(ore / "train.txt"), str(ore / "m")],
                ["test", "--no-plot", str(ore / "test.txt"), str(ore / "m"),
                 str(ore / "train.txt")]):
        proc = subprocess.run([sys.executable, "-m", "gp_ss_ak_torch", *cmd],
                              capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=300)
        assert proc.returncode != 0
        assert "no usable CUDA device" in proc.stderr
        assert "--device cpu" in proc.stderr
    assert not os.path.exists(ore / "m")
