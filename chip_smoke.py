#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]      (from the root of the repository)

Phases, each of which raises on failure (nothing is caught):
  1. device: card name and power limit, torch/CUDA/nvcc versions;
  2. build the hand-written kernel K1 (gp_ss_ak_torch/csrc/gram.cu);
  3. K1 against its plain torch version on the card, at ragged sizes and
     at the main path's shapes, in float64 and float32, plus timings;
  4. the golden fixture (tests/golden) through K1 in float64;
  5. the main path: `gp_ss_ak_torch.cli.main([... "test" ...])` in
     float32 on a synthetic ore body, N_train = 16384, N_test = 4096;
  6. serving: one `serve.Predictor`, then 8 requests of 512 queries.
The line before the last is the JSON kernel report; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result,
when no CUDA device is available or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.metadata
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
WORK = os.path.join(ROOT, "build", "chip_smoke")

N_TRAIN, N_TEST = 16384, 4096   # N_TRAIN = the dense engine's DENSE_MAX_N
REQUESTS, REQUEST_SIZE = 8, 512
SN2 = 0.016                     # the reference's default noise variance
# K1 tolerances, relative to the Gram's scale s2 + bias
TOL_F64 = 1e-10                 # kernel vs plain, both float64
TOL_F32 = 1e-5                  # float32 kernel vs plain in float64
MSE_MAX = 0.2                   # test MSE must stay below MSE_MAX * var(y)
MEAN_TOL = 1e-3                 # Predictor vs CLI means, times std(y)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def _nvcc_version() -> str:
    from gp_ss_ak_torch.ops import _build

    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(_nvidia_smi())
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "not installed"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{_nvcc_version()}, triton {triton}, "
          f"python {sys.version.split()[0]}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")


def phase_build():
    from gp_ss_ak_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"build: K1 loaded in {time.perf_counter() - t0:.3f} s "
          f"(nvcc {_build.build_info.get('seconds', 0.0):.3f} s)")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def phase_k1(device, seed: int, cases=None, time_shapes=True):
    """K1 vs its plain version on the same inputs; returns the report."""
    import torch

    from gp_ss_ak_torch.ops import pairwise

    sigma, bias = 0.32626754572075006, 0.16293397312977825  # golden model
    scale = sigma * sigma + bias
    if cases is None:
        cases = [(1000, None, 3), (1000, 333, 3), (1000, None, 4),
                 (1000, 333, 4), (N_TRAIN, None, 3), (N_TRAIN, 1024, 3),
                 (N_TRAIN, None, 4), (N_TRAIN, 1024, 4)]
    g = torch.Generator(device=device).manual_seed(seed)

    def points(k, d):
        return (3.0 * torch.rand(k, d, generator=g, device=device,
                                 dtype=torch.float64) - 1.5)

    worst_f32 = 0.0
    for n, m, d in cases:
        X = points(n, d)
        Y = None if m is None else points(m, d)
        sn2 = SN2 if m is None else None
        tag = f"n={n} m={n if m is None else m} d={d} " \
              f"{'diag' if m is None else 'cross'}"
        K64 = pairwise.expans_bias_gram(X, sigma, bias, sn2, Y)
        P64 = pairwise.expans_bias_gram_plain(X, sigma, bias, sn2, Y)
        err64 = (K64 - P64).abs().max().item()
        del K64, P64
        X32 = X.float()
        Y32 = None if Y is None else Y.float()
        K32 = pairwise.expans_bias_gram(X32, sigma, bias, sn2, Y32)
        ref = pairwise.expans_bias_gram_plain(
            X32.double(), sigma, bias, sn2,
            None if Y32 is None else Y32.double())
        err32 = (K32.double() - ref).abs().max().item()
        del K32
        plain32 = pairwise.expans_bias_gram_plain(X32, sigma, bias, sn2, Y32)
        err_plain32 = (plain32.double() - ref).abs().max().item()
        del plain32, ref
        print(f"K1 {tag}: f64 |kernel-plain| {err64:.3e} "
              f"(tol {TOL_F64 * scale:.1e}); f32 |kernel-plain64| "
              f"{err32:.3e} (tol {TOL_F32 * scale:.1e}); plain f32's own "
              f"|plain32-plain64| {err_plain32:.3e}")
        _check(err64 <= TOL_F64 * scale, f"K1 f64 disagrees at {tag}")
        _check(err32 <= TOL_F32 * scale, f"K1 f32 disagrees at {tag}")
        worst_f32 = max(worst_f32, err32)

    report = {"max_abs_err": worst_f32}
    if not time_shapes:
        return report
    for name, m in (("diag", None), ("cross", 1024)):
        for dtype in (torch.float32, torch.float64):
            X = points(N_TRAIN, 3).to(dtype)
            Y = None if m is None else points(m, 3).to(dtype)
            # hyperparameters on the device, as the main path has them
            s_t, b_t, n_t = (torch.tensor(v, dtype=dtype, device=device)
                             for v in (sigma, bias, SN2))
            sn2 = n_t if m is None else None
            ms = time_ms(lambda: pairwise.expans_bias_gram(
                X, s_t, b_t, sn2, Y))
            plain_ms = time_ms(lambda: pairwise.expans_bias_gram_plain(
                X, s_t, b_t, sn2, Y), warmup=2, iters=10)
            cols = N_TRAIN if m is None else m
            gbs = N_TRAIN * cols * X.element_size() / (ms * 1e-3) / 1e9
            print(f"K1 time {name} {N_TRAIN}x{cols} "
                  f"{str(dtype).split('.')[-1]}: kernel {ms:.4f} ms "
                  f"({gbs:.0f} GB/s of output), plain {plain_ms:.4f} ms")
            if dtype == torch.float32 and m is None:
                report.update(ms=ms, plain_ms=plain_ms)
            del X, Y
    return report


def phase_golden(device):
    import torch

    from gp_ss_ak_torch.data import (Statistics, apply, read_data,
                                     unapply_var, unapply_y)
    from gp_ss_ak_torch.inference import nlml, predict
    from gp_ss_ak_torch.model import load_model
    from gp_ss_ak_torch.ops import pairwise

    f64 = torch.float64
    model = load_model(os.path.join(GOLDEN, "model")).to(f64, device)
    stats = Statistics.load(os.path.join(GOLDEN, "model_Statistics.txt"))
    Xtr, ytr = read_data(os.path.join(GOLDEN, "train.txt"))
    Xte, _ = read_data(os.path.join(GOLDEN, "test.txt"))
    Xtrs, ytrs = apply(stats, Xtr, ytr)
    Xtes = apply(stats, Xte)
    z = np.load(os.path.join(GOLDEN, "expected.npz"))

    def t(a):
        return torch.as_tensor(a, dtype=f64, device=device)

    before = pairwise.launches
    val = float(nlml(model.kernel, model.kernel_params, model.lik_hypers,
                     t(Xtrs), t(ytrs), model.likelihood))
    mu, var = predict(model.kernel, model.kernel_params, model.lik_hypers,
                      t(Xtrs), t(ytrs), t(Xtes), model.likelihood)
    yh = unapply_y(stats, mu.cpu().numpy())
    std = unapply_var(stats, var.cpu().numpy())
    used = pairwise.launches - before
    rel_nlml = abs(val / float(z["nlml"]) - 1.0)
    rel_mu = float(np.max(np.abs(yh - z["mu"]) / np.abs(z["mu"])))
    rel_std = float(np.max(np.abs(std - z["std"]) / np.abs(z["std"])))
    print(f"golden f64: NLML {val!r} vs {float(z['nlml'])!r} "
          f"(rel {rel_nlml:.2e}, tol 1e-8); mu rel {rel_mu:.2e}, "
          f"std rel {rel_std:.2e} (tol 1e-7); K1 launches {used}")
    np.testing.assert_allclose(val, float(z["nlml"]), rtol=1e-8)
    np.testing.assert_allclose(yh, z["mu"], rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(std, z["std"], rtol=1e-7, atol=1e-10)
    if device.type == "cuda":
        _check(used == 3, f"golden: expected 3 K1 launches, saw {used}")


def ore_body(seed: int, n: int):
    """A smooth synthetic 3-D ore body in drill-hole coordinates
    (metres in a 300 m cube) with 0.05 measurement noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 300.0, size=(n, 3))
    u = X / 150.0 - 1.0
    y = (1.2 + 0.6 * np.sin(1.7 * u[:, 0] + 0.4) * np.cos(1.3 * u[:, 1])
         + 0.4 * u[:, 2] + 0.25 * np.sin(2.1 * u[:, 0] * u[:, 2])
         + 0.05 * rng.normal(size=n))
    return X, y


def write_case(workdir: str, seed: int, n_train: int, n_test: int):
    """Train/test files, statistics and a model file with the golden
    ExpAns+Bias hyperparameters and the default noise sn2 = 0.016."""
    import torch

    from gp_ss_ak_torch.data import MODE_SYMMETRIC, prepare, write_data
    from gp_ss_ak_torch.model import load_model, save_model

    os.makedirs(workdir, exist_ok=True)
    X, y = ore_body(seed, n_train + n_test)
    train = os.path.join(workdir, "train.txt")
    test = os.path.join(workdir, "test.txt")
    model_path = os.path.join(workdir, "model")
    write_data(train, X[:n_train], y[:n_train])
    write_data(test, X[n_train:], y[n_train:])
    _, _, stats = prepare(X[:n_train], y[:n_train], MODE_SYMMETRIC)
    stats.save(model_path + "_Statistics.txt")
    golden = load_model(os.path.join(GOLDEN, "model"))
    model = dataclasses.replace(
        golden, num_data=n_train,
        lik_hypers=torch.tensor([SN2], dtype=torch.float64))
    save_model(model, model_path)
    return train, test, model_path


def phase_main(train: str, test: str, model_path: str):
    """`test` through the CLI entry point, in float32; returns the
    predicted means in test-file order."""
    from gp_ss_ak_torch import cli
    from gp_ss_ak_torch.data import read_data

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["-v", "1", "test", "--no-plot", test, model_path,
                       train])
    wall = time.perf_counter() - t0
    text = out.getvalue()
    print("cli test:", " | ".join(text.strip().splitlines()),
          f"(rc {rc}, {wall:.3f} s wall, file IO included)")
    _check(rc == 0, f"cli test returned {rc}")
    mse = float(re.search(r"Mean Square Error of testing: (\S+)",
                          text).group(1))
    var_y = float(re.search(r"Var MSE Test: (\S+)", text).group(1))
    _check(np.isfinite(mse) and mse < MSE_MAX * var_y,
           f"test MSE {mse} not below {MSE_MAX} * var(y) = "
           f"{MSE_MAX * var_y}")
    pred = model_path + "_predict.txt"
    with open(pred) as f:
        header = f.readline()
    _check(header == "# SampleNo, Y,  Yh, StdYh, Inputs\n",
           f"prediction header {header!r}")
    table = np.loadtxt(pred, comments="#")
    _, yt = read_data(test)
    _check(table.shape[0] == yt.shape[0], "prediction row count")
    _check(bool(np.all(np.isfinite(table[:, 2]))), "non-finite mean")
    _check(bool(np.all(table[:, 3] > 0)), "non-positive predictive std")
    yh = np.empty(yt.shape[0])
    yh[np.argsort(yt, kind="stable")] = table[:, 2]
    print(f"main path: MSE {mse:.6g} = {mse / var_y:.4f} var(y) "
          f"(limit {MSE_MAX}); {yt.shape[0]} predictions, finite, std > 0")
    return yh


def phase_serve(device, dtype, train: str, test: str, model_path: str,
                yh_cli, requests=REQUESTS, size=REQUEST_SIZE):
    """One Predictor, then `requests` requests of `size` queries;
    returns the K1 launches it made."""
    import torch

    from gp_ss_ak_torch.data import (Statistics, apply, read_data,
                                     unapply_y)
    from gp_ss_ak_torch.model import load_model
    from gp_ss_ak_torch.ops import pairwise
    from gp_ss_ak_torch.serve import Predictor

    model = load_model(model_path).to(dtype, device)
    stats = Statistics.load(model_path + "_Statistics.txt")
    Xtr, ytr = read_data(train)
    Xt, yt = read_data(test)
    Xtrs, ytrs = apply(stats, Xtr, ytr)
    Xts = apply(stats, Xt)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    before = pairwise.launches
    t0 = time.perf_counter()
    server = Predictor(model, Xtrs, ytrs)
    sync()
    setup_s = time.perf_counter() - t0
    lat, mus = [], []
    for k in range(requests):
        q = Xts[k * size:(k + 1) * size]
        t0 = time.perf_counter()
        mu, var = server(q)       # returns host arrays: the work is done
        lat.append(time.perf_counter() - t0)
        _check(bool(np.all(np.isfinite(mu)) and np.all(var > 0)),
               f"request {k}: non-finite mean or var <= 0")
        mus.append(mu)
    used = pairwise.launches - before
    yh = unapply_y(stats, np.concatenate(mus))
    diff = float(np.max(np.abs(yh - yh_cli[: requests * size])))
    tol = MEAN_TOL * float(np.std(yt))
    med = float(np.median(lat))
    print(f"serve: setup {setup_s:.4f} s (Gram + potrf + L^-1, "
          f"N={Xtr.shape[0]}); {requests} requests x {size}: median "
          f"{med * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms, "
          f"{size / med:.0f} predictions/s; |mean - cli mean| {diff:.3e} "
          f"(tol {tol:.3e}); K1 launches {used}")
    if cuda:
        print(f"serve: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _check(diff <= tol, "Predictor means disagree with the CLI's")
    if cuda:
        _check(used == 1 + requests,
               f"serve: expected {1 + requests} K1 launches, saw {used}")
    return server, used


def phase_setup_split(server):
    """Device time of each setup step at the main path's N (outside the
    counted run)."""
    import torch

    from gp_ss_ak_torch.kernels.distance import highest_precision
    from gp_ss_ak_torch.ops import cholesky, maybe_fused_A

    m = server.model
    sn2 = m.likelihood.noise_variance(m.lik_hypers)
    with highest_precision():
        A = maybe_fused_A(m.kernel, m.kernel_params, sn2, server.X)
        gram_ms = time_ms(lambda: maybe_fused_A(
            m.kernel, m.kernel_params, sn2, server.X), warmup=1, iters=5)
        chol_ms = time_ms(lambda: cholesky(A), warmup=1, iters=3)
        L = cholesky(A)
        del A
        eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
        linv_ms = time_ms(lambda: torch.linalg.solve_triangular(
            L, eye, upper=False), warmup=1, iters=3)
    print(f"serve setup split (device time): Gram {gram_ms:.4f} ms, "
          f"potrf {chol_ms:.4f} ms, L^-1 {linv_ms:.4f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from gp_ss_ak_torch.ops import pairwise

    device = torch.device("cuda", 0)
    phase_device()
    phase_build()
    k1 = phase_k1(device, args.seed)
    phase_golden(device)
    train, test, model_path = write_case(WORK, args.seed, N_TRAIN, N_TEST)

    pairwise.launches = 0          # the counted run: main path + serving
    yh_cli = phase_main(train, test, model_path)
    main_launches = pairwise.launches
    _check(main_launches == 2,
           f"cli test: expected 2 K1 launches (A, cross), saw "
           f"{main_launches}")
    server, _ = phase_serve(device, torch.float32, train, test, model_path,
                            yh_cli)
    launches = pairwise.launches
    phase_setup_split(server)

    print(json.dumps({"kernels": [{
        "name": "gram (K1, fused ExpAns+Bias Gram)",
        "route": "cuda",
        "source": "gp_ss_ak_torch/csrc/gram.cu",
        "replaces": "gp_ss_ak_tpu/ops/pairwise.py:42",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
