#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]      (from the root of the repository)

Phases, each of which raises on failure (nothing is caught):
  1. device: card name and power limit, torch/CUDA/nvcc versions;
  2. build the hand-written kernels K1 (gp_ss_ak_torch/csrc/gram.cu) and
     K3 (csrc/matmat.cu) into one library, one nvcc per source;
  3. K1 against its plain torch version on the card, at ragged sizes and
     at the main path's shapes, in float64 and float32, plus timings;
  4. K3 against its plain version in float64, at ragged sizes and at the
     matrix-free path's shapes, with a TF32 control that the same gate
     must reject, plus timings;
  5. the golden fixture (tests/golden) through K1 in float64;
  6. the dense path: `gp_ss_ak_torch.cli.main([... "test" ...])` in
     float32 on a synthetic ore body, N_train = 16384, N_test = 4096;
  7. dense serving: one `serve.Predictor`, then 8 requests of 512
     queries, and its setup split;
  8. the matrix-free `serve.IterativePredictor` (float32) against the
     dense Predictor in float64 on the same N = 16384 case;
  9. the matrix-free path: the same CLI call with the default
     `--engine auto` at N_train = 65536, N_test = 1024, which must pick
     the iterative server; then one IterativePredictor serving 4
     requests of 256 queries, and its setup split.
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
SIGMA, BIAS = 0.32626754572075006, 0.16293397312977825   # golden model
WORK = os.path.join(ROOT, "build", "chip_smoke")

N_TRAIN, N_TEST = 16384, 4096   # N_TRAIN = the dense engine's DENSE_MAX_N
REQUESTS, REQUEST_SIZE = 8, 512
# the matrix-free path: past the CLI's ITERATIVE_MIN_N = 32768
N_ITER_TRAIN, N_ITER_TEST = 65536, 1024
ITER_REQUESTS, ITER_REQUEST_SIZE = 4, 256
SN2 = 0.016                     # the reference's default noise variance
# K1 tolerances, relative to the Gram's scale s2 + bias
TOL_F64 = 1e-10                 # kernel vs plain, both float64
TOL_F32 = 1e-5                  # float32 kernel vs plain in float64
# K3 per column b, float32 kernel vs plain in float64:
# max |dY[:, b]| <= TOL_K3 * (s2 + bias) * ||V[:, b]||_1.
# Set from readings on an H100 80GB HBM3 at 700 W, seed 0: the kernel's
# worst column sits at 5.1e-8 (N = 65536, B = 1024; float32 summation
# error grows like n, as ||V||_1 does), and a TF32 product (the control
# below, which the gate must fail) at no less than 4.7e-7 (N = 65536,
# B = 1; its error grows like sqrt(n)), so the limit sits ~3x from each.
TOL_K3 = 1.5e-7
ITER_MEAN_TOL = 1e-2            # iterative vs dense f64 means, x std(y_s)
ITER_VAR_RTOL = 1e-2            # and variances (noise included)
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
    print(f"build: K1 and K3 loaded in {time.perf_counter() - t0:.3f} s "
          f"(nvcc, one process per source, then link: "
          f"{_build.build_info.get('seconds', 0.0):.3f} s)")
    for line in _build.build_info.get("log", "").splitlines():
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line):
            print("  ptxas:", line.strip())


def phase_k1(device, seed: int, cases=None, time_shapes=True):
    """K1 vs its plain version on the same inputs; returns the report."""
    import torch

    from gp_ss_ak_torch.ops import pairwise

    sigma, bias = SIGMA, BIAS
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


def _round_tf32(t):
    """float32 values rounded to nearest with TF32's 10 mantissa bits."""
    import torch

    bits = t.float().contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def tf32_control(Xk, scal, V):
    """K3's function as a TF32 product gives it: the float32 Gram entries
    and V rounded to TF32, the products summed in float64. The K3 gate
    must fail it."""
    import torch

    from gp_ss_ak_torch.ops import matvec

    n, chunk = Xk.shape[0], matvec.PLAIN_CHUNK
    X, s2, V64 = Xk.double(), scal[0].double(), V.double()
    Vt = _round_tf32(V).double()
    Y = torch.empty_like(V64)
    for s in range(0, n, chunk):
        K = s2 * torch.exp(-torch.cdist(X[s:s + chunk], X))
        K.diagonal(offset=s).fill_(s2)
        Y[s:s + chunk] = _round_tf32(K).double() @ Vt
        del K
    return Y + BIAS * V64.sum(dim=0, keepdim=True) + SN2 * V64


def phase_k3(device, seed: int):
    """K3 vs its plain version in float64 on the same inputs, a TF32
    control that the same gate must reject, then CUDA event times at the
    matrix-free path's shapes; returns the report."""
    import torch

    from gp_ss_ak_torch.ops import matvec

    scale = SIGMA * SIGMA + BIAS
    g = torch.Generator(device=device).manual_seed(seed)

    def case(n, b, d):
        X = 3.0 * torch.rand(n, d, generator=g, device=device) - 1.5
        V = torch.randn(n, b, generator=g, device=device)
        Xk, scal = matvec.operator_arrays(X, SIGMA)
        return Xk, scal, V

    cases = [(n, b, d) for n in (1000, 4097) for b in (1, 7, 64, 1024)
             for d in (3, 4)]
    cases += [(N_ITER_TRAIN, 1, 3), (N_ITER_TRAIN, 1024, 3)]
    worst, worst_ratio, ctl_ratio = 0.0, 0.0, float("inf")
    for n, b, d in cases:
        Xk, scal, V = case(n, b, d)
        Y = matvec.streamed_matmat(Xk, scal, BIAS, SN2, V)
        ref = matvec.streamed_matmat_plain(Xk.double(), scal.double(), BIAS,
                                           SN2, V.double())
        err = (Y.double() - ref).abs().max(dim=0).values
        lim = TOL_K3 * scale * V.double().abs().sum(dim=0)
        ratio = float((err / lim).max())
        cerr = (tf32_control(Xk, scal, V) - ref).abs().max(dim=0).values
        cratio = float((cerr / lim).max())
        print(f"K3 n={n} B={b} d={d}: max |kernel-plain64| "
              f"{float(err.max()):.3e}, worst column at {ratio:.3e} of its "
              f"limit {TOL_K3}*(s2+bias)*||V[:,b]||_1; TF32 control "
              f"{float(cerr.max()):.3e}, worst column at {cratio:.3e}")
        _check(bool((err <= lim).all()), f"K3 disagrees at n={n} B={b} "
               f"d={d}")
        _check(bool((cerr > lim).any()), f"K3 gate too loose: a TF32 "
               f"product passes it at n={n} B={b} d={d}")
        worst = max(worst, float(err.max()))
        worst_ratio = max(worst_ratio, ratio)
        ctl_ratio = min(ctl_ratio, cratio)
        del Y, ref
    print(f"K3: worst error {worst:.3e}, worst column at {worst_ratio:.3e} "
          f"of its limit; the TF32 control's worst column at no less than "
          f"{ctl_ratio:.3e} of it")

    report = {"max_abs_err": worst}
    bias_t, sn2_t = (torch.tensor(v, device=device) for v in (BIAS, SN2))
    Xk, scal, _ = case(N_ITER_TRAIN, 1, 3)
    n = N_ITER_TRAIN
    for b, iters in ((1, 20), (256, 5), (1024, 3)):
        V = torch.randn(n, b, generator=g, device=device)
        ms = time_ms(lambda: matvec.streamed_matmat(
            Xk, scal, bias_t, sn2_t, V), warmup=1, iters=iters)
        plain_ms = time_ms(lambda: matvec.streamed_matmat_plain(
            Xk, scal, bias_t, sn2_t, V), warmup=1, iters=min(iters, 5))
        pairs = n * n / (ms * 1e-3) / 1e9
        tflops = 2.0 * n * n * b / (ms * 1e-3) / 1e12
        print(f"K3 time N={n} B={b} d=3 f32: kernel {ms:.4f} ms "
              f"({pairs:.1f} Gpairs/s, {tflops:.2f} TFLOP/s of K.V), "
              f"plain {plain_ms:.4f} ms")
        report[b] = (ms, plain_ms)
    report["ms"], report["plain_ms"] = report[1024]
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


def _load_case(device, dtype, train: str, test: str, model_path: str):
    from gp_ss_ak_torch.data import Statistics, apply, read_data
    from gp_ss_ak_torch.model import load_model

    model = load_model(model_path).to(dtype, device)
    stats = Statistics.load(model_path + "_Statistics.txt")
    Xtr, ytr = read_data(train)
    Xt, yt = read_data(test)
    Xtrs, ytrs = apply(stats, Xtr, ytr)
    return model, stats, Xtrs, ytrs, apply(stats, Xt), yt


def phase_iter_vs_dense(device, train: str, test: str, model_path: str):
    """IterativePredictor (float32) vs the dense Predictor in float64 on
    the same 512 queries of the N = 16384 case."""
    import torch

    from gp_ss_ak_torch.serve import IterativePredictor, Predictor

    model, _, Xtrs, ytrs, Xts, _ = _load_case(
        device, torch.float32, train, test, model_path)
    q = Xts[:512]
    t0 = time.perf_counter()
    it = IterativePredictor(model, Xtrs, ytrs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mu_i, var_i = it(q, batch_size=512)
    dense = Predictor(model.to(torch.float64, device), Xtrs, ytrs,
                      precompute_inverse=False)
    mu_d, var_d = dense(q)
    del dense
    err_mu = float(np.max(np.abs(mu_i - mu_d)))
    tol_mu = ITER_MEAN_TOL * float(np.std(ytrs))
    rel_var = float(np.max(np.abs(var_i - var_d) / var_d))
    print(f"iterative vs dense f64 (N={Xtrs.shape[0]}, 512 queries, rank "
          f"{it.precond_rank}): max |mu diff| {err_mu:.3e} (tol "
          f"{tol_mu:.3e}), max var rel diff {rel_var:.3e} (tol "
          f"{ITER_VAR_RTOL}); setup {setup_s:.3f} s, setup_cg_iters "
          f"{it.setup_cg_iters}, last_cg_iters {it.last_cg_iters}")
    _check(bool(np.all(np.isfinite(mu_i)) and np.all(var_i > 0)),
           "iterative: non-finite mean or var <= 0")
    _check(err_mu <= tol_mu, "iterative means disagree with dense f64")
    _check(rel_var <= ITER_VAR_RTOL,
           "iterative variances disagree with dense f64")


def phase_iter_serve(device, train: str, test: str, model_path: str,
                     yh_cli, k3_ms: float):
    """One IterativePredictor, then ITER_REQUESTS requests of
    ITER_REQUEST_SIZE queries; its means against the CLI's. k3_ms: K3's
    time for one pass at the request's width, for the K3 share."""
    import torch

    from gp_ss_ak_torch.data import unapply_y
    from gp_ss_ak_torch.serve import IterativePredictor

    model, stats, Xtrs, ytrs, Xts, yt = _load_case(
        device, torch.float32, train, test, model_path)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = IterativePredictor(model, Xtrs, ytrs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    size = ITER_REQUEST_SIZE
    lat, mus, iters = [], [], []
    for k in range(ITER_REQUESTS):
        q = Xts[k * size:(k + 1) * size]
        t0 = time.perf_counter()
        mu, var = server(q, batch_size=size)   # host arrays: work done
        lat.append(time.perf_counter() - t0)
        iters.append(server.last_cg_iters)
        _check(bool(np.all(np.isfinite(mu)) and np.all(var > 0)),
               f"iterative request {k}: non-finite mean or var <= 0")
        mus.append(mu)
    yh = unapply_y(stats, np.concatenate(mus))
    diff = float(np.max(np.abs(yh - yh_cli[:ITER_REQUESTS * size])))
    tol = MEAN_TOL * float(np.std(yt))
    med = float(np.median(lat))
    print(f"iterative serve: setup {setup_s:.4f} s (N={Xtrs.shape[0]}, "
          f"rank {server.precond_rank}, setup_cg_iters "
          f"{server.setup_cg_iters}); {ITER_REQUESTS} requests x {size}: "
          f"median {med:.4f} s, max {max(lat):.4f} s, "
          f"{size / med:.1f} predictions/s, CG iterations {iters}; "
          f"|mean - cli mean| {diff:.3e} (tol {tol:.3e})")
    print(f"iterative serve: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; K3 share "
          f"of the median request ~ {iters[0]} passes x {k3_ms:.3f} ms / "
          f"{med * 1e3:.3f} ms = {iters[0] * k3_ms / (med * 1e3):.3f}")
    _check(diff <= tol, "IterativePredictor means disagree with the CLI's")
    return server, ytrs


def phase_iter_setup_split(server, ytrs):
    """Host-clock time of each setup step at the matrix-free path's N
    (outside the counted run)."""
    import torch

    from gp_ss_ak_torch.inference.iterative import pivoted_cholesky

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pivoted_cholesky(server._Xm, server.sigma, server.bias,
                     server.precond_rank)
    torch.cuda.synchronize()
    piv_s = time.perf_counter() - t0
    y = torch.as_tensor(ytrs, dtype=torch.float32, device=server.device)
    t0 = time.perf_counter()
    _, it = server._solve(y[:, None])
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    print(f"iterative setup split (host clock, synchronized): pivoted "
          f"Cholesky rank {server.precond_rank} {piv_s:.4f} s, alpha "
          f"solve {solve_s:.4f} s ({int(it)} whitened-CG iterations, "
          f"{solve_s / max(int(it), 1) * 1e3:.3f} ms each)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from gp_ss_ak_torch.ops import matvec, pairwise

    device = torch.device("cuda", 0)
    phase_device()
    phase_build()
    k1 = phase_k1(device, args.seed)
    k3 = phase_k3(device, args.seed)
    phase_golden(device)
    train, test, model_path = write_case(WORK, args.seed, N_TRAIN, N_TEST)

    # counted run 1, the dense path: CLI test + dense serving
    pairwise.launches = matvec.launches = 0
    yh_cli = phase_main(train, test, model_path)
    _check(pairwise.launches == 2 and matvec.launches == 0,
           f"dense cli test: expected 2 K1 launches (A, cross) and no K3, "
           f"saw {pairwise.launches} and {matvec.launches}")
    server, _ = phase_serve(device, torch.float32, train, test, model_path,
                            yh_cli)
    k1_dense = pairwise.launches
    phase_setup_split(server)
    del server
    torch.cuda.empty_cache()

    phase_iter_vs_dense(device, train, test, model_path)
    itrain, itest, imodel = write_case(WORK + "_iterative", args.seed,
                                       N_ITER_TRAIN, N_ITER_TEST)

    # counted run 2, the matrix-free path: CLI test (auto engine) +
    # iterative serving
    pairwise.launches = matvec.launches = 0
    yh_it = phase_main(itrain, itest, imodel)
    cli_k1, cli_k3 = pairwise.launches, matvec.launches
    print(f"cli test at N={N_ITER_TRAIN} (auto engine): K3 launches "
          f"{cli_k3}, K1 cross launches {cli_k1}")
    _check(cli_k3 > 0, "auto engine did not pick the iterative server")
    _check(cli_k1 > 0, "iterative cli test made no K1 cross launch")
    iserver, ytrs = phase_iter_serve(device, itrain, itest, imodel, yh_it,
                                     k3[ITER_REQUEST_SIZE][0])
    k1_iter, k3_iter = pairwise.launches, matvec.launches
    _check(k1_iter > cli_k1 and k3_iter > cli_k3,
           "iterative serving launched no K1 or no K3")
    phase_iter_setup_split(iserver, ytrs)

    print(json.dumps({"kernels": [{
        "name": "gram (K1, fused ExpAns+Bias Gram)",
        "route": "cuda",
        "source": "gp_ss_ak_torch/csrc/gram.cu",
        "replaces": "gp_ss_ak_tpu/ops/pairwise.py:42",
        "launches": k1_dense + k1_iter,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }, {
        "name": "matmat (K3, streamed Gram matmat, N=65536 B=1024)",
        "route": "cuda",
        "source": "gp_ss_ak_torch/csrc/matmat.cu",
        "replaces": "gp_ss_ak_tpu/ops/matvec.py:90",
        "launches": k3_iter,
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
