#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed N]      (from the root of the repository)
    python3 chip_smoke.py --only k3       (phases 1, 2 and 4: K3 alone)
    python3 chip_smoke.py --only warped   (phases 1, 2, 9b, 10b, 11b, 13)
    python3 chip_smoke.py --only batched  (phases 1, 2, 15-18)

Phases, each of which raises on failure (nothing is caught):
  1. device: card name and power limit, torch/CUDA/nvcc versions;
  2. build the hand-written kernels K1 (gp_ss_ak_torch/csrc/gram.cu), K2
     (csrc/matvec.cu) and K3 (csrc/matmat.cu) into one library, one nvcc
     per source; ptxas's register report (no spills in K3's wide tile)
     and the HMMA count of K3's SASS (cuobjdump);
  3. K1 against its plain torch version on the card, at ragged sizes and
     at the main path's shapes, in float64 and float32, plus timings;
  4. K3 against its plain version in float64, at ragged sizes, at the
     edges of its four tiles and at N = 65536 at every width the main
     path uses, with a TF32 control that the same gate must reject and a
     3xTF32 control that it must accept, equal bits across passes and
     tiles, plus timings at those widths (and B = 65, the wide tile's
     first), the SM clock while the widest runs, and a cuBLAS yardstick
     on a prebuilt K;
  5. K2 against its plain version in float64 at ragged sizes and at
     N = 16384, 32768 (the K2 path's) and 65536, the same gate and TF32
     control, two passes for equal bits, and its time beside its bound
     and K3 at B = 1;
  6. the golden fixture (tests/golden) through K1 in float64;
  7. the dense path: `gp_ss_ak_torch.cli.main([... "test" ...])` in
     float32 on a synthetic ore body, N_train = 16384, N_test = 4096;
  8. dense serving: one `serve.Predictor`, then 8 requests of 512
     queries, and its setup split;
  9. the dense training path: `cli.main([... "train" -# 5 ...])` at
     N = 16384 (DENSE_MAX_N), then `test` on the trained model (the
     round trip), and one real evaluation under torch.profiler;
 9b. the warped round trip: `train -# 5 -lf WarpGauss:tanh1:1` and
     `test` at N = 16384 on a skewed grade, exp(0.8 y) of the same ore
     body; the time of one warped evaluation and of the warp mix;
 10. the matrix-free `serve.IterativePredictor` (float32) against the
     dense Predictor in float64 on the same N = 16384 case, and
     `nlml_and_grad_iterative` there in chol, gemm and stream mode with
     the same probes;
 10b. the same comparison for the warped model of 9b;
 11. the matrix-free path: the same CLI call with the default
     `--engine auto` at N_train = 65536, N_test = 1024, which must pick
     the iterative server; then one IterativePredictor serving 4
     requests of 256 queries, and its setup split;
 11b. the warped matrix-free path at N = 65536: one warped
     IterativePredictor serving 2 requests of 256 queries; one warped
     stream-mode `make_iterative_value_and_grad` evaluation with an
     identity-like warp against the plain Gaussian's with the same
     probes;
 12. matrix-free training: `optim.fit(engine="iterative", stream mode,
     iters=2)` at N = 65536, and one real evaluation under
     torch.profiler;
 13. the default train route at N = 65536: `cli.main([... "train" -# 1
     ...])` with `--engine auto` (chol mode on an 80 GB card) and its
     dense training-set predict (the mean alone, in 4096-query chunks),
     profiled, with its peak memory held to 8 N^2 bytes + 3 GiB;
 14. the K2 path: `nlml_iterative(precond_rank=0, mode="stream")` at
     N = 32768, its residual through K3 and chol mode's exact value;
 15. K1's batched entry against its batched plain version at ragged B, n
     and m (square with its diagonal and cross, float64 and float32,
     per-member scalars), each member bit for bit against a 2-D launch,
     and its time at B = 256 members of 1024^2 beside its bound;
 16. the ensemble: `fit_ensemble` of 256 deposits x 1024 composites
     (float32, maxiter 30), one batched K1 launch per batched
     evaluation, every deposit's NLML below its start, four deposits
     alone through `fit(optimizer="JIT")` against the batch, one
     evaluation's split under torch.profiler, then `predict_ensemble`
     at 1024 queries a deposit (MSE < 0.2 var(y) each);
 17. `cli.main([... "train" -o JIT -# 5 ...])` at N = 16384, then `test`
     on the trained model;
 18. `sample_hyperposterior` (NUTS, 8 chains, N = 2048, float32, 4
     warmup + 4 samples, max_depth 8): samples finite and inside the
     box, one batched K1 launch per objective evaluation, split R-hat
     and ESS printed; then `predictive_mixture` over every 10th sample.
Every bound is the largest of four terms (`bound`): bytes, FP32 work
outside any product, SFU work and the product on the tensor cores at
float32 accuracy; the line says which term sets it.
Each counted path runs with the launch counts set to 0 just before it
and read just after. The line before the last is the JSON kernel report;
the last line is {"ok": true, "device": {...}}. Exits non-zero, printing
no result, when no CUDA device is available or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib.metadata
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SIGMA, BIAS = 0.32626754572075006, 0.16293397312977825   # golden model
WORK = os.path.join(ROOT, "build", "chip_smoke")

N_TRAIN, N_TEST = 16384, 4096   # N_TRAIN = the dense engine's DENSE_MAX_N
# the warped phases: the CLI's likelihood flag, the requests of the warped
# matrix-free server, and the identity-like warp (a = exp(-12), sn2 = SN2;
# tests/test_inference.py:138-147)
WARP_LF = "WarpGauss:tanh1:1"
WARP_ITER_REQUESTS = 2
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
# the K2 path (no preconditioner) and matrix-free training
N_K2_PATH = 32768
K2_PATH_RES = 4.0               # its true residual's limit, x cg_tol
N_ITER_FIT = N_ITER_TRAIN
# stream vs gemm mode of nlml_and_grad_iterative at N_TRAIN with the same
# probes: tests/test_iterative.py:355-365's tolerances for two modes
MODE_VAL_REL, MODE_VAL_ABS = 1e-4, 0.05
MODE_GRAD_REL, MODE_GRAD_ABS = 1e-3, 1e-2
MODE_CG_TOL = 1e-6              # that test's CG tolerance
# the Xm gradient, stream vs gemm, relative to its largest entry: 1.6e-3
# on an H100 at cg_tol 1e-4 and at 1e-6 alike (float32 contraction
# round-off, not the solves), so the limit sits ~6x above it
MODE_XM_REL = 1e-2
# the card's peaks for the bounds (NVIDIA H100 SXM data sheet, at 700 W):
# HBM bytes/s, FP32 outside the tensor cores and dense TF32, flop/s; the
# SFU's rsqrt and ex2 per SM per clock (sm_90), its rate set by the
# card's SM count and maximum SM clock (card_rates)
PEAK_BYTES_S, PEAK_FP32_FLOPS, PEAK_TF32_FLOPS = 3.35e12, 67e12, 495e12
SFU_PER_SM_CLOCK = 16
ITER_MEAN_TOL = 1e-2            # iterative vs dense f64 means, x std(y_s)
ITER_VAR_RTOL = 1e-2            # and variances (noise included)
MSE_MAX = 0.2                   # test MSE must stay below MSE_MAX * var(y)
WARP_MSE_MAX = 1.0              # a warped model's: below var(y), as
#                                 tests/test_cli.py:199-203 holds JAX
# the default train route's peak device memory: A and L during potrf
# (8 N^2 bytes in float32) and this much more
DEFAULT_ROUTE_SLACK_GIB = 3.0
MEAN_TOL = 1e-3                 # Predictor vs CLI means, times std(y)
# the batched paths: K1's batched entry timed at B members of n x n (the
# same 2^28 entries as the 16384^2 timing); the ensemble of ENS_B
# deposits x ENS_N composites (d = 3), fitted for ENS_ITERS iterations,
# ENS_SINGLE of them also alone through fit(optimizer="JIT"), each
# predicted at ENS_Q queries; the CLI's `train -o JIT -# JIT_ITERS`; NUTS
# with NUTS_CHAINS chains on NUTS_N points, its mixture over every
# NUTS_THIN-th sample
K1_BATCH_TIME = (256, 1024)
ENS_B, ENS_N, ENS_Q, ENS_ITERS, ENS_SINGLE = 256, 1024, 1024, 30, 4
ENS_SINGLE_RTOL = 1e-4          # a deposit alone vs in the batch: fun
# and in float32, the first evaluation alone vs in the batch (measured
# 6.4e-6 in the value, 1.7e-6 in the gradient on an H100)
ENS_FIRST_RTOL = 5e-5
JIT_ITERS = 5
# NUTS's sample counts are cut from 100 + 100 to 4 + 4 to keep the
# batched phases near two minutes: past the first few transitions most
# trees of some chain reach max_depth (255 leaves, ~32 ms a batched
# evaluation at 8 x 2048), since the hyperposterior is tight in some
# directions of z and loose in others (InversewidthR does not enter a
# d = 3 model) and a short warmup's diagonal mass cannot match both
# (PERF.md §6)
NUTS_CHAINS, NUTS_N, NUTS_WARMUP, NUTS_SAMPLES = 8, 2048, 4, 4
NUTS_THIN = 10


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


@functools.cache
def card_rates():
    """{"sms": SM count, "clock_hz": maximum SM clock} of card 0, for the
    SFU term of `bound`."""
    import torch

    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "clock_hz": float(mhz) * 1e6}


def bound(work, sms: int, clock_hz: float):
    """(bound_ms, term): the least time the card could take for `work` =
    (bytes moved, each input read once and each output written once;
    FP32 operations outside any product; SFU operations; product
    operations at float32 accuracy on the tensor cores, three TF32
    products each), the largest of its four terms, and which term it
    is: "bytes", "FP32", "SFU" or "tensor".

    The SFU term prices each rsqrt and ex2 at the MUFU unit's 16 per SM
    per clock, so it is a floor only for a kernel that computes both on
    MUFU. A kernel can move part of its ex2 onto the FP32 pipes as a
    polynomial (FlashAttention-4 does), whose combined rate is higher;
    this term does not count that, so it can stand above such a
    kernel's true floor."""
    nbytes, fp32, sfu, tensor = work
    terms = {"bytes": nbytes / PEAK_BYTES_S,
             "FP32": fp32 / PEAK_FP32_FLOPS,
             "SFU": sfu / (sms * SFU_PER_SM_CLOCK * clock_hz),
             "tensor": tensor / PEAK_TF32_FLOPS}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, term


def gram_work(n: int, m: int, d: int):
    """K1's work for n*m Gram entries over d features: the output written
    once and the points read once; 3d + 2 FP32 operations an entry (d
    differences and d multiply-adds, 2 each, for the distance, the scale
    by s2 and the bias add); an rsqrt and an ex2 an entry on the SFU."""
    return 4.0 * (n * m + (n + m) * d), float(n) * m * (3 * d + 2), \
        2.0 * n * m, 0.0


def matvec_work(n: int, d: int):
    """K2's work for one pass over the n*n Gram entries: the points
    (padded to a float4), v and y once; 3d + 2 FP32 operations an entry
    (the distance as in gram_work and the multiply-add with v; s2 scales
    each output once); two SFU operations an entry; the product 2 n^2
    priced as three TF32 products."""
    return 4.0 * n * (4 + 2), float(n) * n * (3 * d + 2), 2.0 * n * n, \
        3 * 2.0 * n * n


def matmat_work(n: int, d: int, b: int):
    """K3's work for one pass over the n*n Gram entries against b
    columns: the points (padded to a float4), V and Y once; 3d + 1 FP32
    operations an entry outside the product (the distance, the s2
    scale); two SFU operations an entry; the product 2 n^2 b priced as
    three TF32 products."""
    return 4.0 * n * (4 + 2 * b), float(n) * n * (3 * d + 1), \
        2.0 * n * n, 3 * 2.0 * n * n * b


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
          f"(count {torch.cuda.device_count()}); {card_rates()['sms']} SMs, "
          f"max SM clock {card_rates()['clock_hz'] / 1e6:.0f} MHz")


def phase_build():
    from gp_ss_ak_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"build: K1, K2 and K3 loaded in {time.perf_counter() - t0:.3f} s "
          f"(nvcc, one process per source, then link: "
          f"{_build.build_info.get('seconds', 0.0):.3f} s)")
    log = _build.build_info.get("log", "")
    for line in log.splitlines():
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line):
            print("  ptxas:", line.strip())
    # K3's wide tile: no spills in ptxas's report, and HMMA in its SASS
    spills = re.findall(r"Function properties for (\S*matmat_tc_kernel\S*)"
                        r"\s+\d+ bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", log)
    _check(len(spills) > 0, "ptxas reported no K3 wide tile")
    for name, st, ld in spills:
        _check(st == ld == "0", f"K3 wide tile {name} spills: {st} bytes "
               f"stored, {ld} loaded")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.load()._name],
                          capture_output=True, text=True, check=True).stdout
    hmma = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if "matmat" in name:
            hmma[name] = part.count("HMMA")
    print(f"build: HMMA instructions in K3's SASS, by kernel: {hmma}")
    wide = [c for k, c in hmma.items() if "matmat_tc_kernel" in k]
    _check(len(wide) == len(spills) and min(wide) > 0,
           "K3's wide tile issues no HMMA")


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
                b_ms, b_by = bound(gram_work(N_TRAIN, N_TRAIN, 3),
                                   **card_rates())
                print(f"K1 bound {N_TRAIN}^2 diag f32: {b_ms:.4f} ms "
                      f"(set by {b_by}); kernel at {b_ms / ms:.3f} of it")
                report.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by)
            del X, Y
    return report


def _round_tf32(t):
    """float32 values rounded to nearest with TF32's 10 mantissa bits."""
    import torch

    bits = t.float().contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def _gram64(X, s2, rows: slice):
    """Float64 Gram rows of K3's function (exact s2 diagonal)."""
    import torch

    K = s2 * torch.exp(-torch.cdist(X[rows], X))
    K.diagonal(offset=rows.start).fill_(s2)
    return K


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
        K = _gram64(X, s2, slice(s, s + chunk))
        Y[s:s + chunk] = _round_tf32(K).double() @ Vt
        del K
    return Y + BIAS * V64.sum(dim=0, keepdim=True) + SN2 * V64


def _split_tf32(t):
    """(hi, lo) of float32 values in float64: hi = t rounded to TF32,
    lo = (t - hi) rounded to TF32, as K3's wide tile splits them."""
    t = t.float()
    hi = _round_tf32(t)
    return hi.double(), _round_tf32(t - hi).double()


def split_tf32_control(Xk, scal, V):
    """K3's function as the wide tile's 3xTF32 product gives it, with no
    accumulation error: the float32 Gram entries and V each split into
    TF32 parts (hi, lo), then K_hi V_hi + K_hi V_lo + K_lo V_hi summed
    in float64. The K3 gate must accept it."""
    import torch

    from gp_ss_ak_torch.ops import matvec

    n, chunk = Xk.shape[0], matvec.PLAIN_CHUNK
    X, s2, V64 = Xk.double(), scal[0].double(), V.double()
    Vh, Vl = _split_tf32(V)
    Y = torch.empty_like(V64)
    for s in range(0, n, chunk):
        Kh, Kl = _split_tf32(_gram64(X, s2, slice(s, s + chunk)))
        Y[s:s + chunk] = Kh @ Vh + (Kh @ Vl + Kl @ Vh)
        del Kh, Kl
    return Y + BIAS * V64.sum(dim=0, keepdim=True) + SN2 * V64


#: the widths the main path gives K3 at N_ITER_TRAIN (setup and whitened
#: CG at 1, the fit's whitened CG at 9, the SLQ at 64, a 256-query
#: request, the CLI's variance solves at 1024), plus 65, the wide tile's
#: first width, for the middle/wide threshold; and timed passes of each
K3_WIDTHS = ((1, 20), (9, 10), (64, 10), (65, 5), (256, 5), (1024, 3))
#: K3's gate cases (n, B, d): ragged n at the narrow, middle and wide
#: tiles' widths, the edges of the four tiles, and every timed width at
#: the main path's N (each tile at the shape the path runs it)
K3_CASES = ([(n, b, d) for n in (1000, 4097) for b in (1, 7, 64, 1024)
             for d in (3, 4)]
            + [(4097, b, 3) for b in (16, 17, 65, 128, 129, 1000)]
            + [(N_ITER_TRAIN, b, 3) for b, _ in K3_WIDTHS])


def _k3_case(g, device, n, b, d):
    import torch

    from gp_ss_ak_torch.ops import matvec

    X = 3.0 * torch.rand(n, d, generator=g, device=device) - 1.5
    V = torch.randn(n, b, generator=g, device=device)
    Xk, scal = matvec.operator_arrays(X, SIGMA)
    return Xk, scal, V


def k3_gate(device, seed: int, cases=K3_CASES):
    """K3 against its plain version in float64 on the same inputs at
    `cases`, with the TF32 control that the gate must reject and the
    3xTF32 control that it must accept; returns (worst error, worst
    column's share of its limit)."""
    import torch

    from gp_ss_ak_torch.ops import matvec

    scale = SIGMA * SIGMA + BIAS
    g = torch.Generator(device=device).manual_seed(seed)
    worst, worst_ratio, ctl_ratio, split_ratio = 0.0, 0.0, float("inf"), 0.0
    for n, b, d in cases:
        Xk, scal, V = _k3_case(g, device, n, b, d)
        Y = matvec.streamed_matmat(Xk, scal, BIAS, SN2, V)
        ref = matvec.streamed_matmat_plain(Xk.double(), scal.double(), BIAS,
                                           SN2, V.double())
        lim = TOL_K3 * scale * V.double().abs().sum(dim=0)

        def share(out):
            return (out - ref).abs().max(dim=0).values / lim

        err = float((Y.double() - ref).abs().max())
        ratio = float(share(Y.double()).max())
        cratio = float(share(tf32_control(Xk, scal, V)).max())
        sratio = float(share(split_tf32_control(Xk, scal, V)).max())
        print(f"K3 n={n} B={b} d={d}: max |kernel-plain64| {err:.3e}, "
              f"worst column at {ratio:.3e} of its limit "
              f"{TOL_K3}*(s2+bias)*||V[:,b]||_1; TF32 control at "
              f"{cratio:.3e}, 3xTF32 control at {sratio:.3e}")
        _check(ratio <= 1.0, f"K3 disagrees at n={n} B={b} d={d}")
        _check(cratio > 1.0, f"K3 gate too loose: a TF32 product passes it "
               f"at n={n} B={b} d={d}")
        _check(sratio <= 1.0, f"K3 gate too tight: the 3xTF32 product "
               f"fails it at n={n} B={b} d={d}")
        worst = max(worst, err)
        worst_ratio = max(worst_ratio, ratio)
        ctl_ratio = min(ctl_ratio, cratio)
        split_ratio = max(split_ratio, sratio)
        del Y, ref
    print(f"K3: worst error {worst:.3e}, worst column at {worst_ratio:.3e} "
          f"of its limit; the TF32 control's worst column at no less than "
          f"{ctl_ratio:.3e} of it, the 3xTF32 control's at no more than "
          f"{split_ratio:.3e}")
    return worst, worst_ratio


def k3_bits(device, seed: int, n: int = 4097):
    """Two K3 passes give equal bits on each tile (B = 9, 257, 1024), and
    the 16-wide tile's output at B = 9 equals the middle tile's on the
    same V zero-padded to 64 columns."""
    import torch

    from gp_ss_ak_torch.ops import matvec

    g = torch.Generator(device=device).manual_seed(seed + 1)
    for b in (9, 257, 1024):
        Xk, scal, V = _k3_case(g, device, n, b, 3)
        Y = matvec.streamed_matmat(Xk, scal, BIAS, SN2, V)
        _check(torch.equal(Y, matvec.streamed_matmat(Xk, scal, BIAS, SN2,
                                                     V)),
               f"K3 passes differ at n={n} B={b}")
        if b == 9:
            # the kernel's own output (no bias or noise: torch's column
            # sums of (n, 9) and (n, 64) tensors need not agree in bits)
            V64 = torch.zeros(n, 64, device=device)
            V64[:, :b] = V
            Y9 = matvec.streamed_matmat(Xk, scal, 0.0, 0.0, V)
            Y64 = matvec.streamed_matmat(Xk, scal, 0.0, 0.0, V64)
            _check(torch.equal(Y9, Y64[:, :b]), "K3's 16-wide tile and "
                   "middle tile differ at B = 9")
    print(f"K3 bits at n={n}: two passes equal at B = 9, 257 and 1024; the "
          f"16-wide tile equals the middle tile at B = 9")


def k3_times(device, seed: int, widths=K3_WIDTHS):
    """CUDA event times of K3 and its plain version at N_ITER_TRAIN, d =
    3, at `widths`, beside the bound; returns ({B: (ms, plain ms, bound
    ms, term)}, the points, scal and the last width's V)."""
    import torch

    from gp_ss_ak_torch.ops import matvec

    g = torch.Generator(device=device).manual_seed(seed + 2)
    bias_t, sn2_t = (torch.tensor(v, device=device) for v in (BIAS, SN2))
    n = N_ITER_TRAIN
    Xk, scal, _ = _k3_case(g, device, n, 1, 3)
    out = {}
    for b, iters in widths:
        V = torch.randn(n, b, generator=g, device=device)
        ms = time_ms(lambda: matvec.streamed_matmat(
            Xk, scal, bias_t, sn2_t, V), warmup=1, iters=iters)
        plain_ms = time_ms(lambda: matvec.streamed_matmat_plain(
            Xk, scal, bias_t, sn2_t, V), warmup=1, iters=min(iters, 5))
        b_ms, b_by = bound(matmat_work(n, 3, b), **card_rates())
        pairs = n * n / (ms * 1e-3) / 1e9
        tflops = 2.0 * n * n * b / (ms * 1e-3) / 1e12
        print(f"K3 time N={n} B={b} d=3 f32: kernel {ms:.4f} ms "
              f"({pairs:.1f} Gpairs/s, {tflops:.2f} TFLOP/s of K.V), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms (set by "
              f"{b_by}), kernel at {b_ms / ms:.3f} of it")
        out[b] = (ms, plain_ms, b_ms, b_by)
    return out, Xk, scal, V


def phase_k3(device, seed: int):
    """K3's gate, its bits and its times at the main path's widths, the
    SM clock under the widest, and a cuBLAS yardstick at B = 1024;
    returns the report."""
    import torch

    from gp_ss_ak_torch.ops import matvec, pairwise

    worst, _ = k3_gate(device, seed)
    k3_bits(device, seed)
    times, Xk, scal, V = k3_times(device, seed)
    report = {"max_abs_err": worst, **times}
    report["ms"], report["plain_ms"], report["bound_ms"], \
        report["bound_by"] = times[1024]
    n = Xk.shape[0]
    # does the card hold its clock under the widest pass? One nvidia-smi
    # reading while four queued passes (~1 s) run
    for _ in range(4):
        matvec.streamed_matmat(Xk, scal, BIAS, SN2, V)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.cuda.synchronize()
    print(f"K3 at N={n} B={V.shape[1]}, read while it runs: SM clock, "
          f"power draw {smi}")
    # a partial yardstick, not the same work: cuBLAS SGEMM on a K that
    # K1 has already built (17 GB at N = 65536), at B = 1024
    K = pairwise.expans_bias_gram(Xk[:, :3].contiguous(), SIGMA, BIAS)
    report["gemm_ms"] = time_ms(lambda: K @ V, warmup=1, iters=2)
    print(f"K3 yardstick (partial: K prebuilt by K1, not streamed): cuBLAS "
          f"SGEMM K @ V at N={n} B={V.shape[1]}: {report['gemm_ms']:.4f} "
          f"ms, against K3's {report['ms']:.4f} ms")
    del K
    torch.cuda.empty_cache()
    return report


def phase_k2(device, seed: int):
    """K2 vs its plain version in float64 on the same inputs, held to
    K3's gate per output with the TF32 control that it must reject; two
    passes for equal bits; then CUDA event times beside the bound and K3
    at B = 1 on the same inputs. Returns the report."""
    import torch

    from gp_ss_ak_torch.ops import matvec

    scale = SIGMA * SIGMA + BIAS
    g = torch.Generator(device=device).manual_seed(seed + 2)
    report = {"max_abs_err": 0.0}
    worst_ratio, ctl_ratio = 0.0, float("inf")
    for n, d in ((1000, 3), (1000, 4), (4097, 3), (4097, 5),
                 (N_TRAIN, 3), (N_K2_PATH, 3), (N_ITER_TRAIN, 3)):
        X = 3.0 * torch.rand(n, d, generator=g, device=device) - 1.5
        Xk, scal = matvec.operator_arrays(X, SIGMA)
        v = torch.randn(n, generator=g, device=device)
        y = matvec.streamed_matvec(Xk, scal, BIAS, SN2, v)
        y2 = matvec.streamed_matvec(Xk, scal, BIAS, SN2, v)
        ref = matvec.streamed_matvec_plain(Xk.double(), scal.double(), BIAS,
                                           SN2, v.double())
        err = float((y.double() - ref).abs().max())
        lim = TOL_K3 * scale * float(v.double().abs().sum())
        cerr = float((tf32_control(Xk, scal, v[:, None])[:, 0] - ref)
                     .abs().max())
        same = torch.equal(y, y2)
        print(f"K2 n={n} d={d}: max |kernel-plain64| {err:.3e} = "
              f"{err / lim:.3e} of the limit {TOL_K3}*(s2+bias)*||v||_1; "
              f"TF32 control at {cerr / lim:.3e} of it; two passes "
              f"{'bitwise equal' if same else 'DIFFER'}")
        _check(err <= lim, f"K2 disagrees at n={n} d={d}")
        _check(cerr > lim, f"K2 gate too loose: a TF32 product passes it "
               f"at n={n} d={d}")
        _check(same, f"K2 passes differ at n={n} d={d}")
        report["max_abs_err"] = max(report["max_abs_err"], err)
        worst_ratio = max(worst_ratio, err / lim)
        ctl_ratio = min(ctl_ratio, cerr / lim)
        if d == 3 and n in (N_TRAIN, N_ITER_TRAIN):
            bias_t, sn2_t = (torch.tensor(x, device=device)
                             for x in (BIAS, SN2))
            V = v[:, None].contiguous()
            ms = time_ms(lambda: matvec.streamed_matvec(
                Xk, scal, bias_t, sn2_t, v), warmup=3, iters=20)
            k3_ms = time_ms(lambda: matvec.streamed_matmat(
                Xk, scal, bias_t, sn2_t, V), warmup=2, iters=10)
            plain_ms = time_ms(lambda: matvec.streamed_matvec_plain(
                Xk, scal, bias_t, sn2_t, v), warmup=1, iters=3)
            b_ms, b_by = bound(matvec_work(n, 3), **card_rates())
            print(f"K2 time N={n} d=3 f32: kernel {ms:.4f} ms "
                  f"({n * n / (ms * 1e-3) / 1e9:.1f} Gpairs/s), bound "
                  f"{b_ms:.4f} ms (set by {b_by}, kernel at "
                  f"{b_ms / ms:.3f} of it), K3 at B = 1 {k3_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms")
            report[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, k3_ms=k3_ms)
        del X, Xk, v, y, y2, ref
    print(f"K2: worst error {report['max_abs_err']:.3e}, worst at "
          f"{worst_ratio:.3e} of its limit; the TF32 control at no less "
          f"than {ctl_ratio:.3e} of it")
    report.update(report[N_ITER_TRAIN])
    return report


def phase_golden(device):
    import torch

    from gp_ss_ak_torch.data import (Statistics, apply, read_data,
                                     unapply_var, unapply_y)
    from gp_ss_ak_torch.inference import nlml, predict
    from gp_ss_ak_torch.model import load_model
    from gp_ss_ak_torch.ops import pairwise

    f64 = torch.float64
    model = load_model(os.path.join(GOLDEN, "model"), device=device)
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


def write_case(workdir: str, seed: int, n_train: int, n_test: int,
               skew: bool = False, model=None):
    """Train/test files, statistics and a model file: `model` (a CPU
    GPModel), by default the golden ExpAns+Bias hyperparameters with the
    default noise sn2 = 0.016. `skew` replaces the grade y by exp(0.8 y),
    the skewed regime the warped likelihood exists for."""
    import torch

    from gp_ss_ak_torch.data import MODE_SYMMETRIC, prepare, write_data
    from gp_ss_ak_torch.model import load_model, save_model

    os.makedirs(workdir, exist_ok=True)
    X, y = ore_body(seed, n_train + n_test)
    if skew:
        y = np.exp(0.8 * y)
    train = os.path.join(workdir, "train.txt")
    test = os.path.join(workdir, "test.txt")
    model_path = os.path.join(workdir, "model")
    write_data(train, X[:n_train], y[:n_train])
    write_data(test, X[n_train:], y[n_train:])
    _, _, stats = prepare(X[:n_train], y[:n_train], MODE_SYMMETRIC)
    stats.save(model_path + "_Statistics.txt")
    if model is None:
        model = dataclasses.replace(
            load_model(os.path.join(GOLDEN, "model"), device="cpu"),
            lik_hypers=torch.tensor([SN2], dtype=torch.float64))
    save_model(dataclasses.replace(model, num_data=n_train), model_path)
    return train, test, model_path


def phase_main(train: str, test: str, model_path: str,
               mse_max: float = MSE_MAX):
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
    _check(np.isfinite(mse) and mse < mse_max * var_y,
           f"test MSE {mse} not below {mse_max} * var(y) = "
           f"{mse_max * var_y}")
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
          f"(limit {mse_max}); {yt.shape[0]} predictions, finite, std > 0")
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

    model = load_model(model_path, dtype, device)
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


def phase_dense_train(train: str, workdir: str, lf: str = "Gauss"):
    """`train -# 5 -lf <lf>` through the CLI entry point in float32 from
    the flagship defaults; returns (model path, the fit's evaluation
    count). -logL must decrease (for a warped likelihood: not
    increase), and the training MSE be finite."""
    import torch

    from gp_ss_ak_torch import cli

    warped = lf != "Gauss"
    model_path = os.path.join(workdir,
                              "trained_warped" if warped else "trained")
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["-v", "1", "train", "-#", "5", "-lf", lf, train,
                       model_path])
    wall = time.perf_counter() - t0
    text = out.getvalue()
    print("cli train:", " | ".join(text.strip().splitlines()),
          f"(rc {rc}, {wall:.3f} s wall, file IO included)")
    _check(rc == 0, f"cli train returned {rc}")
    m = re.search(r"-logL: (\S+) -> (\S+) \((\d+) iters, (\d+) evals, "
                  r"stop: (\S+)\)", text)
    _check(m is not None, "cli train printed no -logL line")
    first, last = float(m.group(1)), float(m.group(2))
    _check(np.isfinite(first) and np.isfinite(last)
           and (last <= first if warped else last < first),
           f"-logL did not decrease: {first} -> {last}")
    mse = float(re.search(r"Mean Square Error of training: (\S+)",
                          text).group(1))
    var_y = float(re.search(r"Var MSE Train: (\S+)", text).group(1))
    _check(np.isfinite(mse), f"training MSE {mse}")
    print(f"dense train (-lf {lf}): -logL {first} -> {last}, {m.group(3)} "
          f"iterations, {m.group(4)} evaluations, stop reason {m.group(5)}; "
          f"training MSE {mse:.6g} = {mse / var_y:.4f} var(y); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return model_path, int(m.group(4))


def profile_split(fn, ranges):
    """Run fn() once under torch.profiler (host and CUDA activity).
    Returns (fn's result, its host-clock seconds up to a synchronize,
    {name: (calls, device ms, host ms)} for each name in `ranges`, the
    device time of every kernel, memcpy and memset, the six kernels
    with the most time as [(name, calls, ms)]).

    A name in `ranges` is a profiler range (record_function) or
    "kernel:<text>" for the kernels whose name holds the text. A range's
    device time is that of the device events inside its device-side
    span. The kernels of this repo's CUDA library are not linked to the
    host range that launched them (they bypass torch's launch path), but
    they run inside that span on the one stream; a host event's own
    device total is not used, since it also counts the device-side span
    of a range as one of its kernels. Host ms: the host range's own
    duration."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    annotations = {e.name for e in events
                   if getattr(e, "is_user_annotation", False)}
    annotations |= {k for k in ranges if not k.startswith("kernel:")}
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    work = [(e.time_range.start, e.time_range.end, e.name) for e in dev
            if e.name not in annotations]

    def outermost(e):
        p = e.cpu_parent
        while p is not None:
            if p.name == e.name:
                return False
            p = p.cpu_parent
        return True

    split = {}
    for name in ranges:
        hits = [e for e in host if e.name == name and outermost(e)]
        host_ms = sum(e.cpu_time_total for e in hits) / 1e3
        if name.startswith("kernel:"):
            mine = [t1 - t0 for t0, t1, k in work if name[7:] in k]
            split[name] = (len(mine), sum(mine) / 1e3, 0.0)
        else:
            spans = [(e.time_range.start, e.time_range.end) for e in dev
                     if e.name == name]
            busy = sum(t1 - t0 for t0, t1, _ in work
                       if any(a <= t0 and t1 <= b for a, b in spans))
            split[name] = (len(hits), busy / 1e3, host_ms)
    by_name = {}
    for t0, t1, k in work:
        c, t = by_name.get(k, (0, 0.0))
        by_name[k] = (c + 1, t + (t1 - t0) / 1e3)
    total = sum(t for _, t in by_name.values())
    top = sorted(((k[:60], c, t) for k, (c, t) in by_name.items()),
                 key=lambda r: -r[2])[:6]
    return out, wall, split, total, top


def _split_text(split, labels, wall, total, top):
    parts = ", ".join(f"{labels[k]} {split[k][1]:.4f} ms" for k in labels)
    kern = "; ".join(f"{n} x{c} {t:.3f} ms" for n, c, t in top)
    return (f"{parts}; all device events {total:.4f} ms of "
            f"{wall * 1e3:.4f} ms profiled wall (device busy "
            f"{total / (wall * 1e3):.3f}); most device time: {kern}")


def phase_dense_eval_split(device, train: str, test: str, model_path: str):
    """One real dense NLML + gradient evaluation (make_value_and_grad,
    as the fit calls it) at N_TRAIN in float32: its host-clock time
    alone, then its device time by profiler range and by kernel."""
    import torch

    from gp_ss_ak_torch.optim import make_value_and_grad

    model, _, Xtrs, ytrs, _, _ = _load_case(device, torch.float32, train,
                                            test, model_path)
    vg = make_value_and_grad(model, Xtrs, ytrs)
    x = model.pack().cpu().numpy().astype(np.float64)
    vg(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val, _ = vg(x)
    whole = time.perf_counter() - t0
    labels = {"kernel:gram_kernel": "K1 forward",
              "QuadLogdet.forward": "potrf + solve",
              "QuadLogdet.backward": "QW backward (trsm + GEMM)",
              "FusedExpansBiasA.backward": "K1 backward"}
    _, pwall, split, total, top = profile_split(lambda: vg(x), labels)
    text = _split_text(split, labels, pwall, total, top)
    print(f"dense evaluation at N={Xtrs.shape[0]} f32, torch.profiler "
          f"device time: {text}; one whole value and gradient "
          f"{whole * 1e3:.3f} ms (host clock, unprofiled, -logL "
          f"{val:.6f})")
    torch.cuda.empty_cache()
    return whole * 1e3


def _iterative_gp(model, Xtrs, device):
    import torch

    from gp_ss_ak_torch.inference.iterative import IterativeGP
    from gp_ss_ak_torch.ops import mapped_points

    ep, bp = model.kernel_params
    X = torch.as_tensor(Xtrs, dtype=torch.float32, device=device)
    Xm = mapped_points(model.kernel.children[0], ep, X).contiguous()
    return IterativeGP(Xm, ep["Sigma"], bp["Sigma"], model.lik_hypers[0])


def phase_iter_modes(device, seed: int, train: str, test: str,
                     model_path: str):
    """nlml_and_grad_iterative at N_TRAIN in chol, gemm and stream mode
    with the same probes at tests/test_iterative.py:355-384's cg_tol
    (outside the counted runs). Gated with that test's tolerances: the
    value, stream against gemm (the same SLQ estimator on two
    operators); the sigma and sn2 gradients, stream against gemm and
    against chol (exact solves, the same Hutchinson probes). Not gated:
    chol's value against the others, which differs by the SLQ's probe
    variance (~10 nats at 64 probes here), and the bias gradient (~5), a
    float32 cancellation of terms ~1e8 whose difference between any two
    runs exceeds 1e-2 at N = 16384 at any cg_tol. The Xm gradient is
    held within MODE_XM_REL of its largest entry (PERF.md §6)."""
    import torch

    from gp_ss_ak_torch.inference import iterative as ti

    model, _, Xtrs, ytrs, _, _ = _load_case(device, torch.float32, train,
                                            test, model_path)
    gp = _iterative_gp(model, Xtrs, device)
    y = torch.as_tensor(ytrs, dtype=torch.float32, device=device)
    n = y.shape[0]
    key = torch.Generator(device=device).manual_seed(seed)
    Zt, Zl = ti.rademacher(key, (n, 8)), ti.rademacher(key, (n, 64))
    out = {}
    for mode in ("chol", "gemm", "stream"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val, grads, st = ti.nlml_and_grad_iterative(
            gp, y, None, None, mode=mode, Z_logdet=Zl, Z_trace=Zt,
            cg_tol=MODE_CG_TOL, cg_maxiter=2000)
        torch.cuda.synchronize()
        out[mode] = (float(val), [float(g) for g in grads[:3]], grads[3])
        print(f"mode {mode} at N={n}: value {float(val):.6f}, "
              f"d(sigma, bias, sn2) {out[mode][1]}, {st.cg_iters} CG "
              f"iterations, rel residual {float(st.rel_residual):.2e}, "
              f"{time.perf_counter() - t0:.3f} s")

    def within(a, b, rel, abs_):
        return abs(a - b) <= abs_ + rel * abs(b)

    vg, gg, xg = out["gemm"]
    vs, gs, xs = out["stream"]
    vc, gc, _ = out["chol"]
    dx = float((xs - xg).abs().max() / xg.abs().max())
    print(f"modes: |stream - gemm| value {abs(vs - vg):.3e} (limit "
          f"{MODE_VAL_ABS + MODE_VAL_REL * abs(vg):.3e}), d Xm max diff "
          f"{dx:.2e} of its largest (limit {MODE_XM_REL}); not gated: "
          f"|stream - chol| value {abs(vs - vc):.3e} (the SLQ's probe "
          f"variance), bias gradient |stream - gemm| "
          f"{abs(gs[1] - gg[1]):.3e}, |stream - chol| "
          f"{abs(gs[1] - gc[1]):.3e} (float32 cancellation)")
    _check(within(vs, vg, MODE_VAL_REL, MODE_VAL_ABS),
           "stream and gemm values disagree")
    _check(dx <= MODE_XM_REL, "stream and gemm Xm gradients disagree")
    for ref, name in ((gg, "gemm"), (gc, "chol")):
        for i in (0, 2):
            _check(within(gs[i], ref[i], MODE_GRAD_REL, MODE_GRAD_ABS),
                   f"stream and {name} sigma/sn2 gradients disagree")


def phase_iter_fit(device, train: str, test: str, model_path: str):
    """optim.fit on the matrix-free engine in stream mode, 2 iterations,
    at N_ITER_FIT; returns (the starting model, X, y, K3 launches)."""
    import torch

    from gp_ss_ak_torch.inference import iterative as ti
    from gp_ss_ak_torch.ops import matvec
    from gp_ss_ak_torch.optim import fit

    model, _, Xtrs, ytrs, _, _ = _load_case(device, torch.float32, train,
                                            test, model_path)
    print(f"mode thresholds on this card (chol, gemm max N): "
          f"{ti._mode_thresholds(device)}; CPU defaults "
          f"{ti._mode_thresholds(None)}")
    torch.cuda.reset_peak_memory_stats()
    timing = {}
    before = matvec.launches
    t0 = time.perf_counter()
    fitted, res = fit(model, Xtrs, ytrs, iters=2, engine="iterative",
                      engine_opts={"mode": "stream"}, timing=timing)
    wall = time.perf_counter() - t0
    k3 = matvec.launches - before
    print(f"iterative fit N={Xtrs.shape[0]} (stream): -logL "
          f"{res.trace[0]:.6f} -> {res.fun:.6f}, {res.n_iters} iterations, "
          f"{res.n_evals} evaluations, stop {res.stop_reason}; CG "
          f"(iterations, rel residual) per evaluation {timing['cg']}; "
          f"evaluation s {[round(w, 3) for w in timing['eval_s']]}; wall "
          f"{wall:.3f} s; K3 launches {k3}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _check(all(np.isfinite(v) for v in res.trace) and np.isfinite(res.fun)
           and res.fun <= res.trace[0], "iterative fit: bad -logL")
    _check(bool(np.all(np.isfinite(fitted.pack().cpu().numpy()))),
           "iterative fit: non-finite hyperparameters")
    _check(k3 > 0, "iterative fit launched no K3")
    return model, Xtrs, ytrs, k3


def phase_iter_eval_split(device, seed: int, model, Xtrs, ytrs):
    """One real nlml_and_grad_iterative call (stream mode, the fit's
    defaults, probes drawn from `seed`) at N_ITER_FIT at the fit's
    starting point, under torch.profiler: device and host time by stage
    (outside the counted runs)."""
    import torch

    from gp_ss_ak_torch.inference import iterative as ti

    gp = _iterative_gp(model, Xtrs, device)
    y = torch.as_tensor(ytrs, dtype=torch.float32, device=device)
    n = y.shape[0]
    key = torch.Generator(device=device).manual_seed(seed)
    Zt, Zl = ti.rademacher(key, (n, 8)), ti.rademacher(key, (n, 64))
    labels = {"iterative._pivchol": "pivoted Cholesky",
              "iterative.whitened_solve_info": "whitened CG",
              "iterative.slq_logdet_batched": "SLQ",
              "iterative._grad_contraction": "gradient contraction"}

    def one():
        return ti.nlml_and_grad_iterative(gp, y, None, None, mode="stream",
                                          Z_logdet=Zl, Z_trace=Zt)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    (_, _, st), pwall, split, total, top = profile_split(one, labels)
    host = ", ".join(f"{labels[k]} {split[k][2] / 1e3:.3f} s"
                     for k in labels)
    print(f"iterative evaluation at N={n} (stream): {whole:.3f} s host "
          f"clock unprofiled; under torch.profiler, device time "
          f"{_split_text(split, labels, pwall, total, top)}; host clock "
          f"(profiled) {host}; whitened CG {st.cg_iters} iterations at "
          f"B = 9, rel residual {float(st.rel_residual):.2e}")
    torch.cuda.empty_cache()


def phase_train_default(itrain: str, workdir: str):
    """`train -# 1` through the CLI at N_ITER_TRAIN with the default
    `--engine auto`, the route a user gets there: the iterative engine in
    the mode the card's thresholds pick, then the CLI's training-set
    predict by that mode (chol: the dense mean in 4096-query chunks).
    Under torch.profiler (per-evaluation and predict time); peak device
    memory, held to 8 N^2 bytes + DEFAULT_ROUTE_SLACK_GIB. Returns (the
    evaluation count, the mode)."""
    import torch

    from gp_ss_ak_torch import cli
    from gp_ss_ak_torch.inference import iterative as ti

    mode = ti.choose_mode(N_ITER_TRAIN, "auto", torch.device("cuda", 0))
    model_path = os.path.join(workdir, "trained_default")
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    labels = {"iterative_fit.value_and_grad": "evaluations",
              "kernel:gram_kernel": "K1",
              "iterative._materialized_chol": "A + potrf",
              "iterative._grad_contraction": "contraction",
              "cmd_train.predict": "training-set predict"}
    with contextlib.redirect_stdout(out):
        rc, wall, split, total, top = profile_split(lambda: cli.main(
            ["-v", "1", "train", "-#", "1", itrain, model_path]), labels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    text = out.getvalue()
    print("cli train (default engine):", " | ".join(
        text.strip().splitlines()), f"(rc {rc}, {wall:.3f} s wall "
        f"profiled, file IO included)")
    _check(rc == 0, f"cli train at N={N_ITER_TRAIN} returned {rc}")
    m = re.search(r"-logL: (\S+) -> (\S+) \((\d+) iters, (\d+) evals, "
                  r"stop: (\S+)\)", text)
    _check(m is not None, "cli train printed no -logL line")
    first, last, evals = float(m.group(1)), float(m.group(2)), \
        int(m.group(4))
    mse = float(re.search(r"Mean Square Error of training: (\S+)",
                          text).group(1))
    var_y = float(re.search(r"Var MSE Train: (\S+)", text).group(1))
    calls, dev, host = split["iterative_fit.value_and_grad"]
    print(f"default train route at N={N_ITER_TRAIN} (auto engine, mode "
          f"{mode}): -logL {first} -> {last}, {evals} evaluations, stop "
          f"{m.group(5)}; per evaluation {host / max(calls, 1):.1f} ms host "
          f"clock (profiled), {dev / max(calls, 1):.1f} ms device; "
          f"training-set predict {split['cmd_train.predict'][1]:.1f} ms "
          f"device; training MSE {mse:.6g} = {mse / var_y:.4f} var(y); "
          f"peak device memory {peak:.3f} GiB")
    print(f"default train route, device time: "
          f"{_split_text(split, labels, wall, total, top)}")
    limit = 8.0 * N_ITER_TRAIN ** 2 / 2**30 + DEFAULT_ROUTE_SLACK_GIB
    print(f"default train route: peak device memory {peak:.3f} GiB (limit "
          f"8 N^2 bytes + {DEFAULT_ROUTE_SLACK_GIB} GiB = {limit:.3f} GiB); "
          f"training-set predict {split['cmd_train.predict'][2] / 1e3:.3f} s "
          f"host clock (profiled)")
    _check(peak <= limit, f"default train route peaked at {peak:.3f} GiB")
    _check(np.isfinite(first) and np.isfinite(last) and last <= first,
           f"default train route: -logL {first} -> {last}")
    _check(np.isfinite(mse) and mse < MSE_MAX * var_y,
           f"training MSE {mse} not below {MSE_MAX} * var(y)")
    return evals, mode


def phase_k2_path(device, seed: int, train: str, test: str,
                  model_path: str):
    """nlml_iterative without a preconditioner in stream mode, the path
    that runs K2, at N_K2_PATH; returns its K2 launches."""
    import torch

    from gp_ss_ak_torch.inference import iterative as ti
    from gp_ss_ak_torch.ops import matvec
    from gp_ss_ak_torch.ops.matvec import MatvecOperator

    model, _, Xtrs, ytrs, _, _ = _load_case(device, torch.float32, train,
                                            test, model_path)
    Xtrs, ytrs = Xtrs[:N_K2_PATH], ytrs[:N_K2_PATH]
    gp = _iterative_gp(model, Xtrs, device)
    y = torch.as_tensor(ytrs, dtype=torch.float32, device=device)
    key = torch.Generator(device=device).manual_seed(seed)
    cg_tol, cg_maxiter = 1e-4, 800
    matvec.matvec_launches = matvec.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val, alpha, it = ti.nlml_iterative(gp, y, key, cg_tol=cg_tol,
                                       cg_maxiter=cg_maxiter,
                                       precond_rank=0, mode="stream")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, k3 = matvec.matvec_launches, matvec.launches
    op = MatvecOperator(gp.Xm, gp.sigma, gp.bias, gp.sn2)
    ny = torch.linalg.vector_norm(y)
    k2_alpha, k3_alpha = op(alpha), op.matmat(alpha[:, None])[:, 0]
    res2 = float(torch.linalg.vector_norm(k2_alpha - y) / ny)
    res3 = float(torch.linalg.vector_norm(k3_alpha - y) / ny)
    gap = float(torch.linalg.vector_norm(k3_alpha - k2_alpha) / ny)
    exact, _, _ = ti.nlml_iterative(gp, y, None, mode="chol")
    print(f"K2 path N={N_K2_PATH}: nlml_iterative(precond_rank=0, stream) "
          f"{float(val):.6f} in {wall:.3f} s; CG {it} iterations "
          f"({'hit cg_maxiter' if it >= cg_maxiter else 'converged'}), "
          f"K2 launches {k2}, K3 launches {k3} (SLQ); ||A alpha - y|| / "
          f"||y|| through K3 {res3:.3e} (limit {K2_PATH_RES} cg_tol), "
          f"through K2 (CG's operator) {res2:.3e}, cg_tol {cg_tol}; the two operators differ on alpha "
          f"by {gap:.3e} ||y|| (||alpha|| / ||y|| = "
          f"{float(torch.linalg.vector_norm(alpha) / ny):.1f}); chol "
          f"mode's exact value {float(exact):.6f} (the raw-A SLQ is biased "
          f"at sn2 = {SN2}, not gated)")
    _check(k2 == it + 1, f"expected {it + 1} K2 launches, saw {k2}")
    _check(np.isfinite(float(val)), "K2 path: non-finite value")
    if it < cg_maxiter:
        # plain float32 CG stops on its updated residual, which drifts
        # from the true one over hundreds of unpreconditioned iterations:
        # on an H100 the true residual through K2 itself read 1.56 cg_tol
        # at 412 iterations, 1.61 through K3 (their disagreement on alpha
        # adds 0.49 cg_tol). The gate sits ~2.5x above those readings.
        _check(res3 <= K2_PATH_RES * cg_tol, f"K2 path: CG converged but "
               f"the residual through K3 is above {K2_PATH_RES} cg_tol")
    return k2


def _load_case(device, dtype, train: str, test: str, model_path: str):
    from gp_ss_ak_torch.data import Statistics, apply, read_data
    from gp_ss_ak_torch.model import load_model

    model = load_model(model_path, dtype, device)
    stats = Statistics.load(model_path + "_Statistics.txt")
    Xtr, ytr = read_data(train)
    Xt, yt = read_data(test)
    Xtrs, ytrs = apply(stats, Xtr, ytr)
    return model, stats, Xtrs, ytrs, apply(stats, Xt), yt


def phase_iter_vs_dense(device, train: str, test: str, model_path: str,
                        label: str = ""):
    """IterativePredictor (float32) vs the dense Predictor in float64 on
    the same 512 queries of the N = 16384 case (a warped model's means
    and variances after the warp mix)."""
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
    print(f"{label}iterative vs dense f64 (N={Xtrs.shape[0]}, 512 queries, rank "
          f"{it.precond_rank}): max |mu diff| {err_mu:.3e} (tol "
          f"{tol_mu:.3e}), max var rel diff {rel_var:.3e} (tol "
          f"{ITER_VAR_RTOL}); setup {setup_s:.3f} s, setup_cg_iters "
          f"{it.setup_cg_iters}, last_cg_iters {it.last_cg_iters}")
    _check(bool(np.all(np.isfinite(mu_i)) and np.all(var_i > 0)),
           f"{label}iterative: non-finite mean or var <= 0")
    _check(err_mu <= tol_mu, f"{label}iterative means disagree with dense "
           f"f64")
    _check(rel_var <= ITER_VAR_RTOL,
           f"{label}iterative variances disagree with dense f64")


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
    return server, ytrs, med


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


def phase_warped_eval(device, train: str, test: str, model_path: str):
    """Outside the counted runs, host clock up to a synchronize: one
    warped dense NLML + gradient evaluation (make_value_and_grad, as the
    fit calls it) at N_TRAIN in float32, and the warp mix
    (gaussian.warped_predictive_mix) of one batch of TRAIN_PREDICT_CHUNK
    latent Gaussians: means g(y) at that many training targets, variance
    1.05 sn2. Returns (evaluation ms, mix ms)."""
    import torch

    from gp_ss_ak_torch.cli import TRAIN_PREDICT_CHUNK
    from gp_ss_ak_torch.inference import (quadrature, warped_predictive_mix,
                                          warping)
    from gp_ss_ak_torch.optim import make_value_and_grad

    model, _, Xtrs, ytrs, _, _ = _load_case(device, torch.float32, train,
                                            test, model_path)
    vg = make_value_and_grad(model, Xtrs, ytrs)
    x = model.pack().cpu().numpy().astype(np.float64)
    vg(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        val, _ = vg(x)
    eval_ms = (time.perf_counter() - t0) / 3 * 1e3
    lik, lh = model.likelihood, model.lik_hypers
    yall = torch.as_tensor(ytrs, dtype=torch.float32, device=device)
    ymax = torch.max(yall)
    mu, _ = lik.effective_target(lh, yall[:TRAIN_PREDICT_CHUNK], ymax)
    var = 1.05 * lik.noise_variance(lh) * torch.ones_like(mu)

    def mix():
        return warped_predictive_mix(lik, lh, mu, var, ymax)

    mix()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        mu_w, var_w = mix()
    torch.cuda.synchronize()
    mix_ms = (time.perf_counter() - t0) / 5 * 1e3
    nodes = torch.as_tensor(quadrature.gauss_hermite(20)[0],
                            dtype=torch.float32, device=device)
    Z = mu[:, None] + torch.sqrt(var)[:, None] * nodes[None, :]
    _, _, n_low, n_up = warping.bracket(lik.family, lik.warp_hypers(lh), Z,
                                        ymax)
    _check(bool(torch.isfinite(mu_w).all() and (var_w > 0).all()),
           "warp mix: non-finite mean or var <= 0")
    print(f"warped dense evaluation at N={Xtrs.shape[0]} f32 ({WARP_LF}): "
          f"{eval_ms:.3f} ms per value and gradient (host clock, "
          f"-logL {val:.6f}); warp mix of {mu.shape[0]} latent Gaussians "
          f"x 20 nodes: {mix_ms:.3f} ms ({n_low} + {n_up} bracketing "
          f"steps, 12 bisection and 12 Newton rounds)")
    return eval_ms, mix_ms


def phase_warped_iter_serve(device, train: str, test: str, model_path: str,
                            k3_ms: float, plain_s=None):
    """One warped IterativePredictor at N_ITER_TRAIN, then
    WARP_ITER_REQUESTS requests of ITER_REQUEST_SIZE queries (each pays
    its variance solve and the warp mix). k3_ms: K3's time for one pass
    at the request's width; plain_s: this run's plain Gaussian request
    median, if measured."""
    import torch

    from gp_ss_ak_torch.serve import IterativePredictor

    model, _, Xtrs, ytrs, Xts, _ = _load_case(device, torch.float32, train,
                                              test, model_path)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = IterativePredictor(model, Xtrs, ytrs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _check(server.warped, "the warped model was served as a Gaussian")
    size = ITER_REQUEST_SIZE
    lat, iters = [], []
    for k in range(WARP_ITER_REQUESTS):
        q = Xts[k * size:(k + 1) * size]
        t0 = time.perf_counter()
        mu, var = server(q, batch_size=size)   # host arrays: work done
        lat.append(time.perf_counter() - t0)
        iters.append(server.last_cg_iters)
        _check(bool(np.all(np.isfinite(mu)) and np.all(var > 0)),
               f"warped iterative request {k}: non-finite mean or var <= 0")
    med = float(np.median(lat))
    plain = "not measured" if plain_s is None else f"{plain_s:.4f} s"
    print(f"warped iterative serve (N={Xtrs.shape[0]}, {WARP_LF}): setup "
          f"{setup_s:.4f} s (rank {server.precond_rank}, setup_cg_iters "
          f"{server.setup_cg_iters}); {WARP_ITER_REQUESTS} requests x "
          f"{size}: {[round(t, 4) for t in lat]} s, CG iterations {iters}; "
          f"K3 share of the median ~ {iters[0]} passes x {k3_ms:.3f} ms / "
          f"{med * 1e3:.3f} ms = {iters[0] * k3_ms / (med * 1e3):.3f}; the "
          f"plain Gaussian's median request in this run {plain}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB")


def phase_warped_identity_eval(device, seed: int, train: str, test: str,
                               model_path: str):
    """One stream-mode make_iterative_value_and_grad evaluation at
    N_ITER_TRAIN of the Gaussian model with an identity-like warp
    (a = exp(-12), exp(2 theta) = SN2) against the plain Gaussian's with
    the same probes: the value within MODE_VAL_*, the kernel's gradient
    entries within MODE_GRAD_*, all but the bias's: its float32
    cancellation spreads by more than MODE_GRAD_ABS between any two
    runs on other targets (phase_iter_modes does not gate it either;
    0.29 of 51.7 on an H100 here, where float64 moves it by ~3e-4).
    And against the plain model run on the warped targets g(y) with the
    same noise: the kernel's entries equal bit for bit, the value less
    sum log g'(y), so the warp's chain rule adds nothing to the kernel's
    gradient."""
    import torch

    from gp_ss_ak_torch.inference import WarpedGaussian
    from gp_ss_ak_torch.inference import iterative as ti
    from gp_ss_ak_torch.optim import make_iterative_value_and_grad

    f32 = torch.float32
    model, _, Xtrs, ytrs, _, _ = _load_case(device, f32, train, test,
                                            model_path)
    n, nk = ytrs.shape[0], model.kernel.n_params
    key = torch.Generator(device=device).manual_seed(seed)
    probes = dict(Z_trace=ti.rademacher(key, (n, 8)),
                  Z_logdet=ti.rademacher(key, (n, 64)))
    wlik = WarpedGaussian("tanh1", 1)
    wmodel = dataclasses.replace(model, likelihood=wlik, lik_hypers=(
        torch.tensor([-12.0, 0.0, 0.0, 0.5 * np.log(SN2)], dtype=f32,
                     device=device)))
    gy, lgpy = wlik.effective_target(
        wmodel.lik_hypers, torch.as_tensor(ytrs, dtype=f32, device=device))
    on_gy = dataclasses.replace(
        model, lik_hypers=wlik.noise_variance(wmodel.lik_hypers)[None])
    out = {}
    for name, m, y in (("plain", model, ytrs), ("warped", wmodel, ytrs),
                       ("plain on g(y)", on_gy, gy.cpu().numpy())):
        vg = make_iterative_value_and_grad(m, Xtrs, y, mode="stream",
                                           **probes)
        x = m.pack().cpu().numpy().astype(np.float64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val, grad = vg(x)
        out[name] = (val, grad, vg.last_cg_iters,
                     time.perf_counter() - t0)
        print(f"identity-like warp, {name} at N={n} (stream): value "
              f"{val:.6f}, kernel gradient {np.round(grad[:nk], 6).tolist()}"
              f", likelihood gradient {np.round(grad[nk:], 6).tolist()}, "
              f"{out[name][2]} CG iterations, {out[name][3]:.3f} s")

    def within(a, b, rel, abs_):
        return abs(a - b) <= abs_ + rel * abs(b)

    (vp, gp, _, _), (vw, gw, _, _), (vg_, gg, _, _) = out.values()
    sum_lgpy = float(torch.sum(lgpy))
    share = np.abs(gw[:nk] - gp[:nk]) / (MODE_GRAD_ABS
                                          + MODE_GRAD_REL * np.abs(gp[:nk]))
    print(f"identity-like warp: |warped - plain| value {abs(vw - vp):.3e} "
          f"(limit {MODE_VAL_ABS + MODE_VAL_REL * abs(vp):.3e}), kernel "
          f"gradient {np.abs(gw[:nk] - gp[:nk]).tolist()}, each at "
          f"{np.round(share, 3).tolist()} of its limit (the bias's, last, "
          f"not gated); sum log g'(y) {sum_lgpy:.6f}; warped vs plain on "
          f"g(y): kernel gradient equal {np.array_equal(gw[:nk], gg[:nk])}, "
          f"value gap {vg_ - vw:.6f}")
    _check(within(vw, vp, MODE_VAL_REL, MODE_VAL_ABS),
           "identity-like warp: value disagrees with the plain Gaussian's")
    for i in range(nk - 1):
        _check(within(gw[i], gp[i], MODE_GRAD_REL, MODE_GRAD_ABS),
               f"identity-like warp: kernel gradient entry {i} disagrees "
               f"with the plain Gaussian's")
    _check(np.array_equal(gw[:nk], gg[:nk]), "the warped kernel gradient "
           "differs from the plain one on g(y)")
    _check(within(vw, vg_ - sum_lgpy, 1e-6, 0.0), "the warped value is not "
           "the plain one on g(y) less sum log g'(y)")
    _check(bool(np.all(np.isfinite(gw[nk:]))), "non-finite warp gradient")
    torch.cuda.empty_cache()


def phase_k1_batched(device, seed: int, cases=None, time_shape=True):
    """K1's batched entry against its batched plain version in float64
    at ragged B, n and m (square with its diagonal and cross), float64
    and float32, and at the batched paths' own shapes in float32, every
    member with its own scalars; each member's output bit for bit
    against a 2-D launch on that member; its time at K1_BATCH_TIME in
    float32 beside its bound, and that timed output checked the same
    way. Returns the report."""
    import torch

    from gp_ss_ak_torch.ops import pairwise

    if cases is None:
        # ragged shapes, then those of the batched paths: the ensemble's
        # A and cross-Gram (ENS_B x ENS_N, ENS_Q queries) and the
        # sampler's A (NUTS_CHAINS x NUTS_N)
        cases = [(1, 1, None, 3), (3, 37, None, 3), (5, 130, 129, 4),
                 (2, 1000, 333, 3), (7, 65, None, 5), (300, 17, 9, 3),
                 (ENS_B, ENS_N, None, 3), (ENS_B, ENS_N, ENS_Q, 3),
                 (NUTS_CHAINS, NUTS_N, None, 3)]
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=device,
                          dtype=torch.float64)

    worst = 0.0
    for B, n, m, d in cases:
        X = 3.0 * rand(B, n, d) - 1.5
        Y = None if m is None else 3.0 * rand(B, m, d) - 1.5
        sig, bia = 0.3 + rand(B), 0.05 + 0.3 * rand(B)
        sn2 = 0.01 + 0.05 * rand(B) if m is None else None
        scale = (sig * sig + bia)[:, None, None]
        tag = f"B={B} n={n} m={n if m is None else m} d={d} " \
              f"{'diag' if m is None else 'cross'}"
        types = ((torch.float64, TOL_F64), (torch.float32, TOL_F32))
        if B * n * (n if m is None else m) > 2 ** 24:
            types = types[1:]   # a batched path's shape, in its type
        for dtype, tol in types:
            Xd = X.to(dtype)
            Yd = None if Y is None else Y.to(dtype)
            args = [t.to(dtype) for t in (sig, bia)] + [
                None if sn2 is None else sn2.to(dtype)]
            K = pairwise.expans_bias_gram(Xd, *args, Yd)
            ref = pairwise.expans_bias_gram_plain(
                Xd.double(), sig.to(dtype).double(), bia.to(dtype).double(),
                None if sn2 is None else sn2.to(dtype).double(),
                None if Yd is None else Yd.double())
            err = float(((K.double() - ref).abs() / scale).max())
            same = all(torch.equal(K[b], pairwise.expans_bias_gram(
                Xd[b], *(None if a is None else a[b] for a in args),
                None if Yd is None else Yd[b])) for b in range(B))
            print(f"K1 batched {tag} {str(dtype).split('.')[-1]}: "
                  f"|kernel-plain64| / (s2+bias) {err:.3e} (tol {tol:.0e}); "
                  f"each member's bits equal a 2-D launch: {same}")
            _check(err <= tol, f"K1 batched disagrees at {tag} {dtype}")
            _check(same, f"K1 batched: a member's bits differ from a 2-D "
                   f"launch at {tag} {dtype}")
            if dtype == torch.float32:
                worst = max(worst, err * float(scale.max()))
            del K, ref
        torch.cuda.empty_cache()
    report = {"max_abs_err": worst}
    if not time_shape:
        return report
    B, n = K1_BATCH_TIME
    X = (3.0 * rand(B, n, 3) - 1.5).float()
    sig, bia, sn2 = ((0.3 + rand(B)).float(), (0.05 + 0.3 * rand(B)).float(),
                     (0.01 + 0.05 * rand(B)).float())
    ms = time_ms(lambda: pairwise.expans_bias_gram(X, sig, bia, sn2))
    plain_ms = time_ms(lambda: pairwise.expans_bias_gram_plain(
        X, sig, bia, sn2), warmup=2, iters=10)
    nbytes, fp32, sfu, tensor = gram_work(n, n, 3)
    b_ms, b_by = bound((B * nbytes, B * fp32, B * sfu, B * tensor),
                       **card_rates())
    print(f"K1 batched time B={B} x {n}^2 diag f32: kernel {ms:.4f} ms "
          f"({B * n * n * 4 / (ms * 1e-3) / 1e9:.0f} GB/s of output), plain "
          f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms (set by {b_by}); kernel "
          f"at {b_ms / ms:.3f} of it")
    # the timed launch's output against the plain version in float64, and
    # a few members bit for bit against 2-D launches
    K = pairwise.expans_bias_gram(X, sig, bia, sn2)
    ref = pairwise.expans_bias_gram_plain(X.double(), sig.double(),
                                          bia.double(), sn2.double())
    scale = (sig.double() ** 2 + bia.double())[:, None, None]
    err = float(((K.double() - ref).abs() / scale).max())
    del ref
    members = (0, B // 2, B - 1)
    same = all(torch.equal(K[b], pairwise.expans_bias_gram(
        X[b], sig[b], bia[b], sn2[b])) for b in members)
    print(f"K1 batched timed output: |kernel-plain64| / (s2+bias) "
          f"{err:.3e} (tol {TOL_F32:.0e}); members {members} equal 2-D "
          f"launches bit for bit: {same}")
    _check(err <= TOL_F32, "K1 batched: the timed output disagrees with "
           "its plain version")
    _check(same, "K1 batched: a timed member's bits differ from a 2-D launch")
    report.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                  max_abs_err=max(worst, err * float(scale.max())))
    del K
    torch.cuda.empty_cache()
    return report


def deposits(seed: int, B: int, n: int, q: int):
    """B synthetic deposits, each an ore body from the seed and its own
    index, standardized as the CLI does (MODE_SYMMETRIC on its own n
    training composites): (X (B, n, 3), y (B, n), X* (B, q, 3),
    y* (B, q)) in standardized units."""
    from gp_ss_ak_torch.data import MODE_SYMMETRIC, apply, prepare

    out = [[], [], [], []]
    for b in range(B):
        X, y = ore_body(seed * 100003 + b + 1, n + q)
        Xs, ys, stats = prepare(X[:n], y[:n], MODE_SYMMETRIC)
        Xq, yq = apply(stats, X[n:], y[n:])
        for lst, a in zip(out, (Xs, ys, Xq, yq)):
            lst.append(a)
    return tuple(np.stack(a) for a in out)


def phase_ensemble(device, seed: int, counts, B=ENS_B, n=ENS_N, q=ENS_Q,
                   iters=ENS_ITERS, single=ENS_SINGLE):
    """Counted: `fit_ensemble` of B deposits, then `predict_ensemble`;
    then, outside the count, the start values, four deposits fitted
    alone through fit(optimizer="JIT"), one batched evaluation's time
    and its profiled split. Returns the (2-D, batched) K1 launches of
    the counted run."""
    import torch

    from gp_ss_ak_torch.ensemble import fit_ensemble, predict_ensemble
    from gp_ss_ak_torch.kernels.distance import highest_precision
    from gp_ss_ak_torch.model import default_model
    from gp_ss_ak_torch.ops import cholesky, maybe_fused_A
    from gp_ss_ak_torch.optim import fit
    from gp_ss_ak_torch.optim.api import (batched_nlml_fn,
                                          batched_value_and_grad,
                                          unpack_batched)

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    Xb, yb, Xq, yq = deposits(seed, B, n, q)
    model = default_model(3, dtype=torch.float32, device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = counts()
    t0 = time.perf_counter()
    res = fit_ensemble(model, Xb, yb, maxiter=iters)
    sync()
    wall = time.perf_counter() - t0
    fit_k1 = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    t0 = time.perf_counter()
    mu, var = predict_ensemble(model, res, Xb, yb, Xq)
    sync()
    pwall = time.perf_counter() - t0
    after = counts()
    fit_launches = (fit_k1[0] - before[0], fit_k1[1] - before[1])
    pred_launches = (after[0] - fit_k1[0], after[1] - fit_k1[1])
    print(f"ensemble fit: {B} deposits x {n} composites, d=3, f32, "
          f"maxiter {iters}: {wall:.3f} s wall, {res.n_evals} batched "
          f"evaluations ({wall / res.n_evals * 1e3:.3f} ms each on average), "
          f"iterations {int(res.n_iters.min())}-{int(res.n_iters.max())}, "
          f"{int(res.converged.sum())} converged; peak device memory "
          f"{peak:.3f} GiB; K1 launches (2-D, batched) {fit_launches}")
    if cuda:
        _check(fit_launches == (0, res.n_evals),
               f"ensemble fit: expected {res.n_evals} batched K1 launches "
               f"(one per batched evaluation) and no 2-D one, saw "
               f"{fit_launches}")
        _check(pred_launches == (0, 2), f"predict_ensemble: expected 2 "
               f"batched K1 launches (A, cross), saw {pred_launches}")

    # outside the count: the start, the single fits, the split
    dtype = torch.float32
    Xt = torch.as_tensor(Xb, dtype=dtype, device=device)
    yt = torch.as_tensor(yb, dtype=dtype, device=device)
    f = batched_nlml_fn(model)
    x0 = model.pack().detach().expand(B, -1)
    with torch.no_grad():
        start = f(x0, Xt, yt)
    fun = res.fun
    _check(bool(torch.all(torch.isfinite(fun))), "ensemble: non-finite NLML")
    _check(bool(torch.all(fun < start)),
           f"ensemble: {int((fun >= start).sum())} deposits did not end "
           f"below their start")
    print(f"ensemble: NLML per deposit {float(start.mean()):.4f} -> "
          f"{float(fun.mean()):.4f} on average; every deposit below its start")
    mse = ((mu.cpu().numpy() - yq) ** 2).mean(axis=1)
    var_y = yq.var(axis=1)
    ratio = mse / var_y
    print(f"predict_ensemble: {B} x {q} queries in {pwall:.4f} s "
          f"({B * q / pwall:.0f} predictions/s); MSE / var(y) per deposit "
          f"{ratio.min():.4f}-{ratio.max():.4f} (limit {MSE_MAX}); K1 "
          f"launches (2-D, batched) {pred_launches}")
    _check(bool(np.all(np.isfinite(mse)) and np.all(ratio < MSE_MAX)),
           "predict_ensemble: a deposit's MSE is not below 0.2 var(y)")
    _check(bool(torch.all(var > 0)), "predict_ensemble: variance <= 0")
    # a deposit alone against the batch. In float32 the two differ by the
    # round-off of the library calls, which pick other kernels for one
    # matrix than for a batch. The first evaluation of the timed float32
    # batch is gated against each deposit alone; the fits after `iters`
    # iterations, a path that this round-off steers, are gated in float64
    # (the first `single` deposits in a batch of their own against each
    # alone) and printed in float32
    vg = batched_value_and_grad(f, Xt, yt)
    vB, gB = vg(x0)
    for b in range(single):
        v1, g1 = batched_value_and_grad(f, Xt[b:b + 1], yt[b:b + 1])(
            x0[b:b + 1])
        dv = float(abs(v1[0] - vB[b]) / max(abs(float(vB[b])), n))
        dg = float((g1[0] - gB[b]).abs().max() / gB[b].abs().max())
        print(f"deposit {b}, first evaluation in float32, alone vs in the "
              f"batch of {B}: value {float(vB[b]):.6f}, |diff| / max(|v|, n) "
              f"{dv:.2e}; gradient max |diff| / max |g| {dg:.2e} (tol "
              f"{ENS_FIRST_RTOL:.0e} each)")
        _check(dv <= ENS_FIRST_RTOL and dg <= ENS_FIRST_RTOL,
               f"deposit {b}: its first evaluation alone and in the batch "
               f"of {B} disagree")
    m64 = default_model(3, dtype=torch.float64, device=device)
    sub = fit_ensemble(m64, Xb[:single], yb[:single], maxiter=iters)
    for b in range(single):
        _, one32 = fit(model, Xb[b], yb[b], optimizer="JIT", iters=iters,
                       engine="dense")
        _, one = fit(m64, Xb[b], yb[b], optimizer="JIT", iters=iters,
                     engine="dense")
        rel = abs(one.fun / float(sub.fun[b]) - 1.0)
        rel32 = abs(one32.fun / float(fun[b]) - 1.0)
        print(f"deposit {b} alone (fit optimizer=JIT): float64 fun "
              f"{one.fun:.8f} vs {float(sub.fun[b]):.8f} in a batch of "
              f"{single} (rel {rel:.2e}, tol {ENS_SINGLE_RTOL:.0e}; "
              f"{one.n_iters} iterations vs {int(sub.n_iters[b])}); float32 "
              f"fun {one32.fun:.6f} vs {float(fun[b]):.6f} in the batch of "
              f"{B} (rel {rel32:.2e}; {one32.n_iters} iterations vs "
              f"{int(res.n_iters[b])})")
        _check(rel <= ENS_SINGLE_RTOL and one.n_iters == int(sub.n_iters[b]),
               f"deposit {b}: alone and in the batch disagree")
    if not cuda:
        return fit_launches, pred_launches
    walls = []
    for _ in range(6):
        sync()
        t0 = time.perf_counter()
        vg(x0)
        sync()
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls[1:]))
    kp, lh = unpack_batched(model, x0)
    with highest_precision():
        A = maybe_fused_A(model.kernel, kp, lh[0], Xt)
        potrf_ms = time_ms(lambda: cholesky(A), warmup=1, iters=5)
    del A
    labels = {"kernel:gram_kernel": "K1 forward",
              "QuadLogdet.forward": "potrf + solve",
              "QuadLogdet.backward": "QW adjoint (trsm + GEMM)",
              "FusedExpansBiasA.backward": "K1 backward"}
    _, pw, split, total, top = profile_split(lambda: vg(x0), labels)
    print(f"ensemble batched evaluation ({B} x {n}, f32): median "
          f"{med * 1e3:.3f} ms (host clock); batched potrf alone "
          f"{potrf_ms:.4f} ms ({potrf_ms / (med * 1e3):.3f} of an "
          f"evaluation); torch.profiler device time: "
          f"{_split_text(split, labels, pw, total, top)}")
    torch.cuda.empty_cache()
    return fit_launches, pred_launches


def phase_train_jit(train: str, test: str, workdir: str, counts,
                    iters=JIT_ITERS, n_train=N_TRAIN):
    """Counted: `train -o JIT -# iters` through the CLI entry point on
    the dense case, then `test` on the trained model. Returns the K1
    launches (2-D, batched)."""
    import torch

    from gp_ss_ak_torch import cli
    from gp_ss_ak_torch.data import MODE_SYMMETRIC, prepare, read_data
    from gp_ss_ak_torch.model import default_model
    from gp_ss_ak_torch.optim import batched_lbfgs, flat_nlml_fn

    model_path = os.path.join(workdir, "trained_jit")
    seen = []
    minimize = batched_lbfgs.minimize

    def spy(*a, **k):       # the fit's own evaluation count
        out = minimize(*a, **k)
        seen.append(out.n_evals)
        return out

    before = counts()
    out = io.StringIO()
    batched_lbfgs.minimize = spy
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["-v", "1", "train", "-o", "JIT", "-#", str(iters),
                           train, model_path])
    finally:
        batched_lbfgs.minimize = minimize
    wall = time.perf_counter() - t0
    text = out.getvalue()
    print("cli train -o JIT:", " | ".join(text.strip().splitlines()),
          f"(rc {rc}, {wall:.3f} s wall, file IO included)")
    _check(rc == 0, f"cli train -o JIT returned {rc}")
    trained = counts()
    phase_main(train, test, model_path)
    after = counts()
    m = re.search(r"-logL: (\S+) -> (\S+) \((\d+) iters, (\S+) evals, "
                  r"stop: (\S+)\)", text)
    _check(m is not None and len(seen) == 1, "cli train -o JIT printed no "
           "-logL line or ran no batched L-BFGS")
    last = float(m.group(2))
    n_evals = seen[0]
    fit_k1 = (trained[0] - before[0], trained[1] - before[1])
    test_k1 = (after[0] - trained[0], after[1] - trained[1])
    # the start, outside the count
    X, y = read_data(train)
    Xs, ys, _ = prepare(X, y, MODE_SYMMETRIC)
    start_model = default_model(3, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        first = float(flat_nlml_fn(start_model)(
            start_model.pack(), *(torch.as_tensor(a, dtype=torch.float32,
                                                  device="cuda")
                                  for a in (Xs, ys))))
    print(f"train -o JIT at N={n_train}: -logL {first} -> {last}, "
          f"{m.group(3)} iterations, {n_evals} batched evaluations (B = 1), "
          f"stop reason {m.group(5)}; K1 launches (2-D, batched): fit and "
          f"training-set predict {fit_k1}, test {test_k1}")
    _check(np.isfinite(first) and np.isfinite(last) and last < first,
           f"train -o JIT: -logL did not decrease: {first} -> {last}")
    want = (predict_k1(n_train), n_evals)
    _check(fit_k1 == want and test_k1 == (2, 0),
           f"train -o JIT + test: expected {want} K1 launches (2-D for the "
           f"training-set predict, batched one per evaluation) and (2, 0) "
           f"for test; saw {fit_k1} and {test_k1}")
    return fit_k1[0] + test_k1[0], fit_k1[1]


def phase_nuts(device, seed: int, counts, chains=NUTS_CHAINS, n=NUTS_N,
               warmup=NUTS_WARMUP, samples=NUTS_SAMPLES, thin=NUTS_THIN):
    """Counted: `sample_hyperposterior` (NUTS) on n points of the ore
    body, float32, then `predictive_mixture` over every thin-th sample.
    Returns the K1 launches (2-D, batched)."""
    import torch

    from gp_ss_ak_torch.bayes import (predictive_mixture,
                                      sample_hyperposterior, summarize)
    from gp_ss_ak_torch.data import MODE_SYMMETRIC, apply, prepare
    from gp_ss_ak_torch.model import default_model
    from gp_ss_ak_torch.optim import DEFAULT_LOWER, DEFAULT_UPPER
    from gp_ss_ak_torch.optim.api import batched_nlml_fn

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    X, y = ore_body(seed + 7, n + 512)
    Xs, ys, stats_ = prepare(X[:n], y[:n], MODE_SYMMETRIC)
    Xq, yq = apply(stats_, X[n:], y[n:])
    model = default_model(3, dtype=torch.float32, device=device)
    st = {}
    before = counts()
    t0 = time.perf_counter()
    theta, aps = sample_hyperposterior(
        model, Xs, ys, seed, n_samples=samples, n_warmup=warmup,
        n_chains=chains, sampler="nuts", stats=st)
    sync()
    wall = time.perf_counter() - t0
    sampled = counts()
    t0 = time.perf_counter()
    mu, var = predictive_mixture(model, Xs, ys, Xq, theta, thin=thin)
    sync()
    mwall = time.perf_counter() - t0
    after = counts()
    samp_k1 = (sampled[0] - before[0], sampled[1] - before[1])
    mix_k1 = (after[0] - sampled[0], after[1] - sampled[1])
    th = theta.cpu().double().numpy()
    leaves = st["leaves"].cpu().numpy()
    diag = summarize(th)
    print(f"NUTS: {chains} chains on N={n} f32, {warmup} warmup + {samples} "
          f"samples, max_depth 8: {wall:.3f} s wall, {st['evals']} "
          f"batched evaluations ({wall / st['evals'] * 1e3:.3f} ms each on "
          f"average), leapfrog leaves per transition mean "
          f"{leaves.mean():.2f} (warmup {leaves[:, :warmup].mean():.2f}, "
          f"sampling {leaves[:, warmup:].mean():.2f}, max "
          f"{leaves.max():.0f}), mean accept statistic "
          f"{float(aps.mean()):.4f}; K1 launches (2-D, batched) {samp_k1}")
    print(f"NUTS diagnostics (printed, not gated): split R-hat "
          f"{np.array2string(diag['rhat'], precision=3)}, bulk ESS "
          f"{np.array2string(diag['ess'], precision=1)}, tail ESS "
          f"{np.array2string(diag['ess_tail'], precision=1)}")
    _check(bool(np.all(np.isfinite(th))), "NUTS: a sample is not finite")
    _check(bool(th.min() >= DEFAULT_LOWER * (1 - 1e-6)
                and th.max() <= DEFAULT_UPPER * (1 + 1e-6)),
           f"NUTS: a sample leaves the box: {th.min()}, {th.max()}")
    if cuda:
        _check(samp_k1 == (0, st["evals"]),
               f"NUTS: expected {st['evals']} batched K1 launches (one per "
               f"objective evaluation) and no 2-D one, saw {samp_k1}")
    # outside the count: the float32 objective's error against float64
    # at the start and at each chain's last sample
    f = batched_nlml_fn(model)
    with torch.no_grad():
        ends = torch.cat([model.pack()[None], theta[:, -1]])
        val = {dt: f(ends.to(dt), *(torch.as_tensor(
            a, dtype=dt, device=device).expand(ends.shape[0], *a.shape)
            for a in (Xs, ys))).double().cpu().numpy()
            for dt in (torch.float32, torch.float64)}
    err = np.abs(val[torch.float32] - val[torch.float64])
    print(f"NUTS target, float32 NLML against float64: at the start "
          f"{val[torch.float64][0]:.4f} (error {err[0]:.4f}); at the chains' "
          f"last samples {np.array2string(val[torch.float64][1:], precision=1)}"
          f" (errors {np.array2string(err[1:], precision=4)})")
    mu_h, var_h = mu.cpu().numpy(), var.cpu().numpy()
    mse = float(np.mean((mu_h - yq) ** 2))
    n_mix = th.reshape(-1, th.shape[-1])[::thin].shape[0]
    print(f"predictive_mixture over {n_mix} samples at {Xq.shape[0]} "
          f"queries: {mwall:.3f} s, MSE "
          f"{mse:.5f} = {mse / yq.var():.4f} var(y); K1 launches (2-D, "
          f"batched) {mix_k1}")
    _check(bool(np.all(np.isfinite(mu_h)) and np.all(np.isfinite(var_h))
                and np.all(var_h >= 0)),
           "predictive_mixture: non-finite mean or variance < 0")
    return samp_k1[0] + mix_k1[0], samp_k1[1] + mix_k1[1]


def run_batched(device, seed: int, zero, counts2, train: str, test: str,
                workdir: str):
    """The batched paths (phases 15-18): K1's batched entry, then the
    counted ensemble, `train -o JIT` and NUTS runs. Returns the K1
    launches of the counted runs and the batched K1 report."""
    import torch

    t0 = time.perf_counter()
    report = phase_k1_batched(device, seed)
    k1 = 0
    zero()
    fit_k1, pred_k1 = phase_ensemble(device, seed, counts2)
    k1 += sum(fit_k1) + sum(pred_k1)
    torch.cuda.empty_cache()
    zero()
    k1 += sum(phase_train_jit(train, test, workdir, counts2))
    torch.cuda.empty_cache()
    zero()
    k1 += sum(phase_nuts(device, seed, counts2))
    torch.cuda.empty_cache()
    print(f"batched phases done in {time.perf_counter() - t0:.1f} s")
    return k1, report


def _kernel_entry(name, source, replaces, launches, report):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": report["max_abs_err"], "ms": report["ms"],
            "plain_ms": report["plain_ms"], "bound_ms": report["bound_ms"],
            "bound_by": "bytes" if report["bound_by"] == "bytes"
            else "operations", "library_ms": None}


def predict_k1(n: int) -> int:
    """K1 launches of the CLI train's dense training-set predict at n
    training points: A, then one cross-Gram per chunk of queries."""
    from gp_ss_ak_torch.cli import TRAIN_PREDICT_CHUNK

    return 1 + -(-n // TRAIN_PREDICT_CHUNK)


def run_warped_dense(device, seed: int, zero, counts):
    """Counted: the warped dense round trip (phase 9b); then, outside
    the count, its evaluation and mix times and the warped iterative vs
    dense comparison (10b). Returns (its K1 launches, the trained model
    path)."""
    import torch

    wtrain, wtest, _ = write_case(WORK + "_warped", seed, N_TRAIN, N_TEST,
                                  skew=True)
    zero()
    wmodel, w_evals = phase_dense_train(wtrain, os.path.dirname(wtrain),
                                        lf=WARP_LF)
    phase_main(wtrain, wtest, wmodel, mse_max=WARP_MSE_MAX)
    want = (w_evals + predict_k1(N_TRAIN) + 2, 0, 0)
    _check(counts() == want,
           f"warped train + test: expected {want[0]} K1 launches ({w_evals} "
           f"for the fit, {predict_k1(N_TRAIN)} for its training-set "
           f"predict, 2 for test) and no K2 or K3; saw (K1, K2, K3) = "
           f"{counts()}")
    k1 = counts()[0]
    phase_warped_eval(device, wtrain, wtest, wmodel)
    phase_iter_vs_dense(device, wtrain, wtest, wmodel, label="warped ")
    torch.cuda.empty_cache()
    return k1, wmodel


def run_warped_iterative(device, seed: int, zero, counts, wmodel: str,
                         itrain: str, itest: str, imodel: str,
                         k3_ms: float, plain_s=None):
    """Counted: the warped matrix-free path (phase 11b) at N_ITER_TRAIN.
    Returns its (K1, K3) launches."""
    import torch

    from gp_ss_ak_torch.model import load_model

    wtrain, wtest, wimodel = write_case(
        WORK + "_iterative_warped", seed, N_ITER_TRAIN, N_ITER_TEST,
        skew=True, model=load_model(wmodel, device="cpu"))
    zero()
    phase_warped_iter_serve(device, wtrain, wtest, wimodel, k3_ms, plain_s)
    phase_warped_identity_eval(device, seed, itrain, itest, imodel)
    k1, k2, k3 = counts()
    print(f"warped matrix-free path: (K1, K2, K3) launches {counts()}")
    _check(k1 > 0 and k3 > 0 and k2 == 0,
           f"warped matrix-free path: (K1, K2, K3) = {counts()}")
    torch.cuda.empty_cache()
    return k1, k3


def run_train_default(itrain: str, zero, counts):
    """Counted: the default train route at N_ITER_TRAIN (phase 13).
    Returns its (K1, K3) launches."""
    zero()
    n_evals, mode = phase_train_default(itrain, os.path.dirname(itrain))
    if mode == "chol":
        want = (n_evals + predict_k1(N_ITER_TRAIN), 0, 0)
        _check(counts() == want,
               f"default train route: expected {n_evals} K1 launches for "
               f"the fit (chol mode) and {predict_k1(N_ITER_TRAIN)} for its "
               f"training-set predict, and no K2 or K3; saw (K1, K2, K3) = "
               f"{counts()}")
    else:
        _check(counts()[2] > 0, f"default train route ({mode} mode) "
               f"launched no K3: (K1, K2, K3) = {counts()}")
    return counts()[0], counts()[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("k3", "warped", "batched"),
                    help="k3: phases 1, 2 and 4; warped: phases 1, 2, 9b, "
                         "10b, 11b and 13; batched: phases 1, 2 and 15-18. "
                         "None prints a result")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from gp_ss_ak_torch.ops import matvec, pairwise

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    phase_device()
    phase_build()
    if args.only == "k3":
        phase_k3(device, args.seed)
        print(f"K3 phases passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    def zero():
        pairwise.launches = pairwise.batched_launches = 0
        matvec.launches = matvec.matvec_launches = 0

    def counts():
        return (pairwise.launches + pairwise.batched_launches,
                matvec.matvec_launches, matvec.launches)

    def counts_k1():
        """K1's launches on one point set and on batches."""
        return pairwise.launches, pairwise.batched_launches

    if args.only == "batched":
        train, test, _ = write_case(WORK, args.seed, N_TRAIN, N_TEST)
        run_batched(device, args.seed, zero, counts_k1, train, test, WORK)
        print(f"batched phases passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0

    if args.only == "warped":
        _, wmodel = run_warped_dense(device, args.seed, zero, counts)
        itrain, itest, imodel = write_case(WORK + "_iterative", args.seed,
                                           N_ITER_TRAIN, N_ITER_TEST)
        k3_ms = k3_times(device, args.seed, ((ITER_REQUEST_SIZE, 3),))[0]
        run_warped_iterative(device, args.seed, zero, counts, wmodel, itrain,
                             itest, imodel, k3_ms[ITER_REQUEST_SIZE][0])
        run_train_default(itrain, zero, counts)
        print(f"warped phases passed in {time.perf_counter() - t_start:.1f} "
              f"s")
        return 0
    k1 = phase_k1(device, args.seed)
    k3 = phase_k3(device, args.seed)
    k2 = phase_k2(device, args.seed)
    phase_golden(device)
    train, test, model_path = write_case(WORK, args.seed, N_TRAIN, N_TEST)

    # counted run 1, the dense serving path: CLI test + dense serving
    zero()
    yh_cli = phase_main(train, test, model_path)
    _check(counts() == (2, 0, 0),
           f"dense cli test: expected 2 K1 launches (A, cross) and no K2 "
           f"or K3, saw (K1, K2, K3) = {counts()}")
    server, _ = phase_serve(device, torch.float32, train, test, model_path,
                            yh_cli)
    k1_launches = pairwise.launches
    phase_setup_split(server)
    del server
    torch.cuda.empty_cache()

    # counted run 2, the dense training path: CLI train, then test on the
    # trained model (the round trip)
    zero()
    trained, n_evals = phase_dense_train(train, WORK)
    phase_main(train, test, trained)
    want = (n_evals + predict_k1(N_TRAIN) + 2, 0, 0)
    _check(counts() == want,
           f"dense train + test: expected {n_evals} K1 launches for the "
           f"fit, {predict_k1(N_TRAIN)} for its training-set predict and 2 "
           f"for test, and no K2 or K3; saw (K1, K2, K3) = {counts()}")
    k1_launches += pairwise.launches
    phase_dense_eval_split(device, train, test, trained)

    # counted run 2b, the warped dense round trip
    k1_w, wmodel = run_warped_dense(device, args.seed, zero, counts)
    k1_launches += k1_w

    phase_iter_vs_dense(device, train, test, model_path)
    phase_iter_modes(device, args.seed, train, test, model_path)
    itrain, itest, imodel = write_case(WORK + "_iterative", args.seed,
                                       N_ITER_TRAIN, N_ITER_TEST)

    # counted run 3, the matrix-free serving path: CLI test (auto
    # engine) + iterative serving
    zero()
    yh_it = phase_main(itrain, itest, imodel)
    cli_k1, cli_k3 = pairwise.launches, matvec.launches
    print(f"cli test at N={N_ITER_TRAIN} (auto engine): K3 launches "
          f"{cli_k3}, K1 cross launches {cli_k1}")
    _check(cli_k3 > 0, "auto engine did not pick the iterative server")
    _check(cli_k1 > 0, "iterative cli test made no K1 cross launch")
    iserver, ytrs, plain_s = phase_iter_serve(
        device, itrain, itest, imodel, yh_it, k3[ITER_REQUEST_SIZE][0])
    print(f"iterative serve: K3 launches {matvec.launches - cli_k3}")
    _check(pairwise.launches > cli_k1 and matvec.launches > cli_k3,
           "iterative serving launched no K1 or no K3")
    k1_launches += pairwise.launches
    k3_launches = matvec.launches
    phase_iter_setup_split(iserver, ytrs)
    del iserver
    torch.cuda.empty_cache()

    # counted run 3b, the warped matrix-free path
    k1_w, k3_w = run_warped_iterative(
        device, args.seed, zero, counts, wmodel, itrain, itest, imodel,
        k3[ITER_REQUEST_SIZE][0], plain_s)
    k1_launches += k1_w
    k3_launches += k3_w

    # counted run 4, matrix-free training (stream mode)
    zero()
    start, Xfit, yfit, _ = phase_iter_fit(device, itrain, itest, imodel)
    _check(matvec.launches > 0 and matvec.matvec_launches == 0,
           f"iterative fit: (K1, K2, K3) = {counts()}")
    k1_launches += pairwise.launches
    k3_launches += matvec.launches
    phase_iter_eval_split(device, args.seed, start, Xfit, yfit)

    # counted run 5, the default train route past DENSE_MAX_N: the CLI
    # with --engine auto, then its training-set predict
    k1_d, k3_d = run_train_default(itrain, zero, counts)
    k1_launches += k1_d
    k3_launches += k3_d
    torch.cuda.empty_cache()

    # counted run 6, the K2 path: nlml_iterative without a preconditioner
    zero()
    k2_launches = phase_k2_path(device, args.seed, itrain, itest, imodel)
    _check(k2_launches > 0, "the K2 path launched no K2")

    # counted runs 7-9, the batched paths: the ensemble, train -o JIT and
    # NUTS, after K1's batched entry against its plain version
    k1_b, k1_batched = run_batched(device, args.seed, zero, counts_k1, train,
                                   test, WORK)
    k1_launches += k1_b
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_batched["max_abs_err"])

    print(f"smoke phases done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        _kernel_entry("gram (K1, fused ExpAns+Bias Gram, N=16384 diag f32)",
                      "gp_ss_ak_torch/csrc/gram.cu",
                      "gp_ss_ak_tpu/ops/pairwise.py:42", k1_launches, k1),
        _kernel_entry("matvec (K2, streamed Gram matvec, N=65536)",
                      "gp_ss_ak_torch/csrc/matvec.cu",
                      "gp_ss_ak_tpu/ops/matvec.py:32", k2_launches, k2),
        _kernel_entry("matmat (K3, streamed Gram matmat, N=65536 B=1024)",
                      "gp_ss_ak_torch/csrc/matmat.cu",
                      "gp_ss_ak_tpu/ops/matvec.py:90", k3_launches, k3),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
