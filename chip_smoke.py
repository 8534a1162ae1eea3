#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed N]      (from the root of the repository)
    python3 chip_smoke.py --only k3       (phases 1, 2 and 4: K3 alone)
    python3 chip_smoke.py --only k2       (phases 1, 2, 5 and 14: K2 alone)
    python3 chip_smoke.py --only k4       (phases 1, 2 and 5b: K4 alone)
    python3 chip_smoke.py --only k6       (phases 1, 2 and 5c: K6 alone)
    python3 chip_smoke.py --only warped   (phases 1, 2, 9b, 10b, 11b, 13)
    python3 chip_smoke.py --only batched  (phases 1, 2, 15-18)
    python3 chip_smoke.py --only sparse   (phases 1, 2, 19-24)
    python3 chip_smoke.py --only parallel (phases 1, 2, 25-30)
    python3 chip_smoke.py --only segmented (phases 1, 2, 31-34)
    python3 chip_smoke.py --only examples (phases 1, 2, 35-38)

Phases, each of which raises on failure (nothing is caught):
  1. device: card name and power limit, torch/CUDA/nvcc versions;
  2. build the hand-written kernels K1 (gp_ss_ak_torch/csrc/gram.cu), K2
     (csrc/matvec.cu), K3 (csrc/matmat.cu), K4 (csrc/contraction.cu) and
     K6 (csrc/pivchol.cu) into one library, one nvcc per source;
     ptxas's register report (no spills in any K3 instance or in K2),
     the HMMA count of K3's SASS (cuobjdump), K3's register tiles' issue
     slots per Gram entry of each inner loop, K2's opcode histograms (no
     FRND or F2I) and the issue slots per Gram entry of its d = 3 inner
     loop;
  3. K1 against its plain torch version on the card, at ragged sizes and
     at the main path's shapes, in float64 and float32, plus timings;
  4. K3 against its plain version in float64, at ragged sizes, at the
     edges of its register widths, column groups and wide tile, and at
     N = 65536 at every width the main path uses, with a TF32 control
     that the same gate must reject and a 3xTF32 control that it must
     accept, each launch on the tile route its B picks
     (`matvec.route_launches`), equal bits across passes and across
     register widths, plus timings at N = 65536 (B = 1, 8, 9, 16, 64 and
     the wide tile's 65, 256, 1024) and N = 100000 (B = 9, 32) beside the
     bound and the SASS model, the SM clock while the widest runs, and a
     cuBLAS yardstick on a prebuilt K;
  5. K2 against its plain version in float64 at ragged sizes (d = 2, 3,
     4, 5) and at N = 16384, 32768 (the K2 path's) and 65536, the same
     gate and TF32 control, two passes for equal bits, the diagonal
     exactly s2 in both classes of its ex2 split, and its time at those
     three N beside its bound, the MUFU-only term, the SASS model, K3 at
     B = 1 and the plain version;
     at N = 100000 and 150000 also the gate and K2's time under its slab
     plan beside 16 slabs and beside one wave of slabs, floored;
  5b. K4 (csrc/contraction.cu, the gradient's contraction): its
     instances' spills (none at d <= 3), opcode histograms and issue
     slots per Gram entry from the SASS; against its plain version in
     float64 at ragged sizes, d = 2 and 5 and rank 9, 17 and 33, and at
     N = 100000 (equal bits over two launches); on the ore body's mapped
     points at N = 100000, rank 9, the four gradients of
     `_grad_contraction` (one K4 launch) and of the autograd version it
     replaced against float64; the kernel's time beside its bound and
     the SASS model's floor, `_grad_contraction`'s, the plain version's
     and the autograd version's; the kernel at rank 17;
  5c. K6 (csrc/pivchol.cu, the pivoted Cholesky's steps): no spills in
     ptxas's report; against the plain loop on the card at the main
     path's (n, rank) = (100000, 1024) and (16384, 341), on the ore
     body's mapped points, in float32 and float64: the first 64 pivots,
     the trace of K - L L^T, 4096 sampled entries of L L^T, two calls
     bit for bit, `rank` launches a call, and, reported, the first step
     whose pivot differs and logdet P of the two preconditioners; its
     time at both shapes beside its bound (`pivchol_work`), the plain
     loop's and the one-direction sweep's (the ragged and rank > n cases
     are the card tests');
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
     per-member scalars; at the batched paths' own shapes in their own
     types, the ensemble's A in float64, its objective's), each member
     bit for bit against a 2-D launch, and its time at B = 256 members
     of 1024^2 beside its bound;
 16. the ensemble: `fit_ensemble` of 256 deposits x 1024 composites
     (float32 model, the objective in float64, maxiter 30), one batched
     K1 launch per batched evaluation, every deposit's NLML below its
     start, four deposits alone through `fit(optimizer="JIT")` against
     the batch, the objective's evaluation timed and split under
     torch.profiler, then `predict_ensemble` at 1024 queries a deposit
     (MSE < 0.2 var(y) each);
 17. `cli.main([... "train" -o JIT -# 5 ...])` at N = 16384 (the
     objective in float64) with its peak memory, then `test` on the
     trained model;
 18. `sample_hyperposterior` (NUTS, 8 chains, N = 2048, float32, 4
     warmup + 4 samples, max_depth 8): samples finite and inside the
     box, one batched K1 launch per objective evaluation, split R-hat
     and ESS printed; then `predictive_mixture` over every 10th sample.
 19. K1's cross entry at sparse GP regression's Kmn shapes (512 and 2048
     x 100000) against its plain version in float64 and float32, timed
     beside its bound, with its closed-form backward's time;
 20. `inference.sgpr.fit_sgpr` at N = 100000 composites, m = 512, 60
     iterations (float32), then `predict` at 4096 held-out queries
     (MSE < 0.2 var(y)), K1 launches = 2 per evaluation + 3; one
     evaluation profiled, and one at m = 2048;
 21. SGPR at N = 16384, m = 512: float32 through K1 against float64
     through kernel.matrix, the float64 bound below the exact evidence,
     and the cross-Gram backward against autograd through kernel.matrix
     in float64 where Z is a subset of X (coincident pairs);
 22. Laplace at N = 16384 in float64: its NLML with Gaussian.log_prob
     equal to the exact NLML, with WarpedGaussian.log_prob on exp(0.8 y)
     to the warped exact NLML, and its latent prediction (plus sn2) at
     4096 queries to the dense `predict`; 7 K1 launches;
 23. the opt-in gemm_bf16 mode at N = 65536: its matvec against the
     float32 store's, and `nlml_and_grad_iterative` in gemm_bf16 against
     gemm mode with the same probes (CG at its 1e-3 floor; K built in
     row blocks, one K1 launch each), with its peak memory;
 23b. SGPR (m = 512) against the matrix-free exact fit (3 iterations)
     at N = 65536 from the same start: wall and holdout MSE, printed;
 24. utils/: a profiler trace of one SGPR evaluation, `fit` with a
     checkpoint and its resume on the dense case, `nan_debug` on the card.
 25. the mesh engines (parallel/) in float64 at N = 4096 on a mesh of one
     rank (NCCL): the dist NLML and exact gradient against the dense
     engine, its predict against the dense Predictor, the ring NLML and
     the ring predict (alpha and the variance columns by its whitened CG)
     against the dense Predictor;
 26. the same on 4 ranks sharing the card (this script run 4 times with
     --mesh-io, gloo asked for by name, host-staged), held to one rank,
     and `entry.dryrun_multichip(4)` in place on those ranks, its NLML
     held to the dense engine's in float64;
 27. the two-level meshes (2 chains x 2 rows) at N = 2048, dist and
     ring, each chain held to itself alone on one rank;
 28. K1's cross entry at the dist panel (16384^2) and the ring tile
     (65536 x 4096) against its plain version, on independent and on
     coincident points, timed beside its bound;
     the dist NLML in float32 at N = 16384 with the exact and the
     Hutchinson gradient against the dense engine (2 K1 launches an
     evaluation), profiled; `train --engine dist -# 3` and `test`;
 29. the ring at N = 65536 in float32: one evaluation with its CG
     iterations, residual, time and peak memory, profiled, then
     `fit_ring` for 2 iterations;
 30. `make_ring_predict` at 256 queries against the same in float64 and
     IterativePredictor (variances against the prior variance), with a
     TF32 control the variance gate must reject.
 31. the segmented evaluator (optim/segmented.py: the fused stream
     evaluator with a warm start) at N = 100000 (BASELINE configuration
     3's N) with STREAM_OPTS at the golden start, cold: bit for bit and
     iteration for iteration against the fused stream evaluator, K3
     launches = CG iterations + Lanczos steps, one evaluation split by
     its profiler ranges;
 32. warm against cold at x and x (1 + 1e-3): fewer CG iterations warm,
     the value within 1e-4 and the gradient within 2e-3 of its largest
     entry, one more K3 pass;
 33. `cli.main([... "train" -# 2 --engine iterative --segmented ...])` at
     N = 100000: per evaluation sn2, CG iterations, residual and rank; the
     peak device memory within a bound derived from the code; the holdout
     MSE on 4096 held-out composites through IterativePredictor;
 34. K3 at N = 100000, B = 9 and 32, against its plain version in float64
     (with both controls) and timed beside its bound.
 35. the full example workflow (gp_ss_ak_torch/examples/full_workflow.py)
     at N = 16384 training and 4096 test composites, 5 iterations: the
     dense fit, the model file, Predictor on the test set (MSE < 0.2
     var(y)), NUTS at the example's 80 points and 2 chains, 5 + 5
     transitions;
 36. the Bayes example workflow at its own 40 points: NUTS with 4 chains
     on a mesh of one rank, 8 + 8 transitions (acceptance in (0.3, 1),
     every draw finite);
 37. the distributed example workflow in float32 on a world of one at
     N = 16384, 3 iterations, with its own check of the dist predict
     against the ring's posterior mean;
 38. the ring example workflow at N = 65536, 2 iterations, its posterior
     mean's CG residual printed.
The matrix-free phases also hold the solves' verdicts
(inference.iterative.solve_state): phase 12 prints sn2 and the
unconverged flag for each evaluation, phase 23 requires gemm_bf16's
failed solve at the case's noise to give a NaN value and gradient, and
phase 33 requires the CLI's one stderr warning to count exactly the
evaluations whose residual is above cg_tol.
Every bound is the largest of three terms (`bound`, from the benchmark's
yardstick in port_bench/roofline.py): bytes, the SFU and FP32 work with
the ex2 split at its best between MUFU and a polynomial on the FP32
pipes ("SFU/FMA", `sfu_fma_ms`; K2's and K3's lines also print the
MUFU-only term) and the product on the tensor cores at float32
accuracy; the line says which term sets it.
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
import warnings

import numpy as np

# The card's yardstick and the ore body are the benchmark's (port_bench,
# the one copy). POLY_EX2_SLOTS = 10 there: csrc/ex2_poly.cuh's ex2 on the
# FP32 pipes is 10 issue slots in its SASS (1 FMNMX, 3 FADD, 5 FFMA, 1
# LEA; no FRND or F2I, which issue at MUFU's quarter rate), and an
# integer slot costs as much as an FP32 one (128 instructions an SM a
# clock, PEAK_FP32_FLOPS / 2 a second). A probe built for the purpose
# read 12.37-12.44 of them per SM per clock on an H100 80GB HBM3 at
# 700 W, 10.3 slots each, against MUFU's 15.88-16.11.
from port_bench.data import ore_body
from port_bench.roofline import (PEAK_BYTES_S, PEAK_FP32_FLOPS,
                                 PEAK_TF32_FLOPS, POLY_EX2_SLOTS,
                                 SFU_PER_SM_CLOCK, bound, card_rates,
                                 gram_work, matmat_work, sfu_fma_ms)

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
ITER_FIT_CG_TOL = 1e-4          # the matrix-free fit's default cg_tol
# stream vs gemm mode of nlml_and_grad_iterative at N_TRAIN with the same
# probes: tests/test_iterative.py:355-365's tolerances for two modes
MODE_VAL_REL, MODE_VAL_ABS = 1e-4, 0.05
MODE_GRAD_REL, MODE_GRAD_ABS = 1e-3, 1e-2
MODE_CG_TOL = 1e-6              # that test's CG tolerance
# the Xm gradient, stream vs gemm, relative to its largest entry: 1.6e-3
# on an H100 at cg_tol 1e-4 and at 1e-6 alike, with the autograd
# contraction and with K4 (whose own error is ~4e-7 of float64) alike:
# the two modes' float32 operators, so the limit sits ~6x above it
MODE_XM_REL = 1e-2
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
# and the first evaluation of the fit's objective (float64) alone vs in
# the batch (6.4e-6 in the value, 1.7e-6 in the gradient on an H100 when
# it ran in float32)
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
# the sparse phases: SGPR at N_SGPR composites and M_SGPR inducing points
# for SGPR_ITERS iterations (benchmarks/large_n.py:500 sgpr_row, run at
# n = 100000 as bench.py:281 does), predicting N_SGPR_TEST held-out
# queries; one evaluation at M_SGPR_WIDE, the widest cell of
# sgpr_sweep_row (benchmarks/large_n.py:456)
N_SGPR, M_SGPR, SGPR_ITERS, N_SGPR_TEST = 100000, 512, 60, 4096
M_SGPR_WIDE = 2048
# SGPR against the matrix-free exact fit at N_ITER_TRAIN: the exact fit's
# iterations (chol mode on an 80 GB card, ~2.7 s an evaluation)
EXACT_ITERS = 3
# SGPR at N_TRAIN, m = M_SGPR: float32 through K1 against float64 through
# kernel.matrix. Set before the first card run from the CPU's float32
# (1.5e-5 in the value; 3.2e-5 and 3.0e-4 of the largest hyperparameter
# and Z gradient entries), 7-30x above those
SGPR_F32_VAL_REL, SGPR_F32_GRAD_REL, SGPR_F32_Z_REL = 1e-4, 1e-3, 1e-2
SGPR_BOUND_SLACK = 1e-6         # ELBO <= -NLML + this * |NLML|
# the cross-Gram backward against autograd through kernel.matrix in
# float64, of each gradient's largest entry; the second for the rows where
# the expansion left round-off at a coincident pair
# (tests/test_torch_sgpr.py)
CROSS_BWD_RTOL, CROSS_BWD_NOISY_RTOL = 1e-9, 1e-7
# Laplace at N_TRAIN in float64 against the exact dense algebra: the NLML
# at 1e-8; the latent variance + sn2, and the mean kX^T alpha_hat from the
# same Newton run as predict_latent's, at 1e-6 of the dense prediction's
# largest entry. predict_latent's own mean is kX^T dlp with
# dlp = (y - f_hat) / sn2, the JAX package's formula, which divides the
# round-off of f_hat = K alpha_hat by sn2 before kX^T cancels it to O(1);
# it is held at LAPLACE_MEAN_RTOL beside the alpha_hat gate (the first
# card run read 1.09e-6; the CPU 5.6e-8 at N = 4096, and 2.8e-12 through
# alpha_hat, which the Student-t's early stop rules out as the formula)
LAPLACE_NLML_RTOL, LAPLACE_PRED_RTOL, LAPLACE_MEAN_RTOL = 1e-8, 1e-6, 1e-5
# gemm_bf16 at N_ITER_TRAIN: its matvec of y within BF16_MATVEC_REL of the
# float32 store's (tests/test_iterative.py:296-310). Its gradient is gated
# at BF16_SN2, the warped model's noise floor (exp(2 theta) >= 1 in the
# box), where A_bf16 stays positive definite: the quantization's spectral
# norm grows with N (0.039 at N = 4096, 0.065 at 8192 on the CPU,
# 0.448 at 65536 on an H100), so at the case's sn2 = 0.016 A_bf16 is
# indefinite past N ~ 2000 and CG stalls. The sigma and sn2 gradients
# within BF16_GRAD_REL of gemm mode's with the same probes, the Xm gradient
# within BF16_XM_REL of gemm's largest entry. Set before the first card
# run from the CPU at the same ratio of quantization to noise (N = 4096,
# sn2 = 0.25: 3e-3, 3e-3 and 9e-2)
BF16_MATVEC_REL = 5e-3
BF16_SN2 = 1.0
BF16_GRAD_REL, BF16_XM_REL = 5e-2, 0.3

# the mesh engines (parallel/): float64 at N_DIST64 rows on a mesh of one
# rank (NCCL) and of MESH_RANKS ranks sharing the one card (gloo, asked for
# by name: NCCL takes one rank a card), MESH_QUERIES predicted; the
# two-level meshes (2 chains x 2 rows) at N_TWO; float32 at N_TRAIN (the
# dense route's width) and the ring at N_ITER_TRAIN (the matrix-free
# width) on one rank; DIST_NB the fits' block size (parallel/fit.py)
N_DIST64, MESH_RANKS, MESH_QUERIES, N_TWO = 4096, 4, 512, 2048
DIST_NB = 256
MESH_TIMEOUT_S = 600            # the MESH_RANKS-rank launch, start-up included
DIST_TRAIN_ITERS, RING_FIT_ITERS, RING_PREDICT_QUERIES = 3, 2, 256
# the ring predict in float32 at N_ITER_TRAIN against IterativePredictor
# on the same model and against the same ring predict in float64 (CG to
# 1e-10): means within phase 10's ITER_MEAN_TOL x std(y), variances within
# phase 10's ITER_VAR_RTOL of the prior variance s^2 + bias + sn2. That is
# the scale of the float32 error in s^2 + bias - k' A^-1 k; relative to
# the variance itself, small where the data pin the mean down, the
# cancellation inflates it (on an H100 at N = 65536 both float32 solves
# sit 1.6-1.7e-2 from float64 at the worst of 256 queries). The same
# ring predict with its tile products in TF32 is a control the variance
# gate must reject
# the float64 ring: its probes, a preconditioner of rank 64 and a CG run
# to convergence, so one rank and MESH_RANKS agree to round-off
RING_PROBES, RING_SLQ_PROBES, RING64_RANK, RING64_CG_TOL = 8, 16, 64, 1e-10
# the gates: dist against the dense engine (value, gradient of its largest
# entry) and the dense Predictor; MESH_RANKS ranks against one (dist,
# ring value, ring gradient); the ring predict's solves against the dense
# Predictor;
# a two-level chain against itself alone; float32 at N_TRAIN against the
# dense engine (value over max(|v|, n), exact gradient of its largest
# entry)
DIST64_VAL_RTOL, DIST64_GRAD_RTOL, DIST64_PRED_RTOL = 1e-9, 1e-7, 1e-9
DIST_P4_RTOL, RING_P4_RTOL, RING_P4_GRAD = 1e-10, 1e-9, 1e-8
RING_ALPHA_RTOL, TWO_LEVEL_RTOL = 1e-6, 1e-9
DIST_F32_VAL_REL, DIST_F32_GRAD_REL = 5e-5, 5e-5
# the mesh dry run (entry.dryrun_multichip) on MESH_RANKS ranks: 8 points
# a rank in float32, its NLML against the dense float64 engine's (the
# port's float32 value sat 1.7e-5 from the JAX dry run's on the CPU)
DRYRUN_N, DRYRUN_VAL_RTOL = 8 * MESH_RANKS, 1e-4
# the segmented evaluator (optim/segmented.py) at BASELINE.json
# configuration 3's N (benchmarks/large_n.py's 100000), N_SEG_TEST held
# out, with large_n.py's STREAM_OPTS (the segmented evaluator's defaults:
# 16 Lanczos steps, cg_tol 1e-3, 32 SLQ probes) and 8 Hutchinson probes
# at rank auto_precond_rank(N_SEG) = 1024; warm against cold at x and
# x (1 + SEG_STEP), their values within SEG_WARM_RTOL
# (tests/test_iterative.py:743-775) and their gradients within
# SEG_WARM_GRAD of the largest entry (tests/test_torch_segmented.py's
# rtol); the CLI's iterations; K3 timed at the path's widths (CG on
# [y | 8 probes], SLQ)
N_SEG, N_SEG_TEST = 100000, 4096
STREAM_OPTS = dict(lanczos_iters=16, cg_tol=1e-3, slq_probes=32, probes=8)
SEG_STEP, SEG_WARM_RTOL, SEG_WARM_GRAD, SEG_TRAIN_ITERS = 1e-3, 1e-4, 2e-3, 2
K3_SEG_WIDTHS = ((9, 5), (32, 5))
# the example workflows (gp_ss_ak_torch/examples): the full workflow at
# the dense path's full width (N_TRAIN training and N_TEST test
# composites, EX_FULL_ITERS iterations), its Bayes part at the example's
# 80 points and 2 chains; the Bayes workflow at its own 40 points and 4
# chains; the distributed workflow in float32 on a world of one at
# N_TRAIN for EX_DIST_ITERS iterations; the ring workflow at N_ITER_TRAIN
# for EX_RING_ITERS iterations, as phase 29's fit_ring. The NUTS sample
# counts (warmup, samples) are cut from the examples' (120, 80) and
# (150, 150) to EX_FULL_NUTS and EX_BAYES_NUTS: at their own counts most
# trees reach 255 leaves, 49579 and 45737 batched evaluations of ~7 ms
# (325 s and 338 s on an H100), where the phases' whole budget is ~90 s;
# tests/test_torch_gpu.py runs both at their own counts
EX_FULL_ITERS, EX_DIST_ITERS, EX_RING_ITERS = 5, 3, 2
EX_FULL_NUTS, EX_BAYES_NUTS = (5, 5), (8, 8)
# the acceptance the Bayes workflow's NUTS must show, mean over chains
EX_ACCEPT = (0.3, 1.0)
# what the segmented path holds at once (segmented_peak_bound): the
# (n, rank) float32 blocks (the pivoted Cholesky's L, and the
# preconditioner's Q twice while precond_sqrt_pieces masks it); the
# columns of n floats beside them (the probes, 8 + 32; CG's and SLQ's
# blocks and the warm start, at most 33 wide each; K4's records, 3 + 2 *
# 9, and its [t, g] partial sums, 4 a slice); the training-set mean's
# (4096, 4096) cross-Gram blocks with their temporaries
SEG_RANK_BLOCKS, SEG_COLUMNS, SEG_MEAN_BLOCKS = 3, 256, 4
# K4, the gradient's contraction: the fit's N and ranks (8 and 16 probes,
# plus alpha), and its gate: t and g against the plain version in float64
# on the same inputs, within TOL_K4 of each output's largest entry
N_K4 = 100000
K4_RANKS = (9, 17)
TOL_K4 = 1e-5

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


def sfu_shares(work, ms: float) -> str:
    """The kernel's share of both SFU terms of `sfu_fma_ms`, printed."""
    mufu_only, balanced = sfu_fma_ms(work, **card_rates())
    return (f"SFU bounds: MUFU-only {mufu_only:.4f} ms (kernel at "
            f"{mufu_only / ms:.3f}), balanced with "
            f"{POLY_EX2_SLOTS}-slot polynomial ex2 {balanced:.4f} ms "
            f"(kernel at {balanced / ms:.3f})")


def matvec_work(n: int, d: int):
    """K2's work for one pass over the n*n Gram entries: the points
    (padded to a float4), v and y once; 3d + 2 FP32 operations an entry
    (the distance as in gram_work and the multiply-add with v; s2 scales
    each output once); two SFU operations an entry; the product 2 n^2
    priced as three TF32 products."""
    return 4.0 * n * (4 + 2), float(n) * n * (3 * d + 2), 2.0 * n * n, \
        3 * 2.0 * n * n


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


# one instruction of cuobjdump -sass: its address, opcode and operands
_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)([^;]*);")
#: opcodes an ex2 on the FP32 pipes must not use: on sm_90 they issue at
#: MUFU's quarter rate (CUDA C++ Programming Guide, arithmetic throughput)
SLOW_OPCODES = ("FRND", "F2I")


def sass_functions(sass: str):
    """{function name: [(address, opcode, operands)]} of cuobjdump -sass
    output."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        out[name] = [(int(a, 16), op, rest.strip())
                     for a, op, rest in _SASS_INSN.findall(part)]
    return out


def _opcode_key(op: str) -> str:
    """An opcode without its modifiers, except MUFU's function and LDS's
    width (MUFU.EX2, LDS.128)."""
    parts = op.split(".")
    return ".".join(parts[:2]) if parts[0] in ("MUFU", "LDS") else parts[0]


def opcode_histogram(insns):
    """{opcode: count} of `insns`, NOPs left out (they fill the tail)."""
    hist = {}
    for _, op, _ in insns:
        key = _opcode_key(op)
        if key != "NOP":
            hist[key] = hist.get(key, 0) + 1
    return dict(sorted(hist.items(), key=lambda kv: (-kv[1], kv[0])))


def innermost_loop(insns, marker: str):
    """The instructions of the smallest loop of `insns` (a backward BRA
    and its target) that holds an opcode starting with `marker`, or
    None."""
    best = None
    for addr, op, rest in insns:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op.split(".")[0] != "BRA" or m is None:
            continue
        top = int(m.group(1), 16)
        body = [i for i in insns if top <= i[0] <= addr]
        if top < addr and any(o.startswith(marker) for _, o, _ in body) \
                and (best is None or len(body) < len(best)):
            best = body
    return best


_INT_OPCODES = {"IADD3", "IMAD", "LEA", "SHF", "LOP3", "ISETP", "SEL",
                "PRMT", "IABS", "IMNMX", "IADD", "IMUL", "SHL", "SHR"}


def issue_classes(hist, per: float):
    """Issue slots of a histogram by kind, divided by `per`: FP32 (F*
    arithmetic, compares and selects), INT (integer arithmetic and
    logic), MUFU, conversions, shared/global memory and the rest; and
    their total."""
    kinds = {"FP32": 0, "INT": 0, "MUFU": 0, "conversion": 0, "memory": 0,
             "other": 0}
    for key, k in hist.items():
        base = key.split(".")[0]
        if base == "MUFU":
            kind = "MUFU"
        elif base in ("F2I", "I2F", "F2F", "F2FP", "I2I"):
            kind = "conversion"
        elif base.startswith("F"):
            kind = "FP32"
        elif base in _INT_OPCODES:
            kind = "INT"
        elif base[:2] in ("LD", "ST"):
            kind = "memory"
        else:
            kind = "other"
        kinds[kind] += k
    out = {k: v / per for k, v in kinds.items()}
    out["total"] = sum(hist.values()) / per
    return out


def _fmt_classes(c) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in c.items())


def k2_sass_report(sass: str):
    """Phase 2's reading of K2's SASS: each K2 kernel's opcode histogram
    (none may hold SLOW_OPCODES) and the issue slots per Gram entry of
    its d = 3 kernel's inner loop (an entry per MUFU square root).
    Returns those slots per entry by kind (`issue_classes`)."""
    report = {}
    for name, insns in sass_functions(sass).items():
        if "matvec" not in name:
            continue
        hist = opcode_histogram(insns)
        slow = [op for op in hist if op.split(".")[0] in SLOW_OPCODES]
        _check(not slow, f"{name}: {slow} in its SASS")
        m = re.search(r"\d(matvec_[a-z]+)(?:ILi(\d+)E)?", name)
        args = "" if m.group(2) is None else f"<{m.group(2)}>"
        print(f"build: K2 {m.group(1)}{args} SASS opcodes: {hist}")
        loop = innermost_loop(insns, "MUFU")
        if loop is None or "matvec_packed" not in name:
            continue
        lhist = opcode_histogram(loop)
        entries = sum(v for k, v in lhist.items()
                      if k in ("MUFU.SQRT", "MUFU.RSQ"))
        report = issue_classes(lhist, entries)
        poly = entries - lhist.get("MUFU.EX2", 0)
        print(f"build: K2 d<=3, {poly} of {entries} exponentials on "
              f"the polynomial: inner loop {len(loop)} instructions, "
              f"{entries} Gram entries; issue slots per entry: "
              f"{_fmt_classes(report)}; loop opcodes {lhist}")
    _check(bool(report), "K2's inner loop not found in the SASS")
    return report


def phase_build():
    from gp_ss_ak_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"build: K1-K4 and K6 loaded in {time.perf_counter() - t0:.3f} s "
          f"(nvcc, one process per source, then link: "
          f"{_build.build_info.get('seconds', 0.0):.3f} s)")
    log = _build.build_info.get("log", "")
    for line in log.splitlines():
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line):
            print("  ptxas:", line.strip())
    # K3's wide tile and register tiles: no spills in ptxas's report, HMMA
    # in the wide tile's SASS, the register tiles' slots per entry
    spills = re.findall(r"Function properties for (\S*matmat_tc_kernel\S*)"
                        r"\s+\d+ bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", log)
    _check(len(spills) > 0, "ptxas reported no K3 wide tile")
    for name, st, ld in spills:
        _check(st == ld == "0", f"K3 wide tile {name} spills: {st} bytes "
               f"stored, {ld} loaded")
    k3_sass_report()
    sass = _sass()
    hmma = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if "matmat_tc_kernel" in name:
            hmma[name] = part.count("HMMA")
    print(f"build: HMMA instructions in K3's wide tile SASS, by kernel: "
          f"{hmma}")
    _check(len(hmma) == len(spills) and min(hmma.values()) > 0,
           "K3's wide tile issues no HMMA")
    # K2: no spills, no slow opcodes, slots per entry
    k2_spills = re.findall(r"Function properties for (\S*matvec"
                           r"\S*)\s+\d+ bytes stack frame, (\d+) bytes "
                           r"spill stores, (\d+) bytes spill loads", log)
    for name, st, ld in k2_spills:
        _check(st == ld == "0", f"{name} spills: {st} bytes stored, {ld} "
               f"loaded")
    return k2_sass_report(sass)


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
#: request, the CLI's variance solves at 1024), plus 8 and 16 (register
#: tiles a set-up solve and a wider CG take) and 65, the wide tile's
#: first width; and timed passes of each
K3_WIDTHS = ((1, 20), (8, 20), (9, 10), (16, 10), (64, 10), (65, 5),
             (256, 5), (1024, 3))
#: K3's gate cases (n, B, d): ragged n at register, grouped and wide
#: widths, d <= 3 and the general kernel (d = 4, 7), the edges of the
#: register widths and column groups, and every timed width at the main
#: path's N (each tile at the shape the path runs it)
K3_CASES = ([(n, b, d) for n in (1000, 4097) for b in (1, 7, 64, 1024)
             for d in (3, 4)]
            + [(4097, b, d) for b in (9, 32) for d in (2, 7)]
            + [(4097, b, 3) for b in (2, 3, 5, 8, 9, 10, 12, 13, 16, 17,
                                      24, 25, 32, 33, 48, 49, 63, 65, 128,
                                      129, 1000)]
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
        route = matvec.matmat_route(b)[0]
        before = dict(matvec.route_launches)
        Y = matvec.streamed_matmat(Xk, scal, BIAS, SN2, V, d)
        _check(matvec.route_launches[route] == before[route] + 1,
               f"K3 at B={b} did not launch its {route} tile: "
               f"{before} -> {matvec.route_launches}")
        ref = matvec.streamed_matmat_plain(Xk.double(), scal.double(), BIAS,
                                           SN2, V.double())
        lim = TOL_K3 * scale * V.double().abs().sum(dim=0)

        def share(out):
            return (out - ref).abs().max(dim=0).values / lim

        err = float((Y.double() - ref).abs().max())
        ratio = float(share(Y.double()).max())
        cratio = float(share(tf32_control(Xk, scal, V)).max())
        sratio = float(share(split_tf32_control(Xk, scal, V)).max())
        print(f"K3 n={n} B={b} d={d} ({route}): max |kernel-plain64| "
              f"{err:.3e}, "
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


#: register widths whose columns must equal those of B = 64 bit for bit:
#: every width of one ex2 split (no exponential on the polynomial from
#: B = 8 on; the narrower tiles put a share there, by the issue model)
K3_BITS_WIDTHS = (8, 9, 12, 16, 17, 31, 32, 33, 63)


def k3_bits(device, seed: int, n: int = 4097):
    """Two K3 passes give equal bits on each route (B = 9, 32, 257,
    1024), and each register width of K3_BITS_WIDTHS gives the bits of
    the same V zero-padded to B = 64 in every column it has."""
    import torch

    from gp_ss_ak_torch.ops import matvec

    g = torch.Generator(device=device).manual_seed(seed + 1)
    for b in (9, 32, 257, 1024):
        Xk, scal, V = _k3_case(g, device, n, b, 3)
        Y = matvec.streamed_matmat(Xk, scal, BIAS, SN2, V, 3)
        _check(torch.equal(Y, matvec.streamed_matmat(Xk, scal, BIAS, SN2,
                                                     V, 3)),
               f"K3 passes differ at n={n} B={b}")
    # the kernel's own output (no bias or noise: torch's column sums of
    # (n, b) and (n, 64) tensors need not agree in bits)
    Xk, scal, V64 = _k3_case(g, device, n, 64, 3)
    Y64 = matvec.streamed_matmat(Xk, scal, 0.0, 0.0, V64, 3)
    for b in K3_BITS_WIDTHS:
        V = V64[:, :b].contiguous()
        Vp = torch.zeros_like(V64)
        Vp[:, :b] = V
        Yp = matvec.streamed_matmat(Xk, scal, 0.0, 0.0, Vp, 3)
        _check(torch.equal(matvec.streamed_matmat(Xk, scal, 0.0, 0.0, V, 3),
                           Yp[:, :b]),
               f"K3's register tile at B = {b} differs from B = 64")
        _check(torch.equal(Yp[:, :b], Y64[:, :b]),
               "K3 at B = 64: column bits depend on the other columns")
    print(f"K3 bits at n={n}: two passes equal at B = 9, 32, 257 and 1024; "
          f"B = {K3_BITS_WIDTHS} each equal to B = 64 in their columns")


def k3_times(device, seed: int, widths=K3_WIDTHS, n: int = N_ITER_TRAIN):
    """CUDA event times of K3 and its plain version at n (N_ITER_TRAIN
    unless given), d = 3, at `widths`, beside the bound; returns ({B:
    (ms, plain ms, bound ms, term)}, the points, scal and the last
    width's V)."""
    import torch

    from gp_ss_ak_torch.ops import matvec

    g = torch.Generator(device=device).manual_seed(seed + 2)
    bias_t, sn2_t = (torch.tensor(v, device=device) for v in (BIAS, SN2))
    Xk, scal, _ = _k3_case(g, device, n, 1, 3)
    out = {}
    for b, iters in widths:
        V = torch.randn(n, b, generator=g, device=device)
        ms = time_ms(lambda: matvec.streamed_matmat(
            Xk, scal, bias_t, sn2_t, V, 3), warmup=1, iters=iters)
        plain_ms = time_ms(lambda: matvec.streamed_matmat_plain(
            Xk, scal, bias_t, sn2_t, V), warmup=1, iters=min(iters, 5))
        b_ms, b_by = bound(matmat_work(n, 3, b), **card_rates())
        pairs = n * n / (ms * 1e-3) / 1e9
        tflops = 2.0 * n * n * b / (ms * 1e-3) / 1e12
        route, w = matvec.matmat_route(b)
        sass = ""
        if route == "register":
            slots = k3_sass_report()[(w, 1)]
            floor = -(-b // w) * sass_floor_ms(n, slots)
            sass = (f"; SASS {slots['total']:.3f} issue slots per Gram "
                    f"entry of width {w} ({-(-b // w)} column group(s)), "
                    f"floor {floor:.4f} ms, kernel at {floor / ms:.3f} of "
                    f"it")
        print(f"K3 time N={n} B={b} d=3 f32 ({route}): kernel {ms:.4f} ms "
              f"({pairs:.1f} Gpairs/s, {tflops:.2f} TFLOP/s of K.V), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms (set by "
              f"{b_by}), kernel at {b_ms / ms:.3f} of it{sass}; "
              f"{sfu_shares(matmat_work(n, 3, b), ms)}")
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
    seg, _, _, _ = k3_times(device, seed, K3_SEG_WIDTHS, n=N_SEG)
    times, Xk, scal, V = k3_times(device, seed)
    print(f"K3 launches by route: {matvec.route_launches}")
    report = {"max_abs_err": worst, **times,
              **{f"{b}@{N_SEG}": t for b, t in seg.items()}}
    report["ms"], report["plain_ms"], report["bound_ms"], \
        report["bound_by"] = times[1024]
    n = Xk.shape[0]
    # does the card hold its clock under the widest pass? One nvidia-smi
    # reading while four queued passes (~1 s) run
    for _ in range(4):
        matvec.streamed_matmat(Xk, scal, BIAS, SN2, V, 3)
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


#: K2's timed sizes (d = 3): the dense width, the K2 path's, the
#: matrix-free path's
K2_TIMED = (N_TRAIN, N_K2_PATH, N_ITER_TRAIN)
#: K2's sizes off the powers of two (d = 3), each also timed under other
#: column slab plans (k2_plans): configuration 3's N, and one past 135168,
#: where an H100's 132 SMs take one 1024-row block each
K2_PLANS_TIMED = (N_SEG, 150000)


def k2_plans(n: int, sms: int):
    """{name: (slab width, slab count)} of K2's column split at n on a
    card of `sms` SMs: ops/matvec.matvec_slabs's plan, 16 slabs, and one
    wave of blocks' worth of slabs, floored."""
    from gp_ss_ak_torch.ops import matvec

    def cut(k):
        per = -(-n // k)
        width = -(-per // matvec.MATVEC_TILE) * matvec.MATVEC_TILE
        return width, -(-n // width)

    rows = -(-n // matvec.MATVEC_ROWS)
    return {"library plan": matvec.matvec_slabs(n, sms), "16 slabs": cut(16),
            "one wave, floored": cut(max(1, sms * matvec.MATVEC_BLOCKS_PER_SM
                                         // rows))}


def k2_time_plan(Xk, scal, v, width: int, slabs: int):
    """(ms, y) of K2's kernel alone, y = s2 exp(-dist) v with no bias or
    noise, launched through the library's C entry with the given column
    slabs (not counted as a launch of the main path)."""
    import torch

    from gp_ss_ak_torch.ops import _build

    lib, n = _build.load(), v.shape[0]
    partial = torch.empty((slabs, n), device=v.device)
    y = torch.empty_like(v)
    stream = torch.cuda.current_stream(v.device).cuda_stream

    def run():
        code = lib.gp_matvec_f32(Xk.data_ptr(), v.data_ptr(), scal.data_ptr(),
                                 partial.data_ptr(), y.data_ptr(), n,
                                 Xk.shape[1], 3, width, slabs,
                                 v.device.index, stream)
        _build.check(lib, code, "matvec kernel launch")

    return time_ms(run, warmup=2, iters=10), y


def sass_floor_ms(n: int, slots) -> float:
    """The issue-slot model of one K2 pass (or of one column group of a
    K3 register tile) from its SASS (phase 2's slots per entry): MUFU
    at SFU_PER_SM_CLOCK an SM a clock and every instruction at 128,
    whichever takes longer, at the card's maximum SM clock."""
    rates = card_rates()
    per_entry = max(slots["MUFU"] / SFU_PER_SM_CLOCK, slots["total"] / 128)
    return n * n * per_entry / (rates["sms"] * rates["clock_hz"]) * 1e3


def phase_k2(device, seed: int, sass):
    """K2 vs its plain version in float64 on the same inputs, held to
    K3's gate per output with the TF32 control that it must reject; two
    passes for equal bits; the diagonal exactly s2 in both classes of
    the ex2 split and across slabs; then CUDA event times at K2_TIMED
    beside the bound, the MUFU-only term, the SASS model (phase 2's
    slots per entry `sass`), K3 at B = 1 on the same inputs and the
    plain version; at K2_PLANS_TIMED the gate as well, and the kernel's
    time under each of k2_plans. Returns the report."""
    import torch

    from gp_ss_ak_torch.ops import matvec

    scale = SIGMA * SIGMA + BIAS
    g = torch.Generator(device=device).manual_seed(seed + 2)
    report = {"max_abs_err": 0.0}
    worst_ratio, ctl_ratio = 0.0, float("inf")
    for n, d in ((1000, 3), (1000, 4), (4097, 2), (4097, 3), (4097, 5),
                 (N_TRAIN, 3), (N_K2_PATH, 3), (N_ITER_TRAIN, 3),
                 *((n, 3) for n in K2_PLANS_TIMED)):
        X = 3.0 * torch.rand(n, d, generator=g, device=device) - 1.5
        Xk, scal = matvec.operator_arrays(X, SIGMA)
        v = torch.randn(n, generator=g, device=device)
        y = matvec.streamed_matvec(Xk, scal, BIAS, SN2, v, d)
        y2 = matvec.streamed_matvec(Xk, scal, BIAS, SN2, v, d)
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
        if n == 4097 and d == 3:
            # K(i, i) = s2 exactly: columns 0-7 of a group cover both
            # classes of the split; 259 and 4096 lie in other slabs
            for i in (*range(8), 259, 4096):
                e = torch.zeros(n, device=device)
                e[i] = 1.0
                yi = matvec.streamed_matvec(Xk, scal, 0.0, 0.0, e, d)
                _check(yi[i].item() == scal.item(),
                       f"K2's diagonal at {i} is {yi[i].item()!r}, not "
                       f"s2 = {scal.item()!r}")
            print(f"K2 n={n} d=3: K(i, i) = s2 exactly in both classes of "
                  f"the split and across slabs")
        if d == 3 and n in K2_TIMED:
            bias_t, sn2_t = (torch.tensor(x, device=device)
                             for x in (BIAS, SN2))
            V = v[:, None].contiguous()
            ms = time_ms(lambda: matvec.streamed_matvec(
                Xk, scal, bias_t, sn2_t, v, d), warmup=3, iters=20)
            k3_ms = time_ms(lambda: matvec.streamed_matmat(
                Xk, scal, bias_t, sn2_t, V, d), warmup=2, iters=10)
            plain_ms = time_ms(lambda: matvec.streamed_matvec_plain(
                Xk, scal, bias_t, sn2_t, v), warmup=1, iters=3)
            b_ms, b_by = bound(matvec_work(n, 3), **card_rates())
            print(f"K2 time N={n} d=3 f32: kernel {ms:.4f} ms "
                  f"({n * n / (ms * 1e-3) / 1e9:.1f} Gpairs/s), bound "
                  f"{b_ms:.4f} ms (set by {b_by}, kernel at "
                  f"{b_ms / ms:.3f} of it), K3 at B = 1 {k3_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms; "
                  f"{sfu_shares(matvec_work(n, 3), ms)}; the SASS model's "
                  f"floor {sass_floor_ms(n, sass):.4f} ms")
            report[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, k3_ms=k3_ms)
        if n in K2_PLANS_TIMED:
            plans = k2_plans(n, card_rates()["sms"])
            times = {}
            for name, plan in plans.items():
                times[name], yp = k2_time_plan(Xk, scal, v, *plan)
                perr = float((yp.double() + BIAS * float(v.double().sum())
                              + SN2 * v.double() - ref).abs().max())
                _check(perr <= lim, f"K2 at n={n} under {name} {plan} "
                       f"disagrees: {perr:.3e} > {lim:.3e}")
            b_ms, b_by = bound(matvec_work(n, 3), **card_rates())
            print(f"K2 time N={n} d=3 f32 by column slab plan (width, "
                  f"count): " + ", ".join(f"{name} {plan}: {times[name]:.4f}"
                                          f" ms" for name, plan in
                                          plans.items())
                  + f"; each within the gate; bound {b_ms:.4f} ms (set by "
                  f"{b_by})")
        del X, Xk, v, y, y2, ref
    print(f"K2: worst error {report['max_abs_err']:.3e}, worst at "
          f"{worst_ratio:.3e} of its limit; the TF32 control at no less "
          f"than {ctl_ratio:.3e} of it")
    report.update(report[N_ITER_TRAIN])
    return report


# ---------------------------------------------------------------------------
# K4, the gradient's contraction (csrc/contraction.cu)
# ---------------------------------------------------------------------------

def contraction_work(n: int, d: int, k: int):
    """K4's work for the n*n ordered pairs at rank k (columns of U and V):
    the records (points, V, cU) read once and [t, g] written once;
    3d + 2k + 6 FP32 instructions an entry (the distance's d differences
    and d multiply-adds, g's d multiply-adds; the guard's compare and
    select, r, W(p, j) and W(j, p) at k FFMA each, t's FFMA, the factor's
    two multiplies), priced at two flops each as `sfu_fma_ms` counts
    them; an rsqrt and an ex2 an entry on the SFU; no product on the
    tensor cores."""
    return 4.0 * n * (2 * d + 2 * k + 1), \
        2.0 * n * n * (3 * d + 2 * k + 6), 2.0 * n * n, 0.0


def _sass() -> str:
    """cuobjdump -sass of the loaded kernel library."""
    from gp_ss_ak_torch.ops import _build

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", _build.load()._name],
                          capture_output=True, text=True, check=True).stdout


_K4_NAME = re.compile(r"contraction_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E")
#: a K3 register tile's template arguments: W, RPT, STEP, MINB, AHEAD, D4
_K3_REG_NAME = re.compile(r"matmat_reg_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi"
                          r"(\d+)ELb(\d)ELi(\d+)E")


@functools.cache
def k3_sass_report():
    """K3's register tiles in ptxas's report (registers; no spill in any
    instance) and their SASS: the issue slots per Gram entry of each
    inner loop (an entry per MUFU.SQRT), by kind. Returns {(W, D4):
    slots per entry by kind (`issue_classes`)}."""
    from gp_ss_ak_torch.ops import _build

    log = _build.build_info.get("log", "")
    found = re.findall(
        r"Compiling entry function '(\S*matmat_reg_kernel\S*)'.*?(\d+) "
        r"bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
        r"loads\s+ptxas info\s+: Used (\d+) registers", log, re.S)
    _check(len(found) > 0, "ptxas reported no K3 register tile")
    for name, stack, st, ld, regs in found:
        w, rpt, step, minb, ahead, d4 = _K3_REG_NAME.search(name).groups()
        print(f"build: K3 register tile <W={w}, RPT={rpt}, STEP={step}, "
              f"MINB={minb}, AHEAD={ahead}, D4={d4}>: {regs} registers, "
              f"stack {stack} bytes, spills {st} bytes stored, {ld} loaded")
        _check(st == ld == "0", f"K3 register tile {name} spills")
    out = {}
    for name, insns in sass_functions(_sass()).items():
        m = _K3_REG_NAME.search(name)
        if m is None:
            continue
        w, rpt, d4 = int(m.group(1)), int(m.group(2)), int(m.group(6))
        loop = innermost_loop(insns, "MUFU")
        _check(loop is not None, f"K3 register tile {name}: no inner loop")
        lhist = opcode_histogram(loop)
        entries = lhist.get("MUFU.SQRT", 0)
        _check(entries > 0, f"K3 register tile {name}: loop {lhist}")
        c = issue_classes(lhist, entries)
        out[(w, d4)] = c
        poly = entries - lhist.get("MUFU.EX2", 0)
        print(f"build: K3 register tile W={w} RPT={rpt} D4={d4}: inner "
              f"loop {len(loop)} instructions, {entries} Gram entries, "
              f"{poly} exponentials on the polynomial; issue slots per "
              f"entry: {_fmt_classes(c)}")
    return out


def k4_sass_report():
    """K4's instances in ptxas's report (registers, spills: none in the
    d <= 3 instances) and their SASS: each opcode histogram (no
    SLOW_OPCODES) and the issue slots per Gram entry of each inner loop
    (an entry per MUFU.RSQ). Returns {(D, MP): slots by kind}."""
    from gp_ss_ak_torch.ops import _build

    log = _build.build_info.get("log", "")
    for name, st, ld in re.findall(
            r"Function properties for (\S*contraction_kernel\S*)\s+\d+ "
            r"bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
            r"spill loads", log):
        m = _K4_NAME.search(name)
        print(f"build: K4 <D={m.group(1)}, MP={m.group(2)}, R={m.group(3)}, "
              f"MINB={m.group(4)}> spills {st} bytes stored, {ld} loaded")
        _check(m.group(1) != "3" or st == ld == "0",
               f"K4 instance {m.groups()} spills")
    out = {}
    for name, insns in sass_functions(_sass()).items():
        m = _K4_NAME.search(name)
        if m is None:
            continue
        hist = opcode_histogram(insns)
        slow = [op for op in hist if op.split(".")[0] in SLOW_OPCODES]
        _check(not slow, f"{name}: {slow} in its SASS")
        loop = innermost_loop(insns, "MUFU")
        _check(loop is not None, f"K4 {m.groups()}: no inner loop found")
        lhist = opcode_histogram(loop)
        entries = lhist.get("MUFU.RSQ", 0)
        _check(entries > 0 and lhist.get("MUFU.EX2", 0) == entries,
               f"K4 {m.groups()}: loop opcodes {lhist}")
        c = issue_classes(lhist, entries)
        out[(int(m.group(1)), int(m.group(2)))] = c
        print(f"build: K4 <D={m.group(1)}, MP={m.group(2)}, R={m.group(3)}>"
              f" inner loop {len(loop)} instructions, {entries} Gram "
              f"entries; issue slots per entry: {_fmt_classes(c)}; loop "
              f"opcodes {lhist}")
    _check((3, 9) in out, f"K4's d <= 3, rank 9 instance not found: {out}")
    return out


def _k4_inputs(device, g, X, k: int):
    """c * U and V of a rank-k contraction on points X: U holds k - 1
    probe solves (normal, scale 3) and alpha, V the probes (+-1) and
    alpha; with (alpha, ws, zs) as `_grad_contraction` takes them."""
    import torch

    n = X.shape[0]
    alpha = torch.randn(n, generator=g, device=device)
    ws = 3.0 * torch.randn(k - 1, n, generator=g, device=device)
    zs = torch.randint(0, 2, (k - 1, n), generator=g, device=device) * 2.0 \
        - 1.0
    coef = torch.tensor([1.0 / (k - 1)] * (k - 1) + [-1.0], device=device)
    cU = (torch.cat([ws.T, alpha[:, None]], 1) * coef).contiguous()
    V = torch.cat([zs.T, alpha[:, None]], 1).contiguous()
    return cU, V, (alpha, ws, zs)


def autograd_contraction(it_gp, alpha, ws, zs, chunk: int = 1024):
    """The gradient's contraction as the port computed it before K4: a
    (chunk, N) Gram block at a time under torch.autograd, in float32 (the
    yardstick of K4's error and time)."""
    import torch

    from gp_ss_ak_torch.kernels.distance import (gram_sqdist,
                                                 highest_precision)

    f32 = torch.float32
    n = alpha.shape[0]
    m = ws.shape[0]
    U = torch.cat([ws.T, alpha[:, None]], 1).to(f32)
    V = torch.cat([zs.T, alpha[:, None]], 1).to(f32)
    coef = torch.cat([torch.full((m,), 1.0 / m, dtype=f32, device=U.device),
                      torch.full((1,), -1.0, dtype=f32, device=U.device)])
    leaves = [t.detach().to(f32).requires_grad_()
              for t in (it_gp.sigma, it_gp.bias, it_gp.sn2, it_gp.Xm)]
    sigma, bias, sn2, Xm = leaves
    cols = torch.arange(n, device=Xm.device)
    total = [torch.zeros_like(t) for t in leaves]
    with torch.enable_grad(), highest_precision():
        for s in range(0, n, chunk):
            rows = Xm[s:s + chunk]
            c = rows.shape[0]
            d2 = gram_sqdist(rows, Xm)
            on_diag = (s + torch.arange(c, device=Xm.device))[:, None] \
                == cols[None, :]
            r = torch.sqrt(torch.where(on_diag, 1.0,
                                       torch.clamp_min(d2, 1e-30)))
            k = sigma * sigma * torch.where(on_diag, 1.0, torch.exp(-r))
            k = k + bias + sn2 * on_diag
            per_col = torch.sum(U[s:s + c] * (k @ V), dim=0)
            val = 0.5 * torch.dot(per_col, coef)
            for acc, gr in zip(total, torch.autograd.grad(val, leaves)):
                acc += gr
    return tuple(total)


def _grad_errors(got, ref):
    """|got - ref| / max |ref| of each of the four gradients."""
    return [float((a.double() - b).abs().max() / b.abs().max())
            for a, b in zip(got, ref)]


def phase_k4(device, seed: int):
    """K4 against its plain version in float64 on the same inputs (t and
    g within TOL_K4 of their largest entries; equal bits over two
    launches) at ragged sizes, the d = 2 padding, the general instance
    (d = 5) and N_K4 at K4_RANKS; then on the ore body mapped by the
    golden model at N_K4, rank 9: the four gradients of
    `_grad_contraction` (one K4 launch) and of the autograd version it
    replaced, each against the closed form in float64; and CUDA event
    times of the kernel, of `_grad_contraction`, of the plain version in
    float32 and of the autograd version, beside the bound
    (`contraction_work`) and the SASS model's floor. Returns the
    report."""
    import torch

    from gp_ss_ak_torch.inference import iterative as ti
    from gp_ss_ak_torch.ops import contraction

    slots = k4_sass_report()
    g = torch.Generator(device=device).manual_seed(seed + 4)
    report = {"max_abs_err": 0.0}
    for n, d, k in ((4097, 3, 9), (4097, 2, 17), (5000, 5, 9),
                    (4097, 3, 33), *((N_K4, 3, k) for k in K4_RANKS)):
        X = 3.0 * torch.rand(n, d, generator=g, device=device) - 1.5
        X[7] = X[3]
        cU, V, _ = _k4_inputs(device, g, X, k)
        t, gr = contraction.expans_contraction(X, cU, V)
        t2, gr2 = contraction.expans_contraction(X, cU, V)
        t64, g64 = contraction.expans_contraction_plain(
            X.double(), cU.double(), V.double())
        errs = [float((a.double() - b).abs().max() / b.abs().max())
                for a, b in ((t, t64), (gr, g64))]
        same = torch.equal(t, t2) and torch.equal(gr, gr2)
        print(f"K4 n={n} d={d} rank {k}: max |kernel-plain64| / max "
              f"|plain64|: t {errs[0]:.3e}, g {errs[1]:.3e} (limit "
              f"{TOL_K4}); two launches "
              f"{'bitwise equal' if same else 'DIFFER'}")
        _check(max(errs) <= TOL_K4, f"K4 disagrees at n={n} d={d} k={k}")
        _check(same, f"K4 launches differ at n={n} d={d} k={k}")
        report["max_abs_err"] = max(report["max_abs_err"], max(errs))
        del X, cU, V, t, t2, gr, gr2, t64, g64
    torch.cuda.empty_cache()

    # the fit's own points: the ore body, standardized, mapped
    Xs, _, _ = _mesh_problem(seed, N_K4)
    it_gp = _iterative_gp(_golden_model(device, torch.float32), Xs, device)
    k = K4_RANKS[0]
    cU, V, (alpha, ws, zs) = _k4_inputs(device, g, it_gp.Xm, k)
    before = contraction.launches
    got = ti._grad_contraction(it_gp, alpha, ws, zs, 1024)
    _check(contraction.launches == before + 1,
           f"_grad_contraction made {contraction.launches - before} K4 "
           f"launches")
    old = autograd_contraction(it_gp, alpha, ws, zs)
    f64 = torch.float64
    t64, g64 = contraction.expans_contraction_plain(
        it_gp.Xm.double(), cU.double(), V.double())
    s = it_gp.sigma.double()
    ref = (s * t64.sum(), 0.5 * torch.dot(cU.double().sum(0),
                                          V.double().sum(0)),
           0.5 * torch.sum(cU.double() * V.double()), -0.5 * s * s * g64)
    e_k4, e_old = _grad_errors(got, ref), _grad_errors(old, ref)
    names = ("sigma", "bias", "sn2", "Xm")
    print(f"K4 N={N_K4} rank {k}, the ore body's mapped points: gradients "
          f"against float64, max |err| / max |ref| (K4 / autograd): "
          + ", ".join(f"{nm} {a:.3e} / {b:.3e}"
                      for nm, a, b in zip(names, e_k4, e_old)))
    worse = [nm for nm, a, b in zip(names, e_k4, e_old) if a > b]
    _check(not worse, f"K4's error exceeds the autograd version's on "
           f"{worse}")
    del t64, g64
    torch.cuda.empty_cache()

    rec, plan = contraction.records(it_gp.Xm, cU, V)
    ms = time_ms(lambda: contraction.run_kernel(rec, plan), warmup=3,
                 iters=20)
    call_ms = time_ms(lambda: ti._grad_contraction(it_gp, alpha, ws, zs,
                                                    1024), warmup=2, iters=10)
    X32 = it_gp.Xm.contiguous()
    plain_ms = time_ms(lambda: contraction.expans_contraction_plain(
        X32, cU, V), warmup=1, iters=2)
    old_ms = time_ms(lambda: autograd_contraction(it_gp, alpha, ws, zs),
                     warmup=1, iters=2)
    work = contraction_work(N_K4, 3, k)
    b_ms, b_by = bound(work, **card_rates())
    rates = card_rates()
    c = slots[(3, 9)]
    floor = N_K4 * N_K4 * max(c["MUFU"] / SFU_PER_SM_CLOCK,
                              c["total"] / 128) / (rates["sms"]
                                                   * rates["clock_hz"]) * 1e3
    rows_pad, width, slices, _, _ = plan
    print(f"K4 time N={N_K4} d=3 rank {k} f32: kernel {ms:.4f} ms "
          f"({N_K4 * N_K4 / (ms * 1e-3) / 1e9:.1f} Gpairs/s; {slices} "
          f"column slices of {width}, {rows_pad} rows), bound {b_ms:.4f} ms "
          f"(set by {b_by}: {3 * 3 + 2 * k + 6} FP32 instructions an entry; "
          f"kernel at {b_ms / ms:.3f} of it), the SASS model's floor "
          f"{floor:.4f} ms ({c['total']:.2f} issue slots an entry; kernel "
          f"at {floor / ms:.3f} of it); _grad_contraction {call_ms:.4f} ms, "
          f"plain f32 {plain_ms:.4f} ms, the autograd version "
          f"{old_ms:.4f} ms")
    report.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                  call_ms=call_ms, autograd_ms=old_ms)
    for k2 in K4_RANKS[1:]:
        cU, V, _ = _k4_inputs(device, g, it_gp.Xm, k2)
        rec, plan = contraction.records(it_gp.Xm, cU, V)
        ms2 = time_ms(lambda: contraction.run_kernel(rec, plan), warmup=2,
                      iters=10)
        b2, _ = bound(contraction_work(N_K4, 3, k2), **card_rates())
        print(f"K4 time N={N_K4} d=3 rank {k2} f32: kernel {ms2:.4f} ms, "
              f"bound {b2:.4f} ms (kernel at {b2 / ms2:.3f} of it)")
    del rec, cU, V
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# K6, the pivoted Cholesky's steps (csrc/pivchol.cu)
# ---------------------------------------------------------------------------

#: (n, rank, d) of K6's gate and times: the main path's
#: (`auto_precond_rank`: 1024 at 100000, 341 at 16384)
K6_CASES = ((100000, 1024, 3), (16384, 341, 3))
#: kernel against the plain loop on the card: the trace of K - L L^T
#: (relative; plus 8 ulps of the type times trace K, the round-off of
#: a residual that is itself round-off at full rank), sampled entries of
#: L L^T (of s2 + bias)
TOL_K6_TRACE, TOL_K6_ENTRY = 1e-4, 1e-4


def pivchol_work(n: int, rank: int, d: int):
    """K6's work for `rank` steps at n points in float32: step j reads
    rows 0..j-1 of L^T (4 n j bytes) and, once, the points (4 n d), d
    (read and written, 8 n) and L^T's row j (4 n written); j FMA a point
    in the dot product and 3d + 7 FP32 operations for the entry and the
    update (two flops each, as `sfu_fma_ms` counts them); a sqrt and an
    exp a point on the SFU; no product on the tensor cores."""
    steps = rank * (rank - 1) / 2.0             # sum_j j
    return 4.0 * n * steps + 4.0 * n * rank * (d + 3), \
        2.0 * n * (steps + rank * (3 * d + 7)), 2.0 * n * rank, 0.0


def _k6_case(device, n: int, seed: int):
    """(points, sigma, bias, sn2): the ore body at n mapped by the golden
    model, as the matrix-free path maps it."""
    import torch

    Xs, _, _ = _mesh_problem(seed, n)
    it_gp = _iterative_gp(_golden_model(device, torch.float32), Xs, device)
    return it_gp.Xm, it_gp.sigma, it_gp.bias, it_gp.sn2


def _k6_compare(L, Lp, s2b: float, sn2, g):
    """K6's factor L against the plain loop's Lp: (pivots equal over the
    first 64 columns, the first column whose pivot differs or None,
    |trace residual kernel - plain|, the plain's trace residual
    trace(K - Lp Lp^T), max |(L L^T - Lp Lp^T)(p, q)| / (s2 + bias) over
    4096 sampled pairs, logdet P of each preconditioner L L^T + sn2 I).
    A column's pivot is read back as its largest entry."""
    import torch

    from gp_ss_ak_torch.inference.iterative import precond_sqrt_pieces

    n, rank = L.shape
    k = min(64, rank, n)
    piv, pivp = L[:, :k].abs().argmax(0), Lp[:, :k].abs().argmax(0)
    same = torch.equal(piv, pivp)
    m = min(rank, n)
    differ = torch.nonzero(L[:, :m].abs().argmax(0)
                           != Lp[:, :m].abs().argmax(0))
    first = int(differ[0, 0]) if differ.numel() else None
    L64, Lp64 = L.double(), Lp.double()
    tr = n * s2b - float((L64 * L64).sum())
    trp = n * s2b - float((Lp64 * Lp64).sum())
    p = torch.randint(0, n, (4096,), generator=g, device=L.device)
    q = torch.randint(0, n, (4096,), generator=g, device=L.device)
    ent = ((L64[p] * L64[q]).sum(1) - (Lp64[p] * Lp64[q]).sum(1)).abs()
    s = torch.as_tensor(sn2, dtype=L.dtype, device=L.device)
    logdets = tuple(float(precond_sqrt_pieces(f, s)[2]) for f in (L, Lp))
    return same, first, abs(tr - trp), trp, float(ent.max()) / s2b, logdets


def phase_k6(device, seed: int):
    """K6 against the plain loop on the card at K6_CASES in float32 and
    float64 (the first 64 pivots, the trace of K - L L^T, 4096 sampled
    entries of L L^T, two calls bit for bit, `rank` launches a call; the
    first step whose pivot differs and both logdet P reported); then
    CUDA event times at K6_CASES beside the bound (`pivchol_work`), the
    plain loop's time and the one-direction sweep's; ptxas's report of
    its instances (no spills). Returns the report."""
    import torch

    from gp_ss_ak_torch.inference import iterative as ti
    from gp_ss_ak_torch.ops import _build, pivchol

    log = _build.build_info.get("log", "")
    spills = re.findall(r"Function properties for (\S*pivchol_step\S*)\s+"
                        r"\d+ bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", log)
    _check(len(spills) == 8, f"ptxas reported {len(spills)} K6 instances")
    for name, st, ld in spills:
        _check(st == ld == "0", f"K6 {name} spills: {st} bytes stored, {ld} "
               f"loaded")
    print(f"build: K6's {len(spills)} instances, no spills")
    g = torch.Generator(device=device).manual_seed(seed + 6)
    report = {"max_abs_err": 0.0}
    rates = card_rates()
    for n, rank, d in K6_CASES:
        X32, sigma, bias, sn2 = _k6_case(device, n, seed)
        s2b = float(sigma) ** 2 + float(bias)
        for dtype in (torch.float32, torch.float64):
            X = X32.to(dtype).contiguous()
            before = pivchol.launches
            L = ti.pivoted_cholesky(X, sigma, bias, rank)
            L2 = ti.pivoted_cholesky(X, sigma, bias, rank)
            _check(pivchol.launches == before + 2 * rank,
                   f"K6 made {pivchol.launches - before} launches for two "
                   f"calls at rank {rank}")
            Lp = ti.pivoted_cholesky_plain(X, sigma, bias, rank)
            same, first, tr_diff, trp, ent, (ld_k, ld_p) = _k6_compare(
                L, Lp, s2b, sn2, g)
            tr_lim = TOL_K6_TRACE * abs(trp) \
                + 8 * torch.finfo(dtype).eps * n * s2b
            bits = torch.equal(L, L2)
            print(f"K6 n={n} rank {rank} d={d} {str(dtype)[6:]}: first "
                  f"{min(64, rank, n)} pivots "
                  f"{'equal' if same else 'DIFFER'}; pivots "
                  + ("all equal" if first is None
                     else f"first differ at step {first}")
                  + f"; trace of K - L L^T {trp:.6e} (plain), kernel - "
                  f"plain {tr_diff:.3e} (limit {tr_lim:.3e}); L L^T "
                  f"entries {ent:.3e} of s2 + bias (limit {TOL_K6_ENTRY}); "
                  f"logdet P (sn2 {float(sn2):.6g}) kernel {ld_k:.9g}, "
                  f"plain {ld_p:.9g}, relative difference "
                  f"{abs(ld_k - ld_p) / abs(ld_p):.3e}; two calls "
                  f"{'bitwise equal' if bits else 'DIFFER'}")
            _check(same, f"K6 pivots differ at n={n} rank {rank}")
            _check(tr_diff <= tr_lim and ent <= TOL_K6_ENTRY,
                   f"K6 disagrees with the plain loop at n={n} rank {rank}")
            _check(bits, f"K6 calls differ at n={n} rank {rank}")
            report["max_abs_err"] = max(report["max_abs_err"], ent)
            del L, L2, Lp
        torch.cuda.empty_cache()

        X = X32.contiguous()
        s = torch.as_tensor(sigma, dtype=X.dtype, device=device)
        scal = torch.stack((s * s, torch.as_tensor(bias, dtype=X.dtype,
                                                   device=device)))
        ld, splits, per_block, blocks = pivchol.pivchol_plan(n, 4)
        before = pivchol.launches
        ms = time_ms(lambda: pivchol.run_kernel(X, scal, rank), warmup=2,
                     iters=5)
        per_call = (pivchol.launches - before) // 7
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pivchol.run_kernel(X, scal, rank)
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        one_way = time_ms(lambda: pivchol.run_kernel(X, scal, rank,
                                                     alternate=False),
                          warmup=1, iters=5)
        plain_ms = time_ms(lambda: ti.pivoted_cholesky_plain(X, sigma, bias,
                                                             rank),
                           warmup=1, iters=2)
        b_ms, b_by = bound(pivchol_work(n, rank, d), **rates)
        print(f"K6 time N={n} rank {rank} d={d} f32: kernel {ms:.4f} ms "
              f"({per_call} launches a call, {blocks} blocks of "
              f"{per_block} points, {splits} k groups; the host's call "
              f"{host_ms:.3f} ms), bound {b_ms:.4f} ms (set by {b_by}; "
              f"kernel at {b_ms / ms:.3f} of it; over 1 means L2 reuse), "
              f"one-direction sweep {one_way:.4f} ms (alternating "
              f"{'wins' if ms < one_way else 'loses'} by "
              f"{one_way - ms:+.4f} ms), plain loop {plain_ms:.4f} ms")
        if n == K6_CASES[0][0]:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by)
        del X, X32
        torch.cuda.empty_cache()
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
    as the fit calls it) at N_TRAIN of a float32 model, which evaluates
    in float64 (optim.api.OBJECTIVE_DTYPE): its host-clock time alone,
    then its device time by profiler range and by kernel."""
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
    labels = {"dense_fit.value_and_grad": "whole evaluation",
              "kernel:gram_kernel": "K1 forward",
              "QuadLogdet.forward": "potrf + solve",
              "QuadLogdet.backward": "QW backward",
              "QuadLogdet.linv": "its trsm (L^-1)",
              "QuadLogdet.ainv": "its GEMM (A^-1)",
              "FusedExpansBiasA.backward": "K1 backward"}
    _, pwall, split, total, top = profile_split(lambda: vg(x), labels)
    text = _split_text(split, labels, pwall, total, top)
    print(f"dense evaluation at N={Xtrs.shape[0]} (float32 model, "
          f"float64 objective), torch.profiler "
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
    from gp_ss_ak_torch.ops import contraction, matvec, pivchol
    from gp_ss_ak_torch.optim import fit

    from gp_ss_ak_torch.optim import api

    model, _, Xtrs, ytrs, _, _ = _load_case(device, torch.float32, train,
                                            test, model_path)
    print(f"mode thresholds on this card (chol, gemm, gemm_bf16 max N): "
          f"{ti._mode_thresholds(device)}; CPU defaults "
          f"{ti._mode_thresholds(None)}")
    torch.cuda.reset_peak_memory_stats()
    timing, log = {}, []
    before, before4 = matvec.launches, contraction.launches
    before6 = pivchol.launches
    make = api.make_iterative_value_and_grad
    api.make_iterative_value_and_grad = _recording(make, log)
    try:
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always", ti.UnconvergedSolveWarning)
            fitted, res = fit(model, Xtrs, ytrs, iters=2,
                              engine="iterative",
                              engine_opts={"mode": "stream"}, timing=timing)
        wall = time.perf_counter() - t0
    finally:
        api.make_iterative_value_and_grad = make
    seen = [w for w in seen
            if issubclass(w.category, ti.UnconvergedSolveWarning)]
    k3 = matvec.launches - before
    k4 = contraction.launches - before4
    k6 = pivchol.launches - before6
    rank = ti.auto_precond_rank(Xtrs.shape[0])
    print(f"iterative fit N={Xtrs.shape[0]} (stream): -logL "
          f"{res.trace[0]:.6f} -> {res.fun:.6f}, {res.n_iters} iterations, "
          f"{res.n_evals} evaluations, stop {res.stop_reason}; per "
          f"evaluation (sn2, CG iterations, rel residual, rank, s): "
          f"{_evaluation_text(log, ITER_FIT_CG_TOL)}; unconverged "
          f"{timing['unconverged_evals']} of {res.n_evals}, largest rel "
          f"residual {timing['max_rel_residual']:.3e}; warnings "
          f"{[str(w.message) for w in seen]}; wall {wall:.3f} s; K3 "
          f"launches {k3}, K4 launches {k4}, K6 launches {k6}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _check(len(seen) == (1 if timing["unconverged_evals"] else 0),
           f"iterative fit: {len(seen)} warnings for "
           f"{timing['unconverged_evals']} unconverged evaluations")
    _check(all(np.isfinite(v) for v in res.trace) and np.isfinite(res.fun)
           and res.fun <= res.trace[0], "iterative fit: bad -logL")
    _check(bool(np.all(np.isfinite(fitted.pack().cpu().numpy()))),
           "iterative fit: non-finite hyperparameters")
    _check(k3 > 0, "iterative fit launched no K3")
    _check(len(log) == res.n_evals, f"{len(log)} evaluations recorded, "
           f"the fit says {res.n_evals}")
    _check(k6 == rank * res.n_evals, f"iterative fit: {k6} K6 launches, "
           f"not {rank} a preconditioner for {res.n_evals} evaluations")
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
    from gp_ss_ak_torch.optim import api

    mode = ti.choose_mode(N_ITER_TRAIN, "auto", torch.device("cuda", 0))
    model_path = os.path.join(workdir, "trained_default")
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    labels = {"iterative_fit.value_and_grad": "evaluations",
              "kernel:gram_kernel": "K1",
              "iterative._materialized_chol": "A + potrf",
              "iterative._grad_contraction": "contraction",
              "cmd_train.predict": "training-set predict"}
    log = []
    make = api.make_iterative_value_and_grad
    api.make_iterative_value_and_grad = _recording(make, log,
                                                   mode == "chol")
    try:
        with contextlib.redirect_stdout(out):
            rc, wall, split, total, top = profile_split(lambda: cli.main(
                ["-v", "1", "train", "-#", "1", itrain, model_path]),
                labels)
    finally:
        api.make_iterative_value_and_grad = make
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
    _check(len(log) == evals, f"{len(log)} evaluations recorded, the CLI "
           f"says {evals}")
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
    _, it, _ = server._solve(y[:, None])
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    print(f"iterative setup split (host clock, synchronized): pivoted "
          f"Cholesky rank {server.precond_rank} {piv_s:.4f} s, alpha "
          f"solve {solve_s:.4f} s ({int(it)} whitened-CG iterations, "
          f"{solve_s / max(int(it), 1) * 1e3:.3f} ms each)")


def phase_warped_eval(device, train: str, test: str, model_path: str):
    """Outside the counted runs, host clock up to a synchronize: one
    warped dense NLML + gradient evaluation (make_value_and_grad, as the
    fit calls it) at N_TRAIN of a float32 model, which evaluates in
    float64, and the warp mix
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
    print(f"warped dense evaluation at N={Xtrs.shape[0]} (float32 model, "
          f"float64 objective, {WARP_LF}): "
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
    and float32, and at the batched paths' own shapes in their own types
    (the ensemble's A in its objective's float64, the rest in float32),
    every member with its own scalars; each member's output bit for bit
    against a 2-D launch on that member; its time at K1_BATCH_TIME in
    float32 beside its bound, and that timed output checked the same
    way. Returns the report."""
    import torch

    from gp_ss_ak_torch.ops import pairwise
    from gp_ss_ak_torch.optim.api import OBJECTIVE_DTYPE

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
            # a batched path's shape, in its type
            own = (OBJECTIVE_DTYPE if (B, n, m) == (ENS_B, ENS_N, None)
                   else torch.float32)
            types = tuple(t for t in types if t[0] == own)
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
    alone through fit(optimizer="JIT"), and one batched evaluation of
    the objective that the fit runs (float64, `OBJECTIVE_DTYPE`): its
    time and its profiled split. Returns the (2-D, batched) K1 launches
    of the counted run."""
    import torch

    from gp_ss_ak_torch.ensemble import fit_ensemble, predict_ensemble
    from gp_ss_ak_torch.kernels.distance import highest_precision
    from gp_ss_ak_torch.model import default_model
    from gp_ss_ak_torch.ops import cholesky, maybe_fused_A
    from gp_ss_ak_torch.optim import fit
    from gp_ss_ak_torch.optim.api import (OBJECTIVE_DTYPE, batched_nlml_fn,
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
    print(f"ensemble fit: {B} deposits x {n} composites, d=3, float32 "
          f"model, float64 objective, maxiter {iters}: {wall:.3f} s wall, "
          f"{res.n_evals} batched evaluations "
          f"({wall / res.n_evals * 1e3:.3f} ms each on average), "
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

    # outside the count: the start, the single fits, the split, all on
    # the objective that the fit evaluates
    dtype = OBJECTIVE_DTYPE
    Xt = torch.as_tensor(Xb, dtype=dtype, device=device)
    yt = torch.as_tensor(yb, dtype=dtype, device=device)
    f = batched_nlml_fn(model)
    x0 = model.pack().detach().to(dtype).expand(B, -1)
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
    # a deposit alone against the batch. The two differ by the round-off
    # of the library calls, which pick other kernels for one matrix than
    # for a batch. The first evaluation of the timed batch is gated
    # against each deposit alone; the fits after `iters` iterations, a
    # path that this round-off steers through the float32 optimizer
    # state, are gated with a float64 model (the first `single` deposits
    # in a batch of their own against each alone) and printed with the
    # float32 one
    vg = batched_value_and_grad(f, Xt, yt)
    vB, gB = vg(x0)
    for b in range(single):
        v1, g1 = batched_value_and_grad(f, Xt[b:b + 1], yt[b:b + 1])(
            x0[b:b + 1])
        dv = float(abs(v1[0] - vB[b]) / max(abs(float(vB[b])), n))
        dg = float((g1[0] - gB[b]).abs().max() / gB[b].abs().max())
        print(f"deposit {b}, first evaluation in float64, alone vs in the "
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
    print(f"ensemble batched evaluation ({B} x {n}, f64): median "
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["-v", "1", "train", "-o", "JIT", "-#", str(iters),
                           train, model_path])
    finally:
        batched_lbfgs.minimize = minimize
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    text = out.getvalue()
    print("cli train -o JIT:", " | ".join(text.strip().splitlines()),
          f"(rc {rc}, {wall:.3f} s wall, file IO included; the objective "
          f"in float64; peak device memory {peak:.3f} GiB)")
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


def _sgpr_case(device, seed: int, n: int, dtype):
    """The ore body's first n composites (training) and N_SGPR_TEST more
    (held out), standardized by the training set's statistics, and the
    golden model with the default noise sn2 = SN2, on `device` in
    `dtype`: (model, X, y, Xq, yq)."""
    import torch

    from gp_ss_ak_torch.data import MODE_SYMMETRIC, apply, prepare
    from gp_ss_ak_torch.model import load_model

    X, y = ore_body(seed, n + N_SGPR_TEST)
    Xs, ys, stats = prepare(X[:n], y[:n], MODE_SYMMETRIC)
    Xq, yq = apply(stats, X[n:], y[n:])
    model = dataclasses.replace(
        load_model(os.path.join(GOLDEN, "model"), device="cpu"),
        lik_hypers=torch.tensor([SN2], dtype=torch.float64))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return model.to(dtype, device), t(Xs), t(ys), t(Xq), t(yq)


def _sgpr_value_and_grad(model, X, y, Z, kernel=None):
    """-ELBO and its gradient in the flat hyperparameters and in Z, as
    one evaluation of fit_sgpr takes them (one host read); `kernel`
    replaces the model's (the same parameters)."""
    import torch

    from gp_ss_ak_torch.inference import sgpr

    kern = kernel or model.kernel
    nk = model.kernel.n_params
    flat = model.pack().detach().clone().requires_grad_()
    Zl = Z.detach().clone().requires_grad_()
    val = sgpr.neg_elbo(kern, kern.unpack(flat[:nk]), flat[nk:nk + 1], X, y,
                        Zl)
    gf, gz = torch.autograd.grad(val, [flat, Zl])
    out = torch.cat([val.detach().reshape(1), gf, gz.reshape(-1)]).cpu()
    return (out[0].item(), out[1:1 + flat.numel()].double().numpy(),
            out[1 + flat.numel():].double().numpy().reshape(Z.shape))


def _eval_ms(fn, reps: int = 3) -> float:
    """Host-clock ms of fn(), which ends in a host read, after a warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_k1_cross(device, seed: int):
    """K1's cross entry at SGPR's Kmn shapes, (m, N_SGPR) for m = M_SGPR
    and M_SGPR_WIDE: against its plain version in float64 and float32
    (phase 3's tolerances), then timed in float32 beside its bound, with
    the time of FusedExpansBiasCross's backward there. Returns the
    report of the m = M_SGPR shape."""
    import torch

    from gp_ss_ak_torch.ops import pairwise
    from gp_ss_ak_torch.ops.fused import fused_expans_bias_cross

    checked = phase_k1(device, seed, cases=[(m, N_SGPR, 3)
                                            for m in (M_SGPR, M_SGPR_WIDE)],
                       time_shapes=False)
    g = torch.Generator(device=device).manual_seed(seed + 19)
    X = 3.0 * torch.rand(N_SGPR, 3, generator=g, device=device) - 1.5
    s_t, b_t = (torch.tensor(v, device=device) for v in (SIGMA, BIAS))
    report = {}
    for m in (M_SGPR, M_SGPR_WIDE):
        Z = X[:m].contiguous()
        ms = time_ms(lambda: pairwise.expans_bias_gram(Z, s_t, b_t, None, X))
        plain_ms = time_ms(lambda: pairwise.expans_bias_gram_plain(
            Z, s_t, b_t, None, X), warmup=2, iters=10)
        b_ms, b_by = bound(gram_work(m, N_SGPR, 3), **card_rates())
        leaves = [t.clone().requires_grad_() for t in (Z, X, s_t, b_t)]
        K = fused_expans_bias_cross(*leaves)
        G = torch.ones_like(K)
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            K, leaves, G, retain_graph=True), warmup=1, iters=5)
        del K, G
        print(f"K1 cross {m}x{N_SGPR} f32 (SGPR Kmn): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms (set by "
              f"{b_by}); kernel at {b_ms / ms:.3f} of it; library call: "
              f"none; FusedExpansBiasCross backward (torch ops) "
              f"{bwd_ms:.4f} ms")
        if m == M_SGPR:
            report = dict(checked, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by)
    torch.cuda.empty_cache()
    return report


def phase_sgpr_fit(device, seed: int, counts):
    """Counted: `fit_sgpr` at N_SGPR composites, M_SGPR inducing points,
    SGPR_ITERS iterations (float32), then `predict` at N_SGPR_TEST
    held-out queries. K1 launches: Kmm and Kmn per evaluation, and Kmm,
    Kmn and Kms for the predict. Then, outside the count, one
    evaluation under torch.profiler and one at M_SGPR_WIDE. Returns the
    counted K1 launches."""
    import torch

    from gp_ss_ak_torch.inference import sgpr

    model, X, y, Xq, yq = _sgpr_case(device, seed, N_SGPR, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, Z, res = sgpr.fit_sgpr(model, X, y, m=M_SGPR, iters=SGPR_ITERS,
                                   seed=seed)
    wall = time.perf_counter() - t0
    fit_k1 = counts()[0] - before[0]
    t1 = time.perf_counter()
    mu, var = sgpr.predict(fitted.kernel, fitted.kernel_params,
                           fitted.lik_hypers, X, y, Z, Xq)
    mse = torch.mean((mu - yq) ** 2).item()
    pred_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    seen = tuple(a - b for a, b in zip(counts(), before))
    var_y = torch.var(yq).item()
    trace = res.trace
    marks = ", ".join(f"{i}: {trace[i]:.3f}" for i in
                      sorted({0, *range(10, len(trace), 10), len(trace) - 1}))
    print(f"SGPR fit at N={N_SGPR}, m={M_SGPR} f32 ({SGPR_ITERS} "
          f"iterations): {wall:.3f} s, {res.n_iters} iterations, "
          f"{res.n_evals} evaluations ({wall / res.n_evals * 1e3:.3f} ms "
          f"each, host clock), stop reason {res.stop_reason}; -ELBO by "
          f"iteration {marks}; peak device memory {peak:.3f} GiB; predict "
          f"of {N_SGPR_TEST} held-out queries {pred_s * 1e3:.3f} ms, MSE "
          f"{mse:.6f} (limit {MSE_MAX * var_y:.6f} = {MSE_MAX} var(y)); "
          f"fitted sn2 {fitted.lik_hypers[0].item():.6f}")
    _check(res.fun < res.trace[0], "SGPR fit: the bound did not improve")
    _check(mse < MSE_MAX * var_y, f"SGPR holdout MSE {mse} too large")
    _check(bool(torch.isfinite(mu).all() and (var >= 0).all()),
           "SGPR predict: non-finite mean or negative variance")
    want = (2 * res.n_evals + 3, 0, 0)
    _check(seen == want and fit_k1 == 2 * res.n_evals,
           f"SGPR fit + predict: expected {want[0]} K1 launches (Kmm and "
           f"Kmn for each of {res.n_evals} evaluations, Kmm, Kmn and Kms "
           f"for the predict) and no K2 or K3; saw (K1, K2, K3) = {seen}")

    def one():
        return _sgpr_value_and_grad(fitted, X, y, Z)

    whole = _eval_ms(one)
    labels = {"kernel:gram_kernel": "K1 forward (Kmm, Kmn)",
              "FusedExpansBiasCross.backward": "K1 cross backward",
              "FusedExpansBiasA.backward": "K1 Kmm backward"}
    _, pwall, split, total, top = profile_split(one, labels)
    print(f"SGPR evaluation at N={N_SGPR}, m={M_SGPR} f32: {whole:.3f} ms "
          f"(host clock, unprofiled); under torch.profiler "
          f"{_split_text(split, labels, pwall, total, top)}")
    Zw = sgpr.init_inducing(X, M_SGPR_WIDE, seed)
    torch.cuda.reset_peak_memory_stats()
    wide = _eval_ms(lambda: _sgpr_value_and_grad(fitted, X, y, Zw))
    print(f"SGPR evaluation at N={N_SGPR}, m={M_SGPR_WIDE} f32 (the widest "
          f"cell of sgpr_sweep_row): {wide:.3f} ms (host clock), peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    torch.cuda.empty_cache()
    return seen[0]


def _coincident_noise_rows(K, scale):
    """Rows of K with a pair at distance zero where the Gram expansion
    left round-off (|K - scale| tiny but not zero)."""
    gap = (K - scale).abs()
    return ((gap < 1e-6) & (gap > 0)).any(dim=1).nonzero().flatten()


def _rows_close(got, want, noisy, what: str):
    """got within CROSS_BWD_RTOL of want's largest entry, the `noisy`
    rows within CROSS_BWD_NOISY_RTOL of it; returns the worst share."""
    import torch

    scale = want.abs().max().item()
    keep = torch.ones(want.shape[0], dtype=torch.bool, device=want.device)
    keep[noisy] = False
    err = (got - want).abs()
    worst = err[keep].max().item() / scale
    worst_noisy = err[~keep].max().item() / scale if len(noisy) else 0.0
    _check(worst <= CROSS_BWD_RTOL and worst_noisy <= CROSS_BWD_NOISY_RTOL,
           f"cross-Gram backward disagrees in {what}: {worst:.2e} "
           f"(noisy rows {worst_noisy:.2e}) of its largest entry")
    return worst, worst_noisy


def phase_sgpr_correct(device, seed: int):
    """SGPR at N_TRAIN, m = M_SGPR (outside the counted runs): the
    float32 bound and gradient through K1 against float64 through
    kernel.matrix (the generic Gram, no K1); the float64 bound below the
    exact evidence (dense float64 NLML); FusedExpansBiasCross's backward
    against autograd through kernel.matrix in float64 at Z subsets of X
    (coincident pairs), m = M_SGPR and M_SGPR_WIDE."""
    import torch

    from gp_ss_ak_torch.inference import gaussian, sgpr
    from gp_ss_ak_torch.kernels import Sum
    from gp_ss_ak_torch.ops.fused import maybe_fused_cross

    m64, X64, y64, _, _ = _sgpr_case(device, seed, N_TRAIN, torch.float64)
    m32 = m64.to(torch.float32, device)
    X32, y32 = X64.float(), y64.float()
    Z64 = sgpr.init_inducing(X64, M_SGPR, seed)
    # the same model through the generic Gram: a Sum that is not the
    # flagship takes kernel.matrix
    generic = Sum([m64.kernel])
    v32, gf32, gz32 = _sgpr_value_and_grad(m32, X32, y32, Z64.float())
    v64, gf64, gz64 = _sgpr_value_and_grad(m64, X64, y64, Z64, generic)
    vfused, _, _ = _sgpr_value_and_grad(m64, X64, y64, Z64)
    dv = abs(v32 - v64) / abs(v64)
    dgf = np.abs(gf32 - gf64).max() / np.abs(gf64).max()
    dgz = np.abs(gz32 - gz64).max() / np.abs(gz64).max()
    nlml = gaussian.nlml(m64.kernel, m64.kernel_params, m64.lik_hypers, X64,
                         y64).item()
    print(f"SGPR at N={N_TRAIN}, m={M_SGPR}: -ELBO f32 through K1 "
          f"{v32:.6f}, f64 through kernel.matrix {v64:.6f} (f64 through "
          f"K1 {vfused:.6f}): value {dv:.2e} relative (limit "
          f"{SGPR_F32_VAL_REL}), hyperparameter gradient {dgf:.2e} of its "
          f"largest (limit {SGPR_F32_GRAD_REL}), Z gradient {dgz:.2e} of "
          f"its largest (limit {SGPR_F32_Z_REL}); exact NLML (dense f64) "
          f"{nlml:.6f}, so ELBO - (-NLML) = {-v64 + nlml:.6f}")
    _check(dv <= SGPR_F32_VAL_REL, "SGPR f32 bound disagrees with f64")
    _check(dgf <= SGPR_F32_GRAD_REL and dgz <= SGPR_F32_Z_REL,
           "SGPR f32 gradient disagrees with f64")
    _check(-v64 <= -nlml + SGPR_BOUND_SLACK * abs(nlml),
           "SGPR bound above the exact evidence")

    s2b = (m64.kernel_params[0]["Sigma"] ** 2
           + m64.kernel_params[1]["Sigma"]).item()
    g = torch.Generator(device=device).manual_seed(seed + 21)
    for m in (M_SGPR, M_SGPR_WIDE):
        Zc = sgpr.init_inducing(X64, m, seed)
        G = torch.randn(m, N_TRAIN, generator=g, device=device,
                        dtype=torch.float64)
        out = []
        for build in (maybe_fused_cross,
                      lambda k, p, A, B: k.matrix(p, A, B, same=False)):
            flat = m64.pack().detach().clone().requires_grad_()
            A = Zc.clone().requires_grad_()
            B = X64.clone().requires_grad_()
            nk = m64.kernel.n_params
            K = build(m64.kernel, m64.kernel.unpack(flat[:nk]), A, B)
            out.append((K.detach(), *torch.autograd.grad(
                (K * G).sum(), [flat, A, B])))
            del K
        (Kf, gf_f, gA_f, gB_f), (Kg, gf_g, gA_g, gB_g) = out
        pairs = int(((Kg - s2b).abs() < 1e-6).sum())
        noisy_a = _coincident_noise_rows(Kg, s2b)
        noisy_b = _coincident_noise_rows(Kg.T, s2b)
        wf = (gf_f - gf_g).abs().max().item() / gf_g.abs().max().item()
        _check(wf <= CROSS_BWD_RTOL, f"cross-Gram backward disagrees in the "
               f"hyperparameters: {wf:.2e}")
        wa = _rows_close(gA_f, gA_g, noisy_a, "Z")
        wb = _rows_close(gB_f, gB_g, noisy_b, "X")
        print(f"FusedExpansBiasCross backward at {m}x{N_TRAIN} f64 vs "
              f"autograd through kernel.matrix: {pairs} coincident pairs "
              f"({len(noisy_a)} left round-off by the expansion); "
              f"hyperparameters {wf:.2e}, Z {wa[0]:.2e} (those rows "
              f"{wa[1]:.2e}), X {wb[0]:.2e} ({wb[1]:.2e}) of each largest "
              f"entry (limits {CROSS_BWD_RTOL}, {CROSS_BWD_NOISY_RTOL})")
        _check(pairs == m, "the inducing subset gives no coincident pairs")
        del out, G
    torch.cuda.empty_cache()
    return m32, X32, y32, Z64.float()


def phase_laplace(device, seed: int, counts):
    """Counted: Laplace at N_TRAIN in float64 (the dense wall): the
    Laplace NLML with Gaussian.log_prob against the exact NLML, the
    latent prediction (plus sn2) at N_SGPR_TEST queries against dense
    `predict`, and with WarpedGaussian.log_prob on exp(0.8 y) against
    the warped exact NLML. K1 launches: K for the Laplace NLML, A for
    each exact NLML, K and kX for predict_latent, A and the cross-Gram
    for the dense predict, and kX again for the mean through
    predict_latent's alpha_hat. Returns its K1 launches."""
    import torch

    from gp_ss_ak_torch.inference import gaussian, laplace
    from gp_ss_ak_torch.inference.likelihoods import WarpedGaussian

    model, X, y, Xq, _ = _sgpr_case(device, seed, N_TRAIN, torch.float64)
    kern, kp, lh = model.kernel, model.kernel_params, model.lik_hypers
    lik = model.likelihood
    before = counts()
    t0 = time.perf_counter()
    K = gaussian._noisy_gram(kern, kp, 0.0, X)
    st = {}
    lap = laplace.nlml(K, y, lambda yy, f: lik.log_prob(lh, yy, f),
                       stats=st).item()
    exact = gaussian.nlml(kern, kp, lh, X, y, lik).item()
    t_nlml = time.perf_counter() - t0
    wl = WarpedGaussian()
    wh = wl.default_hypers(torch.float64, device)
    yw = torch.exp(0.8 * y)
    stw = {}
    t0 = time.perf_counter()
    lap_w = laplace.nlml(K, yw, lambda yy, f: wl.log_prob(wh, yy, f),
                         stats=stw).item()
    exact_w = gaussian.nlml(kern, kp, wh, X, yw, wl).item()
    t_warp = time.perf_counter() - t0
    del K
    stp = {}
    t0 = time.perf_counter()
    mu, var = laplace.predict_latent(
        kern, kp, X, y, lambda yy, f: lik.log_prob(lh, yy, f), Xq,
        stats=stp)
    t_pred = time.perf_counter() - t0
    mu_e, var_e = gaussian.predict(kern, kp, lh, X, y, Xq, lik)
    mu_a = gaussian._cross_gram(kern, kp, X, Xq).T @ stp["alpha"]
    seen = tuple(a - b for a, b in zip(counts(), before))
    dmu = ((mu - mu_e).abs().max() / mu_e.abs().max()).item()
    dmu_a = ((mu_a - mu_e).abs().max() / mu_e.abs().max()).item()
    dvar = ((var + lh[0] - var_e).abs().max() / var_e.abs().max()).item()
    print(f"Laplace at N={N_TRAIN} f64: NLML {lap:.10f} vs exact "
          f"{exact:.10f} ({abs(lap - exact) / abs(exact):.2e} relative, "
          f"limit {LAPLACE_NLML_RTOL}; {st['newton_iters']} Newton "
          f"iterations, {st['halvings']} halvings; {t_nlml:.3f} s for both); "
          f"warped on exp(0.8 y): {lap_w:.10f} vs {exact_w:.10f} "
          f"({abs(lap_w - exact_w) / abs(exact_w):.2e}; "
          f"{stw['newton_iters']} Newton iterations, {stw['halvings']} "
          f"halvings; {t_warp:.3f} s); predict_latent at {N_SGPR_TEST} "
          f"queries {t_pred:.3f} s ({stp['newton_iters']} Newton "
          f"iterations): mean kX^T alpha_hat {dmu_a:.2e} (limit "
          f"{LAPLACE_PRED_RTOL}), mean kX^T dlp {dmu:.2e} (limit "
          f"{LAPLACE_MEAN_RTOL}), variance + sn2 {dvar:.2e} (limit "
          f"{LAPLACE_PRED_RTOL}) of the dense predict's largest")
    _check(abs(lap - exact) <= LAPLACE_NLML_RTOL * abs(exact),
           "Laplace NLML differs from the exact NLML")
    _check(abs(lap_w - exact_w) <= LAPLACE_NLML_RTOL * abs(exact_w),
           "warped Laplace NLML differs from the warped exact NLML")
    _check(dmu_a <= LAPLACE_PRED_RTOL and dmu <= LAPLACE_MEAN_RTOL
           and dvar <= LAPLACE_PRED_RTOL,
           "Laplace latent prediction differs from the dense predict")
    want = (8, 0, 0)
    _check(seen == want, f"Laplace: expected 8 K1 launches (K, two exact "
           f"NLMLs, K and kX, A and the cross-Gram, kX for the alpha_hat "
           f"mean) and no K2 or K3; saw (K1, K2, K3) = {seen}")
    torch.cuda.empty_cache()
    return seen[0]


def _quantization_norm(A16, A32, iters: int = 30) -> float:
    """Spectral norm of the bfloat16 store's error, ||K_bf16 - K_f32||_2,
    by power iteration over row blocks (no second float32 matrix)."""
    import torch

    from gp_ss_ak_torch.ops import matvec

    n = A32.shape[0]
    rows = max(1, matvec.NARROW_BUILD_ELEMS // n)
    v = torch.ones(n, device=A32.device) / n ** 0.5
    norm = 0.0
    for _ in range(iters):
        w = torch.cat([(A16[s:s + rows].float() - A32[s:s + rows]) @ v
                       for s in range(0, n, rows)])
        norm = torch.linalg.norm(w).item()
        v = w / norm
    return norm


def phase_gemm_bf16(device, seed: int, itrain: str, itest: str,
                    imodel: str, counts):
    """The opt-in gemm_bf16 mode on the matrix-free case at N_ITER_TRAIN:
    its matvec against the float32 store's, and its quantization's
    spectral norm; then, counted, nlml_and_grad_iterative in gemm_bf16
    and in gemm mode with the same probes, at the case's noise SN2
    (printed: the quantization exceeds sn2 there, so A_bf16 is
    indefinite, as the JAX package documents, iterative.py:675-683) and
    at BF16_SN2, where A_bf16 stays positive definite (gated). Returns
    the K1 launches of the four runs."""
    import torch

    from gp_ss_ak_torch.inference import iterative as ti
    from gp_ss_ak_torch.ops import matvec

    model, _, Xtrs, ytrs, _, _ = _load_case(device, torch.float32, itrain,
                                            itest, imodel)
    gp = _iterative_gp(model, Xtrs, device)
    y = torch.as_tensor(ytrs, dtype=torch.float32, device=device)
    n = y.shape[0]
    g = torch.Generator(device=device).manual_seed(seed)
    v_rand = torch.randn(n, generator=g, device=device)
    ops = {dt: matvec.MaterializedOperator(gp.Xm, gp.sigma, gp.bias, gp.sn2,
                                           store_dtype=dt)
           for dt in (torch.float32, torch.bfloat16)}
    rel = {}
    for name, v in (("y", y), ("randn", v_rand)):
        ref = ops[torch.float32](v)
        rel[name] = (torch.linalg.norm(ops[torch.bfloat16](v) - ref)
                     / torch.linalg.norm(ref)).item()
    q = _quantization_norm(ops[torch.bfloat16].A, ops[torch.float32].A)
    del ops
    torch.cuda.empty_cache()
    print(f"gemm_bf16 at N={n}: |K_bf16 v - K_f32 v| / |K_f32 v| = "
          f"{rel['y']:.3e} for v = y, the right-hand side of every solve "
          f"(limit {BF16_MATVEC_REL}); not gated: {rel['randn']:.3e} for a "
          f"standard normal v (its size depends on how much K v cancels); "
          f"||K_bf16 - K_f32||_2 = {q:.4f} (power iteration), against sn2 "
          f"{SN2} of the case and {BF16_SN2}")
    _check(rel["y"] <= BF16_MATVEC_REL, "gemm_bf16 matvec disagrees")
    Zt, Zl = ti.rademacher(g, (n, 8)), ti.rademacher(g, (n, 64))
    out = {}
    k1 = 0
    for sn2 in (SN2, BF16_SN2):
        gps = gp._replace(sn2=torch.tensor(sn2, device=device))
        for mode in ("gemm", "gemm_bf16"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            val, grads, st = ti.nlml_and_grad_iterative(
                gps, y, None, None, mode=mode, Z_logdet=Zl, Z_trace=Zt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            seen = tuple(a - b for a, b in zip(counts(), before))
            k1 += seen[0]
            peak = torch.cuda.max_memory_allocated()
            out[sn2, mode] = ([float(x) for x in grads[:3]], grads[3], st,
                              seen)
            out[sn2, mode, "value"] = float(val)
            print(f"mode {mode} at N={n}, sn2 {sn2}: value {float(val):.6f} "
                  f"(not gated: the bf16 SLQ logdet is biased), d(sigma, "
                  f"bias, sn2) {out[sn2, mode][0]}, {st.cg_iters} CG "
                  f"iterations, rel residual {float(st.rel_residual):.3e}, "
                  f"{wall:.3f} s, peak {peak / 2 ** 30:.3f} GiB (2 N^2 bytes "
                  f"= {2 * n * n / 2 ** 30:.3f} GiB, 4 N^2 = "
                  f"{4 * n * n / 2 ** 30:.3f} GiB), (K1, K2, K3) launches "
                  f"{seen}")
        gg, xg, _, seen_g = out[sn2, "gemm"]
        gb, xb, stb, seen_b = out[sn2, "gemm_bf16"]
        dx = ((xb - xg).abs().max() / xg.abs().max()).item()
        d = [abs(gb[i] - gg[i]) / abs(gg[i]) for i in (0, 2)]
        print(f"gemm_bf16 vs gemm at sn2 {sn2}: d sigma {d[0]:.2e}, d sn2 "
              f"{d[1]:.2e} relative (limit {BF16_GRAD_REL}), d Xm {dx:.2e} "
              f"of its largest (limit {BF16_XM_REL}); d bias "
              f"|{gb[1] - gg[1]:.3e}| (the float32 cancellation of phase "
              f"10){'; not gated at the case noise' if sn2 == SN2 else ''}")
        rows = max(1, matvec.NARROW_BUILD_ELEMS // n)
        want = (-(-n // rows), 0, 0)
        _check(seen_b == want and seen_g == (1, 0, 0),
               f"gemm_bf16 evaluation: expected {want[0]} K1 launches (K in "
               f"blocks of {rows} rows) and no K2 or K3, and gemm's one; saw "
               f"(K1, K2, K3) = {seen_b} and {seen_g}")
    # at the case's noise A_bf16 is indefinite and CG fails (residual
    # >= 1): the evaluation is NaN, where the JAX package returns its
    # zero start's gradient; at BF16_SN2 it converges
    _, _, st_case, _ = out[SN2, "gemm_bf16"]
    val_case = out[SN2, "gemm_bf16", "value"]
    print(f"gemm_bf16 at sn2 {SN2}: rel residual "
          f"{float(st_case.rel_residual):.3e}, value {val_case!r}, solve "
          f"{ti.solve_state(st_case.rel_residual, ti.BF16_CG_TOL_FLOOR)}")
    _check(ti.solve_state(st_case.rel_residual, ti.BF16_CG_TOL_FLOOR)
           == "failed" and np.isnan(val_case)
           and all(np.isnan(x) for x in out[SN2, "gemm_bf16"][0])
           and bool(torch.isnan(out[SN2, "gemm_bf16"][1]).all()),
           f"gemm_bf16 at sn2 {SN2}: a failed solve must give a NaN value "
           "and gradient")
    _check(float(stb.rel_residual) <= ti.BF16_CG_TOL_FLOOR
           and stb.cg_iters < 800,
           f"gemm_bf16 CG at sn2 {BF16_SN2} did not reach its floor")
    _check(max(d) <= BF16_GRAD_REL and dx <= BF16_XM_REL,
           f"gemm_bf16 gradient at sn2 {BF16_SN2} disagrees with gemm's")
    torch.cuda.empty_cache()
    return k1


def phase_sgpr_vs_exact(device, seed: int, itrain: str, itest: str,
                        imodel: str):
    """Outside the counted runs: SGPR (m = M_SGPR, SGPR_ITERS iterations)
    against the matrix-free exact fit (`fit(engine="iterative")`, which
    resolves to chol mode on an 80 GB card, EXACT_ITERS iterations, then
    the IterativePredictor's mean) on the matrix-free case at
    N_ITER_TRAIN, from the same starting model: each one's wall (fit and
    predict, host clock) and holdout MSE on the case's test queries, in
    the grade's own units. Printed, not gated."""
    import torch

    from gp_ss_ak_torch.data import unapply_y
    from gp_ss_ak_torch.inference import sgpr
    from gp_ss_ak_torch.optim import fit
    from gp_ss_ak_torch.serve import IterativePredictor

    model, stats, Xtrs, ytrs, Xts, yt = _load_case(device, torch.float32,
                                                   itrain, itest, imodel)
    n = Xtrs.shape[0]
    var_y = float(np.var(yt))
    rows = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fs, Z, rs = sgpr.fit_sgpr(model, Xtrs, ytrs, m=M_SGPR, iters=SGPR_ITERS,
                              seed=seed)
    mu, _ = sgpr.predict(fs.kernel, fs.kernel_params, fs.lik_hypers,
                         torch.as_tensor(Xtrs, dtype=torch.float32,
                                         device=device),
                         torch.as_tensor(ytrs, dtype=torch.float32,
                                         device=device),
                         Z, torch.as_tensor(Xts, dtype=torch.float32,
                                            device=device))
    mse = float(np.mean((unapply_y(stats, mu.cpu().double().numpy())
                         - yt) ** 2))
    rows.append(("SGPR m=512", time.perf_counter() - t0, mse, rs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fe, re_ = fit(model, Xtrs, ytrs, engine="iterative", iters=EXACT_ITERS)
    mu, _ = IterativePredictor(fe, Xtrs, ytrs)(Xts, mean_only=True)
    mse = float(np.mean((unapply_y(stats, np.asarray(mu, np.float64))
                         - yt) ** 2))
    rows.append(("matrix-free exact", time.perf_counter() - t0, mse, re_))
    for name, wall, mse, r in rows:
        print(f"{name} at N={n}: fit + predict {wall:.3f} s ({r.n_iters} "
              f"iterations, {r.n_evals} evaluations, {r.stop_reason}), "
              f"holdout MSE {mse:.6g} = {mse / var_y:.4f} var(y) on "
              f"{len(yt)} queries; var(y) / MSE per second "
              f"{var_y / mse / wall:.4f}")
    torch.cuda.empty_cache()


def phase_utils(device, train: str, test: str, model_path: str, workdir: str,
                sgpr_case):
    """utils/ on the card (outside the counted runs): a profiler trace of
    one SGPR evaluation; `fit(checkpoint_path=...)` on the dense case
    writes a checkpoint and `resume=True` restarts from it; nan_debug
    raises at a NaN made on the card."""
    import torch

    from gp_ss_ak_torch.optim import fit
    from gp_ss_ak_torch.utils.checkpoint import load_fit_checkpoint
    from gp_ss_ak_torch.utils.debug import nan_debug
    from gp_ss_ak_torch.utils.profiling import TRACE_FILE, trace

    model, X, y, Z = sgpr_case
    os.makedirs(workdir, exist_ok=True)
    tdir = os.path.join(workdir, "trace")
    with trace(tdir):
        _sgpr_value_and_grad(model, X, y, Z)
    text = open(os.path.join(tdir, TRACE_FILE)).read()
    _check("gram_kernel" in text, "the trace holds no K1 kernel")
    print(f"utils.profiling.trace: {len(text)} bytes of Chrome trace for one "
          f"SGPR evaluation, {text.count('gram_kernel')} mentions of K1")

    dense, _, Xtrs, ytrs, _, _ = _load_case(device, torch.float32, train,
                                            test, model_path)
    ck = os.path.join(workdir, "fit_checkpoint")
    for ext in (".npz", ".json"):
        if os.path.exists(ck + ext):
            os.remove(ck + ext)
    t0 = time.perf_counter()
    _, r1 = fit(dense, Xtrs, ytrs, iters=2, engine="dense",
                checkpoint_path=ck, checkpoint_every=1)
    saved = load_fit_checkpoint(ck)
    _check(saved is not None and 1 <= saved["iteration"] <= r1.n_iters,
           "fit wrote no checkpoint")
    _, r2 = fit(dense, Xtrs, ytrs, iters=1, engine="dense",
                checkpoint_path=ck)
    rel = abs(r2.trace[0] - saved["fun"]) / abs(saved["fun"])
    print(f"checkpoint: fit(iters=2) at N={Xtrs.shape[0]} f32 saved "
          f"iteration {saved['iteration']} (-logL {saved['fun']:.6f}); the "
          f"resumed fit started at -logL {r2.trace[0]:.6f} ({rel:.1e} "
          f"relative); {time.perf_counter() - t0:.3f} s for both")
    _check(rel <= 1e-6, "the resumed fit did not start at the checkpoint")
    x = torch.tensor([1.0, -1.0], device=device)
    try:
        with nan_debug():
            torch.log(x)
    except FloatingPointError as e:
        print(f"nan_debug on the card: raised {e}")
    else:
        raise AssertionError("nan_debug did not raise at a NaN on the card")
    torch.cuda.empty_cache()


def run_sparse(device, seed: int, zero, counts, dense_case, icase):
    """The sparse phases (19-24): K1's cross entry at SGPR's shapes, the
    counted SGPR fit, SGPR's correctness at N_TRAIN, the counted Laplace
    and gemm_bf16 runs, SGPR against the exact fit, and utils/.
    `dense_case` and `icase` are the (train, test, model) files at
    N_TRAIN and N_ITER_TRAIN. Returns (the K1 launches of the counted
    runs, the cross-entry report)."""
    import torch

    train, test, model_path = dense_case
    itrain, itest, imodel = icase
    t0 = time.perf_counter()
    cross = phase_k1_cross(device, seed)
    zero()
    k1 = phase_sgpr_fit(device, seed, counts)
    sgpr_case = phase_sgpr_correct(device, seed)
    zero()
    k1 += phase_laplace(device, seed, counts)
    zero()
    k1 += phase_gemm_bf16(device, seed, itrain, itest, imodel, counts)
    phase_sgpr_vs_exact(device, seed, itrain, itest, imodel)
    phase_utils(device, train, test, model_path, WORK + "_sparse", sgpr_case)
    torch.cuda.empty_cache()
    print(f"sparse phases done in {time.perf_counter() - t0:.1f} s")
    return k1, cross


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
    Returns its (K1, K3, K4, K6) launches."""
    from gp_ss_ak_torch.inference.iterative import auto_precond_rank
    from gp_ss_ak_torch.ops import contraction, pivchol

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
    _check(contraction.launches > 0, "default train route launched no K4")
    # a preconditioner an evaluation and one for the training-set
    # predict's IterativePredictor, none in chol mode
    rank = auto_precond_rank(N_ITER_TRAIN)
    want6 = 0 if mode == "chol" else rank * (n_evals + 1)
    print(f"default train route: K6 launches {pivchol.launches} (expected "
          f"{want6}: {mode} mode, {n_evals} evaluations)")
    _check(pivchol.launches == want6, f"default train route: "
           f"{pivchol.launches} K6 launches, not {want6}")
    return counts()[0], counts()[2], contraction.launches, pivchol.launches


# ---------------------------------------------------------------------------
# the mesh engines (parallel/): phases 25-30
# ---------------------------------------------------------------------------

def _golden_model(device, dtype):
    """The golden ExpAns+Bias hyperparameters with the default noise,
    on `device` in `dtype`."""
    import torch

    from gp_ss_ak_torch.model import load_model

    model = load_model(os.path.join(GOLDEN, "model"), dtype, device)
    return dataclasses.replace(model, lik_hypers=torch.tensor(
        [SN2], dtype=dtype, device=device))


def _mesh_problem(seed: int, n: int, n_query: int = 0):
    """The ore body at n training points, standardized as the CLI does,
    and n_query held-out queries in the same frame."""
    from gp_ss_ak_torch.data import MODE_SYMMETRIC, apply, prepare

    X, y = ore_body(seed, n + n_query)
    Xs, ys, stats = prepare(X[:n], y[:n], MODE_SYMMETRIC)
    return Xs, ys, apply(stats, X[n:])


def _mesh_inputs(seed: int):
    """The inputs of the phases run at MESH_RANKS ranks (one launch):
    the float64 dist and ring problem at N_DIST64 (with the ring's
    probes) and the two-level problem at N_TWO."""
    import torch

    from gp_ss_ak_torch.parallel import ring

    X, y, Xq = _mesh_problem(seed, N_DIST64, MESH_QUERIES)
    X2, y2, _ = _mesh_problem(seed + 1, N_TWO)
    flat = _golden_model("cpu", torch.float64).pack().numpy()
    Z, Zl = ring.draw_probes(seed, N_DIST64, RING_PROBES, RING_SLQ_PROBES)
    flats2 = np.stack([flat, np.clip(flat * 1.2, 1e-4, 6.0)])
    return dict(X=X, y=y, Xq=Xq, flat=flat, Z=Z.numpy(), Zl=Zl.numpy(),
                X2=X2, y2=y2, flats2=flats2)


def _ring64_opts(data):
    return dict(precond_rank=RING64_RANK, probes=RING_PROBES,
                slq_probes=RING_SLQ_PROBES, lanczos_iters=32,
                cg_tol=RING64_CG_TOL, cg_maxiter=2000, Z=data["Z"],
                Zl=data["Zl"])


def mesh_tasks(mesh, data, two=None):
    """What every rank of a mesh computes on `data` (float64): the dist
    NLML and gradient at N_DIST64 with its predict, the ring NLML and
    gradient and the ring predict, and on a TwoLevelMesh `two` the
    two-level dist and ring evaluations at N_TWO. Returns {name: numpy
    array}; the K1 launches made under "k1"."""
    import torch

    from gp_ss_ak_torch import parallel as tp
    from gp_ss_ak_torch.ops import pairwise

    model = _golden_model(mesh.device, torch.float64)
    k, lik = model.kernel, model.likelihood
    flat = torch.as_tensor(data["flat"], device=mesh.device)
    out = {}
    before = pairwise.launches
    Xl, yl, n, _ = tp.shard_training_data(mesh, torch.as_tensor(data["X"]),
                                          torch.as_tensor(data["y"]),
                                          nb=DIST_NB)
    v, g = tp.make_dist_nlml_and_grad(k, lik, mesh, n, nb=DIST_NB,
                                      grad_mode="exact")(flat, Xl, yl)
    out["dist_v"], out["dist_g"] = v.cpu().numpy(), g.cpu().numpy()
    mu, var = tp.make_dist_predict(k, lik, mesh, n, nb=DIST_NB)(
        flat, Xl, yl, torch.as_tensor(data["Xq"], device=mesh.device))
    out["pred_mu"], out["pred_var"] = mu.cpu().numpy(), var.cpu().numpy()
    v, g, st = tp.make_ring_nlml_and_grad(k, mesh, n, with_stats=True,
                                          **_ring64_opts(data))(flat, Xl, yl)
    out["ring_v"], out["ring_g"] = v.cpu().numpy(), g.cpu().numpy()
    out["ring_stats"] = st.cpu().numpy()
    # the solve part: alpha and the variance columns by the ring's
    # whitened CG (make_ring_predict), to convergence
    mu, var = tp.make_ring_predict(k, mesh, n, tol=RING64_CG_TOL,
                                   maxiter=2000, precond_rank=RING64_RANK)(
        flat, Xl, yl, torch.as_tensor(data["Xq"], device=mesh.device))
    out["ring_mu"], out["ring_var"] = mu.cpu().numpy(), var.cpu().numpy()
    if two is not None:
        flats2 = torch.as_tensor(data["flats2"], device=mesh.device)
        X2l, y2l, n2, _ = tp.shard_training_data(
            two.rows, torch.as_tensor(data["X2"]),
            torch.as_tensor(data["y2"]), nb=DIST_NB)
        v, g = tp.make_two_level_nlml_and_grad(
            k, lik, two, n2, nb=DIST_NB, grad_mode="exact")(flats2, X2l, y2l)
        out["two_v"], out["two_g"] = v.cpu().numpy(), g.cpu().numpy()
        v, g = tp.make_two_level_ring_nlml_and_grad(
            k, two, n2, **{**_ring64_opts(data), "Z": data["Z"][:n2],
                           "Zl": data["Zl"][:n2]})(flats2, X2l, y2l)
        out["two_ring_v"], out["two_ring_g"] = (v.cpu().numpy(),
                                                g.cpu().numpy())
    out["k1"] = np.asarray(pairwise.launches - before)
    return out


def mesh_rank_main(args) -> int:
    """One rank of the MESH_RANKS-rank launch (`--mesh-io`): gloo on
    the one card, asked for by name; writes its results beside the
    inputs."""
    import torch

    from gp_ss_ak_torch import parallel as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = tp.make_mesh("cuda", backend="gloo")
    two = tp.two_level_mesh(rows_per_host=2, device="cuda", backend="gloo")
    with np.load(os.path.join(args.mesh_io, "in.npz")) as f:
        data = dict(f)
    out = mesh_tasks(mesh, data, two)
    # the mesh dry run (entry.dryrun_multichip) in place on these ranks
    from gp_ss_ak_torch.entry import dryrun_multichip
    from gp_ss_ak_torch.ops import pairwise

    before = pairwise.launches
    for key, val in dryrun_multichip(MESH_RANKS, "cuda").items():
        out["dryrun_" + key] = np.asarray(val)
    out["k1"] = out["k1"] + (pairwise.launches - before)
    np.savez(os.path.join(args.mesh_io, f"rank{os.environ['RANK']}.npz"),
             **out)
    return 0


def launch_mesh_ranks(data, workdir: str, timeout: float = MESH_TIMEOUT_S):
    """Run MESH_RANKS ranks of this script (`--mesh-io`) on the one card,
    gloo between them, through the package's launcher
    (parallel.launch_local: every rank is stopped at the first failure or
    past `timeout` seconds, and a failure raises). Returns the ranks'
    results in rank order and the launch's wall seconds."""
    from gp_ss_ak_torch.parallel import launch_local

    os.makedirs(workdir, exist_ok=True)
    np.savez(os.path.join(workdir, "in.npz"), **data)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    wall = launch_local([sys.executable, os.path.abspath(__file__),
                         "--mesh-io", workdir], MESH_RANKS, workdir, timeout,
                        env=env, cwd=ROOT)
    out = []
    for r in range(MESH_RANKS):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as f:
            out.append(dict(f))
    return out, wall


def _rel(a, b) -> float:
    """max |a - b| over the largest |b|."""
    b = np.asarray(b)
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


def phase_mesh64(device, seed: int):
    """Phases 25-27 in float64 at N_DIST64: the dist NLML and gradient on
    a mesh of one rank (NCCL) against the dense engine, its predict
    against the dense Predictor; the ring's against the dense solve; then
    the same on MESH_RANKS ranks sharing the card (gloo, host-staged),
    held to one rank, and the two-level meshes (2 chains x 2 rows) held
    to each chain alone. Returns the K1 launches of the counted runs (one
    rank's, then every rank of the launch summed)."""
    import torch

    from gp_ss_ak_torch import parallel as tp
    from gp_ss_ak_torch.model import default_model
    from gp_ss_ak_torch.optim import make_value_and_grad
    from gp_ss_ak_torch.serve import Predictor

    data = _mesh_inputs(seed)
    mesh = tp.make_mesh(device)
    print(f"mesh: one rank over {mesh.backend} on {mesh.device}")
    t0 = time.perf_counter()
    one = mesh_tasks(mesh, data)
    wall1 = time.perf_counter() - t0
    k1 = int(one["k1"])
    model = _golden_model(device, torch.float64)
    vd, gd = make_value_and_grad(model, data["X"], data["y"])(
        data["flat"])
    e_v = abs(float(one["dist_v"]) - vd) / abs(vd)
    e_g = _rel(one["dist_g"], gd)
    mu_d, var_d = Predictor(model, data["X"], data["y"],
                            precompute_inverse=False)(data["Xq"])
    e_mu, e_var = _rel(one["pred_mu"], mu_d), _rel(one["pred_var"], var_d)
    e_a = max(_rel(one["ring_mu"], mu_d), _rel(one["ring_var"], var_d))
    print(f"dist f64 N={N_DIST64} P=1 ({mesh.backend}): value "
          f"{float(one['dist_v'])!r} "
          f"vs dense {vd!r}: rel {e_v:.3e} (tol {DIST64_VAL_RTOL}); "
          f"gradient {e_g:.3e} of its largest entry (tol "
          f"{DIST64_GRAD_RTOL}); predict mu {e_mu:.3e}, var {e_var:.3e} "
          f"(tol {DIST64_PRED_RTOL}); ring predict (alpha and the "
          f"variance solves) {e_a:.3e} (tol {RING_ALPHA_RTOL}); ring NLML's "
          f"CG {int(one['ring_stats'][0])} "
          f"iterations; {wall1:.2f} s; K1 launches {k1}")
    _check(e_v <= DIST64_VAL_RTOL, "dist value disagrees with dense f64")
    _check(e_g <= DIST64_GRAD_RTOL, "dist gradient disagrees with dense f64")
    _check(max(e_mu, e_var) <= DIST64_PRED_RTOL,
           "dist predict disagrees with the dense Predictor")
    _check(e_a <= RING_ALPHA_RTOL, "ring predict disagrees with the dense "
           "Predictor")

    ranks, wall4 = launch_mesh_ranks(data, WORK + "_mesh")
    k1_ranks = sum(int(r["k1"]) for r in ranks)
    worst = {}
    for r in ranks:
        for key, tol in (("dist_v", DIST_P4_RTOL), ("dist_g", DIST_P4_RTOL),
                         ("pred_mu", DIST_P4_RTOL), ("pred_var", DIST_P4_RTOL),
                         ("ring_v", RING_P4_RTOL), ("ring_g", RING_P4_GRAD),
                         ("ring_mu", RING_P4_RTOL), ("ring_var", RING_P4_RTOL)):
            e = _rel(r[key], one[key])
            worst[key] = max(worst.get(key, 0.0), e)
            _check(e <= tol, f"{key} on {MESH_RANKS} ranks disagrees with "
                   f"one rank: {e:.3e} > {tol}")
    # the dry run on those ranks: its dist NLML (float32, DRYRUN_N
    # points) against the dense engine's in float64 on the same points
    rng = np.random.default_rng(0)
    Xd = rng.uniform(-1, 1, size=(DRYRUN_N, 3)).astype(np.float32)
    yd = np.sin(Xd @ np.array([3.0, 1.0, 2.0], np.float32))
    start = default_model(3, dtype=torch.float64, device=device)
    vdry = make_value_and_grad(start, Xd.astype(np.float64),
                               yd.astype(np.float64))(
        start.pack().cpu().numpy())[0]
    for r in ranks:
        line = str(r["dryrun_line"])
        e = abs(float(r["dryrun_nlml"]) - vdry) / abs(vdry)
        _check(re.fullmatch(r"dryrun_multichip\(4\): nlml=\S+ fit3=\S+ "
                            r"ring=\S+ predict\+2level ok", line)
               is not None, f"dry run printed {line!r}")
        _check(e <= DRYRUN_VAL_RTOL, f"dry run NLML {r['dryrun_nlml']} vs "
               f"dense float64 {vdry}: rel {e:.3e}")
        _check(float(r["dryrun_ring_rel"]) < 1e-4
               and float(r["dryrun_fit3"]) <= float(r["dryrun_nlml"]) + 1e-6,
               "dry run: ring CG or fit_distributed failed")
    print(f"{ranks[0]['dryrun_line']} (on {MESH_RANKS} ranks, gloo on the "
          f"card; NLML {float(ranks[0]['dryrun_nlml'])!r} vs dense float64 "
          f"{vdry!r}; ring CG {int(ranks[0]['dryrun_ring_iters'])} "
          f"iterations)")
    print(f"mesh of {MESH_RANKS} ranks on one card (gloo, host-staged; "
          f"no NVLink): against one rank, worst rel "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; ring CG {int(ranks[0]['ring_stats'][0])} iterations vs "
          f"{int(one['ring_stats'][0])}; launch wall {wall4:.2f} s (4 "
          f"processes, start-up included); K1 launches, all ranks "
          f"{k1_ranks}")
    # the two-level meshes: each chain against itself alone on one rank
    X2l, y2l, n2, _ = tp.shard_training_data(
        mesh, torch.as_tensor(data["X2"]), torch.as_tensor(data["y2"]),
        nb=DIST_NB)
    opts = {**_ring64_opts(data), "Z": data["Z"][:n2], "Zl": data["Zl"][:n2]}
    f1 = tp.make_dist_nlml_and_grad(model.kernel, model.likelihood, mesh, n2,
                                    nb=DIST_NB, grad_mode="exact")
    r1 = tp.make_ring_nlml_and_grad(model.kernel, mesh, n2, **opts)
    e2 = 0.0
    for c in range(2):
        fl = torch.as_tensor(data["flats2"][c], device=device)
        for (v, g), key in ((f1(fl, X2l, y2l), "two"),
                            (r1(fl, X2l, y2l), "two_ring")):
            for r in ranks:
                e = max(abs(float(r[key + "_v"][c]) - float(v)) / abs(float(v)),
                        _rel(r[key + "_g"][c], g.cpu().numpy()))
                e2 = max(e2, e)
    print(f"two-level (2 chains x 2 rows, gloo): each chain against itself "
          f"alone on one rank, worst rel {e2:.3e} (tol {TWO_LEVEL_RTOL})")
    _check(e2 <= TWO_LEVEL_RTOL, "two-level chains disagree with one rank")
    return k1, k1_ranks


def phase_mesh_k1_shapes(device, seed: int):
    """K1's cross entry at the mesh engines' shapes: the dist panel
    (N_TRAIN x N_TRAIN, one rank) and the ring tile (N_ITER_TRAIN x
    TILE_CHUNK), against its plain version on independent points
    (float64 and float32, phase_k1) and on the coincident points the
    engines give it (the columns a subset of the rows; float32 against
    the plain float64 Gram), then timed in float32 beside its bound."""
    import torch

    from gp_ss_ak_torch.ops import pairwise
    from gp_ss_ak_torch.parallel.ring import TILE_CHUNK

    shapes = ((N_TRAIN, N_TRAIN, "dist panel"),
              (N_ITER_TRAIN, TILE_CHUNK, "ring tile"))
    report = phase_k1(device, seed, cases=[(n, m, 3) for n, m, _ in shapes],
                      time_shapes=False)
    torch.cuda.empty_cache()
    g = torch.Generator(device=device).manual_seed(seed + 29)
    s_t, b_t = (torch.tensor(v, device=device) for v in (SIGMA, BIAS))
    tol = TOL_F32 * (SIGMA * SIGMA + BIAS)
    for n, m, what in shapes:
        X = 3.0 * torch.rand(n, 3, generator=g, device=device) - 1.5
        Y = X[:m].contiguous()
        K = pairwise.expans_bias_gram(X, s_t, b_t, None, Y)
        ref = pairwise.expans_bias_gram_plain(X.double(), s_t.double(),
                                              b_t.double(), None, Y.double())
        err = (K.double() - ref).abs().max().item()
        del K, ref
        torch.cuda.empty_cache()
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = time_ms(lambda: pairwise.expans_bias_gram(X, s_t, b_t, None, Y),
                     iters=10)
        plain_ms = time_ms(lambda: pairwise.expans_bias_gram_plain(
            X, s_t, b_t, None, Y), warmup=1, iters=3)
        b_ms, b_by = bound(gram_work(n, m, 3), **card_rates())
        print(f"K1 cross {n}x{m} f32 ({what}, coincident points): "
              f"|kernel-plain64| {err:.3e} (tol {tol:.1e}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"(set by {b_by}); kernel at {b_ms / ms:.3f} of it; library "
              f"call: none")
        _check(err <= tol, f"K1 cross disagrees at the {what}")
        del X, Y
    torch.cuda.empty_cache()
    return report


def phase_dist32(device, seed: int, train: str, test: str, model_path: str,
                 counts):
    """Phase 28 in float32 at N_TRAIN (the dense route's width) on a mesh
    of one rank (NCCL): one evaluation with the exact gradient and one
    with the Hutchinson estimate against the dense engine, K1 launches
    counted per evaluation, the exact one's profiled split; then
    `train --engine dist -# DIST_TRAIN_ITERS` and `test` on its model.
    Returns the K1 launches of the counted runs."""
    import torch

    from gp_ss_ak_torch import cli
    from gp_ss_ak_torch import parallel as tp
    from gp_ss_ak_torch.optim import make_value_and_grad
    from gp_ss_ak_torch.parallel import nlml as dist_nlml

    model, _, Xtrs, ytrs, _, _ = _load_case(device, torch.float32, train,
                                            test, model_path)
    mesh = tp.make_mesh(device)
    Xl, yl, n, _ = tp.shard_training_data(
        mesh, torch.as_tensor(Xtrs, dtype=torch.float32),
        torch.as_tensor(ytrs, dtype=torch.float32), nb=DIST_NB)
    flat = model.pack().detach()
    vd, gd = make_value_and_grad(model, Xtrs, ytrs)(
        flat.cpu().numpy().astype(np.float64))
    k1 = 0
    for mode in ("exact", "hutchinson"):
        f = tp.make_dist_nlml_and_grad(model.kernel, model.likelihood, mesh,
                                       n, nb=DIST_NB, grad_mode=mode)
        counts()
        v, g = f(flat, Xl, yl)
        used = counts()
        k1 += used
        _check(used == 2, f"dist {mode} evaluation made {used} K1 launches, "
               "not 2 (the panel, and its rebuild for the contraction)")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        v, g = f(flat, Xl, yl)
        v = float(v)
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        e_v = abs(v - vd) / max(abs(vd), n)
        e_g = _rel(g.cpu().numpy(), gd)
        print(f"dist f32 N={n} P=1 grad_mode={mode}: value {v!r} vs dense "
              f"{vd!r} (rel to max(|v|, n) {e_v:.3e}, tol "
              f"{DIST_F32_VAL_REL}); gradient {e_g:.3e} of the dense "
              f"gradient's largest entry; {ms:.3f} ms (host clock, one "
              f"evaluation), peak {peak:.3f} GiB; K1 launches {used}")
        _check(e_v <= DIST_F32_VAL_REL, f"dist {mode} value disagrees")
        if mode == "exact":
            _check(e_g <= DIST_F32_GRAD_REL, "dist exact gradient "
                   "disagrees with the dense engine")
            labels = {"dist.block_cholesky": "block Cholesky",
                      "dist.solves": "alpha + Q solves",
                      "dist.contraction": "contraction (K1 rebuild + "
                                          "backward)",
                      "kernel:gram_kernel": "K1 forward",
                      "FusedExpansBiasCross.backward": "K1 cross backward"}
            _, pwall, split, total, top = profile_split(
                lambda: f(flat, Xl, yl), labels)
            print(f"dist exact evaluation at N={n} f32, torch.profiler "
                  f"device time: "
                  f"{_split_text(split, labels, pwall, total, top)}")
        del f
        torch.cuda.empty_cache()

    workdir = WORK + "_dist"
    os.makedirs(workdir, exist_ok=True)
    trained = os.path.join(workdir, "trained_dist")
    out = io.StringIO()
    counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["-v", "1", "train", "--engine", "dist", "-#",
                       str(DIST_TRAIN_ITERS), train, trained])
    wall = time.perf_counter() - t0
    text = out.getvalue()
    print("cli train --engine dist:", " | ".join(text.strip().splitlines()),
          f"(rc {rc}, {wall:.3f} s wall)")
    _check(rc == 0, f"train --engine dist returned {rc}")
    m = re.search(r"-logL: (\S+) -> (\S+) \((\d+) iters, (\d+) evals", text)
    _check(m is not None and float(m.group(2)) < float(m.group(1)),
           "train --engine dist: -logL did not decrease")
    evals = int(m.group(4))
    chunks = -(-n // dist_nlml.PREDICT_CHUNK)
    want = 2 * evals + 1 + chunks
    used = counts()
    k1 += used
    _check(used == want, f"train --engine dist: expected {want} K1 launches "
           f"(2 an evaluation, the panel and {chunks} cross chunks "
           f"of its training-set mean), saw {used}")
    counts()
    phase_main(train, test, trained)
    k1 += counts()
    return k1


@contextlib.contextmanager
def _ring_tf32():
    """The ring's matrix products in TF32: parallel/ring.py's
    full-float32 switch replaced by its opposite for the block."""
    import torch

    from gp_ss_ak_torch.parallel import ring

    @contextlib.contextmanager
    def tf32():
        prev = (torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32)
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev[0])
            torch.backends.cuda.matmul.allow_tf32 = prev[1]

    full, ring.highest_precision = ring.highest_precision, tf32
    try:
        yield
    finally:
        ring.highest_precision = full


def phase_ring32(device, seed: int, itrain: str, itest: str, imodel: str,
                 counts):
    """Phases 29-30 in float32 at N_ITER_TRAIN on a mesh of one rank: one
    `make_ring_nlml_and_grad(with_stats=True)` evaluation (CG iterations,
    residual, time, peak memory, profiled split), `fit_ring` for
    RING_FIT_ITERS iterations, and `make_ring_predict` at
    RING_PREDICT_QUERIES queries against the same predict in float64 and
    IterativePredictor on the same model (phase 10's tolerances, the
    variances' against the prior variance), with a TF32 control the
    variance gate must reject. Returns the K1 launches."""
    import torch

    from gp_ss_ak_torch import parallel as tp
    from gp_ss_ak_torch.inference.iterative import auto_precond_rank
    from gp_ss_ak_torch.parallel import ring
    from gp_ss_ak_torch.serve import IterativePredictor

    model, _, Xtrs, ytrs, Xts, _ = _load_case(device, torch.float32, itrain,
                                              itest, imodel)
    mesh = tp.make_mesh(device)
    Xl, yl, n, _ = tp.shard_training_data(
        mesh, torch.as_tensor(Xtrs, dtype=torch.float32),
        torch.as_tensor(ytrs, dtype=torch.float32), nb=DIST_NB)
    flat = model.pack().detach()
    f = tp.make_ring_nlml_and_grad(model.kernel, mesh, n, with_stats=True,
                                   probe_seed=seed)
    counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v, g, st = f(flat, Xl, yl)
    v = float(v)
    wall = time.perf_counter() - t0
    k1 = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"ring f32 N={n} P=1: value {v!r}, CG {int(st[0])} iterations to "
          f"relative residual {float(st[1]):.3e} (tol 1e-4, precond rank "
          f"{auto_precond_rank(n)}); {wall:.3f} s (host clock), "
          f"peak {peak:.3f} GiB; K1 launches {k1}")
    _check(np.isfinite(v) and bool(torch.isfinite(g).all()),
           "ring evaluation not finite")
    labels = {"ring.pivoted_cholesky": "pivoted Cholesky",
              "ring.cg": "whitened CG", "ring.slq": "SLQ",
              "ring.surrogate": "surrogate backward",
              "kernel:gram_kernel": "K1 forward",
              "FusedExpansBiasCross.backward": "K1 cross backward"}
    _, pwall, split, total, top = profile_split(lambda: f(flat, Xl, yl),
                                                labels)
    print(f"ring evaluation at N={n} f32, torch.profiler device time: "
          f"{_split_text(split, labels, pwall, total, top)}")
    del f
    torch.cuda.empty_cache()

    counts()
    t0 = time.perf_counter()
    fitted, res = tp.fit_ring(model, Xtrs, ytrs, mesh, iters=RING_FIT_ITERS,
                              seed=seed)
    wall = time.perf_counter() - t0
    k1 += counts()
    print(f"fit_ring N={n} P=1, {RING_FIT_ITERS} iterations: -logL "
          f"{res.trace[0]:.6f} -> {res.fun:.6f}, {res.n_iters} iterations, "
          f"{res.n_evals} evaluations, stop {res.stop_reason}, sn2 "
          f"{res.x[-1]:.4g}; {wall:.3f} s")
    _check(np.isfinite(res.fun) and res.fun <= res.trace[0],
           "fit_ring did not improve")

    q = Xts[:RING_PREDICT_QUERIES]
    qt = torch.as_tensor(q, dtype=torch.float32, device=device)
    counts()
    t0 = time.perf_counter()
    mu_r, var_r = (t.cpu().numpy() for t in tp.make_ring_predict(
        model.kernel, mesh, n)(flat, Xl, yl, qt))
    wall = time.perf_counter() - t0
    k1 += counts()
    mu_i, var_i = IterativePredictor(model, Xtrs, ytrs)(q)
    k1 += counts()
    # the control: the same predict with the tile products in TF32 (its
    # launches not counted)
    with _ring_tf32():
        mu_c, var_c = (t.cpu().numpy() for t in tp.make_ring_predict(
            model.kernel, mesh, n)(flat, Xl, yl, qt))
    counts()
    # the reference: the same ring predict in float64, CG to 1e-10
    m64 = model.to(torch.float64, device)
    t0 = time.perf_counter()
    mu_f, var_f = (t.cpu().numpy() for t in tp.make_ring_predict(
        m64.kernel, mesh, n, tol=1e-10, maxiter=2000)(
        m64.pack(), Xl.double(), yl.double(), qt.double()))
    wall64 = time.perf_counter() - t0
    k1 += counts()
    _, sigma, bias, sn2 = ring._hypers(m64.kernel, m64.pack())
    prior = float(sigma * sigma + bias + sn2)
    tol_mu = ITER_MEAN_TOL * float(np.std(ytrs))

    def diff(mu, var, mu_ref, var_ref):
        """max |mu diff|, max |var diff| / prior, max var rel diff"""
        dv = np.abs(var - var_ref)
        return (float(np.max(np.abs(mu - mu_ref))), float(np.max(dv)) / prior,
                float(np.max(dv / var_ref)))

    readings = {"ring float32 against float64": diff(mu_r, var_r, mu_f, var_f),
                "ring float32 against IterativePredictor": diff(
                    mu_r, var_r, mu_i, var_i),
                "IterativePredictor against float64": diff(mu_i, var_i, mu_f,
                                                           var_f),
                "TF32 control against float64": diff(mu_c, var_c, mu_f,
                                                     var_f)}
    print(f"ring predict N={n} P=1, {q.shape[0]} queries: {wall:.3f} s "
          f"(float64 reference {wall64:.3f} s); prior variance {prior:.6g} "
          f"(sn2 {float(sn2):.4g}), float64 variances {float(var_f.min()):.4g}"
          f"..{float(var_f.max()):.4g}; max |mu diff| (tol {tol_mu:.3e}), "
          f"max |var diff| / prior (tol {ITER_VAR_RTOL}), max var rel diff: "
          + "; ".join(f"{k} {a:.3e}, {b:.3e}, {c:.3e}"
                      for k, (a, b, c) in readings.items()))
    for key in ("ring float32 against float64",
                "ring float32 against IterativePredictor"):
        e_mu, e_var, _ = readings[key]
        _check(e_mu <= tol_mu, f"ring predict means: {key} {e_mu:.3e}")
        _check(e_var <= ITER_VAR_RTOL,
               f"ring predict variances: {key} {e_var:.3e}")
    _check(readings["TF32 control against float64"][1] > ITER_VAR_RTOL,
           "the ring predict's variance gate passes its TF32 control")
    torch.cuda.empty_cache()
    return k1


def run_parallel(device, seed: int, counts, dense_case, icase):
    """The mesh phases (25-30). Returns the K1 launches of the counted
    runs, every rank's summed, and the report of K1's cross entry at the
    mesh engines' shapes."""
    t0 = time.perf_counter()
    k1, k1_ranks = phase_mesh64(device, seed)
    report = phase_mesh_k1_shapes(device, seed)
    k1 += phase_dist32(device, seed, *dense_case, counts)
    k1 += phase_ring32(device, seed, *icase, counts)
    print(f"parallel phases done in {time.perf_counter() - t0:.1f} s; K1 "
          f"launches {k1} on one rank, {k1_ranks} on {MESH_RANKS}")
    return k1 + k1_ranks, report


# ---------------------------------------------------------------------------
# the segmented evaluator (optim/segmented.py): phases 31-34
# ---------------------------------------------------------------------------

def segmented_peak_bound(n: int, rank: int, chunk: int = 4096) -> float:
    """Bytes a segmented stream fit and its matrix-free training-set mean
    may hold on the device at n points, from the code, all float32:
    SEG_RANK_BLOCKS (n, rank) blocks, SEG_COLUMNS columns of n, and
    SEG_MEAN_BLOCKS of the mean's (chunk, chunk) cross-Gram blocks (a
    chunk of training rows against a batch of as many queries), plus
    128 MiB for the rest (d-wide points, scalars) and the allocator's
    rounding. The server's setup (L and Q again) fits inside the same
    sum. A (1024, n) Gram block, as the autograd contraction held ~16
    of, is 0.38 GiB at n = 100000: two of them do not fit."""
    return 4.0 * (SEG_RANK_BLOCKS * n * rank + SEG_COLUMNS * n
                  + SEG_MEAN_BLOCKS * chunk * chunk) + 2.0 ** 27


def _seg_case(device, seed: int):
    """The N_SEG ore body (and N_SEG_TEST held-out composites) written as
    the CLI reads it; (paths, the golden model in float32 on the card,
    the standardized training X and y)."""
    import torch

    train, test, model_path = write_case(WORK + "_segmented", seed, N_SEG,
                                         N_SEG_TEST)
    model, _, Xtrs, ytrs, _, _ = _load_case(device, torch.float32, train,
                                            test, model_path)
    return (train, test, model_path), model, Xtrs, ytrs


def phase_seg_vs_fused(device, model, X, y):
    """Phase 31: at the golden start, the fused stream evaluator and the
    segmented one (cold) with the same options and probes: equal bits and
    CG iterations; K3 launches = CG iterations + Lanczos steps; one
    evaluation split by its profiler ranges. Returns (the cold evaluator,
    the start x, its value, its CG iterations)."""
    from gp_ss_ak_torch.ops import matvec
    from gp_ss_ak_torch.optim import (
        make_iterative_value_and_grad,
        make_segmented_value_and_grad,
    )

    x = model.pack().cpu().numpy().astype(np.float64)
    fused = make_iterative_value_and_grad(model, X, y, mode="stream",
                                          **STREAM_OPTS)
    cold = make_segmented_value_and_grad(model, X, y, warm_start=False,
                                         **STREAM_OPTS)
    t0 = time.perf_counter()
    vf, gf = fused(x)
    t_fused = time.perf_counter() - t0
    before, reg0 = matvec.launches, matvec.route_launches["register"]
    t0 = time.perf_counter()
    vs, gs = cold(x)
    t_seg = time.perf_counter() - t0
    k3 = matvec.launches - before
    k3_reg = matvec.route_launches["register"] - reg0
    k, rel = cold.last_cg_iters, cold.last_rel_residual
    lanczos = STREAM_OPTS["lanczos_iters"]
    print(f"segmented vs fused at N={N_SEG} (golden start, sn2 "
          f"{float(x[-1])!r}, "
          f"rank {cold.precond_rank}): value {vs!r} vs {vf!r}; gradient "
          f"bits equal {np.array_equal(gs, gf)}; CG {k} vs "
          f"{fused.last_cg_iters} iterations, rel residual {rel:.3e}; "
          f"one evaluation {t_seg:.3f} s segmented, {t_fused:.3f} s fused "
          f"(host clock); K3 launches {k3} (CG {k} + Lanczos {lanczos}), "
          f"{k3_reg} of them on the register tiles")
    _check(np.isfinite(vs) and bool(np.all(np.isfinite(gs))),
           "segmented evaluation not finite")
    _check(vs == vf and np.array_equal(gs, gf)
           and k == fused.last_cg_iters,
           "segmented evaluation differs from the fused stream one")
    _check(k3 == k + lanczos, f"segmented evaluation: {k3} K3 launches, "
           f"expected {k} + {lanczos}")
    _check(k3_reg == k3, f"segmented evaluation: {k3_reg} of {k3} K3 "
           f"launches on the register tiles (CG at B = 9, SLQ at 32)")
    labels = {"iterative._pivchol": "pivoted Cholesky",
              "iterative.whitened_solve_info": "whitened CG",
              "iterative.slq_logdet_batched": "SLQ",
              "iterative._grad_contraction": "gradient contraction",
              "kernel:matmat": "K3"}
    _, pwall, split, total, top = profile_split(lambda: cold(x), labels)
    host = ", ".join(f"{labels[key]} {split[key][2] / 1e3:.3f} s"
                     for key in labels if not key.startswith("kernel:"))
    print(f"segmented evaluation at N={N_SEG}: device time "
          f"{_split_text(split, labels, pwall, total, top)}; host clock "
          f"(profiled) {host}; K3 {split['kernel:matmat'][0]} launches")
    return cold, x, vs, k


def phase_seg_warm(model, X, y, cold, x, v1, k1):
    """Phase 32: two evaluations, at x and x (1 + SEG_STEP), cold and
    warm (tests/test_iterative.py:743-775): the warm one's first equals
    the cold one's bits, its second takes fewer CG iterations to the cold
    value within SEG_WARM_RTOL and gradient within SEG_WARM_GRAD of its
    largest entry, and one more K3 pass (its true residual)."""
    from gp_ss_ak_torch.ops import matvec
    from gp_ss_ak_torch.optim import make_segmented_value_and_grad

    x2 = x * (1.0 + SEG_STEP)
    vc2, gc2 = cold(x2)
    kc2, relc2 = cold.last_cg_iters, cold.last_rel_residual
    warm = make_segmented_value_and_grad(model, X, y, **STREAM_OPTS)
    vw1, _ = warm(x)
    kw1 = warm.last_cg_iters
    before = matvec.launches
    t0 = time.perf_counter()
    vw2, gw2 = warm(x2)
    t_warm = time.perf_counter() - t0
    k3 = matvec.launches - before
    kw2, relw2 = warm.last_cg_iters, warm.last_rel_residual
    e_v = abs(vw2 - vc2) / abs(vc2)
    e_g = float(np.max(np.abs(gw2 - gc2)) / np.max(np.abs(gc2)))
    print(f"warm vs cold at N={N_SEG}, x then x (1 + {SEG_STEP}): CG "
          f"iterations cold {k1}, {kc2} (rel residual {relc2:.3e}); warm "
          f"{kw1}, {kw2} (rel residual "
          f"{relw2:.3e}); second value warm {vw2!r} vs cold {vc2!r}, rel "
          f"{e_v:.3e} (tol {SEG_WARM_RTOL}); gradient {e_g:.3e} of its "
          f"largest entry (tol {SEG_WARM_GRAD}); the warm evaluation {t_warm:.3f} s host clock, "
          f"K3 launches {k3}")
    _check(vw1 == v1 and kw1 == k1,
           "a warm evaluator's first evaluation is not cold")
    _check(kw2 < kc2, f"warm start took {kw2} CG iterations, cold {kc2}")
    _check(e_v <= SEG_WARM_RTOL, "warm and cold values disagree")
    _check(e_g <= SEG_WARM_GRAD, "warm and cold gradients disagree")
    _check(k3 == kw2 + STREAM_OPTS["lanczos_iters"] + 1,
           f"warm evaluation: {k3} K3 launches, expected {kw2} + "
           f"{STREAM_OPTS['lanczos_iters']} + 1")
    return kc2, kw2


class _Recorded:
    """A matrix-free value_and_grad that appends (sn2, CG iterations,
    rel residual, rank, host seconds) for every evaluation to `log`; its
    other attributes (cg_tol, last_rel_residual, ...) read through, so
    optim.fit judges its solves as it judges the closure's. Gates: each
    evaluation launches K4 once for its gradient, and not at all after a
    failed solve (which returns without one); each builds its
    preconditioner by K6, `precond_rank` launches, unless `chol` (the
    materialized mode, which builds none)."""

    def __init__(self, vg, log, chol=False):
        self.vg, self.log, self.chol = vg, log, chol

    def __call__(self, x):
        from gp_ss_ak_torch.inference.iterative import solve_state
        from gp_ss_ak_torch.ops import contraction, pivchol

        before, before6 = contraction.launches, pivchol.launches
        t0 = time.perf_counter()
        out = self.vg(x)
        rel = self.vg.last_rel_residual
        self.log.append((float(x[-1]), self.vg.last_cg_iters, rel,
                         self.vg.precond_rank, time.perf_counter() - t0))
        k4 = contraction.launches - before
        want = 0 if solve_state(rel, self.vg.cg_tol) == "failed" else 1
        _check(k4 == want, f"an evaluation (rel residual {rel:.3e}) made "
               f"{k4} K4 launches, not {want}")
        k6 = pivchol.launches - before6
        want6 = 0 if self.chol else self.vg.precond_rank
        _check(k6 == want6, f"an evaluation made {k6} K6 launches, not "
               f"{want6}")
        return out

    def __getattr__(self, name):
        return getattr(self.__dict__["vg"], name)


def _recording(make, log, chol=False):
    """`make` (make_iterative_value_and_grad or
    make_segmented_value_and_grad) whose closures record into `log`
    (_Recorded; `chol`: they evaluate in the materialized mode)."""
    def made(model, X, y, **kw):
        return _Recorded(make(model, X, y, **kw), log, chol)

    return made


def _evaluation_text(log, cg_tol: float) -> str:
    """Per evaluation of `log` (_Recorded): sn2, CG iterations, rel
    residual, rank, seconds, and "UNCONVERGED" where the residual is not
    within cg_tol."""
    return "; ".join(
        f"({s2:.6g}, {k}, {r:.3e}, {rk}, {t:.3f}"
        f"{'' if r <= cg_tol else ', UNCONVERGED'})"
        for s2, k, r, rk, t in log)


def phase_seg_train(device, case, workdir: str):
    """Phase 33: `train -# SEG_TRAIN_ITERS --engine iterative --segmented`
    through the CLI at N_SEG: wall, evaluations, per evaluation its sn2,
    CG iterations, residual and preconditioner rank; the peak device
    memory against segmented_peak_bound; then the holdout MSE on the
    N_SEG_TEST held-out composites through IterativePredictor(mean_only)
    from the saved model."""
    import torch

    from gp_ss_ak_torch import cli
    from gp_ss_ak_torch.data import Statistics, unapply_y
    from gp_ss_ak_torch.inference.iterative import auto_precond_rank
    from gp_ss_ak_torch.model import load_model
    from gp_ss_ak_torch.optim import api
    from gp_ss_ak_torch.serve import IterativePredictor

    train, test, model_path = case
    out_model = os.path.join(workdir, "trained_segmented")
    log = []
    make = api.make_segmented_value_and_grad
    api.make_segmented_value_and_grad = _recording(make, log)
    torch.cuda.reset_peak_memory_stats()
    text, err = io.StringIO(), io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text), \
                contextlib.redirect_stderr(err):
            rc = cli.main(["-v", "1", "train", "-#", str(SEG_TRAIN_ITERS),
                           "--engine", "iterative", "--segmented", train,
                           out_model])
        wall = time.perf_counter() - t0
    finally:
        api.make_segmented_value_and_grad = make
    peak = torch.cuda.max_memory_allocated()
    text, err = text.getvalue(), err.getvalue()
    print("cli train --segmented:", " | ".join(text.strip().splitlines()),
          f"(rc {rc}, {wall:.3f} s wall, file IO included); stderr:",
          " | ".join(err.strip().splitlines()) or "(empty)")
    _check(rc == 0, f"cli train --segmented at N={N_SEG} returned {rc}")
    m = re.search(r"-logL: (\S+) -> (\S+) \((\d+) iters, (\d+) evals, "
                  r"stop: (\S+)\)", text)
    _check(m is not None, "cli train --segmented printed no -logL line")
    first, last, evals = float(m.group(1)), float(m.group(2)), \
        int(m.group(4))
    cg_tol = STREAM_OPTS["cg_tol"]
    print(f"segmented train at N={N_SEG}: -logL {first} -> {last}, "
          f"{evals} evaluations, stop {m.group(5)}; per evaluation (sn2, "
          f"CG iterations, rel residual, rank, s): "
          + _evaluation_text(log, cg_tol))
    # the CLI's one stderr line for the fit's unconverged solves counts
    # exactly the evaluations whose residual is above cg_tol
    bad = sum(1 for _, _, r, _, _ in log if not r <= cg_tol)
    w = re.search(r"^Warning: fit: (\d+) of (\d+) CG solves ended "
                  r"unconverged, largest relative residual (\S+) > cg_tol "
                  r"(\S+)", err, re.M)
    said = (0, evals) if w is None else (int(w.group(1)), int(w.group(2)))
    print(f"segmented train: {bad} of {evals} evaluations above cg_tol "
          f"{cg_tol}; the CLI's warning says {said[0]} of {said[1]}")
    _check(said == (bad, evals) and (w is None or float(w.group(4))
                                     == cg_tol),
           f"the CLI's unconverged count {said} is not the log's "
           f"({bad}, {evals})")
    bound = segmented_peak_bound(N_SEG, auto_precond_rank(N_SEG))
    print(f"segmented train: peak device memory {peak / 2**30:.3f} GiB "
          f"(limit {bound / 2**30:.3f} GiB from the code; a float32 K "
          f"alone is {4.0 * N_SEG ** 2 / 2**30:.1f} GiB)")
    _check(len(log) == evals, f"{len(log)} evaluations recorded, the CLI "
           f"says {evals}")
    _check(np.isfinite(first) and np.isfinite(last) and last <= first,
           f"segmented train: -logL {first} -> {last}")
    _check(peak <= bound, f"segmented train peaked at {peak / 2**30:.3f} "
           f"GiB, past {bound / 2**30:.3f}")
    # the holdout: the saved model served by the matrix-free server
    model = load_model(out_model, torch.float32, device)
    stats = Statistics.load(out_model + "_Statistics.txt")
    _, _, Xtrs, ytrs, Xts, yt = _load_case(device, torch.float32, train,
                                           test, model_path)
    t0 = time.perf_counter()
    server = IterativePredictor(model, Xtrs, ytrs)
    mu, _ = server(Xts, mean_only=True)
    t_pred = time.perf_counter() - t0
    yh = unapply_y(stats, np.asarray(mu))
    mse = float(np.mean((yt - yh) ** 2))
    var_t = float(np.var(yt))
    print(f"segmented model, holdout of {N_SEG_TEST}: MSE {mse:.6g} = "
          f"{mse / var_t:.4f} var(y) (limit {MSE_MAX}); IterativePredictor "
          f"setup + mean {t_pred:.3f} s")
    _check(np.isfinite(mse) and mse < MSE_MAX * var_t,
           f"segmented holdout MSE {mse} not below {MSE_MAX} var(y)")
    return evals, log, peak


def phase_seg_k3(device, seed: int):
    """Phase 34: K3 at N_SEG against its plain version in float64 (with
    the TF32 and 3xTF32 controls) at the segmented path's widths, and
    timed there beside its bound. Returns the report."""
    worst, _ = k3_gate(device, seed, [(N_SEG, b, 3) for b, _ in
                                      K3_SEG_WIDTHS])
    times, _, _, _ = k3_times(device, seed, K3_SEG_WIDTHS, n=N_SEG)
    return {"max_abs_err": worst, **times}


def run_segmented(device, seed: int, zero, counts):
    """Counted: phases 31-33 at N_SEG (K3 alone: no K1 or K2 in the
    fits; the server's mean launches K1); then phase 34 outside the
    count. Returns (the counted K1, K3, K4 and K6 launches, phase 34's
    report)."""
    import torch

    from gp_ss_ak_torch.inference.iterative import auto_precond_rank
    from gp_ss_ak_torch.ops import contraction, pivchol

    t0 = time.perf_counter()
    rank = auto_precond_rank(N_SEG)
    case, model, Xtrs, ytrs = _seg_case(device, seed)
    zero()
    cold, x, v1, k1 = phase_seg_vs_fused(device, model, Xtrs, ytrs)
    kc2, kw2 = phase_seg_warm(model, Xtrs, ytrs, cold, x, v1, k1)
    del cold
    torch.cuda.empty_cache()
    _check(counts()[:2] == (0, 0), f"segmented evaluations: (K1, K2, K3) "
           f"= {counts()}")
    # one K4 launch a gradient: phase 31's fused, cold and profiled cold
    # evaluations, phase 32's cold, warm and warm
    _check(contraction.launches == 6, f"segmented evaluations: "
           f"{contraction.launches} K4 launches for 6 gradients")
    _check(pivchol.launches == 6 * rank, f"segmented evaluations: "
           f"{pivchol.launches} K6 launches for 6 preconditioners of rank "
           f"{rank}")
    evals, _, _ = phase_seg_train(device, case, os.path.dirname(case[0]))
    k1_l, _, k3_l = counts()
    k4_l, k6_l = contraction.launches, pivchol.launches
    print(f"segmented path: (K1, K2, K3) launches {counts()}, K4 {k4_l}, "
          f"K6 {k6_l}")
    _check(k3_l > 0 and k1_l > 0, f"segmented path: (K1, K2, K3) = "
           f"{counts()}")
    # one preconditioner an evaluation (6, then the CLI fit's), one for
    # the CLI's training-set predict and one for the holdout's server
    _check(k6_l == rank * (6 + evals + 2), f"segmented path: {k6_l} K6 "
           f"launches, not {rank} x (6 + {evals} + 2)")
    torch.cuda.empty_cache()
    report = phase_seg_k3(device, seed)
    print(f"segmented phases done in {time.perf_counter() - t0:.1f} s")
    return k1_l, k3_l, k4_l, k6_l, report



def phase_ex_full(zero, counts):
    """Phase 35: the full workflow on the card at N_TRAIN training and
    N_TEST test composites (the dense fit through K1, potrf and the QW
    adjoint; the model file and statistics; Predictor on the test set;
    NUTS at the example's 80 points and 2 chains through the batched
    K1). Gates: the test MSE below MSE_MAX var(y); K1 launched by the
    fit, the server (A and the cross-Gram) and the sampler (batched).
    Returns the K1 launches."""
    from gp_ss_ak_torch.examples import full_workflow

    zero()
    t0 = time.perf_counter()
    out = full_workflow.main(n=N_TRAIN + N_TEST, n_train=N_TRAIN,
                             iters=EX_FULL_ITERS, n_warmup=EX_FULL_NUTS[0],
                             n_samples=EX_FULL_NUTS[1])
    wall = time.perf_counter() - t0
    k1, k1_batched = counts()
    res = out["res"]
    print(f"example full_workflow at N={N_TRAIN}/{N_TEST}: -logL "
          f"{res.trace[0]:.6f} -> {res.fun:.6f} ({res.n_iters} iterations, "
          f"{res.n_evals} evaluations, stop {res.stop_reason}), test MSE "
          f"{out['mse']:.6g} = {out['mse'] / out['var_y']:.4f} var(y) "
          f"(limit {MSE_MAX}), NUTS accept {out['accept']:.3f}, mixed MSE "
          f"{out['bayes_mse']:.4g}; {wall:.3f} s; K1 launches {k1}, "
          f"batched {k1_batched}")
    _check(np.isfinite(out["mse"]) and out["mse"] < MSE_MAX * out["var_y"],
           f"full workflow test MSE {out['mse']} not below {MSE_MAX} var(y)")
    _check(k1 >= res.n_evals + 2 and k1_batched > 0,
           f"full workflow: K1 launches {k1} (fit {res.n_evals} + server "
           f"2 at least), batched {k1_batched}")
    _check(bool(np.isfinite(out["theta"].cpu().numpy()).all()),
           "full workflow: non-finite hyperposterior samples")
    return k1 + k1_batched


def phase_ex_bayes(zero, counts):
    """Phase 36: the Bayes workflow at its own data size (40 points, 4
    chains on a mesh of one rank, EX_BAYES_NUTS transitions). Gates:
    every draw finite, the mean acceptance inside EX_ACCEPT. Returns the
    K1 launches."""
    from gp_ss_ak_torch.examples import bayes_workflow

    zero()
    t0 = time.perf_counter()
    out = bayes_workflow.main(n_warmup=EX_BAYES_NUTS[0],
                              n_samples=EX_BAYES_NUTS[1])
    wall = time.perf_counter() - t0
    k1, k1_batched = counts()
    accept = float(out["accept"].mean())
    print(f"example bayes_workflow: {tuple(out['theta'].shape)} samples, "
          f"mean accept {accept:.3f} (gate {EX_ACCEPT}), max split R-hat "
          f"{float(np.max(out['diag']['rhat'])):.4f}; {wall:.3f} s; K1 "
          f"launches {k1}, batched {k1_batched}")
    _check(bool(np.isfinite(out["theta"].cpu().numpy()).all()),
           "bayes workflow: non-finite draws")
    _check(EX_ACCEPT[0] < accept < EX_ACCEPT[1],
           f"bayes workflow: acceptance {accept} outside {EX_ACCEPT}")
    return k1 + k1_batched


def phase_ex_mesh(zero, counts):
    """Phases 37-38: the distributed workflow in float32 on a world of
    one (NCCL) at N_TRAIN, EX_DIST_ITERS iterations (the dist panel
    through K1's cross entry; gate: its own dist-against-ring check),
    and the ring workflow at N_ITER_TRAIN, EX_RING_ITERS iterations
    (gates: finite, its own MSE check; its posterior mean's CG residual
    printed). Returns the K1 launches."""
    from gp_ss_ak_torch.examples import distributed_workflow, ring_workflow

    zero()
    t0 = time.perf_counter()
    d = distributed_workflow.main(n=N_TRAIN, iters=EX_DIST_ITERS)
    wall = time.perf_counter() - t0
    k1_d = counts()[0]
    print(f"example distributed_workflow at N={N_TRAIN} f32: NLML "
          f"{d['res'].trace[0]:.6f} -> {d['res'].fun:.6f} "
          f"({d['res'].n_evals} evaluations), dist - ring means "
          f"{np.abs(d['mu'] - d['mu_ring']).max():.3e} (limit 1e-3), ring "
          f"CG {d['cg_iters']} iterations; {wall:.3f} s; K1 launches {k1_d}")
    _check(k1_d > 0, "distributed workflow launched no K1")
    zero()
    t0 = time.perf_counter()
    r = ring_workflow.main(n=N_ITER_TRAIN, iters=EX_RING_ITERS)
    wall = time.perf_counter() - t0
    k1_r = counts()[0]
    print(f"example ring_workflow at N={N_ITER_TRAIN} f32: NLML "
          f"{r['res'].trace[0]:.6f} -> {r['res'].fun:.6f} "
          f"({r['res'].n_evals} evaluations), held-out MSE {r['mse']:.4g} "
          f"(limit 0.1), posterior-mean CG {r['cg_iters']} iterations, "
          f"relative residual {r['cg_rel']:.3e}; {wall:.3f} s; K1 launches "
          f"{k1_r}")
    _check(np.isfinite(r["res"].fun) and np.isfinite(r["mse"])
           and np.isfinite(r["cg_rel"]), "ring workflow not finite")
    _check(k1_r > 0, "ring workflow launched no K1")
    return k1_d + k1_r


def run_examples(zero, counts_k1):
    """Counted: phases 35-38, the four example workflows on the card,
    each read from zero. Returns their K1 launches."""
    import torch

    t0 = time.perf_counter()
    k1 = phase_ex_full(zero, counts_k1)
    k1 += phase_ex_bayes(zero, counts_k1)
    torch.cuda.empty_cache()
    k1 += phase_ex_mesh(zero, counts_k1)
    torch.cuda.empty_cache()
    print(f"example phases done in {time.perf_counter() - t0:.1f} s; K1 "
          f"launches {k1}")
    return k1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("k3", "k2", "k4", "k6", "warped",
                                       "batched", "sparse", "parallel",
                                       "segmented", "examples"),
                    help="k3: phases 1, 2 and 4; k2: phases 1, 2, 5 and "
                         "14; k4: phases 1, 2 and 5b; k6: phases 1, 2 and "
                         "5c; warped: phases 1, 2, 9b, "
                         "10b, 11b and 13; batched: phases 1, 2 and 15-18; "
                         "sparse: phases 1, 2 and 19-24; parallel: phases "
                         "1, 2 and 25-30; segmented: phases 1, 2 and "
                         "31-34; examples: phases 1, 2 and 35-38. None "
                         "prints a result")
    # one rank of the phases' multi-rank launch (launch_mesh_ranks)
    ap.add_argument("--mesh-io", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    if args.mesh_io is not None:
        return mesh_rank_main(args)
    from gp_ss_ak_torch.ops import contraction, matvec, pairwise, pivchol

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    phase_device()
    sass = phase_build()
    if args.only == "k3":
        phase_k3(device, args.seed)
        print(f"K3 phases passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    def zero():
        pairwise.launches = pairwise.batched_launches = 0
        matvec.launches = matvec.matvec_launches = 0
        contraction.launches = 0
        pivchol.launches = 0

    def counts():
        return (pairwise.launches + pairwise.batched_launches,
                matvec.matvec_launches, matvec.launches)

    def counts_k1():
        """K1's launches on one point set and on batches."""
        return pairwise.launches, pairwise.batched_launches

    def take_k1():
        """K1's launches since the last call (or zero()); then zero."""
        k1 = counts()[0]
        zero()
        return k1

    if args.only == "k4":
        phase_k4(device, args.seed)
        print(f"K4 phases passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    if args.only == "k6":
        phase_k6(device, args.seed)
        print(f"K6 phases passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    if args.only == "k2":
        phase_k2(device, args.seed, sass)
        itrain, itest, imodel = write_case(WORK + "_iterative", args.seed,
                                           N_ITER_TRAIN, N_ITER_TEST)
        zero()
        _check(phase_k2_path(device, args.seed, itrain, itest, imodel) > 0,
               "the K2 path launched no K2")
        print(f"K2 phases passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    if args.only == "parallel":
        dense = write_case(WORK, args.seed, N_TRAIN, N_TEST)
        icase = write_case(WORK + "_iterative", args.seed, N_ITER_TRAIN,
                           N_ITER_TEST)
        run_parallel(device, args.seed, take_k1, dense, icase)
        print(f"parallel phases passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0

    if args.only == "examples":
        run_examples(zero, counts_k1)
        print(f"example phases passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0

    if args.only == "segmented":
        run_segmented(device, args.seed, zero, counts)
        print(f"segmented phases passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0

    if args.only == "batched":
        train, test, _ = write_case(WORK, args.seed, N_TRAIN, N_TEST)
        run_batched(device, args.seed, zero, counts_k1, train, test, WORK)
        print(f"batched phases passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0

    if args.only == "sparse":
        dense = write_case(WORK, args.seed, N_TRAIN, N_TEST)
        icase = write_case(WORK + "_iterative", args.seed, N_ITER_TRAIN,
                           N_ITER_TEST)
        run_sparse(device, args.seed, zero, counts, dense, icase)
        print(f"sparse phases passed in {time.perf_counter() - t_start:.1f} "
              f"s")
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
    k2 = phase_k2(device, args.seed, sass)
    k4 = phase_k4(device, args.seed)
    k6 = phase_k6(device, args.seed)
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

    # counted run 4, matrix-free training (stream mode); from here K4's
    # and K6's launches are added up over the runs that gate one a
    # gradient and one preconditioner an evaluation (_Recorded): 4, 5
    # and 17-19
    zero()
    start, Xfit, yfit, _ = phase_iter_fit(device, itrain, itest, imodel)
    _check(matvec.launches > 0 and matvec.matvec_launches == 0,
           f"iterative fit: (K1, K2, K3) = {counts()}")
    _check(contraction.launches > 0, "iterative fit launched no K4")
    k1_launches += pairwise.launches
    k3_launches += matvec.launches
    k4_launches = contraction.launches
    k6_launches = pivchol.launches
    phase_iter_eval_split(device, args.seed, start, Xfit, yfit)

    # counted run 5, the default train route past DENSE_MAX_N: the CLI
    # with --engine auto, then its training-set predict
    k1_d, k3_d, k4_d, k6_d = run_train_default(itrain, zero, counts)
    k1_launches += k1_d
    k3_launches += k3_d
    k4_launches += k4_d
    k6_launches += k6_d
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

    # counted runs 10-12, the sparse phases: the SGPR fit, Laplace and
    # the gemm_bf16 evaluation, after K1's cross entry at SGPR's shapes
    k1_s, k1_cross = run_sparse(device, args.seed, zero, counts,
                                (train, test, model_path),
                                (itrain, itest, imodel))
    k1_launches += k1_s
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_cross["max_abs_err"])

    # counted runs 13-16, the mesh engines: dist and ring in float64 on
    # one rank and on MESH_RANKS ranks (their launches summed), the two
    # levels, dist in float32 with `train --engine dist`, the ring at
    # N_ITER_TRAIN
    zero()
    k1_p, k1_mesh = run_parallel(device, args.seed, take_k1,
                                 (train, test, model_path),
                                 (itrain, itest, imodel))
    k1_launches += k1_p
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_mesh["max_abs_err"])

    # counted runs 17-19, the segmented evaluator at N_SEG: against the
    # fused one, warm against cold, `train --segmented` and its holdout
    k1_g, k3_g, k4_g, k6_g, k3_seg = run_segmented(device, args.seed, zero,
                                                   counts)
    k1_launches += k1_g
    k3_launches += k3_g
    k4_launches += k4_g
    k6_launches += k6_g
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_seg["max_abs_err"])

    # counted runs 20-23, the four example workflows
    k1_launches += run_examples(zero, counts_k1)

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
        _kernel_entry("contraction (K4, the gradient's contraction, "
                      "N=100000 rank 9)", "gp_ss_ak_torch/csrc/contraction.cu",
                      "none (XLA: gp_ss_ak_tpu/inference/iterative.py:855)",
                      k4_launches, k4),
        _kernel_entry("pivchol (K6, the pivoted Cholesky's steps, N=100000 "
                      "rank 1024)", "gp_ss_ak_torch/csrc/pivchol.cu",
                      "none (XLA: gp_ss_ak_tpu/inference/iterative.py:87)",
                      k6_launches, k6),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
