"""The kernel bounds and the K3 gate's two controls of chip_smoke.py, on
the CPU.

`chip_smoke.bound` prices a kernel's work as the largest of three terms:
bytes over 3.35 TB/s; the SFU and FP32 work together ("SFU/FMA",
`sfu_fma_ms`): an rsqrt and an ex2 per Gram entry on MUFU at SMs x 16 x
the SM clock, the FP32 operations outside any product on the FP32 pipes
at 67 TFLOP/s (two flops an instruction), and the ex2 split at its best
between MUFU and a 10-slot polynomial on the FP32 pipes (the slots of
gp_ss_ak_torch/csrc/ex2_poly.cuh's SASS, which a probe's rate on the
card confirmed); and a product
over the 495 TFLOP/s of TF32 at three TF32 products each (float32
accuracy on the tensor cores). At an H100 SXM's 132 SMs and 1.98 GHz
the numbers below are the ones PERF.md states, to 1e-3 relative; the
MUFU-only SFU term, which PERF.md prints beside the balanced one, is
2.054 ms at N = 65536. The peaks, `bound`, `sfu_fma_ms`, the work counts
of K1 and K3, `card_rates` and the ore body are the benchmark's own
(port_bench/roofline.py, port_bench/data.py), so the smoke and the
benchmark read one yardstick.

The K3 gate (max |Y - plain64| per column within 1.5e-7 (s2 + bias)
||V[:, b]||_1) must reject a TF32 product and accept a 3xTF32 one, whose
split leaves ~2^-21 of each product; at n = 4097, B = 64 they sit at
~17x and ~0.005 of it.
"""

import ast
import importlib.util
import os

import pytest
import torch

from port_bench import data, roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

SMS, CLOCK_HZ = 132, 1.98e9             # H100 SXM: SMs, max SM clock
N = 65536                               # the matrix-free path's N


@pytest.fixture(autouse=True)
def one_thread():
    # six pytest workers at a thread per core oversubscribe the CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("work,ms,term", [
    (cs.gram_work(16384, 16384, 3), 0.3206, "bytes"),        # K1
    (cs.matvec_work(N, 3), 1.454, "SFU/FMA"),                # K2
    (cs.matmat_work(N, 3, 1), 1.426, "SFU/FMA"),             # K3 setup
    (cs.matmat_work(N, 3, 9), 1.426, "SFU/FMA"),             # fit's CG
    (cs.matmat_work(N, 3, 64), 3.332, "tensor"),             # SLQ
    (cs.matmat_work(N, 3, 256), 13.33, "tensor"),            # a request
    (cs.matmat_work(N, 3, 1024), 53.31, "tensor"),           # CLI's solves
    (cs.contraction_work(100000, 3, 9), 9.851, "SFU/FMA"),   # K4, the fit
    (cs.pivchol_work(100000, 1024, 3), 63.27, "bytes"),      # K6, the fit
    (cs.pivchol_work(16384, 341, 3), 1.1741, "bytes"),       # K6, 16384
], ids=["K1-16384", "K2", "K3-B1", "K3-B9", "K3-B64", "K3-B256",
        "K3-B1024", "K4-100000", "K6-100000", "K6-16384"])
def test_bound_matches_perf_md(work, ms, term):
    b_ms, b_term = cs.bound(work, sms=SMS, clock_hz=CLOCK_HZ)
    assert b_term == term
    assert b_ms == pytest.approx(ms, rel=1e-3)


@pytest.mark.parametrize("n,rank,d", [(1, 4, 3), (37, 64, 2),
                                      (16384, 341, 3), (100000, 1024, 3)])
def test_pivchol_work_is_its_closed_form(n, rank, d):
    """K6's work summed step by step: step j reads rows 0..j-1 of L^T
    (4 n j bytes) and the points, d twice and L^T's row j once
    (4 n (d + 3)); j FMA and 3d + 7 FP32 operations a point; a sqrt and
    an exp a point."""
    steps = [(4 * n * j + 4 * n * (d + 3), 2 * n * (j + 3 * d + 7), 2 * n)
             for j in range(rank)]
    got = cs.pivchol_work(n, rank, d)
    for i in range(3):
        assert got[i] == pytest.approx(sum(s[i] for s in steps), rel=1e-12)
    assert got[3] == 0.0


def test_sfu_term_follows_the_card():
    # half the SMs at the same clock: twice the MUFU-only SFU time; the
    # balanced term moves more ex2 onto the FP32 pipes, whose peak does
    # not follow the SM count here, so it grows by less
    work = cs.matvec_work(N, 3)
    mufu, balanced = cs.sfu_fma_ms(work, sms=SMS, clock_hz=CLOCK_HZ)
    mufu2, balanced2 = cs.sfu_fma_ms(work, sms=SMS // 2, clock_hz=CLOCK_HZ)
    assert mufu == pytest.approx(2.054, rel=1e-3)
    assert mufu2 == pytest.approx(2 * mufu, rel=1e-12)
    assert balanced < balanced2 < 2 * balanced
    half, term = cs.bound(work, sms=SMS // 2, clock_hz=CLOCK_HZ)
    assert term == "SFU/FMA" and half == pytest.approx(balanced2, rel=1e-12)


@pytest.mark.parametrize("work", [cs.matvec_work(N, 3),
                                  cs.matmat_work(N, 3, 9)],
                         ids=["K2", "K3-B9"])
def test_balanced_sfu_term_is_the_best_split(work):
    """The balanced term splits the ex2 so that MUFU and the FP32 pipes
    finish together, and no split of the ex2 between them does better;
    it lies between the FP32 work alone and the MUFU-only term."""
    _, fp32, sfu, _ = work
    mufu_rate = SMS * cs.SFU_PER_SM_CLOCK * CLOCK_HZ
    slots = cs.PEAK_FP32_FLOPS / 2
    c = cs.POLY_EX2_SLOTS

    def split_ms(x):
        return 1e3 * max((sfu / 2 + x) / mufu_rate,
                         (fp32 / 2 + c * (sfu / 2 - x)) / slots)

    mufu_only, balanced = cs.sfu_fma_ms(work, sms=SMS, clock_hz=CLOCK_HZ)
    best = min(split_ms(sfu / 2 * k / 1000) for k in range(1001))
    assert balanced == pytest.approx(best, rel=2e-3) and balanced <= best
    assert 1e3 * fp32 / cs.PEAK_FP32_FLOPS < balanced < mufu_only
    assert mufu_only == pytest.approx(split_ms(sfu / 2), rel=1e-12)


def test_yardstick_is_the_benchmarks():
    """chip_smoke.py holds no copy of port_bench's yardstick or ore body:
    it binds their objects, and defines none of their names."""
    shared = {"PEAK_BYTES_S": roofline, "PEAK_FP32_FLOPS": roofline,
              "PEAK_TF32_FLOPS": roofline, "SFU_PER_SM_CLOCK": roofline,
              "POLY_EX2_SLOTS": roofline, "card_rates": roofline,
              "sfu_fma_ms": roofline, "bound": roofline,
              "gram_work": roofline, "matmat_work": roofline,
              "ore_body": data}
    for name, owner in shared.items():
        assert getattr(cs, name) is getattr(owner, name), name
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    defined = {t.id for node in tree.body if isinstance(node, ast.Assign)
               for target in node.targets
               for t in ast.walk(target) if isinstance(t, ast.Name)}
    defined |= {node.name for node in tree.body
                if isinstance(node, ast.FunctionDef)}
    assert not defined & set(shared)


@pytest.mark.parametrize("d", [3, 4])
def test_k3_gate_rejects_tf32_and_accepts_3xtf32(d):
    from gp_ss_ak_torch.ops import matvec

    g = torch.Generator().manual_seed(d)
    Xk, scal, V = cs._k3_case(g, torch.device("cpu"), 4097, 64, d)
    ref = matvec.streamed_matmat_plain(Xk.double(), scal.double(), cs.BIAS,
                                       cs.SN2, V.double())
    lim = cs.TOL_K3 * (cs.SIGMA ** 2 + cs.BIAS) * V.double().abs().sum(0)

    def worst_share(out):
        return float(((out - ref).abs().max(dim=0).values / lim).max())

    assert worst_share(cs.tf32_control(Xk, scal, V)) > 1.0
    assert worst_share(cs.split_tf32_control(Xk, scal, V)) <= 1.0
