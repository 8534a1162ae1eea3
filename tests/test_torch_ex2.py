"""K2's exponential on the FP32 pipes, its launch plan and its d argument,
on the CPU (no jax, no card).

csrc/ex2_poly.cuh computes 2^x for x <= 0 as 2^j * p(f): x clamped to
-126, j = x rounded to nearest by adding and subtracting 1.5 * 2^23, f =
x - j, p a degree-5 polynomial in Horner form with c0 = 1, and j added to
p's exponent bits. The test emulates that float32 sequence in numpy with
the coefficients read from the header's marked line, and holds it to
float64's exp2: exactly 1 at +-0 (so K2's diagonal stays s2 in both
classes of its split), within 3 ulp of 2^-23 relative over [-126, 0]
(ex2.approx's own 2 ulp, plus one for the emulation's multiply-adds,
which round in float64 before float32), and finite and non-negative
below -126. The rest checks the wrapper's plan and argument handling,
chip_smoke.py's reading of SASS on a made-up listing, and which sources
the kernel library is built from.
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from gp_ss_ak_torch.ops import _build, matvec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "gp_ss_ak_torch", "csrc", "ex2_poly.cuh")
ROUND = np.float32(12582912.0)          # 1.5 * 2^23
ULP = 2.0 ** -23
TOL = 3 * ULP


@pytest.fixture(autouse=True)
def one_thread():
    # six pytest workers at a thread per core oversubscribe the CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def coefficients():
    """c1..c5 from the header's EX2_POLY_COEFFS line, as float32."""
    text = open(HEADER).read()
    line = re.search(r"EX2_POLY_COEFFS:(.*)", text).group(1).split()
    return np.array([float.fromhex(c) for c in line], dtype=np.float32)


def _fma(a, b, c):
    # a * b is exact in float64 (two 24-bit significands); the sum rounds
    # to float64, then to float32
    return (a.astype(np.float64) * b + c).astype(np.float32)


def poly_ex2(x):
    """ex2_poly.cuh's poly() in numpy float32."""
    c = coefficients()
    x = np.maximum(np.asarray(x, dtype=np.float32), np.float32(-126.0))
    t = x + ROUND
    f = x - (t - ROUND)
    p = _fma(np.full_like(f, c[4]), f, c[3])
    for k in (2, 1, 0):
        p = _fma(p, f, c[k])
    p = _fma(p, f, np.float32(1.0))
    bits = p.view(np.uint32) + (t.view(np.uint32) << np.uint32(23))
    return bits.view(np.float32)


def test_coefficients_have_one_source():
    """The constants the kernel compiles are the marked line's."""
    text = open(HEADER).read()
    consts = re.findall(r"constexpr float C(\d) = (\S+)f;", text)
    assert [int(k) for k, _ in consts] == [1, 2, 3, 4, 5]
    np.testing.assert_array_equal(
        np.array([float.fromhex(v) for _, v in consts], dtype=np.float32),
        coefficients())
    # each is a float32 value, so the literal is what the card holds
    assert all(float(c) == float.fromhex(v)
               for c, (_, v) in zip(coefficients(), consts))


def test_zero_gives_exactly_one():
    out = poly_ex2(np.array([0.0, -0.0], dtype=np.float32))
    assert out.tolist() == [1.0, 1.0]


def test_relative_error_over_the_range():
    rng = np.random.default_rng(0)
    # where j changes (x = k + 1/2, ties to even) and the float32
    # neighbours on both sides; the ends; 10^6 uniform points
    half = np.arange(-126, 1, dtype=np.float32) - np.float32(0.5)
    edges = np.concatenate([half, np.nextafter(half, np.float32(-np.inf)),
                            np.nextafter(half, np.float32(np.inf))])
    x = np.concatenate([
        rng.uniform(-126.0, 0.0, 1_000_000).astype(np.float32),
        edges[(edges >= -126) & (edges <= 0)],
        np.array([-126.0, np.nextafter(np.float32(-126), np.float32(0)),
                  -1e-30, -1e-7, 0.0], dtype=np.float32)])
    got = poly_ex2(x).astype(np.float64)
    want = np.exp2(x.astype(np.float64))
    rel = np.abs(got / want - 1.0)
    assert rel.max() <= TOL, (rel.max() / ULP, x[rel.argmax()])


def test_far_below_the_range_is_finite_and_tiny():
    x = np.array([-126.5, -127.0, -150.0, -1e4, -3.4e38, -np.inf],
                 dtype=np.float32)
    out = poly_ex2(x)
    assert np.all(np.isfinite(out)) and np.all(out >= 0)
    assert np.all(out <= np.float32(2.0 ** -126))


def test_plan_covers_n_in_whole_tiles_near_whole_waves():
    for sms in (132, 114, 66, 1):
        wave = sms * matvec.MATVEC_BLOCKS_PER_SM
        for n in (1, 255, 256, 257, 1000, 4097, 16384, 32768, 40050, 65536,
                  100000, 135168, 140000, 150000, 270000, 1000000):
            width, slabs = matvec.matvec_slabs(n, sms)
            assert width % matvec.MATVEC_TILE == 0
            assert width <= matvec.MATVEC_MAX_SLAB
            assert slabs * width >= n > (slabs - 1) * width
            rows = -(-n // matvec.MATVEC_ROWS)
            if n >= 32768:
                # a pass of ceil(blocks / wave) slab widths, within 15%
                # of the work spread evenly over the wave's slots
                waves = -(-rows * slabs // wave)
                assert waves * width <= 1.15 * rows * n / wave, (sms, n)
    # an H100's 132 SMs: the plans timed on the card
    assert matvec.matvec_slabs(65536, 132) == (16384, 4)
    assert matvec.matvec_slabs(32768, 132) == (4096, 8)
    assert matvec.matvec_slabs(16384, 132) == (1024, 16)
    assert matvec.matvec_slabs(100000, 132) == (12544, 8)
    assert matvec.matvec_slabs(150000, 132) == (10752, 14)


@pytest.mark.parametrize("dp,d,ok", [(4, 3, True), (4, 1, True),
                                     (4, 4, True), (3, 3, True),
                                     (8, 5, True), (16, 13, True),
                                     (4, 5, False), (8, 3, False),
                                     (4, 0, False), (16, 12, False)])
def test_feature_count_is_validated(dp, d, ok):
    Xm = torch.zeros(5, dp)
    if ok:
        assert matvec.feature_count(Xm, d) == d
        assert matvec.feature_count(Xm) == dp
    else:
        with pytest.raises(ValueError):
            matvec.feature_count(Xm, d)


def test_d_is_checked_before_the_device_dispatch():
    X, scal = matvec.operator_arrays(torch.rand(6, 3), 0.7)
    v = torch.ones(6)
    with pytest.raises(ValueError):
        matvec.streamed_matvec(X, scal, 0.1, 0.01, v, 5)
    with pytest.raises(TypeError):
        matvec.streamed_matvec(X, scal, 0.1, 0.01, v, 3.0)
    with pytest.raises(TypeError):
        matvec.streamed_matvec(X, scal, 0.1, 0.01, v, True)
    before = matvec.matvec_launches
    with pytest.raises(ValueError):
        matvec.streamed_matvec(X.to("meta"), scal.to("meta"), 0.1, 0.01,
                               v.to("meta"), 5)
    assert matvec.matvec_launches == before


def test_plain_result_does_not_depend_on_d():
    g = np.random.default_rng(3)
    Xm = torch.from_numpy(g.uniform(-1.5, 1.5, (300, 3)))
    v = torch.from_numpy(g.standard_normal(300))
    X, scal = matvec.operator_arrays(Xm, 0.6)
    ref = matvec.streamed_matvec(X.double(), scal.double(), 0.2, 0.016, v)
    for d in (3, None):
        out = matvec.streamed_matvec(X.double(), scal.double(), 0.2, 0.016,
                                     v, d)
        assert torch.equal(out, ref)
    op = matvec.MatvecOperator(Xm.float(), 0.6, 0.2, 0.016)
    assert op.d == 3
    assert torch.equal(op(v.float()), matvec.streamed_matvec(
        op.X, op.scal, op.bias, op.sn2, v.float(), 4))


_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

# a made-up cuobjdump -sass listing: an outer loop around an inner one
# of two Gram entries (two MUFU.SQRT), one ex2 of them a polynomial
SASS = """
        Function : _ZN12_GLOBAL__N_113matvec_packedEPK6float4PKfPfii
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;       /* 0x0000000000007919 */
        /*0020*/                   LDS.128 R4, [R2] ;        /* 0x0000000002047984 */
        /*0030*/                   FADD R8, R4, -R12 ;
        /*0040*/                   FMUL R8, R8, R8 ;
        /*0050*/                   FFMA R8, R9, R9, R8 ;
        /*0060*/                   MUFU.SQRT R8, R8 ;
        /*0070*/                   MUFU.EX2 R8, -R8 ;
        /*0080*/                   FFMA R20, R8, R7, R20 ;
        /*0090*/                   FADD R9, R5, -R13 ;
        /*00a0*/                   MUFU.SQRT R9, R9 ;
        /*00b0*/                   FMNMX R9, -R9, -126, !PT ;
        /*00c0*/                   LEA R9, R10, R9, 0x17 ;
        /*00d0*/                   FFMA R21, R9, R7, R21 ;
        /*00e0*/                   ISETP.GE.AND P0, PT, R3, 0x100, PT ;
        /*00f0*/               @!P0 BRA 0x20 ;
        /*0100*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0110*/              @P1 BRA 0x10 ;
        /*0120*/                   EXIT ;
        /*0130*/                   BRA 0x130;
        /*0140*/                   NOP;
"""


def test_sass_reading():
    insns = cs.sass_functions(SASS)[
        "_ZN12_GLOBAL__N_113matvec_packedEPK6float4PKfPfii"]
    assert len(insns) == 21
    loop = cs.innermost_loop(insns, "MUFU")
    assert [a for a, _, _ in loop] == list(range(0x20, 0x100, 0x10))
    hist = cs.opcode_histogram(loop)
    assert hist["MUFU.SQRT"] == 2 and hist["LDS.128"] == 1
    assert hist["FFMA"] == 3 and hist["BRA"] == 1
    slots = cs.issue_classes(hist, 2)
    assert slots["total"] == 7.0 and slots["MUFU"] == 1.5
    assert slots["FP32"] == 3.5 and slots["INT"] == 1.0
    assert slots["memory"] == 0.5 and slots["other"] == 0.5
    assert "NOP" not in cs.opcode_histogram(insns)
    assert cs.innermost_loop(insns, "HMMA") is None


def test_library_is_built_from_the_four_kernels_alone():
    """`_build.load()` compiles and links the kernel sources alone: the
    four of K1-K4, and K6's, and nothing else."""
    assert [p.name for p in _build._sources()] == [
        "contraction.cu", "gram.cu", "matmat.cu", "matvec.cu",
        "pivchol.cu"]
