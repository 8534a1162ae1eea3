// 2^x in float32 two ways: on the SFU (MUFU.EX2) and as a polynomial on
// the FP32 pipes, for x <= 0. Included by K2 (matvec.cu), K3
// (matmat.cu) and K4 (contraction.cu).
//
// An H100 SM runs 16 MUFU operations a clock against 128 FP32
// instructions, so a kernel with two SFU operations per element and a
// handful of FP32 ones waits on MUFU; computing a fixed share of its
// exponentials on the FP32 pipes balances the two (the scheme of
// FlashAttention-4). The polynomial form, for x in [-126, 0]:
//
//     j = rn(x)            by adding and subtracting 1.5 * 2^23 (2 FADD;
//                          no FRND or float-to-integer conversion, which
//                          issue at MUFU's quarter rate on sm_90)
//     f = x - j            in [-0.5, 0.5], exact (1 FADD)
//     p = 2^f              degree-5 minimax polynomial in Horner form (5
//                          FFMA), c0 = 1 exactly, so p(-0) = 1
//     2^x = p * 2^j        j added to p's exponent field: the low 9 bits
//                          of rn(x) + 1.5 * 2^23 are j in two's
//                          complement, shifted to bit 23 (1 LEA)
//
// x is clamped to -126 first (1 FMNMX), so 2^j stays a normal number
// and far pairs never wrap the exponent field: below -126 it returns
// 2^-126 (finite, ~1.2e-38) where ex2.approx.ftz returns 0. Relative
// error: 1.6 ulp of 2^-23 with these float32 coefficients (minimax
// within 0.57 ulp, then rounded and tuned; tests/test_torch_ex2.py
// emulates the sequence in numpy), against ex2.approx's 2 ulp.

#pragma once

namespace gp_ex2 {

// the polynomial's coefficients c1..c5 (c0 = 1); the line is read by
// tests/test_torch_ex2.py
// EX2_POLY_COEFFS: 0x1.62e42p-1 0x1.ebf968p-3 0x1.c6bdfp-5 0x1.3d0762p-7 0x1.5a1bb6p-10
constexpr float C1 = 0x1.62e42p-1f;
constexpr float C2 = 0x1.ebf968p-3f;
constexpr float C3 = 0x1.c6bdfp-5f;
constexpr float C4 = 0x1.3d0762p-7f;
constexpr float C5 = 0x1.5a1bb6p-10f;
constexpr float ROUND = 12582912.0f;        // 1.5 * 2^23
constexpr float LOWEST = -126.0f;

// ex2.approx on MUFU, flushing subnormals: within 2 ulp, exactly 1 at -0
__device__ __forceinline__ float mufu(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// the same on the FP32 pipes (see above); the _rn intrinsics keep the
// compiler from reassociating the rounding trick
__device__ __forceinline__ float poly(float x)
{
    x = fmaxf(x, LOWEST);
    const float t = __fadd_rn(x, ROUND);
    const float f = __fsub_rn(x, __fsub_rn(t, ROUND));
    float p = __fmaf_rn(C5, f, C4);
    p = __fmaf_rn(p, f, C3);
    p = __fmaf_rn(p, f, C2);
    p = __fmaf_rn(p, f, C1);
    p = __fmaf_rn(p, f, 1.0f);
    return __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
}

}  // namespace gp_ex2
