// K2 for Hopper: the streamed Gram matvec of the matrix-free NLML.
//
// Replaces the Pallas kernel gp_ss_ak_tpu/ops/matvec.py::_matvec_kernel
// (:32, launched by _matvec, wrapped by MatvecOperator.__call__). On
// metric-mapped points x (n rows, d features zero-padded to dp, a multiple
// of 4) and one vector v (n,) it writes
//
//     y[i] = sum_j K(i, j) v[j],   K(i, j) = s2 * exp(-||xi - xj||),
//     K(i, i) = s2 exactly,
//
// with scal = [s2] read from device memory. K is never stored. The caller
// adds bias * sum(v) + sn2 * v (ops/matvec.py).
//
// What bounds it on an H100 (N = 65536, d = 3): N^2 = 4.3e9 Gram entries
// per pass, each with two SFU-class operations (the distance's square
// root and the exponential) and a few FP32 ones; the bytes (the points
// and v, 1.3 MB) do not count. MUFU runs 16 operations an SM a clock, the
// issue slots 128, so both MUFU operations alone take 2.05 ms, and every
// FP32 or integer instruction of an entry costs 1/128 of an SM clock.
// A first design spent ~16 issue slots an entry beside its two MUFU
// operations, and the two budgets contended (2.80 ms at N = 65536 on an
// H100 80GB HBM3 at 700 W). This one:
//  * Spends ~8.5 slots an entry besides the exponential at d <= 3: the
//    true feature count picks a kernel that skips the padding lane
//    (3 FADD, 1 FMUL, 2 FFMA for d2); the column tile is staged as float4
//    (x, y, z, v), one LDS.128 per column for RPT = 4 rows; the distance
//    is one MUFU.SQRT (sqrt.approx is 0 at 0, so no guard); the points
//    are scaled by log2 e once per load, so the exponent needs no
//    multiply and its negation rides MUFU.EX2's operand; then the FFMA
//    with v.
//  * Computes a fixed share of the exponentials on the FP32 pipes
//    (ex2_poly.cuh: ~10 slots each) instead of MUFU: POLY_OF_8 columns of
//    every group of 8 in the tile, spread through the group (column u
//    when POLY_OF_8 * u mod 8 < POLY_OF_8: 0, 3 and 6 for 3), so that
//    each stretch of the unrolled loop mixes MUFU and FP32 work. With x
//    entries on MUFU the SM needs (1 + x) / 16 clocks of MUFU and
//    (8.5 + x + 10 (1 - x)) / 128 of issue per entry; they meet near
//    x = 0.6, ~1.65 ms at N = 65536. The class of an entry is fixed by
//    its column's position, never by timing, so two passes give the same
//    bits; K(i, i) is exactly s2 in both classes (d2 = 0 exactly, sqrt
//    gives 0, ex2.approx(-0) = 1 and the polynomial's c0 = 1).
//  * Runs 2 blocks of 256 threads an SM (up to 128 registers a thread)
//    over 16 columns an iteration of its inner loop, which leaves the
//    compiler room to interleave the polynomials' dependent chains with
//    the MUFU operations. The share was timed on an H100 by building
//    this file at each POLY_OF_8 when K2 was redesigned for Hopper.
//  * Cuts the columns into slabs on a second grid axis, as many as make
//    the blocks close to a whole number of waves (the wrapper's plan,
//    from n and the SM count alone); each block writes its partial sums
//    to a scratch buffer and a second kernel adds the slabs in a fixed
//    order. No atomics.
//  * d = 1 and 2 take the same kernel: operator_arrays zero-pads the
//    lanes past d, so their differences add exactly 0. d = 4..16 take a
//    general path (points as float4s, v apart, padding lanes computed).
//  * Ragged n is masked in the kernel (zero points and zero v past n).
//    float32 only, the TPU kernel's type.

#include <cuda_runtime.h>

#include "ex2_poly.cuh"

namespace {

constexpr int NT = 256;             // threads per block
constexpr int RPT = 4;              // rows per thread
constexpr int BM = NT * RPT;        // rows per block
constexpr int BK = NT;              // column points per shared tile
constexpr int GROUP = 8;            // the split's period, in columns
constexpr int STEP = 16;            // columns an inner-loop iteration
constexpr int POLY_OF_8 = 3;        // of every GROUP on the polynomial
constexpr int MIN_BLOCKS = 2;       // blocks an SM holds (ops/matvec.py)
constexpr float LOG2E = 1.4426950408889634f;

static_assert(POLY_OF_8 >= 0 && POLY_OF_8 <= GROUP, "share out of range");
static_assert(BK % STEP == 0 && STEP % GROUP == 0, "whole groups");

// the square root on MUFU, flushing subnormals: within ~1 ulp, 0 at 0
__device__ __forceinline__ float sqrt_approx(float x)
{
    float y;
    asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// exp(-dist) from t = dist * log2 e, for the column at position u of its
// inner-loop step (a constant once the loop is unrolled)
__device__ __forceinline__ float exp_neg(float t, int u)
{
    return POLY_OF_8 * u % GROUP < POLY_OF_8 ? gp_ex2::poly(-t)
                                              : gp_ex2::mufu(-t);
}

__device__ __forceinline__ float4 scaled(float4 p)
{
    return make_float4(p.x * LOG2E, p.y * LOG2E, p.z * LOG2E, p.w * LOG2E);
}

__device__ __forceinline__ float lane(const float4& p, int j)
{
    return j == 0 ? p.x : j == 1 ? p.y : j == 2 ? p.z : p.w;
}

// partial[slab, i] = sum over the slab's columns j of exp(-||xi - xj||) v[j]
// for d <= 3: each point is one float4 (features, zero padding), and the
// tile holds (features * log2 e, v[j]) per column.
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
matvec_packed(const float4* __restrict__ x, const float* __restrict__ v,
              float* __restrict__ partial, int n, int slab_w)
{
    __shared__ float4 xs[BK];

    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * BM;
    const int c_begin = blockIdx.y * slab_w;
    const int c_end = min(n, c_begin + slab_w);

    float xr[RPT][3];
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int gi = row0 + tid + r * NT;
        const float4 p = gi < n ? scaled(x[gi])
                                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < 3; ++j) xr[r][j] = lane(p, j);
        acc[r] = 0.0f;
    }

    for (int col0 = c_begin; col0 < c_end; col0 += BK) {
        // one column per thread: its scaled point and its v (zero past
        // the slab)
        const int gj = col0 + tid;
        float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gj < c_end) {
            c = scaled(x[gj]);
            c.w = v[gj];
        }
        xs[tid] = c;
        __syncthreads();
#pragma unroll 1
        for (int k0 = 0; k0 < BK; k0 += STEP) {
#pragma unroll
            for (int u = 0; u < STEP; ++u) {
                const float4 ck = xs[k0 + u];
#pragma unroll
                for (int r = 0; r < RPT; ++r) {
                    float t = xr[r][0] - ck.x;
                    float d2 = t * t;
#pragma unroll
                    for (int j = 1; j < 3; ++j) {
                        t = xr[r][j] - lane(ck, j);
                        d2 = fmaf(t, t, d2);
                    }
                    acc[r] = fmaf(exp_neg(sqrt_approx(d2), u), ck.w,
                                  acc[r]);
                }
            }
        }
        __syncthreads();            // xs is rewritten by the next tile
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int gi = row0 + tid + r * NT;
        if (gi < n) partial[(size_t)blockIdx.y * n + gi] = acc[r];
    }
}

// the same for any d <= 16: D4 float4s a point at most (d4 of them live),
// v in a tile of its own
template <int D4>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
matvec_general(const float4* __restrict__ x, const float* __restrict__ v,
               float* __restrict__ partial, int n, int d4, int slab_w)
{
    __shared__ float4 xs[D4][BK];
    __shared__ float vs[BK];

    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * BM;
    const int c_begin = blockIdx.y * slab_w;
    const int c_end = min(n, c_begin + slab_w);

    float4 xr[RPT][D4];
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int gi = row0 + tid + r * NT;
#pragma unroll
        for (int j = 0; j < D4; ++j)
            xr[r][j] = (gi < n && j < d4) ? scaled(x[(size_t)gi * d4 + j])
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[r] = 0.0f;
    }

    for (int col0 = c_begin; col0 < c_end; col0 += BK) {
        const int gj = col0 + tid;
        const bool live = gj < c_end;
#pragma unroll
        for (int j = 0; j < D4; ++j)
            xs[j][tid] = (live && j < d4) ? scaled(x[(size_t)gj * d4 + j])
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
        vs[tid] = live ? v[gj] : 0.0f;
        __syncthreads();
#pragma unroll 1
        for (int k0 = 0; k0 < BK; k0 += GROUP) {
#pragma unroll
            for (int u = 0; u < GROUP; ++u) {
                const float vk = vs[k0 + u];
#pragma unroll
                for (int r = 0; r < RPT; ++r) {
                    float d2 = 0.0f;
#pragma unroll
                    for (int j = 0; j < D4; ++j) {
                        if (j >= d4) continue;
                        const float4 a = xr[r][j], b = xs[j][k0 + u];
                        float t = a.x - b.x;
                        d2 = fmaf(t, t, d2);
                        t = a.y - b.y;
                        d2 = fmaf(t, t, d2);
                        t = a.z - b.z;
                        d2 = fmaf(t, t, d2);
                        t = a.w - b.w;
                        d2 = fmaf(t, t, d2);
                    }
                    acc[r] = fmaf(exp_neg(sqrt_approx(d2), u), vk,
                                  acc[r]);
                }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int gi = row0 + tid + r * NT;
        if (gi < n) partial[(size_t)blockIdx.y * n + gi] = acc[r];
    }
}

// y[i] = s2 * sum_s partial[s, i], the slabs added in order
__global__ void __launch_bounds__(NT)
matvec_reduce(const float* __restrict__ partial,
              const float* __restrict__ scal, float* __restrict__ y, int n,
              int slabs)
{
    const int i = blockIdx.x * NT + threadIdx.x;
    if (i >= n) return;
    float s = 0.0f;
    for (int k = 0; k < slabs; ++k) s += partial[(size_t)k * n + i];
    y[i] = scal[0] * s;
}

}  // namespace

extern "C" {

// x (n, dp) with d features zero-padded to dp, a multiple of 4, at most
// 16, 16-byte aligned; v (n,); scal (1,) = [s2]; partial (slabs, n)
// scratch; y (n,): float32, contiguous, on `device`. Column slab s covers
// [s * slab_w, (s+1) * slab_w) and slabs * slab_w >= n > (slabs - 1) *
// slab_w. Returns a cudaError_t code (0 on success).
int gp_matvec_f32(const void* x, const void* v, const void* scal,
                  void* partial, void* y, int n, int dp, int d, int slab_w,
                  int slabs, int device, void* stream)
{
    if (n <= 0 || dp <= 0 || dp % 4 != 0 || dp > 16 || d <= 0 || d > dp ||
        (d + 3) / 4 * 4 != dp || slab_w <= 0 || slabs <= 0 ||
        slabs > 65535 || (long long)slabs * slab_w < n ||
        (long long)(slabs - 1) * slab_w >= n)
        return (int)cudaErrorInvalidValue;
    // this library links its own CUDA runtime, whose current device is
    // separate from the caller's: select the tensors' device explicitly
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const float4* xf = (const float4*)x;
    const float* vf = (const float*)v;
    float* pf = (float*)partial;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((n + BM - 1) / BM, slabs);
    if (d <= 3)
        matvec_packed<<<grid, NT, 0, s>>>(xf, vf, pf, n, slab_w);
    else if (dp == 4)
        matvec_general<1><<<grid, NT, 0, s>>>(xf, vf, pf, n, 1, slab_w);
    else
        matvec_general<4><<<grid, NT, 0, s>>>(xf, vf, pf, n, dp / 4, slab_w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    matvec_reduce<<<(n + NT - 1) / NT, NT, 0, s>>>(
        pf, (const float*)scal, (float*)y, n, slabs);
    return (int)cudaGetLastError();
}

}  // extern "C"
