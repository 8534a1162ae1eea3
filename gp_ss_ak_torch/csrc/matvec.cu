// K2 for Hopper: the streamed Gram matvec of the matrix-free NLML.
//
// Replaces the Pallas kernel gp_ss_ak_tpu/ops/matvec.py::_matvec_kernel
// (:32, launched by _matvec, wrapped by MatvecOperator.__call__). On
// metric-mapped points x (n rows, dp features, zero-padded to a multiple of
// 4) and one vector v (n,) it writes
//
//     y[i] = sum_j K(i, j) v[j],   K(i, j) = s2 * exp(-||xi - xj||),
//     K(i, i) = s2 exactly,
//
// with scal = [s2] read from device memory. K is never stored. The caller
// adds bias * sum(v) + sn2 * v (matvec.py:257).
//
// What bounds it on an H100 (N = 65536, d = 3): N^2 = 4.3e9 Gram entries
// per pass, each with two SFU operations (rsqrt, then ex2). At 16 a clock
// per SM, 132 SMs and 1.98 GHz those take 2.05 ms, the largest term of
// chip_smoke.bound: above the FP32 work (11 flop an entry with a
// multiply-add counted as two: three differences, three multiply-adds for
// d2, the multiply-add with v; 0.71 ms at 67 TFLOP/s) and the bytes (the
// points and v, 1.3 MB). That SFU term holds only while both run on MUFU,
// as here: moving part of the ex2 onto the FP32 pipes as a polynomial
// would lower the floor. With the ~12 other issued instructions an entry
// the pass is bound by issue, not by memory. K3 at B = 1 spends 9.2 ms
// on the same pass: it stages every Gram entry in shared memory and runs
// a mostly masked FFMA tile.
//
// Design:
//  * Each thread owns RPT rows and keeps their points in registers. The
//    column points and v go through shared memory one tile of BK at a time;
//    every thread then reads the same tile entry (a broadcast, no bank
//    conflicts) and folds it into its rows' sums in a fixed order.
//  * Distances by direct differences, as K1 and K3 on the card: d2 is
//    exactly 0 on the diagonal, so exp2(-0) = 1 gives K(i, i) = s2 exactly
//    with no index test; s2 is applied once per output.
//  * One thread per row fills only a quarter of the card at N = 65536, so
//    the columns are cut into slabs on a second grid axis (a number fixed
//    by the wrapper from n alone). Each block writes its partial sums to a
//    scratch buffer; a second kernel adds the slabs in a fixed order. No
//    atomics: two passes over the same v give the same bits.
//  * Ragged n is masked in the kernel (zero points and zero v past n).
//  * float32 only, the TPU kernel's type. A simple first version: no
//    cp.async pipelining or tuning yet.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int RPT = 2;              // rows per thread
constexpr int BM = NT * RPT;        // rows per block
constexpr int BK = NT;              // column points per shared tile
constexpr float LOG2E = 1.4426950408889634f;

// SFU approximations, flushing subnormals (as in K3): ex2 is within 2 ulp
// and returns 1 exactly at -0; rsqrt is within 1 ulp
__device__ __forceinline__ float ex2_approx(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float rsqrt_approx(float x)
{
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float sq4(float4 a, float4 b, float acc)
{
    float t = a.x - b.x;
    acc = fmaf(t, t, acc);
    t = a.y - b.y;
    acc = fmaf(t, t, acc);
    t = a.z - b.z;
    acc = fmaf(t, t, acc);
    t = a.w - b.w;
    return fmaf(t, t, acc);
}

// partial[slab, i] = sum over the slab's columns j of exp(-||xi - xj||) v[j]
// D4: the points' float4 count per row, at most.
template <int D4>
__global__ void __launch_bounds__(NT)
matvec_partial(const float4* __restrict__ x, const float* __restrict__ v,
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
            xr[r][j] = (gi < n && j < d4) ? x[(size_t)gi * d4 + j]
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[r] = 0.0f;
    }

    for (int col0 = c_begin; col0 < c_end; col0 += BK) {
        // one column per thread: its point and its v (zero past the slab)
        const int gj = col0 + tid;
        const bool live = gj < c_end;
#pragma unroll
        for (int j = 0; j < D4; ++j)
            xs[j][tid] = (live && j < d4) ? x[(size_t)gj * d4 + j]
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
        vs[tid] = live ? v[gj] : 0.0f;
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < BK; ++k) {
            const float vk = vs[k];
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
                float d2 = 0.0f;
#pragma unroll
                for (int j = 0; j < D4; ++j)
                    if (j < d4) d2 = sq4(xr[r][j], xs[j][k], d2);
                // below 1e-30, sqrt(d2) < 1e-15 rounds exp(-.) to 1 anyway
                const float dist = d2 > 1e-30f ? d2 * rsqrt_approx(d2) : 0.0f;
                acc[r] = fmaf(ex2_approx(-dist * LOG2E), vk, acc[r]);
            }
        }
        __syncthreads();            // xs/vs are rewritten by the next tile
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

// x (n, dp) with dp a multiple of 4, at most 16, 16-byte aligned; v (n,);
// scal (1,) = [s2]; partial (slabs, n) scratch; y (n,): float32,
// contiguous, on `device`. Column slab s covers [s * slab_w, (s+1) * slab_w)
// and slabs * slab_w >= n > (slabs - 1) * slab_w. Returns a cudaError_t
// code (0 on success).
int gp_matvec_f32(const void* x, const void* v, const void* scal,
                  void* partial, void* y, int n, int dp, int slab_w,
                  int slabs, int device, void* stream)
{
    if (n <= 0 || dp <= 0 || dp % 4 != 0 || dp > 16 || slab_w <= 0 ||
        slabs <= 0 || slabs > 65535 || (long long)slabs * slab_w < n ||
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
    const int d4 = dp / 4;
    // d <= 4 (the flagship's 3-D and rock-type inputs) keeps one float4
    if (d4 == 1)
        matvec_partial<1><<<grid, NT, 0, s>>>(xf, vf, pf, n, d4, slab_w);
    else
        matvec_partial<4><<<grid, NT, 0, s>>>(xf, vf, pf, n, d4, slab_w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    matvec_reduce<<<(n + NT - 1) / NT, NT, 0, s>>>(
        pf, (const float*)scal, (float*)y, n, slabs);
    return (int)cudaGetLastError();
}

}  // extern "C"
