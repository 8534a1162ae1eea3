// K6 for Hopper: one step of the rank-`rank` pivoted Cholesky of
//
//     K(p, q) = s2 * exp(-||x_p - x_q||) + bias
//
// on metric-mapped points, a launch a step, all `rank` launches queued by
// one C call on the caller's stream (ops/pivchol.py), the pivot chosen on
// the card.
//
// Replaces no TPU kernel: the JAX package runs this recursion as XLA inside
// lax.fori_loop (gp_ss_ak_tpu/inference/iterative.py:87-130). The port's
// first version ran each step as ~25 torch launches (argmax, the pivot's
// kernel column, a GEMV against L[:, :j], the update of the residual
// diagonal d), ~25 000 launches an evaluation at N = 100000, rank 1024,
// which the host issued more slowly than the card ran them.
//
// What bounds it on an H100: step j must read L[:, :j] whole, since the
// next pivot is the argmax of the exact residual diagonal, which needs
// every row's new entry; no panel of pivots is known ahead, so the
// recursion cannot be blocked into GEMMs. Over the factor that is
// sum_j 4 N j bytes ~ 2 N rank^2 (209.5 GB at N = 100000, rank 1024,
// float32), plus the points, d and L's new row once a step: 63.3 ms at
// 3.35 TB/s. The arithmetic, one FMA per entry read and an exp and a
// sqrt per point a step, is far below the bytes. All 1024 steps ran in
// 71.3 ms on an H100 80GB HBM3 at 700 W, 0.89 of that bound; the torch
// loop took 277 ms of the card's time and more of the host's.
//
// Design:
//  * The factor is held transposed, L^T (rank, ld), ld >= N a multiple of
//    32: step j reads rows 0..j-1 and writes row j, each read coalesced
//    (neighbouring threads take neighbouring points, 16-byte loads: four
//    floats or two doubles a thread).
//  * A block of NT threads owns a slice of points; its threads form KS
//    groups that split the k range (group g takes rows g, g + KS, ...)
//    and add their partial dot products in shared memory in a fixed
//    order, so enough loads are in flight at N = 100000 for the stream to
//    run near the card's bandwidth. KS comes from N and the type alone
//    (ops/pivchol.py `pivchol_plan`: KS = 4 at N = 100000, where 1, 2, 4
//    and 8 ran 80.8, 71.9, 71.4 and 86.8 ms; KS = 8 at N = 16384, rank
//    341, where they ran 4.65, 3.66, 3.06 and 2.87 ms).
//  * The pivot's row of L, L^T[0:j, i], is staged in shared memory KT
//    values at a time, and read there as a broadcast.
//  * The sweep over k alternates direction from step to step when `flip`
//    is set: the rows read last in step j, still in L2, are read first in
//    step j + 1 (71.3 ms against 77.2 ms in one direction at N = 100000).
//  * The pivot: each block leaves the (max, first index) of its points'
//    new d in a partial buffer of parity j & 1; step j + 1 reduces the
//    partials of parity j & 1 in every block to the global first maximum
//    (larger value wins; equal values, the lower index; NaN above all, as
//    torch.argmax), while it writes its own into the other parity. Step
//    0 takes index 0 over the constant diagonal, as torch.argmax and
//    jnp.argmax do. The pivot's residual d_i is that maximum, so no block
//    reads d at a row another block writes in the same step. The kernel
//    boundary is the barrier between steps; no atomics, so the result
//    repeats bit for bit.
//  * The entry c = s2 exp(-sqrt(max(d2, 0))) + bias with d2 by direct
//    differences, the exact diagonal s2 + bias at the pivot, and the
//    update l = (c - dot) / sqrt(max(d_i, 1e-30)) (0 where d_i <= 1e-30),
//    d_p = max(d_p - l^2, 0), d_i = 0: each op rounded as the plain
//    version's torch ops round it (no contraction into FMA), so the two
//    differ by the order of the dot product's sums alone. The dot product
//    runs in FP32 (or FP64) FMA: no TF32.
//  * s2 and bias are read from device memory (no host read). d needs no
//    initialisation: step 0 takes the diagonal for it.
//  * One template for float and double.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int KT = 1024;            // pivot-row values staged per tile
constexpr int U = 4;                // rows of L^T in flight per thread
constexpr int MAX_D = 16;           // features

template <typename T> struct Vec;
template <> struct Vec<float> {
    using type = float4;
    static constexpr int P = 4;
};
template <> struct Vec<double> {
    using type = double2;
    static constexpr int P = 2;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float exp_t(float a) { return expf(a); }
__device__ __forceinline__ double exp_t(double a) { return exp(a); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// max(v, lo) that keeps a NaN, as torch.clamp_min
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) { return v < lo ? lo : v; }

// (a, ia) before (b, ib) in torch.argmax's order: NaN above all, then the
// larger value, then the lower index
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib)
{
    const bool an = a != a, bn = b != b;
    if (an != bn) return an;
    if (!an && a != b) return a > b;
    return ia < ib;
}

// the block's first maximum of (v, i) over all NT threads, in thread 0
template <typename T>
__device__ __forceinline__ void block_first_max(T& v, int& i, T* red_v,
                                                int* red_i)
{
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const T ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, i, off);
        if (before(ov, oi, v, i)) { v = ov; i = oi; }
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < NT / 32; ++w)
            if (before(red_v[w], red_i[w], v, i)) { v = red_v[w]; i = red_i[w]; }
    }
}

template <typename T>
__device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() { return -__int_as_float(0x7f800000); }
template <> __device__ __forceinline__ double neg_inf<double>() { return -__longlong_as_double(0x7ff0000000000000ll); }

// Step j. x (n, d) points; scal = [s2, bias]; lt (rank, ld) L^T, rows
// 0..j-1 read, row j written (0 in the lanes past n of its last vector,
// the only padding ever read); dvec (n)
// the residual diagonal; pval, pidx (2, nblocks) the blocks' partials.
template <typename T, int KS>
__global__ void __launch_bounds__(NT, 4)
pivchol_step(const T* __restrict__ x, const T* __restrict__ scal, T* lt,
             T* __restrict__ dvec, T* __restrict__ pval,
             int* __restrict__ pidx, int n, int d, int ld, int nblocks,
             int j, int flip)
{
    using VT = typename Vec<T>::type;
    constexpr int P = Vec<T>::P;
    constexpr int TPG = NT / KS;            // point threads per k group

    __shared__ T li[KT];
    __shared__ T xi[MAX_D];
    __shared__ T acc_s[KS > 1 ? KS - 1 : 1][TPG * P];
    __shared__ T red_v[NT / 32];
    __shared__ int red_i[NT / 32];
    __shared__ T piv_d;
    __shared__ int piv_s;

    const int tid = threadIdx.x;
    const int g = tid / TPG, t = tid % TPG;
    const int p0 = (blockIdx.x * TPG + t) * P;
    const T s2 = scal[0], bias = scal[1];
    const T diag = add_rn(s2, bias);

    // (a) the pivot: the first maximum of the previous step's partials
    if (j == 0) {
        if (tid == 0) { piv_s = 0; piv_d = diag; }
    } else {
        const T* pv = pval + (size_t)((j + 1) & 1) * nblocks;
        const int* pi = pidx + (size_t)((j + 1) & 1) * nblocks;
        T bv = neg_inf<T>();
        int bi = INT_MAX;
        for (int b = tid; b < nblocks; b += NT)
            if (before(pv[b], pi[b], bv, bi)) { bv = pv[b]; bi = pi[b]; }
        block_first_max(bv, bi, red_v, red_i);
        if (tid == 0) { piv_s = bi; piv_d = bv; }
    }
    __syncthreads();
    const int piv = piv_s;
    const T dpiv = piv_d;

    // (b) the pivot's point
    if (tid < d) xi[tid] = x[(size_t)piv * d + tid];

    // (c) dot = sum_{k < j} L^T[k, p] L^T[k, i], group g over rows g + KS r
    T acc[P];
#pragma unroll
    for (int q = 0; q < P; ++q) acc[q] = T(0);
    const int tiles = (j + KT - 1) / KT;
    for (int c = 0; c < tiles; ++c) {
        const int k0 = (flip ? tiles - 1 - c : c) * KT;
        const int kn = min(KT, j - k0);
        __syncthreads();                    // the previous tile is consumed
        for (int k = tid; k < kn; k += NT)
            li[k] = lt[(size_t)(k0 + k) * ld + piv];
        __syncthreads();
        if (p0 >= n || g >= kn) continue;
        const int m = (kn - g + KS - 1) / KS;   // this group's rows
        int k = flip ? g + (m - 1) * KS : g;
        const int kstep = flip ? -KS : KS;
        const T* row = lt + (size_t)(k0 + k) * ld + p0;
        const long long rstep = (long long)kstep * ld;
        int r = 0;
        for (; r + U <= m; r += U) {
            VT v[U];
            T w[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                v[u] = __ldg((const VT*)(row + u * rstep));
                w[u] = li[k + u * kstep];
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const T* e = (const T*)&v[u];
#pragma unroll
                for (int q = 0; q < P; ++q) acc[q] = fma_t(e[q], w[u], acc[q]);
            }
            row += U * rstep;
            k += U * kstep;
        }
        for (; r < m; ++r) {
            const VT v = __ldg((const VT*)row);
            const T w = li[k];
            const T* e = (const T*)&v;
#pragma unroll
            for (int q = 0; q < P; ++q) acc[q] = fma_t(e[q], w, acc[q]);
            row += rstep;
            k += kstep;
        }
    }
    if (KS > 1) {
        if (g > 0 && p0 < n) {
#pragma unroll
            for (int q = 0; q < P; ++q) acc_s[g - 1][t * P + q] = acc[q];
        }
        __syncthreads();
        if (g == 0 && p0 < n) {
            for (int h = 0; h < KS - 1; ++h) {
#pragma unroll
                for (int q = 0; q < P; ++q) acc[q] += acc_s[h][t * P + q];
            }
        }
    } else {
        __syncthreads();                    // xi is staged
    }

    // (d) the new column and d; (e) the block's partial
    T bv = neg_inf<T>();
    int bi = INT_MAX;
    if (g == 0 && p0 < n) {
        const bool live = dpiv > T(1e-30);
        const T rs = sqrt_rn(clamp_min(dpiv, T(1e-30)));
        alignas(16) T lv[P];
#pragma unroll
        for (int q = 0; q < P; ++q) {
            const int p = p0 + q;
            T l = T(0);
            if (p < n) {
                T c = diag;
                if (p != piv) {
                    const T* xp = x + (size_t)p * d;
                    T d2 = T(0);
                    for (int f = 0; f < d; ++f) {
                        const T df = sub_rn(xp[f], xi[f]);
                        d2 = add_rn(d2, mul_rn(df, df));
                    }
                    c = add_rn(mul_rn(s2, exp_t(-sqrt_rn(clamp_min(d2, T(0))))),
                               bias);
                }
                l = live ? div_rn(sub_rn(c, acc[q]), rs) : T(0);
                const T dold = j == 0 ? diag : dvec[p];
                const T dn = p == piv ? T(0)
                                      : clamp_min(sub_rn(dold, mul_rn(l, l)), T(0));
                dvec[p] = dn;
                if (before(dn, p, bv, bi)) { bv = dn; bi = p; }
            }
            lv[q] = l;
        }
        *(VT*)(lt + (size_t)j * ld + p0) = *(const VT*)lv;
    }
    block_first_max(bv, bi, red_v, red_i);
    if (tid == 0) {
        pval[(size_t)(j & 1) * nblocks + blockIdx.x] = bv;
        pidx[(size_t)(j & 1) * nblocks + blockIdx.x] = bi;
    }
}

template <typename T>
const void* step_fn(int ks)
{
    switch (ks) {
    case 1: return (const void*)pivchol_step<T, 1>;
    case 2: return (const void*)pivchol_step<T, 2>;
    case 4: return (const void*)pivchol_step<T, 4>;
    case 8: return (const void*)pivchol_step<T, 8>;
    default: return nullptr;
    }
}

template <typename T>
int run(const void* x, const void* scal, void* lt, void* dvec, void* pval,
        void* pidx, int n, int d, int ld, int rank, int ks, int flip,
        int device, void* stream)
{
    const void* fn = step_fn<T>(ks);
    const int per_block = Vec<T>::P * NT / (ks > 0 ? ks : 1);
    if (fn == nullptr || n <= 0 || d < 1 || d > MAX_D || rank < 0 ||
        ld < n || ld % 32 != 0)
        return (int)cudaErrorInvalidValue;
    // this library links its own CUDA runtime, whose current device is
    // separate from the caller's: select the tensors' device explicitly
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int nblocks = (n + per_block - 1) / per_block;
    for (int j = 0; j < rank; ++j) {
        int fj = flip ? (j & 1) : 0;
        int jj = j;
        void* args[] = {(void*)&x, (void*)&scal, (void*)&lt, (void*)&dvec,
                        (void*)&pval, (void*)&pidx, (void*)&n, (void*)&d,
                        (void*)&ld, (void*)&nblocks, (void*)&jj,
                        (void*)&fj};
        err = cudaLaunchKernel(fn, dim3(nblocks), dim3(NT), args, 0,
                               (cudaStream_t)stream);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace

extern "C" {

// All `rank` steps of the pivoted Cholesky, queued on `stream`. x (n, d)
// contiguous points, 1 <= d <= 16; scal = [s2, bias]; lt (rank, ld) L^T,
// 16-byte aligned, ld >= n a multiple of 32; dvec (n); pval (2, nblocks)
// of the type and pidx (2, nblocks) int32, nblocks = ceil(n / (P * 256 /
// ks)), P = 4 (float) or 2 (double) points a thread; ks in {1, 2, 4, 8}
// k groups a block, the plan's (ops/pivchol.py `pivchol_plan`); flip != 0
// alternates the sweep's direction step by step, as the program always
// does. Returns a cudaError_t code (0 on success).
int gp_pivchol_f32(const void* x, const void* scal, void* lt, void* dvec,
                   void* pval, void* pidx, int n, int d, int ld, int rank,
                   int ks, int flip, int device, void* stream)
{
    return run<float>(x, scal, lt, dvec, pval, pidx, n, d, ld, rank, ks,
                      flip, device, stream);
}

int gp_pivchol_f64(const void* x, const void* scal, void* lt, void* dvec,
                   void* pval, void* pidx, int n, int d, int ld, int rank,
                   int ks, int flip, int device, void* stream)
{
    return run<double>(x, scal, lt, dvec, pval, pidx, n, d, ld, rank, ks,
                       flip, device, stream);
}

}  // extern "C"
