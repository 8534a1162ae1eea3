// K3 for Hopper: the streamed Gram matmat of the matrix-free server.
//
// Replaces the Pallas kernel gp_ss_ak_tpu/ops/matvec.py::_matmat_kernel
// (:90, launched by _matmat, wrapped by streamed_matmat). On metric-mapped
// points x (n rows, dp features, zero-padded to a multiple of 4) and B
// right-hand sides V (n x B, row-major) it writes
//
//     Y[i, b] = sum_j K(i, j) V[j, b],   K(i, j) = s2 * exp(-||xi - xj||),
//     K(i, i) = s2 exactly,
//
// with scal = [s2] read from device memory. K is never stored: each block
// rebuilds the tiles it needs. The caller adds bias * colsum(V) + sn2 * V.
//
// What bounds it on an H100 (N = 65536, d = 3):
//  * B = 1 (the setup's alpha solve): every pass builds N^2 = 4.3e9 Gram
//    entries. Each costs one rsqrt and one exp2 on the SFU plus ~20 FP32
//    and shared-memory instructions (difference, exact diagonal, store,
//    the FFMA of the narrow tile), so the pass is bound by instruction
//    issue, not by memory: the points are 1 MB and stay in L2.
//  * large B (the variance solves, B up to 1024): 2 N^2 B flop of FFMA
//    (8.8e12 at B = 1024, >= 0.13 s at the 67 TFLOP/s FP32 peak). The
//    Gram tile is rebuilt once per 128-column V tile: ~20 instructions
//    per entry against 128 FFMA.
//  Products stay in FP32 FFMA: TF32 would lose ~1e-3 relative and stall
//  CG at the flagship conditioning (the TPU kernel runs at HIGHEST).
//
// Design, and how it differs from the TPU kernel:
//  * The TPU kernel keeps all points resident in VMEM and accumulates the
//    (tm, B) output block across its sequential minor grid axis. Blocks on
//    the H100 run in no fixed order, so here the grid runs over (row tile,
//    V-column tile) and each block LOOPS over every column tile of the
//    training points, keeping its outputs in registers. No atomics: each
//    output is summed by one thread in a fixed order, so a pass is
//    bit-for-bit repeatable and lock-step CG iteration counts and stall
//    cut-offs do not wander between runs.
//  * Per column tile of BK = 32 points: (1) the block builds the BM x BK
//    Gram tile in shared memory by direct differences (exact zeros for
//    coincident points, no expansion, no clamp), K = s2 on the global
//    diagonal. Every Gram entry a thread builds lies in one row, so that
//    row's point sits in registers for the whole block; column points are
//    float4 loads that a warp shares (L1 broadcast). (2) The BK x BB tile
//    of V goes to shared memory, its loads issued ahead of the build so
//    they overlap it. (3) Each thread multiplies the Gram tile into its
//    RM x RC register tile with FFMA, reading shared memory as float4.
//    Two barriers per tile.
//  * Three tile shapes, chosen by B at launch:
//      wide   (B > 64): BM x BB = 128 x 128, RM x RC = 8 x 8 per thread:
//             4 float4 shared loads per 64 FFMA, and one Gram rebuild per
//             128 V columns. The 8-wide fragments are two float4 groups 64
//             apart, so a warp's loads are conflict-free. Capped at 128
//             registers so two blocks share an SM (one block's barriers
//             and rebuild overlap the other's FFMAs).
//      middle (8 < B <= 64): 128 x 64, RM x RC = 8 x 4, same cap. At
//             N = 65536, d = 3 and B = 9..64 a pass takes 30.0-31.9 ms
//             here against 41.9-43.1 ms on the wide tile, whose masked
//             columns cost as much as live ones (H100 80GB HBM3, 700 W).
//      narrow (B <= 8): 128 x 8, RM x RC = 1 x 4. At B = 1 the wide tile
//             would spend 128 FFMA per Gram entry on masked columns; here
//             it is 8, and the pass stays bound by the build.
//  * Ragged n and B are masked in the kernel: no padded copies of V, no
//    slice of the output afterwards. The points are padded once, at
//    operator setup, to dp = 4 * ceil(d / 4) <= 16 (float4 loads).
//  * float32 only, the TPU kernel's type. A simple first version: no
//    wgmma, TMA, cp.async pipelining or 3xTF32 yet.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int BK = 32;              // training points per column tile
constexpr float LOG2E = 1.4426950408889634f;

// SFU approximations, flushing subnormals: ex2 is within 2 ulp over its
// range and rsqrt within 1 ulp, far inside the kernel's float32 budget
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

// Index of a thread's q-th of R register-tile rows (or columns) in a tile
// of extent T, t the thread's index along it. R <= 4: R adjacent entries.
// R = 8: two float4 groups T/2 apart, so that the 16 threads along the
// tile read 256 contiguous bytes per float4 load (no bank conflicts).
template <int R, int T>
__device__ __forceinline__ int tile_idx(int t, int q)
{
    if constexpr (R <= 4) return t * R + q;
    else return (q / 4) * (T / 2) + t * 4 + q % 4;
}

template <int R, int T>
__device__ __forceinline__ void load_frag(float (&dst)[R], const float* row,
                                          int t)
{
    if constexpr (R % 4 == 0) {
        // 16-byte aligned: ks/vs rows are, and tile_idx(t, 4g) % 4 == 0
#pragma unroll
        for (int q = 0; q < R; q += 4) {
            const float4 f =
                *reinterpret_cast<const float4*>(row + tile_idx<R, T>(t, q));
            dst[q] = f.x; dst[q + 1] = f.y; dst[q + 2] = f.z; dst[q + 3] = f.w;
        }
    } else {
#pragma unroll
        for (int q = 0; q < R; ++q) dst[q] = row[tile_idx<R, T>(t, q)];
    }
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

// BM rows x BB V-columns per block; each thread owns RM rows x RC columns
// of the output. D4: the points' float4 count per row, at most.
template <int BM, int BB, int RM, int RC, int MINB, int D4>
__global__ void __launch_bounds__(NT, MINB)
matmat_kernel(const float4* __restrict__ x, const float* __restrict__ v,
              const float* __restrict__ scal, float* __restrict__ y,
              int n, int b, int d4)
{
    constexpr int TC = BB / RC;             // threads along V columns
    static_assert((BM / RM) * TC == NT, "thread layout must cover NT");
    static_assert(RM <= 4 || (RM == 8 && BM == 16 * 8),
                  "8-row fragments assume 16 threads along the rows");
    static_assert(RC <= 4 || (RC == 8 && BB == 16 * 8),
                  "8-column fragments assume 16 threads along V");
    static_assert(NT % BM == 0, "a thread's Gram entries share one row");
    constexpr int CS = NT / BM;             // column step between them
    constexpr int E = BK / CS;              // Gram entries per thread
    constexpr int VE = BK * BB / NT;        // V values per thread
    static_assert(VE * NT == BK * BB, "V tile must split evenly");

    __shared__ __align__(16) float ks[BK][BM];     // Gram tile, transposed
    __shared__ __align__(16) float vs[BK][BB];     // V tile

    const int tid = threadIdx.x;
    const int ty = tid / TC;
    const int tx = tid % TC;
    const int row0 = blockIdx.x * BM;
    const int b0 = blockIdx.y * BB;
    const float s2 = scal[0];

    // the row of this thread's Gram entries, and its point
    const int r = tid % BM;
    const int gi = row0 + r;
    float4 xr[D4];
#pragma unroll
    for (int j = 0; j < D4; ++j)
        xr[j] = (gi < n && j < d4) ? x[(size_t)gi * d4 + j]
                                   : make_float4(0.f, 0.f, 0.f, 0.f);

    float acc[RM][RC];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < RC; ++c) acc[i][c] = 0.0f;

    for (int col0 = 0; col0 < n; col0 += BK) {
        // (1) V tile: value e = tid + q * NT is (row e / BB, column e % BB);
        // issued first, so the loads overlap the Gram build
#pragma unroll
        for (int q = 0; q < VE; ++q) {
            const int e = tid + q * NT;
            const int gj = col0 + e / BB, gb = b0 + e % BB;
            vs[e / BB][e % BB] =
                (gj < n && gb < b) ? v[(size_t)gj * b + gb] : 0.0f;
        }
        // (2) Gram tile: this thread's entries are (r, tid / BM + q * CS)
#pragma unroll
        for (int q = 0; q < E; ++q) {
            const int c = tid / BM + q * CS;
            const int gj = col0 + c;
            float kv = 0.0f;
            if (gj < n) {
                float d2 = 0.0f;
#pragma unroll
                for (int j = 0; j < D4; ++j)
                    if (j < d4) d2 = sq4(xr[j], __ldg(&x[(size_t)gj * d4 + j]),
                                         d2);
                // below 1e-30, sqrt(d2) < 1e-15 rounds exp(-.) to 1 anyway
                const float dist = d2 > 1e-30f ? d2 * rsqrt_approx(d2) : 0.0f;
                kv = gi == gj ? s2 : s2 * ex2_approx(-dist * LOG2E);
            }
            ks[c][r] = kv;
        }
        __syncthreads();
        // (3) acc += Gram tile x V tile, in FP32 FFMA
#pragma unroll 4
        for (int k = 0; k < BK; ++k) {
            float a[RM], w[RC];
            load_frag<RM, BM>(a, ks[k], ty);
            load_frag<RC, BB>(w, vs[k], tx);
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int c = 0; c < RC; ++c)
                    acc[i][c] = fmaf(a[i], w[c], acc[i][c]);
        }
        __syncthreads();            // ks/vs are rewritten by the next tile
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int row = row0 + tile_idx<RM, BM>(ty, i);
        if (row >= n) continue;
        float* yrow = y + (size_t)row * b;
#pragma unroll
        for (int c = 0; c < RC; ++c) {
            const int gb = b0 + tile_idx<RC, BB>(tx, c);
            if (gb < b) yrow[gb] = acc[i][c];
        }
    }
}

template <int BM, int BB, int RM, int RC, int MINB>
cudaError_t launch(const float4* x, const float* v, const float* scal,
                   float* y, int n, int b, int d4, cudaStream_t stream)
{
    const dim3 grid((n + BM - 1) / BM, (b + BB - 1) / BB);
    if (grid.y > 65535u) return cudaErrorInvalidValue;
    // d <= 4 (the flagship's 3-D and rock-type inputs) keeps one float4
    if (d4 == 1)
        matmat_kernel<BM, BB, RM, RC, MINB, 1><<<grid, NT, 0, stream>>>(
            x, v, scal, y, n, b, d4);
    else
        matmat_kernel<BM, BB, RM, RC, MINB, 4><<<grid, NT, 0, stream>>>(
            x, v, scal, y, n, b, d4);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, dp) with dp a multiple of 4, at most 16, 16-byte aligned;
// v (n, b); scal (1,) = [s2]; y (n, b): float32, contiguous, row-major,
// on `device`. Returns a cudaError_t code (0 on success).
int gp_matmat_f32(const void* x, const void* v, const void* scal, void* y,
                  int n, int b, int dp, int device, void* stream)
{
    if (n <= 0 || b <= 0 || dp <= 0 || dp % 4 != 0 || dp > 16)
        return (int)cudaErrorInvalidValue;
    // this library links its own CUDA runtime, whose current device is
    // separate from the caller's: select the tensors' device explicitly
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const float4* xf = (const float4*)x;
    const float* vf = (const float*)v;
    const float* sf = (const float*)scal;
    float* yf = (float*)y;
    cudaStream_t s = (cudaStream_t)stream;
    if (b <= 8)
        err = launch<128, 8, 1, 4, 3>(xf, vf, sf, yf, n, b, dp / 4, s);
    else if (b <= 64)
        err = launch<128, 64, 8, 4, 2>(xf, vf, sf, yf, n, b, dp / 4, s);
    else
        err = launch<128, 128, 8, 8, 2>(xf, vf, sf, yf, n, b, dp / 4, s);
    return (int)err;
}

}  // extern "C"
