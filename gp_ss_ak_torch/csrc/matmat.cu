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
// What bounds it on an H100 (N = 65536, d = 3). The least time of a pass
// is the largest of four terms (chip_smoke.bound): the bytes (points, V and
// Y once: under 1 ms at every B), the FP32 work outside the product
// (3d + 1 operations an entry: 0.64 ms), the SFU work (an rsqrt and an ex2
// an entry at MUFU's 16 a clock per SM: 2.05 ms at 132 SMs and 1.98 GHz; a
// floor only while both run on MUFU, as here) and the product at float32
// accuracy on the tensor cores (three TF32 products, 3 * 2 N^2 B
// operations at 495 TFLOP/s: 53.3 ms at B = 1024).
//  * B <= 64 (the setup's alpha solve at B = 1, the fit's whitened CG at
//    B = 9, the SLQ at B = 64): the SFU term binds up to B = 40, the tensor
//    term past it. The Gram build sets the pace (an entry issues its two
//    SFU operations among a score of others): 9.2 ms at B = 1, 22% of
//    the bound (H100 80GB HBM3, 700 W; chip_smoke.k3_times).
//  * B > 64 (a request's variance solves at B = 256, the CLI's at 1024):
//    the tensor term binds, and the kernel runs at 22% of it: each
//    128-column pass costs ~30 ms (60.8 ms at B = 256, 242.5 at 1024),
//    and its Gram build and V copy do not yet overlap its products.
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
//  * Per column tile of training points the block stages the V tile and
//    builds the Gram tile in shared memory by direct differences (exact
//    zeros for coincident points, no expansion, no clamp), K = s2 on the
//    global diagonal, then multiplies the two into its register
//    accumulators. Every Gram entry a thread builds lies in one row, so
//    that row's point sits in registers for the whole block; column points
//    are float4 loads that a warp shares (L1 broadcast). The build is
//    branch-free (gram_entry), so a thread's entries overlap their load
//    and SFU latencies.
//  * Four tiles, chosen by B at launch; the first three multiply in FP32
//    FFMA (32-point tiles, V loaded ahead of the build, two barriers a
//    tile), the fourth on the tensor cores:
//      narrow (B <= 8): 128 x 8, RM x RC = 1 x 4 per thread. At B = 1 a
//             wider tile would spend its FFMAs on masked columns.
//      16     (8 < B <= 16, the fit's B = 9): 128 x 16, RM x RC = 2 x 4,
//             four blocks an SM so that N = 65536's 512 row tiles run in
//             one wave: 10.6 ms at B = 9, where the middle tile took 30.0
//             and paid for 55 masked columns.
//      middle (16 < B <= 64): 128 x 64, RM x RC = 8 x 4: 19.5 ms at
//             B = 64, against 34.4 ms for the wide tile at B = 65, so
//             the wide tile starts past 64.
//      wide   (B > 64): 128 x 128, 3xTF32 on the tensor cores, below.
//    Every FFMA tile sums each output over k in the same order from the
//    same Gram values, so the 16-wide and middle tiles give equal bits.
//  * The wide tile's product, 3xTF32 (CUTLASS's "fast FP32"): a float32
//    x splits into hi = rna_tf32(x) and lo = rna_tf32(x - hi) (x - hi is
//    exact), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, three m16n8k8
//    TF32 mma.sync; the dropped a_lo b_lo and lo's rounding leave ~2^-21
//    of each product, unbiased. The Gram entries are split once, by the
//    thread that builds them, and stored as (hi, lo) pairs; V is copied
//    raw (cp.async, 16 bytes at a time where b % 4 == 0) and split as its
//    fragments are loaded. 8 warps tile the 128 x 128 output as 2 x 4
//    warps of 64 x 32 (4 x 4 m16n8 tiles a warp). Rows of ks are padded
//    by 4 pairs and rows of vs by 8 floats: a fragment's loads, at
//    (k = t or t + 4, row or column g or g + 8) with g = lane / 4 and
//    t = lane % 4, then hit distinct banks. 64-point tiles in two stages
//    (200 KB of dynamic shared memory, one block an SM): while a tile is
//    multiplied, the next tile's V copy is in flight and its Gram tile is
//    built after the products; one barrier a tile.
//  * The tensor cores' accumulator truncates: an mma adds its products
//    into its accumulator with round-toward-zero (Fasi, Higham, Mikaitis,
//    Pranesh 2021, "Numerical behavior of NVIDIA tensor cores"). Chained
//    over N = 65536 (24576 mma into one accumulator) the error drifts with
//    the sign of the running sum. So each k-step's three mma start from
//    zero and their sum is added into float32 accumulators with an
//    ordinary FADD (round to nearest): 4 FADD per m16n8 tile per 8 k.
//    Worst column against the gate 1.5e-7 (s2 + bias) ||V[:, b]||_1 at
//    B = 1024, d = 3, seed 0 (chip_smoke.k3_gate's inputs, H100 80GB
//    HBM3, 700 W):
//      accumulating inside the mma chain (the three mma_tf32 calls below
//      taking acc[i][j] itself; that variant is not kept):
//        1.70 of the gate at n = 4097, 7.00 at n = 65536 (fails);
//      flushed every k-step (this kernel):
//        0.094 at n = 4097, 0.093 at n = 65536.
//  * Ragged n and B are masked in the kernel: no padded copies of V, no
//    slice of the output afterwards. The points are padded once, at
//    operator setup, to dp = 4 * ceil(d / 4) <= 16 (float4 loads).
//  * float32 in and out, the TPU kernel's type. No wgmma or TMA yet.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Point gi into registers (zeros past n or past d4 float4s)
template <int D4>
__device__ __forceinline__ void load_point(float4 (&xr)[D4],
                                           const float4* __restrict__ x,
                                           int gi, int n, int d4)
{
#pragma unroll
    for (int j = 0; j < D4; ++j)
        xr[j] = (gi < n && j < d4) ? x[(size_t)gi * d4 + j]
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
}

// K(gi, gj) by direct differences, s2 exactly at gi == gj, 0 past n.
// Branch-free (loads clamped into range, results selected), so that the
// entries a thread builds for one tile overlap their load and SFU
// latencies instead of running one after another
template <int D4>
__device__ __forceinline__ float gram_entry(const float4 (&xr)[D4],
                                            const float4* __restrict__ x,
                                            int gi, int gj, int n, int d4,
                                            float s2)
{
    const int jc = min(gj, n - 1);
    float d2 = 0.0f;
#pragma unroll
    for (int j = 0; j < D4; ++j) {
        const float e = sq4(xr[j], __ldg(&x[(size_t)jc * d4 + min(j, d4 - 1)]),
                            d2);
        d2 = j < d4 ? e : d2;
    }
    // below 1e-30, sqrt(d2) < 1e-15 rounds exp(-.) to 1 anyway
    const float dist = d2 > 1e-30f ? d2 * rsqrt_approx(d2) : 0.0f;
    const float kv = gi == gj ? s2 : s2 * ex2_approx(-dist * LOG2E);
    return gj < n ? kv : 0.0f;
}

// ---------------------------------------------------------------------
// The FFMA tiles (B <= 64)

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
    load_point(xr, x, gi, n, d4);

    float acc[RM][RC];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < RC; ++c) acc[i][c] = 0.0f;

    for (int col0 = 0; col0 < n; col0 += BK) {
        // (1) V tile: value e = tid + q * NT is (row e / BB, column e % BB)
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
            ks[c][r] = gram_entry(xr, x, gi, col0 + c, n, d4, s2);
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

// ---------------------------------------------------------------------
// The wide tile (B > 64): 3xTF32 on the tensor cores

constexpr int TBM = 128, TBB = 128;        // block tile: rows x V columns
constexpr int TBK = 64;                    // training points per tile
constexpr int WM = 64, WN = 32;            // warp tile
constexpr int MI = WM / 16, NI = WN / 8;   // m16n8 tiles per warp
constexpr int KSTRIDE = TBM + 4;           // float2 pairs per ks row
constexpr int VSTRIDE = TBB + 8;           // floats per vs row
constexpr int KS_BYTES = TBK * KSTRIDE * (int)sizeof(float2);
constexpr int VS_BYTES = TBK * VSTRIDE * (int)sizeof(float);
constexpr int TC_SMEM = 2 * (KS_BYTES + VS_BYTES);     // two stages
static_assert((TBM / WM) * (TBB / WN) * 32 == NT, "warps tile the block");

// (hi, lo): x = hi + lo + O(2^-22 |x|), both TF32 values (low 13 bits 0)
__device__ __forceinline__ float2 split_tf32(float x)
{
    uint32_t hi, lo;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
    return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// d = a b + c on one m16n8k8 tile. Fragments (g = lane / 4, t = lane % 4):
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (k = t, col g), b1 (k = t + 4, col g);
// c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 * W bytes (W = 1 or 4 floats) from global memory to shared memory,
// asynchronously: the first `valid` floats of src, zeros after them
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int valid)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (W == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     :: "r"(d), "l"(src), "r"(4 * valid));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                     :: "r"(d), "l"(src), "r"(4 * valid));
}

// One block an SM with two stages of (ks, vs): while the tensor cores
// multiply one column tile, the same warps build the next (FP32 and SFU
// pipes) and its V tile is in flight (cp.async, no registers held); one
// barrier per tile. VW: floats per V copy, 4 (16 bytes) where every row
// of V starts 16-byte aligned (b % 4 == 0), else 1
template <int D4, int VW>
__global__ void __launch_bounds__(NT, 1)
matmat_tc_kernel(const float4* __restrict__ x, const float* __restrict__ v,
                 const float* __restrict__ scal, float* __restrict__ y,
                 int n, int b, int d4)
{
    extern __shared__ __align__(16) unsigned char smem[];
    // stage s: ks[k][row] = (hi, lo) of the Gram tile, vs[k][col] = V tile
    auto ks_at = [&](int s) {
        return reinterpret_cast<float2 (*)[KSTRIDE]>(smem + s * KS_BYTES);
    };
    auto vs_at = [&](int s) {
        return reinterpret_cast<float (*)[VSTRIDE]>(smem + 2 * KS_BYTES +
                                                    s * VS_BYTES);
    };

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int wr = (warp / (TBB / WN)) * WM;   // the warp's rows in the tile
    const int wc = (warp % (TBB / WN)) * WN;   // and its V columns
    const int row0 = blockIdx.x * TBM;
    const int b0 = blockIdx.y * TBB;
    const float s2 = scal[0];

    // the row of this thread's Gram entries, and its point
    constexpr int CS = NT / TBM;
    const int r = tid % TBM;
    const int gi = row0 + r;
    float4 xr[D4];
    load_point(xr, x, gi, n, d4);

    // V tile at col0 into stage s: value e = tid + q * NT is
    // (row e / TBB, column e % TBB), zeros past n and past b
    auto load_v = [&](int s, int col0) {
        float (*vs)[VSTRIDE] = vs_at(s);
        // 4-byte copies: 8 at a time, or their addresses spill
#pragma unroll (VW == 1 ? 8 : TBK * TBB / (NT * VW))
        for (int q = 0; q < TBK * TBB / (NT * VW); ++q) {
            const int e = (tid + q * NT) * VW;
            const int gj = col0 + e / TBB, gb = b0 + e % TBB;
            const int ok = gj < n ? max(0, min(VW, b - gb)) : 0;
            cp_async<VW>(&vs[e / TBB][e % TBB],
                         ok ? v + (size_t)gj * b + gb : v, ok);
        }
        asm volatile("cp.async.commit_group;");
    };
    // Gram tile at col0 into stage s: entries (r, tid / TBM + q * CS),
    // all of a thread's in flight at once where the point is one float4,
    // four at a time past that (more would spill)
    constexpr int BUILD_ILP = D4 == 1 ? TBK / CS : 4;
    auto build = [&](int s, int col0) {
        float2 (*ks)[KSTRIDE] = ks_at(s);
#pragma unroll BUILD_ILP
        for (int q = 0; q < TBK / CS; ++q) {
            const int c = tid / TBM + q * CS;
            ks[c][r] = split_tf32(gram_entry(xr, x, gi, col0 + c, n, d4, s2));
        }
    };

    float acc[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    load_v(0, 0);
    build(0, 0);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    for (int col0 = 0, s = 0; col0 < n; col0 += TBK, s ^= 1) {
        // the next tile: its V copy goes out first, its Gram tile is
        // built after this tile's products (past n both are zeros, so
        // the last tile needs no branch)
        load_v(s ^ 1, col0 + TBK);
        const float2 (*ks)[KSTRIDE] = ks_at(s);
        const float (*vs)[VSTRIDE] = vs_at(s);
        // acc += Gram tile x V tile, 3xTF32, flushed every k-step (not
        // unrolled: the build below keeps its registers)
#pragma unroll 1
        for (int k0 = 0; k0 < TBK; k0 += 8) {
            uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
            for (int j = 0; j < NI; ++j) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float2 p =
                        split_tf32(vs[k0 + t + 4 * h][wc + j * 8 + g]);
                    bh[j][h] = __float_as_uint(p.x);
                    bl[j][h] = __float_as_uint(p.y);
                }
            }
#pragma unroll
            for (int i = 0; i < MI; ++i) {
                const int rr = wr + i * 16 + g;
                const float2 q0 = ks[k0 + t][rr], q1 = ks[k0 + t][rr + 8];
                const float2 q2 = ks[k0 + t + 4][rr];
                const float2 q3 = ks[k0 + t + 4][rr + 8];
                const uint32_t ah[4] = {
                    __float_as_uint(q0.x), __float_as_uint(q1.x),
                    __float_as_uint(q2.x), __float_as_uint(q3.x)};
                const uint32_t al[4] = {
                    __float_as_uint(q0.y), __float_as_uint(q1.y),
                    __float_as_uint(q2.y), __float_as_uint(q3.y)};
#pragma unroll
                for (int j = 0; j < NI; ++j) {
                    float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                    mma_tf32(p, al, bh[j][0], bh[j][1]);
                    mma_tf32(p, ah, bl[j][0], bl[j][1]);
                    mma_tf32(p, ah, bh[j][0], bh[j][1]);
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[i][j][e] += p[e];
                }
            }
        }
        // the other stage was last read before the previous barrier
        build(s ^ 1, col0 + TBK);
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = row0 + wr + i * 16 + g + h * 8;
            if (row >= n) continue;
            float* yrow = y + (size_t)row * b;
#pragma unroll
            for (int j = 0; j < NI; ++j) {
                const int gb = b0 + wc + j * 8 + 2 * t;
                if (gb < b) yrow[gb] = acc[i][j][2 * h];
                if (gb + 1 < b) yrow[gb + 1] = acc[i][j][2 * h + 1];
            }
        }
    }
}

template <int D4, int VW>
cudaError_t launch_tc(const float4* x, const float* v, const float* scal,
                      float* y, int n, int b, int d4, cudaStream_t stream)
{
    const dim3 grid((n + TBM - 1) / TBM, (b + TBB - 1) / TBB);
    if (grid.y > 65535u) return cudaErrorInvalidValue;
    // 200 KB of dynamic shared memory: above the 48 KB default
    cudaError_t err = cudaFuncSetAttribute(
        matmat_tc_kernel<D4, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TC_SMEM);
    if (err != cudaSuccess) return err;
    matmat_tc_kernel<D4, VW><<<grid, NT, TC_SMEM, stream>>>(x, v, scal, y, n,
                                                            b, d4);
    return cudaGetLastError();
}

template <int D4>
cudaError_t launch_tc(const float4* x, const float* v, const float* scal,
                      float* y, int n, int b, int d4, cudaStream_t stream)
{
    return b % 4 == 0 && (size_t)v % 16 == 0
               ? launch_tc<D4, 4>(x, v, scal, y, n, b, d4, stream)
               : launch_tc<D4, 1>(x, v, scal, y, n, b, d4, stream);
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
    const int d4 = dp / 4;
    if (b <= 8)
        err = launch<128, 8, 1, 4, 3>(xf, vf, sf, yf, n, b, d4, s);
    else if (b <= 16)
        err = launch<128, 16, 2, 4, 4>(xf, vf, sf, yf, n, b, d4, s);
    else if (b <= 64)
        err = launch<128, 64, 8, 4, 2>(xf, vf, sf, yf, n, b, d4, s);
    else if (d4 == 1)
        err = launch_tc<1>(xf, vf, sf, yf, n, b, d4, s);
    else
        err = launch_tc<4>(xf, vf, sf, yf, n, b, d4, s);
    return (int)err;
}

}  // extern "C"
