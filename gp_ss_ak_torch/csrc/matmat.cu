// K3 for Hopper: the streamed Gram matmat of the matrix-free server.
//
// Replaces the Pallas kernel gp_ss_ak_tpu/ops/matvec.py::_matmat_kernel
// (:90, launched by _matmat, wrapped by streamed_matmat). On metric-mapped
// points x (n rows, d features, zero-padded to dp, a multiple of 4) and B
// right-hand sides V (n x B, row-major) it writes
//
//     Y[i, b] = sum_j K(i, j) V[j, b],   K(i, j) = s2 * exp(-||xi - xj||),
//     K(i, i) = s2 exactly,
//
// with scal = [s2] read from device memory. K is never stored: each block
// rebuilds the entries it needs. The caller adds bias * colsum(V) + sn2 * V.
//
// What bounds it on an H100 (d = 3). A pass builds n^2 Gram entries, each
// with two MUFU operations (the distance's square root and the
// exponential, 16 an SM a clock) and ~8 issue slots of FP32 work, and
// multiplies each into B outputs. The bytes (points, V and Y once) never
// count.
//  * B <= 64 (the setup's alpha solve at B = 1, the fit's whitened CG at
//    B = 9, the segmented SLQ at B = 32, the fit's SLQ at 64): the FP32
//    pipe. An entry costs ~8 slots to build, B FFMA to use and
//    (1 + ceil(B / 4)) / RPT shared loads, which ptxas's SASS confirms
//    (19.3 slots at B = 9, 45.1 at 32; chip_smoke.k3_sass_report). The SM
//    issues 128 slots a clock, so at N = 100000 (1e10 entries, 132 SMs at
//    1.98 GHz) a pass takes at least 5.8 ms at B = 9 and 13.5 ms at
//    B = 32; the kernel takes 7.80 and 19.07 ms, 0.74 and 0.71 of that
//    floor (the FFMA tiles it replaced: 23.60 and 44.01 ms). At N = 65536:
//    2.48 ms at B = 1, 3.21 at 8, 3.44 at 9, 4.80 at 16, 17.26 at 64
//    (9.14, 9.16, 10.63, 10.63, 19.54 before; H100 80GB HBM3, 700 W,
//    chip_smoke.k3_times). Only at B <= 4 does MUFU bind, and there a
//    share of the exponentials moves to the FP32 pipe (below).
//  * B > 64 (a request's variance solves at B = 256, the CLI's at 1024):
//    the product on the tensor cores binds (three TF32 products, 3 * 2
//    N^2 B operations at 495 TFLOP/s: 53.3 ms at N = 65536, B = 1024),
//    and the kernel runs at 22% of it: each 128-column pass costs ~30 ms
//    (60.8 ms at B = 256, 242.5 at 1024), and its Gram build and V copy
//    do not yet overlap its products.
//
// Design, and how it differs from the TPU kernel:
//  * The TPU kernel keeps all points resident in VMEM and accumulates the
//    (tm, B) output block across its sequential minor grid axis. Blocks on
//    the H100 run in no fixed order, so here each block owns a set of
//    rows and LOOPS over every column tile of the training points,
//    keeping its outputs in registers. No atomics: each output is summed
//    by one thread over j in a fixed order, so a pass is bit-for-bit
//    repeatable and lock-step CG iteration counts and stall cut-offs do
//    not wander between runs.
//  * The register tiles (B <= 64; K2's design, csrc/matvec.cu, widened to
//    B columns). A block of 128 threads stages a tile of 128 training
//    points and the matching rows of V in shared memory: the points as
//    float4s scaled by log2 e, V as rows of W floats. Each thread owns RPT
//    rows (their scaled points in registers) and W columns of their
//    outputs (RPT x W float32 accumulators). For each column point j it
//    builds its RPT Gram entries in registers (d <= 3: three differences,
//    d2 in an FMUL and two FFMA, one MUFU.SQRT, the exponential as ex2 of
//    the negated distance) and multiplies each straight into its
//    accumulators by FFMA, V[j, :] broadcast from shared memory (every
//    lane reads the same row: LDS.128, no bank conflicts). No Gram value
//    goes to shared memory; two barriers per 128-point tile. s2 scales
//    each output once at the end.
//  * The width W is a template parameter, picked by the wrapper
//    (ops/matvec.py matmat_route) from B: the narrowest of 1, 2, 4, 8, 9,
//    12, 16, 24 and 32 at least B, and past 32 two column groups (the
//    grid's second axis) of the narrowest at least B / 2. So the main
//    path's B = 1, 9, 32 and 64 mask no column. Columns past B are zero
//    in shared memory and never written. Wider single tiles were slower:
//    64 accumulators a row and the V loads they keep in flight exceed the
//    registers, and a second group rebuilds the entries for ~8 slots in
//    45 (B = 64 at N = 65536: 17.3 ms in two groups, 19.5-28 ms in one).
//  * Each width runs in the shape that timed best on an H100 (RPT rows a
//    thread, STEP columns an unrolled step, a register cap from MINB
//    blocks an SM; launch_register): 2 rows a thread throughout, which
//    halves the shared loads of V against one; 128 registers up to
//    B = 16 (four blocks an SM), 168 at 24 and 32 (three: at N = 100000
//    the 391 blocks then run in one wave; at 255 registers, two blocks
//    an SM, they took 1.5 waves and 19.7-25.7 ms at B = 32). Up to B = 12 a
//    tile's loads go out one tile ahead into registers (3-5% faster
//    there); wider tiles lack the registers and stage straight to shared
//    memory. ptxas reports no spill in any instance (chip_smoke gates it).
//  * The split of the exponentials between MUFU.EX2 and the polynomial of
//    ex2_poly.cuh (~10 FP32 slots) is a constant of each width, from the
//    issue-slot model above (poly_of_8): with p of every 8 columns on the
//    polynomial, MUFU needs (16 - p) / 8 operations an entry at 16 a
//    clock, the FP32 pipe the slots plus 9 p / 8 at 128. The model puts
//    3 of 8 on the polynomial at B = 1, 2 at B = 2, 1 at B = 4 and none
//    from B = 8 on, where the FFMAs already fill the FP32 pipe. The class
//    of an entry is fixed by its column's position in the unrolled step,
//    never by timing, and K(i, i) is exactly s2 in both classes (d2 = 0
//    exactly, sqrt.approx(0) = 0, ex2.approx(-0) = 1 and the polynomial's
//    c0 = 1). Widths of the same split (every width from 8 on) give equal
//    bits in every column they share: each output is the same chain of
//    FFMAs over the same entries.
//  * d <= 3 (the flagship's 3-D inputs) takes the packed kernel, which
//    skips the padding lane; d = 4..16 a general one (D4 float4s a point,
//    d4 of them live, all four lanes of each), off the main path: a row a
//    thread, widths 8, 16 and 32 only, so fewer instances to build.
//  * The wide tile (B > 64): 128 x 128, 3xTF32 on the tensor cores, below.
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
//    built after the products; one barrier a tile. Every Gram entry a
//    thread builds lies in one row, so that row's point sits in registers
//    for the whole block; column points are float4 loads that a warp
//    shares (L1 broadcast). The build is branch-free (gram_entry), so a
//    thread's entries overlap their load and SFU latencies.
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

#include "ex2_poly.cuh"

namespace {

constexpr int NT = 256;             // threads per block (the wide tile)
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
// The register tiles (B <= 64)

constexpr int RT = 128;             // threads per block
constexpr int RK = RT;              // column points per shared tile
// the issue-slot model of a Gram entry at d <= 3 (see the note above):
// its build (3 FADD, FMUL, 2 FFMA, MUFU.SQRT, MUFU.EX2) and the extra
// slots of an exponential on the polynomial (ex2_poly.cuh, ~10 in all)
constexpr int BUILD_SLOTS = 8;
constexpr int POLY_EXTRA = 9;

// shared loads of a V row per column: float4s, or scalars below 4 wide
__host__ __device__ constexpr int v_loads(int w)
{
    return w < 4 ? w : (w + 3) / 4;
}

// of every 8 columns, how many take the polynomial: the p that gives the
// least of max(MUFU clocks, issue clocks) per 8 entries, both counted in
// 1/128 of an SM clock (a MUFU operation 8, an issue slot 1) and scaled
// by rpt so that the shared loads' share stays whole; ties go to fewer
__host__ __device__ constexpr int poly_of_8(int w, int rpt)
{
    int best = 0, best_cost = 0;
    for (int p = 0; p <= 8; ++p) {
        const int mufu = rpt * (16 - p) * 8;
        const int issue = rpt * (8 * (BUILD_SLOTS + w) + p * POLY_EXTRA) +
                          8 * (1 + v_loads(w));
        const int cost = mufu > issue ? mufu : issue;
        if (p == 0 || cost < best_cost) {
            best = p;
            best_cost = cost;
        }
    }
    return best;
}

// the square root on MUFU, flushing subnormals: within ~1 ulp, 0 at 0
__device__ __forceinline__ float sqrt_approx(float x)
{
    float y;
    asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float4 scaled(float4 p)
{
    return make_float4(p.x * LOG2E, p.y * LOG2E, p.z * LOG2E, p.w * LOG2E);
}

// exp(-dist) from t = dist * log2 e, for the column at position u of its
// inner-loop step (a constant once the loop is unrolled)
template <int POLY>
__device__ __forceinline__ float exp_neg(float t, int u)
{
    return POLY * u % 8 < POLY ? gp_ex2::poly(-t) : gp_ex2::mufu(-t);
}

// acc[r][c] += e[r] * vrow[c] for c < W: vrow is a row of the shared V
// tile (VP floats, 16-byte aligned where VP % 4 == 0)
template <int W, int VP, int RPT>
__device__ __forceinline__ void product(float (&acc)[RPT][W],
                                        const float (&e)[RPT],
                                        const float* vrow)
{
    if constexpr (VP % 4 == 0) {
#pragma unroll
        for (int c = 0; c < W; c += 4) {
            const float4 q = *reinterpret_cast<const float4*>(vrow + c);
            const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (c + i < W) {
#pragma unroll
                    for (int r = 0; r < RPT; ++r)
                        acc[r][c + i] = fmaf(e[r], qv[i], acc[r][c + i]);
                }
            }
        }
    } else {
#pragma unroll
        for (int c = 0; c < W; ++c) {
            const float q = vrow[c];
#pragma unroll
            for (int r = 0; r < RPT; ++r) acc[r][c] = fmaf(e[r], q, acc[r][c]);
        }
    }
}

// Y rows row0 + tid + r * RT (r < RPT), columns b0 + c (c < W, b0 + c <
// b) of the block's column group b0 = blockIdx.y * W. STEP columns an
// unrolled step of the inner loop; MINB blocks an SM, which caps the
// registers a thread. AHEAD: a tile's loads are issued one tile ahead,
// into registers, so that they overlap the previous tile's work (the
// narrow widths, whose registers allow it); else they go straight to
// shared memory before the tile's work, up to 24 in flight (32 spill at
// the wider widths' cap). D4 = 1: d <= 3, one float4 a point whose
// fourth lane is skipped; D4 = 4: any d <= 16, d4 float4s a point live
template <int W, int RPT, int STEP, int MINB, bool AHEAD, int D4>
__global__ void __launch_bounds__(RT, MINB)
matmat_reg_kernel(const float4* __restrict__ x, const float* __restrict__ v,
                  const float* __restrict__ scal, float* __restrict__ y,
                  int n, int b, int d4)
{
    constexpr int VP = W < 4 ? W : (W + 3) / 4 * 4;   // floats a V row
    constexpr int POLY = poly_of_8(W, RPT);
    static_assert(RK % STEP == 0, "whole steps a tile");
    static_assert(POLY == 0 || STEP % 8 == 0, "the split's period is 8");

    __shared__ __align__(16) float4 xs[D4][RK];
    __shared__ __align__(16) float vs[RK][VP];

    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * (RT * RPT);
    const int b0 = blockIdx.y * W;

    float4 xr[RPT][D4];
    float acc[RPT][W];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int gi = row0 + tid + r * RT;
#pragma unroll
        for (int j = 0; j < D4; ++j)
            xr[r][j] = (gi < n && j < d4) ? scaled(x[(size_t)gi * d4 + j])
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < W; ++c) acc[r][c] = 0.0f;
    }

    // the tile at col0: this thread's column point col0 + tid, and its V
    // value q: e = tid + q * RT, (row col0 + e / W, column b0 + e % W).
    // Zeros past n and past b
    auto point = [&](int col0, int j) {
        const int gj = col0 + tid;
        return (gj < n && j < d4) ? x[(size_t)gj * d4 + j]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    auto value = [&](int col0, int q) {
        const int e = tid + q * RT;
        const int jr = col0 + e / W, c = b0 + e % W;
        return (jr < n && c < b) ? v[(size_t)jr * b + c] : 0.0f;
    };
    float4 pn[D4];
    float vn[AHEAD ? W : 1];
    auto fetch = [&](int col0) {
        if constexpr (AHEAD) {
#pragma unroll
            for (int j = 0; j < D4; ++j) pn[j] = point(col0, j);
#pragma unroll
            for (int q = 0; q < W; ++q) vn[q] = value(col0, q);
        }
    };
    if constexpr (AHEAD) fetch(0);

    for (int col0 = 0; col0 < n; col0 += RK) {
        // the tile into shared memory, the points scaled by log2 e
#pragma unroll
        for (int j = 0; j < D4; ++j)
            xs[j][tid] = scaled(AHEAD ? pn[j] : point(col0, j));
#pragma unroll (W <= 24 ? W : 16)
        for (int q = 0; q < W; ++q) {
            const int e = tid + q * RT;
            vs[e / W][e % W] = AHEAD ? vn[q] : value(col0, q);
        }
        __syncthreads();
        if constexpr (AHEAD) {
            if (col0 + RK < n) fetch(col0 + RK);
        }
#pragma unroll 1
        for (int k0 = 0; k0 < RK; k0 += STEP) {
#pragma unroll
            for (int u = 0; u < STEP; ++u) {
                float4 p[D4];
#pragma unroll
                for (int j = 0; j < D4; ++j) p[j] = xs[j][k0 + u];
                float e[RPT];
#pragma unroll
                for (int r = 0; r < RPT; ++r) {
                    float d2;
                    if constexpr (D4 == 1) {
                        float t = xr[r][0].x - p[0].x;
                        d2 = t * t;
                        t = xr[r][0].y - p[0].y;
                        d2 = fmaf(t, t, d2);
                        t = xr[r][0].z - p[0].z;
                        d2 = fmaf(t, t, d2);
                    } else {
                        d2 = 0.0f;
#pragma unroll
                        for (int j = 0; j < D4; ++j)
                            if (j < d4) d2 = sq4(xr[r][j], p[j], d2);
                    }
                    e[r] = exp_neg<POLY>(sqrt_approx(d2), u);
                }
                product<W, VP, RPT>(acc, e, vs[k0 + u]);
            }
        }
        __syncthreads();            // xs and vs are rewritten next
    }

    const float s2 = scal[0];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int gi = row0 + tid + r * RT;
        if (gi >= n) continue;
        float* yrow = y + (size_t)gi * b + b0;
#pragma unroll
        for (int c = 0; c < W; ++c)
            if (b0 + c < b) yrow[c] = s2 * acc[r][c];
    }
}

// The d <= 3 kernel of width W in its shape (matmat_reg_kernel), over
// ceil(b / W) column groups
template <int W, int RPT, int STEP, int MINB, bool AHEAD>
cudaError_t launch_reg(const float4* x, const float* v, const float* scal,
                       float* y, int n, int b, cudaStream_t stream)
{
    const dim3 grid((n + RT * RPT - 1) / (RT * RPT), (b + W - 1) / W);
    matmat_reg_kernel<W, RPT, STEP, MINB, AHEAD, 1>
        <<<grid, RT, 0, stream>>>(x, v, scal, y, n, b, 1);
    return cudaGetLastError();
}

// The general kernel (d = 4..16) of width W: a row a thread, up to 255
// registers (its points take 16 a row), a column a step
template <int W>
cudaError_t launch_general(const float4* x, const float* v,
                           const float* scal, float* y, int n, int b,
                           int d4, cudaStream_t stream)
{
    const dim3 grid((n + RT - 1) / RT, (b + W - 1) / W);
    matmat_reg_kernel<W, 1, 1, 2, false, 4><<<grid, RT, 0, stream>>>(
        x, v, scal, y, n, b, d4);
    return cudaGetLastError();
}

// The register tiles of width w (ops/matvec.py REGISTER_WIDTHS) over
// ceil(b / w) column groups, each width in the shape timed best on an
// H100 (RPT, STEP, MINB, AHEAD). d = 4..16 run the general kernel at the
// width of 8, 16 or 32 that holds w (off the main path: fewer instances
// to build)
cudaError_t launch_register(int w, const float4* x, const float* v,
                            const float* scal, float* y, int n, int b,
                            int dp, int d, cudaStream_t s)
{
    if (d > 3) {
        const int d4 = dp / 4;
        if (w <= 8) return launch_general<8>(x, v, scal, y, n, b, d4, s);
        if (w <= 16) return launch_general<16>(x, v, scal, y, n, b, d4, s);
        return launch_general<32>(x, v, scal, y, n, b, d4, s);
    }
    switch (w) {
    case 1: return launch_reg<1, 2, 8, 4, true>(x, v, scal, y, n, b, s);
    case 2: return launch_reg<2, 2, 8, 4, true>(x, v, scal, y, n, b, s);
    case 4: return launch_reg<4, 2, 8, 4, true>(x, v, scal, y, n, b, s);
    case 8: return launch_reg<8, 2, 8, 4, true>(x, v, scal, y, n, b, s);
    case 9: return launch_reg<9, 2, 8, 4, true>(x, v, scal, y, n, b, s);
    case 12: return launch_reg<12, 2, 8, 4, true>(x, v, scal, y, n, b, s);
    case 16: return launch_reg<16, 2, 8, 4, false>(x, v, scal, y, n, b, s);
    case 24: return launch_reg<24, 2, 4, 3, false>(x, v, scal, y, n, b, s);
    case 32: return launch_reg<32, 2, 4, 3, false>(x, v, scal, y, n, b, s);
    default: return cudaErrorInvalidValue;
    }
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

// x (n, dp) with d features zero-padded to dp, a multiple of 4, at most
// 16, 16-byte aligned; v (n, b); scal (1,) = [s2]; y (n, b): float32,
// contiguous, row-major, on `device`. w: the register tiles' width (one
// of REGISTER_WIDTHS; ceil(b / w) column groups), or 0 for the wide tile.
// Returns a cudaError_t code (0 on success).
int gp_matmat_f32(const void* x, const void* v, const void* scal, void* y,
                  int n, int b, int dp, int d, int w, int device,
                  void* stream)
{
    if (n <= 0 || b <= 0 || dp <= 0 || dp % 4 != 0 || dp > 16 || d <= 0 ||
        d > dp || (d + 3) / 4 * 4 != dp || w < 0 ||
        (w > 0 && (b + w - 1) / w > 65535))
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
    if (w > 0)
        err = launch_register(w, xf, vf, sf, yf, n, b, dp, d, s);
    else if (d4 == 1)
        err = launch_tc<1>(xf, vf, sf, yf, n, b, d4, s);
    else
        err = launch_tc<4>(xf, vf, sf, yf, n, b, d4, s);
    return (int)err;
}

}  // extern "C"
