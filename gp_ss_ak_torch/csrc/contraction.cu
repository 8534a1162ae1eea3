// K4 for Hopper: the matrix-free gradient's contraction against dA/dtheta.
//
// Replaces no TPU kernel: the JAX package computes this contraction in
// XLA (gp_ss_ak_tpu/inference/iterative.py:855, lax.map over remat'ed row
// chunks, differentiated by jax.grad). The port's first version did the
// same in PyTorch under autograd: ~100 chunks of a (1024, N) Gram block,
// ~8 elementwise kernels and a GEMM each, forward and backward, which
// took ~1.1 s of a ~2.7 s evaluation at N = 100000 on an H100. This kernel
// does the same work in one streamed pass and never stores a Gram entry.
//
// With U = [w_1..w_m, alpha], V = [z_1..z_m, alpha], c = [1/m.., -1] and
// W(p, j) = sum_l c_l U(p, l) V(j, l), the gradient of
// 1/2 sum_pj W(p, j) A(p, j) for A = s2 exp(-r) + bias + sn2 I needs, per
// row p (ops/contraction.py adds the O(N m) terms and the factors):
//
//     t[p] = sum_j W(p, j) exp(-r(p, j))                 (j = p gives W(p, p))
//     g[p] = sum_{j : d2 >= 1e-30} (W(p, j) + W(j, p)) exp(-r) / r (xp - xj)
//
// r = ||xp - xj||. A pair closer than d2 = 1e-30 (the diagonal, and any
// duplicate point) adds W(p, j) to t and nothing to g, as the autograd
// version's clamp_min(d2, 1e-30) and its exact diagonal give.
//
// What bounds it on an H100 (N = 100000, rank m + 1 = 9): 1e10 ordered
// pairs, each with ~33 FP32 instructions (the distance 6, the guard 2, r 1,
// W(p, j) and W(j, p) 18 FFMA, t 1, the factor 2, g 3) and two MUFU
// operations (rsqrt, ex2). At 128 FP32 instructions an SM a clock the
// instructions take ~9.9 ms; MUFU's 16 a clock ~4.7 ms; the bytes (the
// points once per block) nothing. So FP32 issue sets the pace. ptxas
// makes 37.1 issue slots an entry of the inner loop (32 FP32, 1.5 LDS),
// and the kernel ran in 14.2 ms on an H100 80GB HBM3 at 700 W: 0.69 of
// the 33-instruction bound, 0.78 of the SASS's.
//
// Design:
//  * A block owns BM = NT * R rows, R per thread in registers: the row's
//    point, V(p, :) and cU(p, :) = c * U(p, :). It streams the columns of
//    its slice through shared memory, JT at a time, as packed records
//    [x * log2 e | V(j, :) | cU(j, :)] (ops/contraction.py builds them):
//    every thread of a warp reads the same record, a broadcast, and each
//    LDS.128 serves R rows.
//  * The points are scaled by log2 e once (in the records), so exp(-r)
//    is one MUFU.EX2 of -r' with r' = r log2 e, and (xp - xj) / r equals
//    (xp' - xj') / r' exactly: the direction needs no rescaling. The
//    distance is d2 * rsqrt(d2) (one MUFU.RSQ), the guard a compare and
//    a select on rsqrt (0 below the threshold, so r = 0, exp = 1, and the
//    pair's factor for g is 0).
//  * g sums f * (xp - xj) from the differences the distance already
//    made (3 FFMA at d = 3): no |x|^2 expansion, so close pairs keep
//    their digits and duplicates give exact zeros.
//  * Sums: each row's sums over one column tile (JT terms) are added to
//    its running total; a block covers one column slice (at most 16384
//    columns, ops/contraction.py MAX_SLICE, so a total adds at most 256
//    tile sums), and writes its rows' totals [t, g] once to partial
//    (slices, rows_pad, 1 + D); the wrapper adds the slices in float64
//    in a fixed order. No atomics: two launches give the same bits.
//  * The rank is a template parameter MP (9, 17, 33: the records pad
//    U and V with zero columns, which add nothing), so W's FFMA chains
//    are unrolled; R shrinks as MP grows to hold the row state in
//    registers. D = 3 covers d <= 3 (zero features add nothing); D = 16,
//    MP = 33 is a general instance for d <= 16 at any rank <= 33.
//  * float32 only, no TF32 or bf16 anywhere (no products on the tensor
//    cores: the "products" here are rank-9 dot products per entry).

#include <cuda_runtime.h>

#include "ex2_poly.cuh"

namespace {

constexpr int NT = 128;             // threads per block
constexpr int JT = 64;              // column records per shared tile
constexpr float LOG2E = 1.4426950408889634f;
// 1e-30 in the records' units (d2' = d2 * log2(e)^2)
constexpr float D2_MIN = 1e-30f * LOG2E * LOG2E;

__device__ __forceinline__ float rsqrt_approx(float x)
{
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// the packed record of one point: DX floats of features (D padded to a
// multiple of 4), then MP of V, then MP of cU, padded to whole float4s
template <int D, int MP>
struct Rec {
    static constexpr int DX = (D + 3) / 4 * 4;
    static constexpr int S = (DX + 2 * MP + 3) / 4 * 4;
    static constexpr int S4 = S / 4;
};

template <int S4>
__device__ __forceinline__ void unpack(const float4* src, float* q)
{
#pragma unroll
    for (int i = 0; i < S4; ++i) {
        const float4 v = src[i];
        q[4 * i] = v.x;
        q[4 * i + 1] = v.y;
        q[4 * i + 2] = v.z;
        q[4 * i + 3] = v.w;
    }
}

// partial[slice, p, :] = [t, g_0 .. g_{D-1}] of row p over the columns of
// `slice`, in the records' units (g is scaled back by the wrapper's
// -s2 / 2; the log2 e of the direction cancels)
template <int D, int MP, int R, int MINB>
__global__ void __launch_bounds__(NT, MINB)
contraction_kernel(const float4* __restrict__ rec, float* __restrict__ partial,
                   int rows_pad, int slice_w)
{
    using L = Rec<D, MP>;
    __shared__ float4 tile[JT * L::S4];

    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * (NT * R);

    float xr[R][D], vr[R][MP], ur[R][MP];
    float tt[R], gt[R][D];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        float q[L::S];
        unpack<L::S4>(rec + (size_t)(row0 + r * NT + tid) * L::S4, q);
#pragma unroll
        for (int i = 0; i < D; ++i) xr[r][i] = q[i];
#pragma unroll
        for (int l = 0; l < MP; ++l) {
            vr[r][l] = q[L::DX + l];
            ur[r][l] = q[L::DX + MP + l];
        }
        tt[r] = 0.0f;
#pragma unroll
        for (int i = 0; i < D; ++i) gt[r][i] = 0.0f;
    }

    const int c0 = blockIdx.y * slice_w;
    for (int j0 = c0; j0 < c0 + slice_w; j0 += JT) {
        const float4* src = rec + (size_t)j0 * L::S4;
        for (int e = tid; e < JT * L::S4; e += NT) tile[e] = src[e];
        __syncthreads();

        float tp[R], gp[R][D];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            tp[r] = 0.0f;
#pragma unroll
            for (int i = 0; i < D; ++i) gp[r][i] = 0.0f;
        }
#pragma unroll 2
        for (int k = 0; k < JT; ++k) {
            float q[L::S];
            unpack<L::S4>(tile + k * L::S4, q);
#pragma unroll
            for (int r = 0; r < R; ++r) {
                float dx[D];
                float d2 = 0.0f;
#pragma unroll
                for (int i = 0; i < D; ++i) {
                    dx[i] = xr[r][i] - q[i];
                    d2 = fmaf(dx[i], dx[i], d2);
                }
                const float rs = d2 >= D2_MIN ? rsqrt_approx(d2) : 0.0f;
                const float e = gp_ex2::mufu(-(d2 * rs));
                float w = 0.0f;                 // W(p, j)
#pragma unroll
                for (int l = 0; l < MP; ++l)
                    w = fmaf(ur[r][l], q[L::DX + l], w);
                tp[r] = fmaf(w, e, tp[r]);
#pragma unroll
                for (int l = 0; l < MP; ++l)    // + W(j, p)
                    w = fmaf(vr[r][l], q[L::DX + MP + l], w);
                const float f = w * e * rs;
#pragma unroll
                for (int i = 0; i < D; ++i) gp[r][i] = fmaf(f, dx[i], gp[r][i]);
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            tt[r] += tp[r];
#pragma unroll
            for (int i = 0; i < D; ++i) gt[r][i] += gp[r][i];
        }
        __syncthreads();            // the tile is rewritten next
    }

    float* out = partial + (size_t)blockIdx.y * rows_pad * (1 + D);
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const size_t p = (size_t)(row0 + r * NT + tid) * (1 + D);
        if constexpr (D == 3) {
            *(float4*)(out + p) = make_float4(tt[r], gt[r][0], gt[r][1],
                                              gt[r][2]);
        } else {
            out[p] = tt[r];
#pragma unroll
            for (int i = 0; i < D; ++i) out[p + 1 + i] = gt[r][i];
        }
    }
}

// one instance: its kernel, rows per block and record width
struct Instance {
    const void* fn;
    int rows;
    int floats;
};

template <int D, int MP, int R, int MINB>
Instance instance()
{
    return {(const void*)contraction_kernel<D, MP, R, MINB>, NT * R,
            Rec<D, MP>::S};
}

// the instance for dp features (3, or 16 for 4..16) and rank mp
bool pick(int dp, int mp, Instance* out)
{
    if (dp == 3 && mp == 9) *out = instance<3, 9, 4, 3>();
    else if (dp == 3 && mp == 17) *out = instance<3, 17, 2, 3>();
    else if (dp == 3 && mp == 33) *out = instance<3, 33, 1, 3>();
    else if (dp == 16 && mp == 33) *out = instance<16, 33, 1, 2>();
    else return false;
    return true;
}

}  // namespace

extern "C" {

// The geometry of the (dp, mp) instance on `device`: shape[0] rows per
// block, shape[1] columns per shared tile (slice widths are multiples of
// it), shape[2] floats per record, shape[3] blocks an SM holds at once.
// Returns a cudaError_t code (0 on success).
int gp_contraction_shape(int dp, int mp, int* shape, int device)
{
    Instance in;
    if (!pick(dp, mp, &in)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, in.fn, NT,
                                                        0);
    if (err != cudaSuccess) return (int)err;
    shape[0] = in.rows;
    shape[1] = JT;
    shape[2] = in.floats;
    shape[3] = blocks;
    return 0;
}

// rec (npad, floats) float32 records, 16-byte aligned, npad >= rows_pad and
// npad >= slices * slice_w, zero past the points; partial (slices,
// rows_pad, 1 + D) float32; rows_pad a multiple of the instance's rows per
// block, slice_w of its tile.
int gp_contraction_f32(const void* rec, void* partial, int rows_pad,
                       int slice_w, int slices, int dp, int mp, int device,
                       void* stream)
{
    Instance in;
    if (!pick(dp, mp, &in) || rows_pad <= 0 || rows_pad % in.rows != 0 ||
        slice_w <= 0 || slice_w % JT != 0 || slices <= 0 ||
        slices > 65535)
        return (int)cudaErrorInvalidValue;
    // this library links its own CUDA runtime, whose current device is
    // separate from the caller's: select the tensors' device explicitly
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(rows_pad / in.rows, slices);
    void* args[] = {(void*)&rec, (void*)&partial, (void*)&rows_pad,
                    (void*)&slice_w};
    return (int)cudaLaunchKernel(in.fn, grid, dim3(NT), args, 0,
                                 (cudaStream_t)stream);
}

}  // extern "C"
