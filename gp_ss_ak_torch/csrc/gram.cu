// K1 for Hopper: the fused ExpAns+Bias Gram matrix.
//
// Replaces the Pallas tile kernel gp_ss_ak_tpu/ops/pairwise.py::_gram_kernel
// (launched by _fused_gram, wrapped by expans_bias_gram). On metric-mapped
// points (rows of Xi and Xj, d features each) it writes
//
//     out[i, j] = s2 * exp(-||xi - xj||) + bias          for i < n, j < m
//     out[i, i] = s2 + bias + sn2   exactly, when with_diag (square build)
//
// with scal = [s2, bias, sn2] read from device memory (no host sync to
// fetch the hyperparameters).
//
// What bounds it on an H100: writing the n*m output (4 or 8 bytes per
// element at 3.35 TB/s: 1.07 GB, so >= 0.32 ms, for a 16384^2 float
// matrix) and one exp + one sqrt per element. The distance itself is a
// handful of FMAs because d is tiny (3 or 4 for ExpAns), so this is not
// a matrix-multiply problem and uses no tensor cores; TF32/bf16 would
// make the Gram indefinite anyway (kernels/distance.py, gram_sqdist).
//
// Design, and how it differs from the TPU kernel:
//  * d stays a runtime argument and is NOT padded to 128 lanes. The
//    features are staged through shared memory DK at a time, so any
//    d >= 1 works with a fixed, small shared footprint.
//  * A 256-thread block owns a BM x BN = 64 x 128 output tile; each
//    thread computes RM x RN = 8 x 4 outputs in registers. A warp spans
//    32 consecutive columns, so every store is a coalesced 128-byte
//    (float) or 256-byte (double) row segment of the row-major output.
//  * d2 is the direct sum of squared differences, not the TPU's
//    |xi|^2 + |xj|^2 - 2 xi.xj expansion: the same few FMAs at d <= 4,
//    no cancellation, exact zeros for coincident points, so no clamp.
//  * Ragged edges are masked in the kernel: no padded copies of X and
//    no slice of the output afterwards.
//  * Templated on float (the serving type) and double (golden checks).
//  * A leading batch axis (the JAX package's jax.vmap over ensemble
//    members and sampler chains): blockIdx.z picks the member, whose
//    points, three scalars and output sit at fixed strides. The 2-D
//    entry is the one-member case of the same kernel body, so a member
//    of a batched launch gets the same bits as a 2-D launch on it.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;          // threads along j: one warp
constexpr int TY = 8;           // threads along i
constexpr int RM = 8;           // rows per thread
constexpr int RN = 4;           // columns per thread
constexpr int BM = TY * RM;     // 64 rows per block
constexpr int BN = TX * RN;     // 128 columns per block
constexpr int DK = 4;           // features staged per pass
constexpr int NT = TX * TY;     // 256 threads

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(NT)
gram_kernel(const T* __restrict__ xi, const T* __restrict__ xj,
            const T* __restrict__ scal, T* __restrict__ out,
            int n, int m, int d, int with_diag)
{
    // transposed tiles: a warp reads one broadcast xi value and 32
    // consecutive xj values per feature, both free of bank conflicts
    __shared__ T sxi[DK][BM];
    __shared__ T sxj[DK][BN];

    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int tid = ty * TX + tx;
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;
    // this block's member of the batch
    xi += (size_t)blockIdx.z * n * d;
    xj += (size_t)blockIdx.z * m * d;
    scal += (size_t)blockIdx.z * 3;
    out += (size_t)blockIdx.z * n * m;

    T acc[RM][RN];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] = T(0);

    for (int k0 = 0; k0 < d; k0 += DK) {
        // rows/features outside the matrix stage as 0 on BOTH sides,
        // so a padded feature adds (0 - 0)^2 = 0
        for (int e = tid; e < BM * DK; e += NT) {
            const int r = e / DK, k = e % DK;
            const int gi = row0 + r, gk = k0 + k;
            sxi[k][r] = (gi < n && gk < d) ? xi[(size_t)gi * d + gk] : T(0);
        }
        for (int e = tid; e < BN * DK; e += NT) {
            const int c = e / DK, k = e % DK;
            const int gj = col0 + c, gk = k0 + k;
            sxj[k][c] = (gj < m && gk < d) ? xj[(size_t)gj * d + gk] : T(0);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < DK; ++k) {
            T a[RM], b[RN];
#pragma unroll
            for (int r = 0; r < RM; ++r) a[r] = sxi[k][ty + r * TY];
#pragma unroll
            for (int c = 0; c < RN; ++c) b[c] = sxj[k][tx + c * TX];
#pragma unroll
            for (int r = 0; r < RM; ++r)
#pragma unroll
                for (int c = 0; c < RN; ++c) {
                    const T t = a[r] - b[c];
                    acc[r][c] = fma_t(t, t, acc[r][c]);
                }
        }
        __syncthreads();
    }

    const T s2 = scal[0];
    const T bias = scal[1];
    const T on_diag = (s2 + bias) + scal[2];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
        const int i = row0 + ty + r * TY;
        if (i >= n) continue;
        T* orow = out + (size_t)i * m;
#pragma unroll
        for (int c = 0; c < RN; ++c) {
            const int j = col0 + tx + c * TX;
            if (j >= m) continue;
            T v = s2 * exp_t(-sqrt_t(acc[r][c])) + bias;
            if (with_diag && i == j) v = on_diag;
            orow[j] = v;
        }
    }
}

template <typename T>
int launch(const void* xi, const void* xj, const void* scal, void* out,
           int batch, int n, int m, int d, int with_diag, int device,
           void* stream)
{
    if (batch <= 0 || n <= 0 || m <= 0 || d <= 0)
        return (int)cudaErrorInvalidValue;
    const unsigned gy = (n + BM - 1) / BM;
    if (gy > 65535u) return (int)cudaErrorInvalidValue;
    // this library links its own CUDA runtime, whose current device is
    // separate from the caller's: select the tensors' device explicitly
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    // gridDim.z is at most 65535: larger batches take several launches
    constexpr int ZMAX = 65535;
    for (int b0 = 0; b0 < batch; b0 += ZMAX) {
        const int nb = batch - b0 < ZMAX ? batch - b0 : ZMAX;
        const dim3 grid((m + BN - 1) / BN, gy, nb);
        gram_kernel<T><<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
            (const T*)xi + (size_t)b0 * n * d,
            (const T*)xj + (size_t)b0 * m * d,
            (const T*)scal + (size_t)b0 * 3,
            (T*)out + (size_t)b0 * n * m, n, m, d, with_diag);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace

extern "C" {

int gp_gram_f32(const void* xi, const void* xj, const void* scal, void* out,
                int n, int m, int d, int with_diag, int device, void* stream)
{
    return launch<float>(xi, xj, scal, out, 1, n, m, d, with_diag, device,
                         stream);
}

int gp_gram_f64(const void* xi, const void* xj, const void* scal, void* out,
                int n, int m, int d, int with_diag, int device, void* stream)
{
    return launch<double>(xi, xj, scal, out, 1, n, m, d, with_diag, device,
                          stream);
}

// xi (batch, n, d), xj (batch, m, d), scal (batch, 3), out (batch, n, m),
// all contiguous; with_diag applies to every member
int gp_gram_batched_f32(const void* xi, const void* xj, const void* scal,
                        void* out, int batch, int n, int m, int d,
                        int with_diag, int device, void* stream)
{
    return launch<float>(xi, xj, scal, out, batch, n, m, d, with_diag,
                         device, stream);
}

int gp_gram_batched_f64(const void* xi, const void* xj, const void* scal,
                        void* out, int batch, int n, int m, int d,
                        int with_diag, int device, void* stream)
{
    return launch<double>(xi, xj, scal, out, batch, n, m, d, with_diag,
                          device, stream);
}

const char* gp_cuda_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
