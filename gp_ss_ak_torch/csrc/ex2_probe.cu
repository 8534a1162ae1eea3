// The ex2 probe: how many 2^x an H100 SM computes a clock on MUFU
// (ex2.approx.ftz.f32) and as ex2_poly.cuh's polynomial on the FP32
// pipes. chip_smoke.py phase 5 times it and reads the polynomial's issue
// slots from its SASS; the split K2 makes between the two (matvec.cu)
// and chip_smoke.sfu_fma_ms's bound rest on those numbers.
//
// Every thread runs CHAINS independent chains x <- 2^-x (x stays in
// [0.5, 1]), STEPS steps a loop iteration, at full occupancy (8 blocks
// of 256 threads an SM), so neither latency nor the loop's three
// instructions per CHAINS * STEPS exponentials set the rate.

#include <cuda_runtime.h>

#include "ex2_poly.cuh"

namespace {

constexpr int NT = 256;
constexpr int CHAINS = 8;
constexpr int STEPS = 8;

template <bool POLY>
__global__ void __launch_bounds__(NT, 8)
ex2_probe(float* __restrict__ out, int iters)
{
    float x[CHAINS];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
        x[c] = 0.5f + 0.001f * (float)((threadIdx.x + 37 * c) & 255);
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
#pragma unroll
            for (int c = 0; c < CHAINS; ++c)
                x[c] = POLY ? gp_ex2::poly(-x[c]) : gp_ex2::mufu(-x[c]);
        }
    }
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) acc += x[c];
    out[(size_t)blockIdx.x * NT + threadIdx.x] = acc;
}

}  // namespace

extern "C" {

// out (blocks * 256,) float32 on `device`; poly = 0 for MUFU, 1 for the
// polynomial. Each thread computes iters * 64 exponentials. Returns a
// cudaError_t code (0 on success).
int gp_ex2_probe(void* out, int poly, int iters, int blocks, int device,
                 void* stream)
{
    if (iters <= 0 || blocks <= 0 || (poly != 0 && poly != 1))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    if (poly)
        ex2_probe<true><<<blocks, NT, 0, s>>>((float*)out, iters);
    else
        ex2_probe<false><<<blocks, NT, 0, s>>>((float*)out, iters);
    return (int)cudaGetLastError();
}

// exponentials one thread computes per loop iteration
int gp_ex2_probe_per_iter() { return CHAINS * STEPS; }

}  // extern "C"
