// RMSNorm forward for Hopper (sm_90a), bf16 in/out, fp32 scale.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py
// (_rms_kernel / rmsnorm_fwd). Per row of an (N, D) view:
//   y = x * rsqrt(mean(x^2) + eps) * scale      (fp32 math, output in bf16)
//
// Bound: memory. Each element is read once and written once (2 bytes each in
// bf16) and costs three flops, far below the card's ~295 flop/byte balance
// point; at the prefill shape (8000 x 4096 bf16, 131 MB) the floor is ~39 us
// at 3.35 TB/s. At decode (8 rows) the launch itself dominates.
//
// Design: one block per row. Each thread moves 16 bytes per load, neighbouring
// threads on neighbouring addresses; the sum of squares is reduced in fp32
// with warp shuffles and one shared-memory step; the second pass re-reads the
// row, which a D = 4096 row keeps in L1/L2, so device memory sees one read
// and one write per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

constexpr int kVec = 8;  // bf16 elements per 16-byte load
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float block_sum(float v) {
    __shared__ float partial[kThreads / 32];
    __shared__ float total;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) partial[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < kThreads / 32 ? partial[lane] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) total = v;
    }
    __syncthreads();
    return total;
}

__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
               bf16* __restrict__ out, int dim, float eps) {
    const bf16* xr = x + (size_t)blockIdx.x * dim;
    bf16* orow = out + (size_t)blockIdx.x * dim;

    float ss = 0.f;
    for (int i = threadIdx.x * kVec; i < dim; i += kThreads * kVec) {
        uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
            float f = __bfloat162float(e[j]);
            ss += f * f;
        }
    }
    const float r = rsqrtf(block_sum(ss) / (float)dim + eps);

    for (int i = threadIdx.x * kVec; i < dim; i += kThreads * kVec) {
        uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
        uint4 res;
        bf16* o = reinterpret_cast<bf16*>(&res);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
            o[j] = __float2bfloat16((__bfloat162float(e[j]) * r) * scale[i + j]);
        *reinterpret_cast<uint4*>(orow + i) = res;
    }
}

}  // namespace

// x/out: (rows, dim) bf16, dim a multiple of 8, 16-byte aligned; scale: (dim,)
// fp32 (the Python wrapper checks).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, int rows,
                           int dim, float eps, void* stream) {
    rmsnorm_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(scale),
        static_cast<bf16*>(out), dim, eps);
    return static_cast<int>(cudaGetLastError());
}
