// RMSNorm forward for Hopper (sm_90a), bf16 in/out, fp32 scale.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py
// (_rms_kernel / rmsnorm_fwd). Per row of an (N, D) view:
//   y = x * rsqrt(mean(x^2) + eps) * scale      (fp32 math, output in bf16)
//
// Bound: memory. Each element is read once and written once (2 bytes each in
// bf16) and costs three flops, far below the card's ~295 flop/byte balance
// point: 131 MB at (8000, 4096), ~0.0391 ms at 3.35 TB/s; 82 MB at
// (8000, 2560), ~0.0245 ms. At decode (8 rows) the launch itself dominates.
//
// Design: a row belongs to one warp (kWarps = 1) or to a fixed group of
// kWarps warps when D is large or the rows are too few to fill the card (see
// rmsnorm_fwd). Each lane loads its share of the row as
// kVecs 16-byte vectors, all issued before the first is used, and keeps them
// in registers: vector i of the row lives in slot i / (32 kWarps) of lane
// i % 32 of warp (i / 32) % kWarps, so neighbouring lanes read neighbouring
// addresses. The sum of squares is taken in fp32 as a tree, pairwise within
// a lane and then by warp shuffles, so its rounding grows with log D rather
// than D; a group of warps adds one shared-memory step and one barrier per
// block. The output pass scales the registers and reads `scale` as float4s
// (the same for every row, so L1 and L2 serve it). A block holds
// kRowsPerBlock rows (128 threads, or one row of 32 kWarps threads above
// that); the last block's surplus rows load and store nothing. Only a row
// wider than the largest register tile (16 warps x 32 lanes x 16 vectors =
// D 65536) is walked in slabs and read twice.
//
// Tiles at prefill's 8000 rows (rows of the repo's configs): D 2560 one
// warp x 10 vectors per lane (slot count 12), D 4096 one warp x 16, D 5120
// two warps x 10 (12), D 8192 two warps x 16, D 16384 four warps x 16; at a
// decode step's 8 rows, 16 warps a row. ptxas (sm_90a, nvcc 12.9), no spills
// in any of the 30 instantiations: 16 slots 94-96 registers, 12 slots 78-80,
// 8 slots 56-57, 4 slots 40, 2 slots 34-40, 1 slot 32; 16-64 B of static
// shared memory where a row takes several warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;  // bf16 elements per 16-byte vector
typedef __nv_bfloat16 bf16;

// threads of a block whose rows take kWarps warps each
__host__ __device__ constexpr int threads_for(int kWarps) {
    return kWarps * 32 > 128 ? kWarps * 32 : 128;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Slab `slab` of a row into the lane's registers: slot s holds vector
// slab * kSlab + s * 32 kWarps + first, zero past the row's end or the rows.
template <int kVecs, int kWarps>
__device__ __forceinline__ void load_slab(uint4 (&v)[kVecs], const uint4* xr, int slab,
                                          int first, int nvec, bool live) {
    constexpr int kSlab = kVecs * kWarps * 32;
#pragma unroll
    for (int s = 0; s < kVecs; ++s) {
        const int i = slab * kSlab + s * kWarps * 32 + first;
        v[s] = live && i < nvec ? xr[i] : make_uint4(0, 0, 0, 0);
    }
}

template <int kVecs, int kWarps>
__global__ void __launch_bounds__(threads_for(kWarps))
rmsnorm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
               bf16* __restrict__ out, int rows, int dim, float eps) {
    constexpr int kRowsPerBlock = threads_for(kWarps) / (kWarps * 32);
    constexpr int kSlab = kVecs * kWarps * 32;  // vectors a group holds at once
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int row = blockIdx.x * kRowsPerBlock + warp / kWarps;
    const int first = (warp % kWarps) * 32 + lane;  // this lane's first vector
    const int nvec = dim / kVec;
    const int nslab = (nvec + kSlab - 1) / kSlab;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * dim);
    uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * dim);

    uint4 v[kVecs];
    float ss = 0.f;
    for (int slab = 0; slab < nslab; ++slab) {
        load_slab<kVecs, kWarps>(v, xr, slab, first, nvec, live);
        float part[kVecs];  // sums of squares, added pairwise (as a tree, not a chain)
#pragma unroll
        for (int s = 0; s < kVecs; ++s) {
            const bf16* e = reinterpret_cast<const bf16*>(&v[s]);
            float sq[kVec];
#pragma unroll
            for (int j = 0; j < kVec; ++j) sq[j] = __bfloat162float(e[j]) * __bfloat162float(e[j]);
            part[s] = ((sq[0] + sq[1]) + (sq[2] + sq[3])) + ((sq[4] + sq[5]) + (sq[6] + sq[7]));
        }
#pragma unroll
        for (int w = 1; w < kVecs; w *= 2)
#pragma unroll
            for (int s = 0; s + w < kVecs; s += 2 * w) part[s] += part[s + w];
        ss += part[0];
    }
    ss = warp_sum(ss);
    if constexpr (kWarps > 1) {
        __shared__ float partial[kRowsPerBlock][kWarps];
        if (lane == 0) partial[warp / kWarps][warp % kWarps] = ss;
        __syncthreads();
        ss = 0.f;
#pragma unroll
        for (int g = 0; g < kWarps; ++g) ss += partial[warp / kWarps][g];
    }
    if (!live) return;
    const float r = rsqrtf(ss / (float)dim + eps);

    const float4* sc = reinterpret_cast<const float4*>(scale);
    // the last slab is still in registers; a row of one slab is read once
    for (int slab = nslab - 1; slab >= 0; --slab) {
        if (slab != nslab - 1) load_slab<kVecs, kWarps>(v, xr, slab, first, nvec, live);
#pragma unroll
        for (int s = 0; s < kVecs; ++s) {
            const int i = slab * kSlab + s * kWarps * 32 + first;
            if (i >= nvec) continue;
            const float4 s0 = sc[2 * i], s1 = sc[2 * i + 1];
            const float sv[kVec] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
            const bf16* e = reinterpret_cast<const bf16*>(&v[s]);
            uint4 res;
            bf16* o = reinterpret_cast<bf16*>(&res);
#pragma unroll
            for (int j = 0; j < kVec; ++j)
                o[j] = __float2bfloat16((__bfloat162float(e[j]) * r) * sv[j]);
            orow[i] = res;
        }
    }
}

template <int kVecs, int kWarps>
int launch(const void* x, const void* scale, void* out, int rows, int dim, float eps,
           cudaStream_t st) {
    constexpr int kRowsPerBlock = threads_for(kWarps) / (kWarps * 32);
    const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    rmsnorm_kernel<kVecs, kWarps><<<blocks, threads_for(kWarps), 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(scale),
        static_cast<bf16*>(out), rows, dim, eps);
    return static_cast<int>(cudaGetLastError());
}

// Slots per lane rounded up to 1, 2, 4, 8, 12 or 16.
template <int kWarps>
int launch_warps(const void* x, const void* scale, void* out, int rows, int dim,
                 float eps, cudaStream_t st) {
    const int per_lane = (dim / kVec + kWarps * 32 - 1) / (kWarps * 32);
    if (per_lane <= 1) return launch<1, kWarps>(x, scale, out, rows, dim, eps, st);
    if (per_lane <= 2) return launch<2, kWarps>(x, scale, out, rows, dim, eps, st);
    if (per_lane <= 4) return launch<4, kWarps>(x, scale, out, rows, dim, eps, st);
    if (per_lane <= 8) return launch<8, kWarps>(x, scale, out, rows, dim, eps, st);
    if (per_lane <= 12) return launch<12, kWarps>(x, scale, out, rows, dim, eps, st);
    return launch<16, kWarps>(x, scale, out, rows, dim, eps, st);
}

constexpr int kSpreadWarps = 1024;  // ~8 warps an SM on 132 SMs

}  // namespace

// x/out: (rows, dim) bf16, dim a multiple of 8, 16-byte aligned; scale: (dim,)
// fp32, 16-byte aligned (the Python wrapper checks).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, int rows,
                           int dim, float eps, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nvec = dim / kVec;
    // the fewest warps per row (a power of two, at most 16: 512 threads keep
    // 128 registers each) whose lanes hold at most 16 vectors; with fewer
    // rows than fill the card (a decode step's 8), wider, until kSpreadWarps
    // warps run or a lane holds one vector: a lane's loads and its reads of
    // `scale` then take fewer rounds of memory latency
    int warps = 1;
    while (warps < 16 && nvec > 16 * 32 * warps) warps *= 2;
    while (warps < 16 && rows * warps < kSpreadWarps && nvec > 32 * warps) warps *= 2;
    switch (warps) {
        case 1: return launch_warps<1>(x, scale, out, rows, dim, eps, st);
        case 2: return launch_warps<2>(x, scale, out, rows, dim, eps, st);
        case 4: return launch_warps<4>(x, scale, out, rows, dim, eps, st);
        case 8: return launch_warps<8>(x, scale, out, rows, dim, eps, st);
        default: return launch_warps<16>(x, scale, out, rows, dim, eps, st);
    }
}
