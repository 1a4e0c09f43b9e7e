// GQA flash-decode for Hopper (sm_90a), bf16 in/out.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py
// (_dec_kernel / decode_attention_fwd). One query token per sequence,
// q (B, H, dh), attends a (B, T, G, dh) KV cache at positions [0, cur_index];
// each kv head g serves query heads g*rep .. g*rep + rep - 1 (rep = H / G), so
// the cache is read once at its native G heads, never repeated.
//
// Bound: memory. The valid part of the cache is read once and each byte
// feeds ~rep multiply-adds, far below the card's flop/byte balance; at the
// serving shape (B 8, G 8, dh 128, ~1016 valid positions) that is ~33 MB of
// K and V, ~10 us at 3.35 TB/s.
//
// Design: B*G = 64 (b, g) pairs would leave most of the 132 SMs idle, so the
// valid positions are split into chunks of kSplit keys and every
// (chunk, g, b) gets a block (flash-decode). A block computes its chunk's
// scores with 16-byte loads (a group of dh/8 lanes per key, reduced with
// shuffles), a local softmax (max m, sum l), and the un-normalised P V; a
// second, tiny kernel combines the chunks per (b, head) with the usual
// exp(m_s - M) weights. cur_index arrives as a host int, so chunks past it
// are never launched and the ragged tail of the last chunk is masked: T need
// not divide any tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 64;  // keys per block; equals SPLIT in decode_attention/ops.py
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 p = __bfloat1622float2(h[i]);
        f[2 * i] = p.x;
        f[2 * i + 1] = p.y;
    }
}

template <int D, int REP>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                    const bf16* __restrict__ vc, float* __restrict__ o_part,
                    float* __restrict__ ml_part, int T, int H, int G, int n_valid,
                    float scale_log2) {
    constexpr int kLanesPerKey = D / 8;                    // 16-byte chunks per key row
    constexpr int kKeysPerPass = kThreads / kLanesPerKey;  // keys a block touches at once
    static_assert(kSplit % kKeysPerPass == 0, "every thread runs the same trip count");
    __shared__ float sc[REP][kSplit];
    __shared__ float red[kKeysPerPass][REP][D];

    const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int n_split = gridDim.x;
    const int key0 = split * kSplit;
    const int chunk = threadIdx.x % kLanesPerKey, slot = threadIdx.x / kLanesPerKey;
    const int c0 = chunk * 8;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    // This thread's 8 dims of the REP query heads, scaled into the log2 domain.
    float qr[REP][8];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
        const uint4 raw = *reinterpret_cast<const uint4*>(q + ((size_t)b * H + g * REP + r) * D + c0);
        unpack8(raw, qr[r]);
#pragma unroll
        for (int j = 0; j < 8; ++j) qr[r][j] *= scale_log2;
    }

    const size_t row_stride = (size_t)G * D;
    const bf16* kb = kc + ((size_t)b * T * G + g) * D + c0;
    const bf16* vb = vc + ((size_t)b * T * G + g) * D + c0;

    // 1. Scores of this chunk's keys; keys past cur_index score -inf.
    for (int kk = slot; kk < kSplit; kk += kKeysPerPass) {
        const int key = key0 + kk;
        const bool valid = key < n_valid;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (valid) raw = *reinterpret_cast<const uint4*>(kb + key * row_stride);
        float kf[8];
        unpack8(raw, kf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
            float p = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) p += qr[r][j] * kf[j];
#pragma unroll
            for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
                p += __shfl_xor_sync(0xffffffffu, p, off);
            if (chunk == 0) sc[r][kk] = valid ? p : -INFINITY;
        }
    }
    __syncthreads();

    // 2. Softmax within the chunk, one warp per head. Every launched chunk
    //    holds at least one valid key, so its max is finite.
    for (int r = warp; r < REP; r += kWarps) {
        float m = -INFINITY;
        for (int i = lane; i < kSplit; i += 32) m = fmaxf(m, sc[r][i]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        float l = 0.f;
        for (int i = lane; i < kSplit; i += 32) {
            const float p = exp2f(sc[r][i] - m);
            sc[r][i] = p;
            l += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
        if (lane == 0) {
            const size_t idx = (((size_t)b * G + g) * n_split + split) * REP + r;
            ml_part[2 * idx] = m;
            ml_part[2 * idx + 1] = l;
        }
    }
    __syncthreads();

    // 3. Un-normalised P V over this chunk's valid keys.
    float acc[REP][8];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
    for (int kk = slot; kk < kSplit && key0 + kk < n_valid; kk += kKeysPerPass) {
        float vf[8];
        unpack8(*reinterpret_cast<const uint4*>(vb + (key0 + kk) * row_stride), vf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
            const float p = sc[r][kk];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[r][j] += p * vf[j];
        }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) red[slot][r][c0 + j] = acc[r][j];
    __syncthreads();
    float* ob = o_part + (((size_t)b * G + g) * n_split + split) * REP * D;
    for (int i = threadIdx.x; i < REP * D; i += kThreads) {
        const int r = i / D, d = i % D;
        float sum = 0.f;
#pragma unroll
        for (int s = 0; s < kKeysPerPass; ++s) sum += red[s][r][d];
        ob[i] = sum;
    }
}

// out[b, g*REP + r] = sum_s w_s o_s / sum_s w_s l_s with w_s = 2^(m_s - max m).
template <int D, int REP>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ ml_part,
                      bf16* __restrict__ out, int H, int G, int n_split) {
    const int g = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
    const size_t base = ((size_t)b * G + g) * n_split * REP;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
        float mx = -INFINITY;
        for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml_part[2 * (base + s * REP + r)]);
        float num = 0.f, den = 0.f;
        for (int s = 0; s < n_split; ++s) {
            const size_t idx = base + s * REP + r;
            const float w = exp2f(ml_part[2 * idx] - mx);
            den += w * ml_part[2 * idx + 1];
            num += w * o_part[idx * D + d];
        }
        out[((size_t)b * H + g * REP + r) * D + d] = __float2bfloat16(num / den);
    }
}

template <int D, int REP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* o_part, float* ml_part,
           int B, int T, int H, int G, int n_valid, float scale_log2, cudaStream_t st) {
    const int n_split = (n_valid + kSplit - 1) / kSplit;
    decode_split_kernel<D, REP><<<dim3(n_split, G, B), kThreads, 0, st>>>(
        q, k, v, o_part, ml_part, T, H, G, n_valid, scale_log2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_combine_kernel<D, REP><<<dim3(G, B), D, 0, st>>>(o_part, ml_part, o, H, G, n_split);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_rep(int rep, const bf16* q, const bf16* k, const bf16* v, bf16* o, float* o_part,
               float* ml_part, int B, int T, int H, int G, int n_valid, float scale_log2,
               cudaStream_t st) {
    switch (rep) {
        case 1: return launch<D, 1>(q, k, v, o, o_part, ml_part, B, T, H, G, n_valid, scale_log2, st);
        case 2: return launch<D, 2>(q, k, v, o, o_part, ml_part, B, T, H, G, n_valid, scale_log2, st);
        case 4: return launch<D, 4>(q, k, v, o, o_part, ml_part, B, T, H, G, n_valid, scale_log2, st);
        case 8: return launch<D, 8>(q, k, v, o, o_part, ml_part, B, T, H, G, n_valid, scale_log2, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// q: (B, H, dh) bf16; k/v: (B, T, G, dh) bf16; o: (B, H, dh) bf16; o_part:
// (B, G, n_split, rep, dh) fp32 and ml_part (B, G, n_split, rep, 2) fp32
// scratch with n_split = ceil(n_valid / kSplit); positions [0, n_valid) are
// attended. dh in {64, 128}, H / G in {1, 2, 4, 8} (the Python wrapper checks).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* o_part, void* ml_part, int B, int T, int H, int G,
                                    int dh, int n_valid, float scale, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(o);
    float* opart = static_cast<float*>(o_part);
    float* mlp = static_cast<float*>(ml_part);
    const float scale_log2 = scale * kLog2e;
    const int rep = H / G;
    if (dh == 128)
        return launch_rep<128>(rep, qp, kp, vp, op, opart, mlp, B, T, H, G, n_valid, scale_log2, st);
    if (dh == 64)
        return launch_rep<64>(rep, qp, kp, vp, op, opart, mlp, B, T, H, G, n_valid, scale_log2, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
