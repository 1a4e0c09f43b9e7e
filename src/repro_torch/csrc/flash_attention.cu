// Causal / full GQA flash-attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_fa_kernel / flash_attention_fwd). Computes, for q (B, S, H, dh) and
// k/v (B, T, G, dh), out[b, i, h] = softmax_j(q.k_j / sqrt(dh)) v_j over keys
// j (j <= i when causal) of kv head h*G/H, with an fp32 online softmax
// (running max m, running sum l, accumulator acc). KV heads are never
// repeated in memory: each block reads its kv head's rows directly.
//
// Bound: operations. 4*dh*S*(S+1)/2*B*H flops at the prefill shape
// (8 x 1000 x 32 heads, dh 128) are ~65.6 GFLOP, ~66 us at 989 TFLOP/s, above
// the ~49 us that its 164 MB of q/k/v/o take at 3.35 TB/s. So the products
// run on the tensor cores: mma.sync m16n8k16 bf16 with fp32 accumulation.
//
// Design (simple first): one block of 4 warps per (q tile of 64 rows, head,
// batch). Each warp owns 16 query rows and keeps its Q fragments, its S tile
// and its O accumulator in registers; the S accumulator is re-packed in
// registers as the A operand of P @ V (the FlashAttention-2 layout trick), so
// P never touches shared memory. K and V tiles of 64 keys are staged in
// padded shared memory (conflict-free fragment reads). Key tiles past the
// diagonal are skipped; ragged S and T tails are masked (rows past S are not
// stored, keys past T are zero-filled and masked), so unlike the Pallas
// kernel no length has to divide the tile. Not yet pipelined (no cp.async /
// TMA double buffering, no wgmma): that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [row0, row0 + 64) of one head of a (len, heads, D) slab into a
// padded shared tile; rows at or past len are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16 (*tile)[D + 8], const bf16* base, int row0,
                                          int len, int row_stride) {
    constexpr int kVecPerRow = D / 8;  // 16-byte vectors per row
    for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
        const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < len)
            val = *reinterpret_cast<const uint4*>(base + (size_t)(row0 + r) * row_stride + c);
        *reinterpret_cast<uint4*>(&tile[r][c]) = val;
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int S, int T, int H,
              int G, float scale_log2, int causal) {
    static_assert(kBlockQ == kBlockK, "Q is staged through the K tile");
    __shared__ __align__(16) bf16 sk[kBlockK][D + 8];
    __shared__ __align__(16) bf16 sv[kBlockK][D + 8];

    const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
    const int g = h * G / H;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tq = lane & 3;  // mma fragment row / column pair
    const int r0 = warp * 16;                  // this warp's first row in the tile

    const bf16* qb = q + ((size_t)b * S * H + h) * D;
    const bf16* kb = k + ((size_t)b * T * G + g) * D;
    const bf16* vb = v + ((size_t)b * T * G + g) * D;

    // Q fragments (A operand, 16 rows x D) stay in registers for the whole loop.
    load_tile<D>(sk, qb, q0, S, H * D);
    __syncthreads();
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * tq;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(&sk[r0 + gid][c]);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(&sk[r0 + gid + 8][c]);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(&sk[r0 + gid][c + 8]);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(&sk[r0 + gid + 8][c + 8]);
    }
    __syncthreads();

    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
        acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows gid and gid + 8 (log2 domain)
    float l_run[2] = {0.f, 0.f};
    const int row_a = q0 + r0 + gid, row_b = row_a + 8;

    int n_tiles = (T + kBlockK - 1) / kBlockK;
    if (causal) n_tiles = min(n_tiles, (q0 + kBlockQ - 1) / kBlockK + 1);

    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * kBlockK;
        load_tile<D>(sk, kb, k0, T, G * D);
        load_tile<D>(sv, vb, k0, T, G * D);
        __syncthreads();

        // S = Q K^T for this warp's 16 rows x 64 keys.
        float s[kBlockK / 8][4];
#pragma unroll
        for (int nt = 0; nt < kBlockK / 8; ++nt) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int c = kk * 16 + 2 * tq;
                uint32_t bf[2];
                bf[0] = *reinterpret_cast<const uint32_t*>(&sk[nt * 8 + gid][c]);
                bf[1] = *reinterpret_cast<const uint32_t*>(&sk[nt * 8 + gid][c + 8]);
                mma_bf16(s[nt], qf[kk], bf);
            }
        }

        // Scale into the log2 domain and mask keys past T or past the diagonal.
        const bool need_mask = (k0 + kBlockK > T) || (causal && k0 + kBlockK - 1 > q0 + r0);
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[nt][e] * scale_log2;
                if (need_mask) {
                    const int col = k0 + nt * 8 + 2 * tq + (e & 1);
                    const int row = e < 2 ? row_a : row_b;
                    if (col >= T || (causal && col > row)) x = -INFINITY;
                }
                s[nt][e] = x;
            }
            mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
        }
        // A row's 64 scores sit in the 4 threads of one quad.
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        }
        float base[2], alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            base[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // fully masked so far
            alpha[i] = exp2f(m_run[i] - base[i]);
            m_run[i] = mx[i];
        }
#pragma unroll
        for (int nt = 0; nt < kBlockK / 8; ++nt) {
            s[nt][0] = exp2f(s[nt][0] - base[0]);
            s[nt][1] = exp2f(s[nt][1] - base[0]);
            s[nt][2] = exp2f(s[nt][2] - base[1]);
            s[nt][3] = exp2f(s[nt][3] - base[1]);
            rsum[0] += s[nt][0] + s[nt][1];
            rsum[1] += s[nt][2] + s[nt][3];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
            rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
            l_run[i] = l_run[i] * alpha[i] + rsum[i];
        }
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
            acc[dt][0] *= alpha[0];
            acc[dt][1] *= alpha[0];
            acc[dt][2] *= alpha[1];
            acc[dt][3] *= alpha[1];
        }

        // O += P V: the S accumulator layout is the A-operand layout.
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
            const int kr = kk * 16 + 2 * tq;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt) {
                const int c = dt * 8 + gid;
                uint32_t bv[2];
                bv[0] = pack_raw(sv[kr][c], sv[kr + 1][c]);
                bv[1] = pack_raw(sv[kr + 8][c], sv[kr + 9][c]);
                mma_bf16(acc[dt], pa, bv);
            }
        }
        __syncthreads();  // the next tile overwrites sk / sv
    }

    const float inv_a = 1.f / fmaxf(l_run[0], 1e-30f);
    const float inv_b = 1.f / fmaxf(l_run[1], 1e-30f);
    bf16* ob = o + ((size_t)b * S * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
        const int c = dt * 8 + 2 * tq;
        if (row_a < S)
            *reinterpret_cast<uint32_t*>(ob + (size_t)row_a * H * D + c) =
                pack_bf16(acc[dt][0] * inv_a, acc[dt][1] * inv_a);
        if (row_b < S)
            *reinterpret_cast<uint32_t*>(ob + (size_t)row_b * H * D + c) =
                pack_bf16(acc[dt][2] * inv_b, acc[dt][3] * inv_b);
    }
}

}  // namespace

// q: (B, S, H, dh), k/v: (B, T, G, dh), o: (B, S, H, dh); all bf16, contiguous,
// 16-byte aligned; dh in {64, 128}; H % G == 0 (the Python wrapper checks).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int T, int H, int G, int dh, float scale,
                                   int causal, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
    const float scale_log2 = scale * kLog2e;
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(o);
    if (dh == 128) {
        fa_fwd_kernel<128><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, S, T, H, G, scale_log2, causal);
    } else if (dh == 64) {
        fa_fwd_kernel<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, S, T, H, G, scale_log2, causal);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
