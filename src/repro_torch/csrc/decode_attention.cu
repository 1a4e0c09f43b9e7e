// GQA flash-decode for Hopper (sm_90a), bf16 in/out, one launch per call.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py
// (_dec_kernel / decode_attention_fwd). One query token per sequence,
// q (B, H, dh), attends a (B, T, G, dh) KV cache at positions [0, n_valid);
// each kv head g serves query heads g*rep .. g*rep + rep - 1 (rep = H / G), so
// the cache is read once at its native G heads, never repeated.
//
// Two forms, one kernel: the whole-cache decode writes the normalised
// output; the partial form (a position shard of a cache, combined across
// devices by all-reduces, sharding/dtensor.py) also writes each head's
// log-sum-exp (natural log, fp32) from the same merge.
//
// Bound: memory. The valid part of the cache is read once and each byte
// feeds ~rep multiply-adds, far below the card's flop/byte balance; at the
// serving shape (B 8, G 8, dh 128, 1016 valid positions) that is 33.4 MB of
// K and V, 10 us at 3.35 TB/s. What matters is bytes in flight on every SM.
//
// Design: a thread-block cluster per (b, g) of `cluster` CTAs (at most
// kMaxCluster, never more than there are key tiles), each CTA one warp group
// (128 threads). The valid positions are cut into tiles of kTile keys; CTA
// `rank` owns tiles [rank * n_tiles / cluster, (rank + 1) * n_tiles /
// cluster), at least one. Copies are TMA boxes (kTile rows x dh of one kv
// head; 4-D tensor maps over the cache, csrc/hopper.cuh) completing on
// mbarriers. Two forms of the math, by rep:
// - rep 1, 2, 4, on the CUDA cores (decode_kernel): thread 0 loads each
//   tile of K and of V into a kStages ring, K and V on separate mbarriers,
//   so V's copy is in flight while the scores of the same tile are computed.
//   A thread holds 8 dims of q and of the accumulator of each of the rep
//   heads; 16-byte shared loads (dh/8 lanes per key, shuffle reduced) give
//   the scores, an online softmax runs across the CTA's tiles (m, l per
//   head in shared memory, the accumulator rescaled), and P V has each
//   thread own 8 dims for a share of the keys.
// - rep 8 and 16, on the tensor cores (decode_mma_kernel): the rep query
//   heads are the 16 rows of mma.sync.m16n8k16 (bf16 in, fp32 sums; at rep 8
//   rows 8-15 are zero heads whose results are dropped as they come out,
//   which keeps one code path: the tensor cores have ~100x headroom here,
//   and the transposed form S^T = K Q^T would need the score accumulators
//   transposed into P V's operand). Each warp owns the
//   CTA's tiles w, w + 4, ... and a ring stage of its own (a K and a V tile,
//   loaded by its lane 0 with the 128-byte swizzle, so ldmatrix reads are
//   conflict-free); the next tile's K is loaded once this tile's scores are
//   taken, its V once P V is done. q is staged once in shared memory and
//   read into A fragments by ldmatrix (32 registers a thread fewer than
//   holding it); S = Q K^T (16 x 32: 4 n8 blocks x dh/16 k-steps) is scaled
//   in fp32 (q is not pre-scaled, so the bf16 operands stay exact); the warp keeps
//   its own (m, l, O) in registers, row max and sum by quad shuffles over the
//   accumulator layout; O += P V with P split from the score registers
//   into hi + lo bf16 parts (P in bf16 alone broke the partial form's
//   limit; rep 16 takes two products, rep 8 one, the lo parts in the zero
//   heads' rows) and V read by ldmatrix.trans. Nothing is shared between warps
//   and no __syncthreads runs in the key loop, only the warp's own
//   mbarriers; the tensor map reads positions
//   past n_valid as zeros (never a stale or non-finite value into P V). At
//   the end the 4 warps merge their (m, l, O) in shared memory.
// - Merge (both forms): each CTA leaves (m, l, o) for its rep heads in
//   shared memory; after a cluster barrier the CTAs read one another's
//   through distributed shared memory (map_shared_rank) and each writes a
//   share of the output with the weights 2^(m_rank - max m), and, in the
//   partial form, ln 2 (max m + log2 sum_c w_c l_c) for each head. No fp32
//   partials go through device memory and there is no second kernel.
// n_valid arrives as a host int, so no CTA is launched past it and the
// ragged tail of the last tile is masked: T need not divide any tile.
// Head dim 112 (zamba2-7b's shared block) runs the dh-128 layout: the TMA
// box is 128 columns wide (two 64-column boxes in the tensor-core form)
// over the 112-wide cache, and the unit zero-fills columns 112-127 (past the
// map's first dimension, never the next head's); the CUDA-core form's lanes
// of those columns load no q and add zeros, the tensor-core form skips the
// last k-step and the last two n8 blocks; the output is stored at 112
// columns a head.
// At the serving shape (rep 4): 64 clusters of 8 CTAs, each CTA 4 tiles of
// 32 keys, 32 KB of ring at dh 128; 4-5 CTAs per SM, so all 512 are resident
// at once. At llama3-405b's (rep 16): 512 CTAs of 4 warps, one tile each,
// 71,616 bytes of dynamic shared memory at dh 128 (3 CTAs an SM, 396
// resident).
// ptxas (CUDA 12.9, sm_90a): the CUDA-core form 48 / 64 / 94 registers at
// rep 1 / 2 / 4 (dh 128), no spills; the tensor-core form 168 at dh 128
// (28 B spilled at rep 16, 56 B at rep 8), 163 / 146 at dh 112, 117 / 120
// at dh 64, no spills there.
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, the kernel table): llama3-405b's
// decode 0.0349-0.0352 ms, 1.26-1.27x SDPA, 29% of its 0.0101 ms bytes
// bound (0.0858 before); qwen3-moe-235b-a22b's 0.0218-0.0220 ms, 1.14-1.15x,
// 23%; at rep 8 deepseek-67b's 0.0311-0.0313 ms, 1.14-1.15x, 32%,
// qwen3-vl-30b-a3b's 0.0194-0.0195 ms, 0.99-1.00x, 26%. What is left is
// fixed cost: the cluster merge's dependent remote loads (issued together
// they took 4-8% off) and the 116 CTAs that wait for room at 3 an SM.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int kTile = 32;        // keys per copy stage; equals TILE in decode_attention/ops.py
constexpr int kMaxCluster = 8;   // CTAs per (b, g); equals MAX_CLUSTER in decode_attention/ops.py
constexpr int kStages = 2;       // the CUDA-core form's ring
constexpr int kThreads = 128;    // one warp group a CTA (the CUDA-core form)
constexpr int kWarps = kThreads / 32;
constexpr int kMmaWarps = 4;     // warps a CTA in the tensor-core form
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

// Merge the cluster's (m, l, o): out = sum_c w_c o_c / sum_c w_c l_c,
// w_c = 2^(m_c - max m), with m in the log2 domain, o (REP x D fp32) and m, l
// (REP each) in every CTA's shared memory. Each CTA writes every n_rank-th
// share; the partial form's lse of head r goes with element (r, 0). NT is
// the CTA's thread count.
template <int D, int DV, int REP, int NT>
__device__ __forceinline__ void cluster_merge(cg::cluster_group& cluster, float* m_s, float* l_s,
                                              float* part_o, bf16* __restrict__ out,
                                              float* __restrict__ lse, int H, int g, int b) {
    const int rank = (int)cluster.block_rank(), n_rank = (int)cluster.num_blocks();
    cluster.sync();
    for (int e = rank * NT + (int)threadIdx.x; e < REP * D; e += n_rank * NT) {
        const int r = e / D, d = e % D;
        if (d >= DV) continue;  // zero pad
        float mx = -INFINITY;
        for (int c = 0; c < n_rank; ++c) mx = fmaxf(mx, *cluster.map_shared_rank(m_s + r, c));
        float num = 0.f, den = 0.f;
        for (int c = 0; c < n_rank; ++c) {
            const float w = fast_exp2(*cluster.map_shared_rank(m_s + r, c) - mx);
            den += w * *cluster.map_shared_rank(l_s + r, c);
            num += w * *cluster.map_shared_rank(part_o + e, c);
        }
        out[((size_t)b * H + g * REP + r) * DV + d] = __float2bfloat16(num / den);
        if (lse != nullptr && d == 0) lse[(size_t)b * H + g * REP + r] = (mx + log2f(den)) * kLn2;
    }
    cluster.sync();  // no CTA leaves while another still reads its shared memory
}

// ---- rep 1, 2, 4: the CUDA cores ------------------------------------------------------

// Byte offsets in dynamic shared memory.
template <int D, int REP>
struct Layout {
    static constexpr int kTileBytes = kTile * D * 2;
    static constexpr int kK = 0;                                  // + stage * kTileBytes
    static constexpr int kV = kStages * kTileBytes;               // + stage * kTileBytes
    static constexpr int kRing = 2 * kStages * kTileBytes;
    static constexpr int kScores = kRing;                         // float [REP][kTile]
    static constexpr int kPartO = kScores + REP * kTile * 4;      // float [REP][D]
    static constexpr int kM = kPartO + REP * D * 4;               // float [REP]
    static constexpr int kL = kM + REP * 4;                       // float [REP]
    static constexpr int kAlpha = kL + REP * 4;                   // float [REP]
    static constexpr int kBar = (kAlpha + REP * 4 + 7) / 8 * 8;   // k_full[], v_full[]
    static constexpr int kBytes = kBar + 16 * kStages + 128;  // + alignment slack
    // the end-of-block reduction over the warps reuses the ring
    static_assert(kWarps * REP * D * 4 <= kRing, "reduction fits the ring");
};

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 p = __bfloat1622float2(h[i]);
        f[2 * i] = p.x;
        f[2 * i + 1] = p.y;
    }
}

// D is the width the ring and the lanes are laid out at, DV <= D the head
// dim of q, the caches and the output.
// lse, if not null, receives each head's natural log-sum-exp (fp32).
template <int D, int DV, int REP>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
              const bf16* __restrict__ q, bf16* __restrict__ out, float* __restrict__ lse, int H,
              int G, int n_valid, int n_tiles, float scale_log2) {
    using L = Layout<D, REP>;
    constexpr int kLanesPerKey = D / 8;                    // 16-byte chunks per key row
    constexpr int kKeysPerPass = kThreads / kLanesPerKey;  // keys the block touches at once
    static_assert(REP <= 4, "rep 8 and 16 take the tensor-core form");
    static_assert(kTile % kKeysPerPass == 0 && kLanesPerKey <= 32, "even trip counts");
    static_assert(DV <= D && DV % 8 == 0, "whole 16-byte chunks of a head");
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((128u - ((uint32_t)__cvta_generic_to_shared(smem_raw) & 127u)) & 127u);
    float* sc = reinterpret_cast<float*>(smem + L::kScores);
    float* part_o = reinterpret_cast<float*>(smem + L::kPartO);
    float* m_s = reinterpret_cast<float*>(smem + L::kM);
    float* l_s = reinterpret_cast<float*>(smem + L::kL);
    float* alpha_s = reinterpret_cast<float*>(smem + L::kAlpha);
    const uint32_t s_base = (uint32_t)__cvta_generic_to_shared(smem);  // 128-byte aligned
    auto k_full = [&](int s) { return s_base + L::kBar + 8u * s; };
    auto v_full = [&](int s) { return s_base + L::kBar + 8u * (kStages + s); };

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank(), n_rank = (int)cluster.num_blocks();
    const int g = blockIdx.y, b = blockIdx.z;
    const int t_begin = rank * n_tiles / n_rank;
    const int my_tiles = (rank + 1) * n_tiles / n_rank - t_begin;  // >= 1: cluster <= n_tiles
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    // slot from tid % kThreads (= tid): its range known, the key loops unroll
    const int chunk = tid % kLanesPerKey, slot = tid % kThreads / kLanesPerKey;
    const int c0 = chunk * 8;

    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(k_full(s), 1);
            mbar_init(v_full(s), 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (tid < REP) {
        m_s[tid] = -INFINITY;
        l_s[tid] = 0.f;
    }
    __syncthreads();

    // Thread 0 copies local tile i into stage i % kStages: one TMA box of
    // kTile rows x dh of K and one of V (rows past T arrive as zeros).
    auto load_tile = [&](int i) {
        const int s = i % kStages, key0 = (t_begin + i) * kTile;
        mbar_expect_tx(k_full(s), L::kTileBytes);
        tma_load_4d(s_base + L::kK + s * L::kTileBytes, &k_map, k_full(s), 0, g, key0, b);
        mbar_expect_tx(v_full(s), L::kTileBytes);
        tma_load_4d(s_base + L::kV + s * L::kTileBytes, &v_map, v_full(s), 0, g, key0, b);
    };
    if (tid == 0)
        for (int i = 0; i < min(kStages, my_tiles); ++i) load_tile(i);

    // This thread's 8 dims of the query heads, scaled into the log2 domain
    // (zeros past DV).
    float qr[REP][8];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (c0 < DV)
            raw = *reinterpret_cast<const uint4*>(q + ((size_t)b * H + g * REP + r) * DV + c0);
        unpack8(raw, qr[r]);
#pragma unroll
        for (int j = 0; j < 8; ++j) qr[r][j] *= scale_log2;
    }
    float acc[REP][8];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

    for (int i = 0; i < my_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = (i / kStages) & 1;
        const int rows = min(kTile, n_valid - (t_begin + i) * kTile);
        const bf16* ks = reinterpret_cast<const bf16*>(smem + L::kK + s * L::kTileBytes);
        const bf16* vs = reinterpret_cast<const bf16*>(smem + L::kV + s * L::kTileBytes);

        // 1. Scores; keys past cur_index score -inf.
        mbar_wait(k_full(s), parity);
#pragma unroll
        for (int kk = slot; kk < kTile; kk += kKeysPerPass) {
            const bool valid = kk < rows;
            uint4 raw = make_uint4(0u, 0u, 0u, 0u);
            if (valid) raw = *reinterpret_cast<const uint4*>(ks + kk * D + c0);
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
                if (chunk == 0) sc[r * kTile + kk] = valid ? p : -INFINITY;
            }
        }
        __syncthreads();

        // 2. Online softmax across this CTA's tiles, one warp per head. Every
        //    tile holds at least one valid key, so the new max is finite.
        for (int r = warp; r < REP; r += kWarps) {
            float mx = -INFINITY;
            for (int kk = lane; kk < kTile; kk += 32) mx = fmaxf(mx, sc[r * kTile + kk]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
            float l = 0.f;
            for (int kk = lane; kk < kTile; kk += 32) {
                const float p = fast_exp2(sc[r * kTile + kk] - m_new);
                sc[r * kTile + kk] = p;
                l += p;
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
            if (lane == 0) {
                const float alpha = fast_exp2(m_old - m_new);
                alpha_s[r] = alpha;
                l_s[r] = l_s[r] * alpha + l;
                m_s[r] = m_new;
            }
        }
        __syncthreads();

        // 3. Rescale, then accumulate P V over the tile's valid keys.
        mbar_wait(v_full(s), parity);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
            const float a = alpha_s[r];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[r][j] *= a;
        }
        for (int kk = slot; kk < rows; kk += kKeysPerPass) {
            float vf[8];
            unpack8(*reinterpret_cast<const uint4*>(vs + kk * D + c0), vf);
#pragma unroll
            for (int r = 0; r < REP; ++r) {
                const float p = sc[r * kTile + kk];
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[r][j] += p * vf[j];
            }
        }
        __syncthreads();  // stage s and the scores are free again
        if (tid == 0 && i + kStages < my_tiles) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            load_tile(i + kStages);
        }
    }

    // This CTA's un-normalised o: sum over the key slots, first within each
    // warp (shuffles), then across the warps through the (now idle) ring.
#pragma unroll
    for (int off = kLanesPerKey; off < 32; off <<= 1)
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
    float* red = reinterpret_cast<float*>(smem);  // [kWarps][REP][D]
    if (lane < kLanesPerKey) {
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
            for (int j = 0; j < 8; ++j) red[(warp * REP + r) * D + c0 + j] = acc[r][j];
    }
    __syncthreads();
    for (int e = tid; e < REP * D; e += kThreads) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[w * REP * D + e];
        part_o[e] = sum;
    }
    cluster_merge<D, DV, REP, kThreads>(cluster, m_s, l_s, part_o, out, lse, H, g, b);
}

// ---- rep 8, 16: the tensor cores ---------------------------------------------------------

// Byte offsets in dynamic shared memory (1024-aligned: the 128-byte swizzle
// repeats every 8 rows of 128 bytes). Warp w owns stage w: a K and a V tile
// of kTile rows x D bf16, each D / 64 column blocks of kTile rows x 128
// bytes. After its key loop warp w leaves its o (16 x D fp32, the size of a
// tile) over its own K tile and its m, l beside the barriers; once every
// warp is done, the CTA's merged o goes over warp 0's V tile. q's 16 rows
// (zeros past rep) sit apart, each padded by 16 bytes so that ldmatrix's 8
// rows fall in 8 different bank groups.
template <int D>
struct MmaLayout {
    static constexpr int kTileBytes = kTile * D * 2;
    static constexpr int kStage = 2 * kTileBytes;
    static constexpr int kK = 0;                                  // + warp * kStage
    static constexpr int kV = kTileBytes;                         // + warp * kStage
    static constexpr int kWarpO = 0;                              // float [16][D], + warp * kStage
    static constexpr int kPartO = kV;                             // float [REP][D]
    static constexpr int kBar = kMmaWarps * kStage;               // k_full[], v_full[]
    static constexpr int kWarpM = kBar + 16 * kMmaWarps;          // float [kMmaWarps][16]
    static constexpr int kWarpL = kWarpM + kMmaWarps * 16 * 4;    // float [kMmaWarps][16]
    static constexpr int kM = kWarpL + kMmaWarps * 16 * 4;        // float [16]
    static constexpr int kL = kM + 16 * 4;                        // float [16]
    static constexpr int kQRow = D * 2 + 16;                      // bytes a q row, padded
    static constexpr int kQ = kL + 16 * 4;                        // bf16 [16][D + 8]
    static constexpr int kBytes = kQ + 16 * kQRow + 1024;         // + alignment slack
    static_assert(16 * D * 4 == kTileBytes, "a warp's o fills its K tile");
    static_assert(kQ % 16 == 0, "16-byte rows of q");
};

// Byte offset of 16-byte chunk c (columns 8c .. 8c + 7) of row `row` in a
// tile the TMA unit wrote with the 128-byte swizzle: chunk c % 8 of a
// 128-byte row lands at chunk (c % 8) ^ (row % 8) of column block c / 8.
__device__ __forceinline__ uint32_t swizzled(int row, int c) {
    return (uint32_t)((c / 8) * kTile * 128 + row * 128 + (((c % 8) ^ (row % 8)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row-major) * b (16 x 8 bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product keeping rows 0-7 only (rep 8: rows 8-15 of a are zero
// heads): rows 8-15 start from zero and are dropped, so they hold no
// registers across products.
__device__ __forceinline__ void mma_bf16(float (&d)[2], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    float drop2, drop3;
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %12};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(drop2), "=f"(drop3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(d[0]), "f"(d[1]),
          "f"(0.f));
}

// rep 8's P V: rows 0-7 of a hold P's hi parts and rows 8-15 (the zero
// heads') its lo parts. Row r + 8's product sits in the same thread and
// columns as row r's, so d (rows 0-7) takes both from one product.
__device__ __forceinline__ void mma_bf16_fold(float (&d)[2], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
    float lo0, lo1;
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %12};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(lo0), "=f"(lo1)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(d[0]), "f"(d[1]),
          "f"(0.f));
    d[0] += lo0;
    d[1] += lo1;
}

// (a, b) as two packed bf16 pairs whose sum carries ~16 of fp32's 24 bits:
// hi = bf16(x) and lo = bf16(x - hi), each with a in the low half. P V
// takes both (P in bf16 alone put the partial form, each piece rounded
// again before the combine, past K3's limit at llama3-405b's decode).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Accumulator layout of m16n8k16 (lane = 4 gid + tq): element e of an n8
// block sits at row gid (e < 2) or gid + 8, column 2 tq + (e & 1). At rep 8
// only elements 0 and 1 are kept (kAcc = 2).
template <int D, int DV, int REP>
__global__ void __launch_bounds__(kMmaThreads, 3)
decode_mma_kernel(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, const bf16* __restrict__ q,
                  bf16* __restrict__ out, float* __restrict__ lse, int H, int G, int n_valid,
                  int n_tiles, float scale_log2) {
    using L = MmaLayout<D>;
    constexpr int kKSteps = DV / 16;    // k16 steps of Q K^T (dh 112: the zero pad skipped)
    constexpr int kNBlocks = DV / 8;    // n8 blocks of P V
    constexpr int kAcc = REP == 16 ? 4 : 2;  // accumulator elements kept an n8 block
    static_assert(REP == 8 || REP == 16, "the tensor-core form takes rep 8 and 16");
    static_assert(DV <= D && DV % 16 == 0 && D % 64 == 0, "whole k16 steps, whole boxes");
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* smem = smem_raw + (base - raw);

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank(), n_rank = (int)cluster.num_blocks();
    const int g = blockIdx.y, b = blockIdx.z;
    const int t_begin = rank * n_tiles / n_rank;
    const int my_tiles = (rank + 1) * n_tiles / n_rank - t_begin;  // >= 1: cluster <= n_tiles
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tq = lane & 3, mi = lane >> 3;  // mi: the ldmatrix matrix
    const uint32_t ks = base + L::kK + warp * L::kStage, vs = base + L::kV + warp * L::kStage;
    const uint32_t k_full = base + L::kBar + 8u * warp;
    const uint32_t v_full = base + L::kBar + 8u * (kMmaWarps + warp);

    if (threadIdx.x == 0) {
        for (int w = 0; w < 2 * kMmaWarps; ++w) mbar_init(base + L::kBar + 8u * w, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }

    // Lane 0 of a warp copies local tile i (kTile rows x D, D / 64 boxes of
    // 64 columns) of K or V into the warp's stage.
    auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int i) {
        mbar_expect_tx(bar, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
            tma_load_4d(dst + c * kTile * 128, map, bar, c * 64, g, (t_begin + i) * kTile, b);
    };

    // q of the group's heads into shared memory, 16 bytes a thread, zero
    // rows past rep; it is read back as the A fragments of Q K^T, unscaled.
    const bf16* qg = q + ((size_t)b * H + g * REP) * DV;
    for (int e = threadIdx.x; e < 16 * (DV / 8); e += kMmaThreads) {
        const int r = e / (DV / 8), c = e % (DV / 8);
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < REP) val = *reinterpret_cast<const uint4*>(qg + r * DV + 8 * c);
        *reinterpret_cast<uint4*>(smem + L::kQ + r * L::kQRow + 16 * c) = val;
    }
    __syncthreads();
    if (lane == 0 && warp < my_tiles) {
        load(ks, &k_map, k_full, warp);
        load(vs, &v_map, v_full, warp);
    }
    // matrix mi of a q fragment: rows 8 (mi % 2) .., columns 16 kk + 8 (mi / 2) ..
    const uint32_t q_lane = base + L::kQ + ((mi & 1) * 8 + (lane & 7)) * L::kQRow + (mi >> 1) * 16;

    float o[kNBlocks][kAcc];
#pragma unroll
    for (int n = 0; n < kNBlocks; ++n)
#pragma unroll
        for (int e = 0; e < kAcc; ++e) o[n][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows gid, gid + 8 (raw scores)
    float l_run[2] = {0.f, 0.f};

    for (int i = warp, n_seen = 0; i < my_tiles; i += kMmaWarps, ++n_seen) {
        const uint32_t parity = n_seen & 1;
        const int rows = min(kTile, n_valid - (t_begin + i) * kTile);

        // 1. S = Q K^T, 16 heads x kTile keys: ldmatrix x4 gives the B
        //    fragments of two n8 blocks (matrix mi: keys 8 (2p + mi / 2) ..,
        //    columns 16 kk + 8 (mi % 2) ..).
        float s[kTile / 8][kAcc];
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
            for (int e = 0; e < kAcc; ++e) s[j][e] = 0.f;
        mbar_wait(k_full, parity);
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
            uint32_t qa[4];
            ldsm_x4(q_lane + 32 * kk, qa);
#pragma unroll
            for (int p = 0; p < kTile / 16; ++p) {
                uint32_t kb[4];
                const int key = 8 * (2 * p + (mi >> 1)) + (lane & 7);
                ldsm_x4(ks + swizzled(key, 2 * kk + (mi & 1)), kb);
                mma_bf16(s[2 * p], qa, kb[0], kb[1]);
                mma_bf16(s[2 * p + 1], qa, kb[2], kb[3]);
            }
        }
        __syncwarp();
        if (lane == 0 && i + kMmaWarps < my_tiles) {  // the next tile's K into the freed K tile
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            load(ks, &k_map, k_full, i + kMmaWarps);
        }

        // 2. Keys past n_valid score -inf; the online softmax of each row
        //    (every tile holds a valid key, so the new max is finite).
        if (rows < kTile) {
#pragma unroll
            for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
                for (int e = 0; e < kAcc; ++e)
                    if (8 * j + 2 * tq + (e & 1) >= rows) s[j][e] = -INFINITY;
        }
        float alpha[2] = {1.f, 1.f};
#pragma unroll
        for (int h = 0; h < kAcc / 2; ++h) {
            float mx = m_run[h];
#pragma unroll
            for (int j = 0; j < kTile / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float base_h = mx * scale_log2;
            alpha[h] = fast_exp2(m_run[h] * scale_log2 - base_h);
            m_run[h] = mx;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
                for (int e = 2 * h; e < 2 * h + 2; ++e) {
                    s[j][e] = fast_exp2(fmaf(s[j][e], scale_log2, -base_h));
                    sum += s[j][e];
                }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            l_run[h] = l_run[h] * alpha[h] + sum;
        }

        // 3. O = alpha O + P V: P (16 x kTile) as hi + lo bf16 parts, the A
        //    fragments of the two k16 steps (rep 16: two fragments, two
        //    products; rep 8: one, the lo parts in rows 8-15);
        //    ldmatrix x4 .trans gives the B fragments of both k16 steps for
        //    one n8 block (matrix mi: keys 8 mi .., columns 8 n ..).
        uint32_t pa[kTile / 16][4], pl[kTile / 16][4];
#pragma unroll
        for (int t = 0; t < kTile / 16; ++t) {
            split_bf16(s[2 * t][0], s[2 * t][1], pa[t][0], pl[t][0]);
            split_bf16(s[2 * t + 1][0], s[2 * t + 1][1], pa[t][2], pl[t][2]);
            if constexpr (kAcc == 4) {
                split_bf16(s[2 * t][2], s[2 * t][3], pa[t][1], pl[t][1]);
                split_bf16(s[2 * t + 1][2], s[2 * t + 1][3], pa[t][3], pl[t][3]);
            } else {
                pa[t][1] = pl[t][0];
                pa[t][3] = pl[t][2];
            }
        }
#pragma unroll
        for (int n = 0; n < kNBlocks; ++n)
#pragma unroll
            for (int e = 0; e < kAcc; ++e) o[n][e] *= alpha[e / 2];
        mbar_wait(v_full, parity);
#pragma unroll
        for (int n = 0; n < kNBlocks; ++n) {
            uint32_t vb[4];
            ldsm_x4_trans(vs + swizzled(8 * mi + (lane & 7), n), vb);
#pragma unroll
            for (int t = 0; t < kTile / 16; ++t) {
                if constexpr (kAcc == 4) {
                    mma_bf16(o[n], pa[t], vb[2 * t], vb[2 * t + 1]);
                    mma_bf16(o[n], pl[t], vb[2 * t], vb[2 * t + 1]);
                } else {
                    mma_bf16_fold(o[n], pa[t], vb[2 * t], vb[2 * t + 1]);
                }
            }
        }
        __syncwarp();
        if (lane == 0 && i + kMmaWarps < my_tiles) {  // the next tile's V into the freed V tile
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            load(vs, &v_map, v_full, i + kMmaWarps);
        }
    }

    // The warp's (m, l, o) into shared memory: o over its own K tile (its
    // last copy has landed and no other warp reads it), m in the log2 domain
    // beside the barriers. A warp without a tile leaves m = -inf, l = 0, o = 0.
    float* wo = reinterpret_cast<float*>(smem + L::kWarpO + warp * L::kStage);
    float* wm = reinterpret_cast<float*>(smem + L::kWarpM);
    float* wl = reinterpret_cast<float*>(smem + L::kWarpL);
#pragma unroll
    for (int n = 0; n < kNBlocks; ++n) {
        const int c = 8 * n + 2 * tq;
#pragma unroll
        for (int h = 0; h < kAcc / 2; ++h)
            *reinterpret_cast<float2*>(wo + (gid + 8 * h) * D + c) =
                make_float2(o[n][2 * h], o[n][2 * h + 1]);
    }
    if (tq == 0)
#pragma unroll
        for (int h = 0; h < kAcc / 2; ++h) {
            wm[warp * 16 + gid + 8 * h] = m_run[h] * scale_log2;
            wl[warp * 16 + gid + 8 * h] = l_run[h];
        }
    __syncthreads();

    // The CTA's (m, l, o) of its rep heads, merged over the warps with the
    // weights 2^(m_w - max m) (warp 0 holds a tile, so max m is finite), o
    // into warp 0's V tile: every warp is past its key loop.
    float* part_o = reinterpret_cast<float*>(smem + L::kPartO);
    float* m_s = reinterpret_cast<float*>(smem + L::kM);
    float* l_s = reinterpret_cast<float*>(smem + L::kL);
    for (int e = threadIdx.x; e < REP * D; e += kMmaThreads) {
        const int r = e / D, d = e % D;
        if (d >= DV) continue;  // zero pad: never read
        float mx = -INFINITY;
#pragma unroll
        for (int w = 0; w < kMmaWarps; ++w) mx = fmaxf(mx, wm[w * 16 + r]);
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int w = 0; w < kMmaWarps; ++w) {
            const float wt = fast_exp2(wm[w * 16 + r] - mx);
            num += wt * reinterpret_cast<const float*>(smem + w * L::kStage)[r * D + d];
            den += wt * wl[w * 16 + r];
        }
        part_o[e] = num;
        if (d == 0) {
            m_s[r] = mx;
            l_s[r] = den;
        }
    }
    cluster_merge<D, DV, REP, kMmaThreads>(cluster, m_s, l_s, part_o, out, lse, H, g, b);
}

// ---- host side ------------------------------------------------------------------

// One (cluster, G, B) launch of `kernel`, a cluster of CTAs of `threads`
// per (b, g).
template <typename Kernel>
int launch_clusters(Kernel kernel, int threads, int bytes, const CUtensorMap& k_map,
                    const CUtensorMap& v_map, const bf16* q, bf16* o, float* lse, int B, int H,
                    int G, int n_valid, int n_tiles, int cluster, float scale_log2,
                    cudaStream_t st) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, G, B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, k_map, v_map, q, o, lse, H, G, n_valid, n_tiles,
                             scale_log2);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <int D, int DV, int REP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B, int T, int H,
           int G, int n_valid, int n_tiles, int cluster, float scale_log2, cudaStream_t st) {
    CUtensorMap k_map, v_map;
    if constexpr (REP <= 4) {
        if (!make_map(&k_map, k, B, T, G, DV, D, kTile, CU_TENSOR_MAP_SWIZZLE_NONE) ||
            !make_map(&v_map, v, B, T, G, DV, D, kTile, CU_TENSOR_MAP_SWIZZLE_NONE))
            return static_cast<int>(cudaErrorInvalidValue);
        return launch_clusters(decode_kernel<D, DV, REP>, kThreads, Layout<D, REP>::kBytes, k_map,
                               v_map, q, o, lse, B, H, G, n_valid, n_tiles, cluster, scale_log2,
                               st);
    } else {
        // 64-column boxes, 128-byte swizzle; positions past n_valid read as zeros
        const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
        if (!make_map(&k_map, k, B, T, G, DV, 64, kTile, sw, n_valid) ||
            !make_map(&v_map, v, B, T, G, DV, 64, kTile, sw, n_valid))
            return static_cast<int>(cudaErrorInvalidValue);
        return launch_clusters(decode_mma_kernel<D, DV, REP>, kMmaThreads, MmaLayout<D>::kBytes,
                               k_map, v_map, q, o, lse, B, H, G, n_valid, n_tiles, cluster,
                               scale_log2, st);
    }
}

template <int D, int DV>
int launch_rep(int rep, const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B,
               int T, int H, int G, int n_valid, int n_tiles, int cluster, float scale_log2,
               cudaStream_t st) {
#define DECODE_REP(R) \
    case R: return launch<D, DV, R>(q, k, v, o, lse, B, T, H, G, n_valid, n_tiles, cluster, scale_log2, st);
    switch (rep) {
        DECODE_REP(1)
        DECODE_REP(2)
        DECODE_REP(4)
        DECODE_REP(8)
        DECODE_REP(16)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DECODE_REP
}

}  // namespace

// q: (B, H, dh) bf16; k/v: (B, T, G, dh) bf16; o: (B, H, dh) bf16; lse: null,
// or (B, H) fp32 for the partial form; positions [0, n_valid) are attended,
// 1 <= n_valid <= T, cut into n_tiles = ceil(n_valid / kTile) tiles shared
// by `cluster` CTAs per (b, g), 1 <= cluster <= min(kMaxCluster, n_tiles).
// dh in {64, 112, 128}, H / G in {1, 2, 4, 8, 16} (the Python wrapper checks
// and plans).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int T, int H, int G, int dh, int n_valid,
                                    int n_tiles, int cluster, float scale, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(o);
    float* lp = static_cast<float*>(lse);
    if (cluster < 1 || cluster > kMaxCluster || cluster > n_tiles || n_valid < 1 || n_valid > T ||
        (long long)n_tiles * kTile < n_valid || (long long)(n_tiles - 1) * kTile >= n_valid)
        return static_cast<int>(cudaErrorInvalidValue);
    const float scale_log2 = scale * kLog2e;
    const int rep = H / G;
    if (dh == 128)
        return launch_rep<128, 128>(rep, qp, kp, vp, op, lp, B, T, H, G, n_valid, n_tiles, cluster,
                                    scale_log2, st);
    if (dh == 112)
        return launch_rep<128, 112>(rep, qp, kp, vp, op, lp, B, T, H, G, n_valid, n_tiles, cluster,
                                    scale_log2, st);
    if (dh == 64)
        return launch_rep<64, 64>(rep, qp, kp, vp, op, lp, B, T, H, G, n_valid, n_tiles, cluster,
                                  scale_log2, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
