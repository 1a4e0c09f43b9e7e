// GQA flash-decode for Hopper (sm_90a), bf16 in/out, one launch per call.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py
// (_dec_kernel / decode_attention_fwd). One query token per sequence,
// q (B, H, dh), attends a (B, T, G, dh) KV cache at positions [0, cur_index];
// each kv head g serves query heads g*rep .. g*rep + rep - 1 (rep = H / G), so
// the cache is read once at its native G heads, never repeated.
//
// Bound: memory. The valid part of the cache is read once and each byte
// feeds ~rep multiply-adds, far below the card's flop/byte balance; at the
// serving shape (B 8, G 8, dh 128, 1016 valid positions) that is 33.4 MB of
// K and V, 10 us at 3.35 TB/s. What matters is bytes in flight on every SM.
//
// Design: a thread-block cluster per (b, g) of `cluster` CTAs (at most
// kMaxCluster, never more than there are key tiles). The valid positions are
// cut into tiles of kTile keys; CTA `rank` owns tiles
// [rank * n_tiles / cluster, (rank + 1) * n_tiles / cluster), at least one.
// - Copies: thread 0 loads each tile of K and of V with one TMA box (kTile
//   rows x dh of one kv head; 4-D tensor maps over the cache, csrc/hopper.cuh)
//   into a kStages ring, K and V on separate mbarriers, so V's copy is in
//   flight while the scores of the same tile are computed; a stage is
//   refilled once the block has finished with it.
// - Math: 16-byte shared loads per thread (dh/8 lanes per key, shuffle
//   reduced) for the scores of the rep heads; an online softmax across the
//   CTA's tiles (m, l per head in shared memory, the accumulator rescaled);
//   P V with each thread owning 8 dims of every head for a share of the keys.
// - Merge: each CTA leaves (m, l, o) for its rep heads in shared memory; after
//   a cluster barrier the CTAs read one another's through distributed shared
//   memory (map_shared_rank) and each writes a share of the output with the
//   weights 2^(m_rank - max m). No fp32 partials go through device memory
//   and there is no second kernel.
// cur_index arrives as a host int, so no CTA is launched past it and the
// ragged tail of the last tile is masked: T need not divide any tile.
// At the serving shape: 64 clusters of 8 CTAs, each CTA 4 tiles of 32 keys,
// 32 KB of ring at dh 128; 4-5 CTAs per SM, so all 512 are resident at once.
// ptxas (CUDA 12.9, sm_90a): 95 registers at rep 4 (40 / 64 / 167 at rep 1 /
// 2 / 8, dh 128), no spills.

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
constexpr int kStages = 2;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

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
    // the end-of-block reduction over warps reuses the ring
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

template <int D, int REP>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
              const bf16* __restrict__ q, bf16* __restrict__ out, int H, int G, int n_valid,
              int n_tiles, float scale_log2) {
    using L = Layout<D, REP>;
    constexpr int kLanesPerKey = D / 8;                    // 16-byte chunks per key row
    constexpr int kKeysPerPass = kThreads / kLanesPerKey;  // keys a block touches at once
    static_assert(kTile % kKeysPerPass == 0 && kLanesPerKey <= 32, "even trip counts");
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
    const int chunk = tid % kLanesPerKey, slot = tid / kLanesPerKey;
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

    // This thread's 8 dims of the REP query heads, scaled into the log2 domain.
    float qr[REP][8];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
        const uint4 raw = *reinterpret_cast<const uint4*>(q + ((size_t)b * H + g * REP + r) * D + c0);
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
    // warp (shuffles), then across warps through the (now idle) ring.
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

    // Merge the cluster's (m, l, o): out = sum_c w_c o_c / sum_c w_c l_c,
    // w_c = 2^(m_c - max m). Each CTA writes every n_rank-th share.
    cluster.sync();
    for (int e = rank * kThreads + tid; e < REP * D; e += n_rank * kThreads) {
        const int r = e / D;
        float mx = -INFINITY;
        for (int c = 0; c < n_rank; ++c) mx = fmaxf(mx, *cluster.map_shared_rank(m_s + r, c));
        float num = 0.f, den = 0.f;
        for (int c = 0; c < n_rank; ++c) {
            const float w = fast_exp2(*cluster.map_shared_rank(m_s + r, c) - mx);
            den += w * *cluster.map_shared_rank(l_s + r, c);
            num += w * *cluster.map_shared_rank(part_o + e, c);
        }
        out[((size_t)b * H + g * REP) * D + e] = __float2bfloat16(num / den);
    }
    cluster.sync();  // no CTA leaves while another still reads its shared memory
}

template <int D, int REP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int T, int H, int G,
           int n_valid, int n_tiles, int cluster, float scale_log2, cudaStream_t st) {
    CUtensorMap k_map, v_map;
    if (!make_map(&k_map, k, B, T, G, D, D, kTile, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !make_map(&v_map, v, B, T, G, D, D, kTile, CU_TENSOR_MAP_SWIZZLE_NONE))
        return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = Layout<D, REP>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(decode_kernel<D, REP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, G, B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, decode_kernel<D, REP>, k_map, v_map, q, o, H, G, n_valid,
                             n_tiles, scale_log2);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_rep(int rep, const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int T, int H,
               int G, int n_valid, int n_tiles, int cluster, float scale_log2, cudaStream_t st) {
    switch (rep) {
        case 1: return launch<D, 1>(q, k, v, o, B, T, H, G, n_valid, n_tiles, cluster, scale_log2, st);
        case 2: return launch<D, 2>(q, k, v, o, B, T, H, G, n_valid, n_tiles, cluster, scale_log2, st);
        case 4: return launch<D, 4>(q, k, v, o, B, T, H, G, n_valid, n_tiles, cluster, scale_log2, st);
        case 8: return launch<D, 8>(q, k, v, o, B, T, H, G, n_valid, n_tiles, cluster, scale_log2, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// q: (B, H, dh) bf16; k/v: (B, T, G, dh) bf16; o: (B, H, dh) bf16; positions
// [0, n_valid) are attended, cut into n_tiles = ceil(n_valid / kTile) tiles
// shared by `cluster` CTAs per (b, g), 1 <= cluster <= min(kMaxCluster,
// n_tiles). dh in {64, 128}, H / G in {1, 2, 4, 8} (the Python wrapper
// checks and plans).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                    int T, int H, int G, int dh, int n_valid, int n_tiles,
                                    int cluster, float scale, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(o);
    if (cluster < 1 || cluster > kMaxCluster || cluster > n_tiles ||
        (long long)n_tiles * kTile < n_valid || (long long)(n_tiles - 1) * kTile >= n_valid)
        return static_cast<int>(cudaErrorInvalidValue);
    const float scale_log2 = scale * kLog2e;
    const int rep = H / G;
    if (dh == 128)
        return launch_rep<128>(rep, qp, kp, vp, op, B, T, H, G, n_valid, n_tiles, cluster, scale_log2, st);
    if (dh == 64)
        return launch_rep<64>(rep, qp, kp, vp, op, B, T, H, G, n_valid, n_tiles, cluster, scale_log2, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
