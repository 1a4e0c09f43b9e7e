// Causal / full GQA flash-attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_fa_kernel / flash_attention_fwd). Computes, for q (B, S, H, dh) and
// k/v (B, T, G, dh), out[b, i, h] = softmax_j(q.k_j / sqrt(dh)) v_j over keys
// j (j <= i when causal) of kv head h / (H / G), with an fp32 online softmax
// in the log2 domain (running max m, running sum l, accumulator acc). KV
// heads are never repeated in memory: each block reads its kv head's rows.
//
// Bound: operations. 4*dh*S*(S+1)/2*B*H flops at the prefill shape
// (8 x 1000 x 32 heads, dh 128) are 65.6 GFLOP, 66 us at 989 TFLOP/s, above
// the 49 us that its 164 MB of q/k/v/o take at 3.35 TB/s. Only wgmma reaches
// the dense bf16 tensor-core rate, and it needs its operands in shared memory
// as fast as it consumes them.
//
// Design (FlashAttention-3 style):
// - Persistent, warp-specialised blocks of three warpgroups, one block per
//   SM. The blocks walk the work items (q tile of 128 rows, head, batch),
//   heaviest causal q tiles first, so the long items do not form the tail.
//   Warpgroup 0 is the producer: it gives up its registers (setmaxnreg 24)
//   and one thread starts the TMA loads. Warpgroups 1 and 2 are consumers, each
//   owning 64 query rows, with 240 registers a thread.
// - TMA: Q once per item (reloaded as soon as the consumers' last Q K^T of
//   the item is done); K and V tiles of 128 keys each into their own
//   2-stage ring with a full mbarrier (the copy's byte count) and an empty
//   one (all 256 consumer threads arrive), so K_{j+1} streams in while V_j is
//   still in use. Tensor maps are 4-D over the contiguous (B, len, heads, dh)
//   layout, dims {dh, heads, len, B}, box {64, 1, 128, 1} with 128-byte
//   swizzle (csrc/hopper.cuh), so a dh-128 row is two boxes and a tile is
//   dh/64 regions of 128 rows x 128 bytes. Rows past S or T are zero-filled
//   by the TMA unit; keys past T are masked to -inf.
// - S = Q K^T: wgmma m64n128k16, both operands K-major in swizzled shared
//   memory. O += P V: P is the fp32 S accumulator, rescaled and packed to
//   bf16 in registers as the A operand; V is an MN-major B operand (the
//   transpose bit bf16 allows), so V is never read element by element.
// - Overlap: each consumer starts S_j and P_{j-1} V_{j-1} together and runs
//   the softmax of S_j while the tensor cores do P V; the two consumers take
//   turns at starting them (named barriers), so one's softmax overlaps the other's
//   products. The softmax keeps the raw row max and takes one FFMA and one
//   ex2.approx per element; row max and sum are quad shuffles over the
//   accumulator layout.
// - Causal: key tiles past the diagonal are never loaded and only tiles that
//   cut it are masked.
// Shared memory: Q 128 x dh + 2 stages x (K + V) 128 x dh, bf16, plus 10
// mbarriers: 164,944 bytes at dh 128, 83,024 at dh 64 (dynamic).
// ptxas (CUDA 12.9, sm_90a): 168 registers a thread at launch for both dh
// (the consumers raise theirs to 240), no spills, 16 named barriers. The
// mma.sync kernel this replaces took 168 registers and 34,816 bytes of
// static shared memory at dh 128, 126 and 18,432 at dh 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockQ = 128;  // two consumer warpgroups x 64 rows
constexpr int kBlockK = 128;
constexpr int kStages = 2;
constexpr int kThreads = 384;  // warpgroup 0 loads, 1 and 2 compute
constexpr int kConsumers = 256;
constexpr int kBoxBytes = 128;  // one TMA box row: 64 bf16, the swizzle width
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Byte offsets in dynamic shared memory; tiles are 1024-byte aligned, as
// the 128-byte swizzle pattern repeats every 8 rows of 128 bytes.
template <int D>
struct Layout {
    static constexpr int kQBytes = kBlockQ * D * 2;
    static constexpr int kTileBytes = kBlockK * D * 2;  // one K or one V tile
    static constexpr int kQ = 0;
    static constexpr int kK = kQBytes;                       // + stage * kTileBytes
    static constexpr int kV = kK + kStages * kTileBytes;     // + stage * kTileBytes
    static constexpr int kBar = kV + kStages * kTileBytes;   // 2 + 4 * kStages mbarriers
    static constexpr int kBytes = kBar + 8 * (2 + 4 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands: lbo
// unused (16), sbo = 1024 (8 rows of 128 bytes). MN-major: lbo = stride
// between 64-element column blocks, sbo = 1024 (8 rows along K).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns those registers, and from reusing an A
// fragment's registers before the wgmma reading them has completed.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, fp32) (+)= A (64 x 16, smem, K-major) * B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : D8(0), D8(8), D8(16), D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D8

// ---- the kernel ---------------------------------------------------------------

// Work item -> (q tile start, head, batch), heaviest q tiles first.
struct Item {
    int q0, h, b, n_tiles;
};

__device__ __forceinline__ Item item_of(int item, int n_qt, int S, int T, int H, int B,
                                        int causal) {
    Item it;
    const int per_tile = H * B;
    it.q0 = (n_qt - 1 - item / per_tile) * kBlockQ;
    it.h = item % H;
    it.b = (item % per_tile) / H;
    it.n_tiles = (T + kBlockK - 1) / kBlockK;
    if (causal) it.n_tiles = min(it.n_tiles, (min(it.q0 + kBlockQ, S) - 1) / kBlockK + 1);
    return it;
}

// Online-softmax step on one 64 x 128 score tile in the accumulator layout
// (element 4j + e at row e < 2 ? row_a : row_b, key k0 + 8j + 2tq + (e & 1)):
// mask keys past T or past the diagonal, update the running max (of the raw
// scores) and the running sum, leave P = 2^(scale_log2 (s - m)) in sc (one
// FFMA and one ex2 per element) and return the factor the output
// accumulator must be rescaled by.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBlockK / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int k0,
                                             int row_a, int row_b, int wg_row0, int T,
                                             float scale_log2, int causal, int tq) {
    if ((k0 + kBlockK > T) || (causal && k0 + kBlockK - 1 > wg_row0)) {
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = k0 + 8 * j + 2 * tq + (e & 1);
                const int row = e < 2 ? row_a : row_b;
                if (col >= T || (causal && col > row)) sc[4 * j + e] = -INFINITY;
            }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    // A row's 128 scores sit in the 4 threads of one quad.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float base[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        base[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale_log2;  // fully masked so far
        alpha[i] = fast_exp2(m_run[i] * scale_log2 - base[i]);
        m_run[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
        sc[4 * j] = fast_exp2(fmaf(sc[4 * j], scale_log2, -base[0]));
        sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -base[0]));
        sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -base[1]));
        sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -base[1]));
        rsum[0] += sc[4 * j] + sc[4 * j + 1];
        rsum[1] += sc[4 * j + 2] + sc[4 * j + 3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
        l_run[i] = l_run[i] * alpha[i] + rsum[i];
    }
}

// The two consumer warpgroups take turns at starting their products (named
// barriers 1 and 2), so one's softmax runs while the other's products keep
// the tensor cores busy.
__device__ __forceinline__ void turn_wait(int cw) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + cw), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - cw), "n"(kConsumers) : "memory");
}

// P (the S accumulator of keys 16kk .. 16kk + 15, packed to bf16) is the A
// fragment of one k16 step of O += P V.
__device__ __forceinline__ void pack_p(const float (&sc)[kBlockK / 2], uint32_t (&pa)[kBlockK / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
}

template <int D>
__device__ __forceinline__ void start_qk(float (&sc)[kBlockK / 2], uint32_t q_tile, uint32_t ks) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // a k16 step is 32 bytes of a 128-byte row
        const uint64_t da = sw128_desc(q_tile + (kk / 4) * kBlockQ * kBoxBytes + col, 16, 1024);
        const uint64_t db = sw128_desc(ks + (kk / 4) * kBlockK * kBoxBytes + col, 16, 1024);
        wgmma_ss_n128(sc, da, db, kk > 0);
    }
    wg_commit();
}

template <int D>
__device__ __forceinline__ void start_pv(float (&acc)[D / 2], const uint32_t (&pa)[kBlockK / 16][4],
                                         uint32_t vs) {
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)  // 16 keys = 16 rows of 128 bytes
        wgmma_rs(acc, pa[kk], sw128_desc(vs + kk * 16 * kBoxBytes, kBlockK * kBoxBytes, 1024));
    wg_commit();
}

// Persistent: gridDim.x blocks walk the n_items = n_qt * H * B work items
// (item, item + gridDim.x, ...). The K and V rings, and their phases, run on
// across items; the producer loads the next item's Q as soon as the
// consumers' last Q K^T of the current item is done.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, int B, int S,
              int T, int H, int G, float scale_log2, int causal) {
    using L = Layout<D>;
    constexpr int kChunks = D / 64;  // TMA boxes (128-byte column blocks) per row
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
    const uint32_t sq = base + L::kQ, sk = base + L::kK, sv = base + L::kV;
    // barriers: q_full, q_empty, then per stage k_full, v_full, k_empty, v_empty
    const uint32_t q_full = base + L::kBar, q_empty = q_full + 8u;
    auto k_full = [&](int s) { return q_full + 8u * (2 + 4 * s); };
    auto v_full = [&](int s) { return q_full + 8u * (3 + 4 * s); };
    auto k_empty = [&](int s) { return q_full + 8u * (4 + 4 * s); };
    auto v_empty = [&](int s) { return q_full + 8u * (5 + 4 * s); };

    const int n_qt = (S + kBlockQ - 1) / kBlockQ;
    const int n_items = n_qt * H * B;
    const int rep = H / G;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        mbar_init(q_empty, kConsumers);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(k_full(s), 1);
            mbar_init(v_full(s), 1);
            mbar_init(k_empty(s), kConsumers);
            mbar_init(v_empty(s), kConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {
        // ---- producer warpgroup: one thread keeps the rings full ------------------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (threadIdx.x == 0) {
            int ring = 0;  // tiles loaded so far
            for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
                const Item it = item_of(item, n_qt, S, T, H, B, causal);
                const int g = it.h / rep;
                mbar_wait(q_empty, (n & 1) ^ 1);  // the first wait passes
                mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
                for (int c = 0; c < kChunks; ++c)
                    tma_load_4d(sq + c * kBlockQ * kBoxBytes, &q_map, q_full, c * 64, it.h, it.q0,
                                it.b);
                for (int kt = 0; kt < it.n_tiles; ++kt, ++ring) {
                    const int s = ring % kStages;
                    const uint32_t parity = ((ring / kStages) & 1) ^ 1;
                    mbar_wait(k_empty(s), parity);
                    mbar_expect_tx(k_full(s), L::kTileBytes);
#pragma unroll
                    for (int c = 0; c < kChunks; ++c)
                        tma_load_4d(sk + s * L::kTileBytes + c * kBlockK * kBoxBytes, &k_map,
                                    k_full(s), c * 64, g, kt * kBlockK, it.b);
                    mbar_wait(v_empty(s), parity);
                    mbar_expect_tx(v_full(s), L::kTileBytes);
#pragma unroll
                    for (int c = 0; c < kChunks; ++c)
                        tma_load_4d(sv + s * L::kTileBytes + c * kBlockK * kBoxBytes, &v_map,
                                    v_full(s), c * 64, g, kt * kBlockK, it.b);
                }
            }
        }
    } else {
        // ---- consumer warpgroups: 64 query rows each ------------------------------
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int cw = threadIdx.x / 128 - 1;  // 0 or 1
        const int tid = threadIdx.x % 128;
        const int warp = tid / 32, lane = tid % 32;
        const int gid = lane >> 2, tq = lane & 3;  // accumulator row / column pair
        const uint32_t q_tile = sq + cw * 64 * kBoxBytes;  // this warpgroup's 64 rows
        int ring = 0;
        if (cw == 1) turn_pass(cw);  // warpgroup 0 goes first

        for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
            const Item it = item_of(item, n_qt, S, T, H, B, causal);
            const int wg_row0 = it.q0 + 64 * cw;
            const int row_a = wg_row0 + 16 * warp + gid, row_b = row_a + 8;

            float acc[D / 2];
#pragma unroll
            for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
            float m_run[2] = {-INFINITY, -INFINITY};  // rows row_a, row_b (raw scores)
            float l_run[2] = {0.f, 0.f};
            float alpha[2];
            float sc[kBlockK / 2];
            uint32_t pa[kBlockK / 16][4];

            // Tile 0: S = Q K^T, then P.
            mbar_wait(q_full, n & 1);
            {
                const int s = ring % kStages;
                mbar_wait(k_full(s), (ring / kStages) & 1);
                turn_wait(cw);
                wg_fence();
                start_qk<D>(sc, q_tile, sk + s * L::kTileBytes);
                turn_pass(cw);
                wg_wait_all();
                reg_fence(sc);
                mbar_arrive(k_empty(s));
                if (it.n_tiles == 1) mbar_arrive(q_empty);
                softmax_tile(sc, m_run, l_run, alpha, 0, row_a, row_b, wg_row0, T, scale_log2,
                             causal, tq);
                pack_p(sc, pa);
            }
            // Tile kt: S_kt = Q K_kt^T and O += P_{kt-1} V_{kt-1} in flight together;
            // the softmax of S_kt runs while the tensor cores do P V.
            for (int kt = 1; kt < it.n_tiles; ++kt) {
                const int s = (ring + kt) % kStages, sp = (ring + kt - 1) % kStages;
                mbar_wait(k_full(s), ((ring + kt) / kStages) & 1);
                mbar_wait(v_full(sp), ((ring + kt - 1) / kStages) & 1);
                turn_wait(cw);
                wg_fence();
                start_qk<D>(sc, q_tile, sk + s * L::kTileBytes);
                start_pv<D>(acc, pa, sv + sp * L::kTileBytes);
                turn_pass(cw);
                asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S_kt done
                reg_fence(sc);
                mbar_arrive(k_empty(s));
                if (kt == it.n_tiles - 1) mbar_arrive(q_empty);
                softmax_tile(sc, m_run, l_run, alpha, kt * kBlockK, row_a, row_b, wg_row0, T,
                             scale_log2, causal, tq);
                wg_wait_all();  // P_{kt-1} V_{kt-1} done
                reg_fence(acc);
                reg_fence(pa);
                mbar_arrive(v_empty(sp));
#pragma unroll
                for (int j = 0; j < D / 8; ++j) {
                    acc[4 * j] *= alpha[0];
                    acc[4 * j + 1] *= alpha[0];
                    acc[4 * j + 2] *= alpha[1];
                    acc[4 * j + 3] *= alpha[1];
                }
                pack_p(sc, pa);
            }
            {
                const int sp = (ring + it.n_tiles - 1) % kStages;
                mbar_wait(v_full(sp), ((ring + it.n_tiles - 1) / kStages) & 1);
                turn_wait(cw);
                wg_fence();
                start_pv<D>(acc, pa, sv + sp * L::kTileBytes);
                turn_pass(cw);
                wg_wait_all();
                reg_fence(acc);
                reg_fence(pa);
                mbar_arrive(v_empty(sp));
            }
            ring += it.n_tiles;

            const float inv_a = 1.f / fmaxf(l_run[0], 1e-30f);
            const float inv_b = 1.f / fmaxf(l_run[1], 1e-30f);
            bf16* ob = o + ((size_t)it.b * S * H + it.h) * D;
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                const int c = 8 * j + 2 * tq;
                if (row_a < S)
                    *reinterpret_cast<uint32_t*>(ob + (size_t)row_a * H * D + c) =
                        pack_bf16(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
                if (row_b < S)
                    *reinterpret_cast<uint32_t*>(ob + (size_t)row_b * H * D + c) =
                        pack_bf16(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
            }
        }
        if (cw == 0) turn_wait(cw);  // the pass warpgroup 1 made after its last products
    }
}

// ---- host side ------------------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, bf16* o, int B, int S, int T, int H,
           int G, float scale_log2, int causal, cudaStream_t st) {
    CUtensorMap q_map, k_map, v_map;
    const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
    if (!make_map(&q_map, q, B, S, H, D, 64, kBlockQ, sw) ||
        !make_map(&k_map, k, B, T, G, D, 64, kBlockK, sw) ||
        !make_map(&v_map, v, B, T, G, D, 64, kBlockK, sw))
        return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = Layout<D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(fa_fwd_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, n_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
        return static_cast<int>(err);
    const long long n_items = (long long)((S + kBlockQ - 1) / kBlockQ) * H * B;
    const int grid = (int)(n_items < n_sm ? n_items : n_sm);  // one persistent block per SM
    fa_fwd_kernel<D><<<grid, kThreads, bytes, st>>>(q_map, k_map, v_map, o, B, S, T, H, G,
                                                    scale_log2, causal);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, S, H, dh), k/v: (B, T, G, dh), o: (B, S, H, dh); all bf16, contiguous,
// 16-byte aligned; dh in {64, 128}; H % G == 0 (the Python wrapper checks).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int T, int H, int G, int dh, float scale,
                                   int causal, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float scale_log2 = scale * kLog2e;
    bf16* op = static_cast<bf16*>(o);
    if (dh == 128) return launch<128>(q, k, v, op, B, S, T, H, G, scale_log2, causal, st);
    if (dh == 64) return launch<64>(q, k, v, op, B, S, T, H, G, scale_log2, causal, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
