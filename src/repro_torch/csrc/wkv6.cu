// WKV6 for Hopper (sm_90a), chunked on the tensor cores: bf16 or fp32 in/out,
// fp32 state.
//
// Replaces the Pallas TPU kernel repro/kernels/wkv6/kernel.py (_wkv_kernel /
// wkv6_fwd). Per (b, h), from a zero state, over r, k, v, w (B, S, H, dh) and
// u (H, dh):
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// returning y (B, S, H, dh) in the input type and the final state
// (B, H, dh, dh) fp32 with state[b, h, i, j] accumulating k_i v_j. w is
// clamped below at 1e-12, as the chunked form's log(max(w, 1e-12)).
//
// Bound: at the serving shape (8, 1000, 40, 64) bf16 the bytes (r, k, v, w
// in, y out, 5.2 MB of state) are 210 MB, 0.0627 ms at 3.35 TB/s. The
// chunked form's products are ~10.7 GFLOP, 0.022 ms at the 495 TFLOP/s TF32
// peak, so bytes bound it. (The per-step recurrence's 5.2 GFLOP of fp32 FMAs
// outside the tensor cores would take 0.078 ms.)
//
// Algorithm: the chunked form of the Pallas kernel and the plain version
// (kernels/wkv6/ref.py), in base 2. One block of 4 warps per (b, h) walks
// chunks of C = 64 tokens in order; a chunk's decay is the partial sums
// P[t] = sum_{t' < t} log2(max(w_t', 1e-12)) per channel (P[t] exclusive,
// P[t + 1] inclusive). Sums of non-positive terms fall monotonically in
// fp32 too, so every exponent below is <= 0 and nothing overflows; a factor
// that underflows to 0 stands for a true product that is smaller still.
// Warp a owns sub-chunk a (16 tokens) of y:
//   y  = (r 2^P[t]) @ S                                  inter-chunk
//      + A @ v,  A = [scores of key sub-chunks b < a | diagonal block]
//   scores = (r 2^(P[t] - P[16a])) @ (k 2^(P[16a] - P[s + 1]))^T
//        (factored about a's first token: both exponents <= 0)
//   diagonal block, elementwise fp32: sum_i r k 2^(P[t] - P[s + 1]) for
//        s < t, sum_i r u k for s = t
// and warp m owns state rows 16m..16m+15:
//   S <- 2^P[C] S + (k 2^(P[C] - P[s + 1]))^T @ v.
// The four products run on mma.sync.m16n8k8 TF32 with fp32 accumulators,
// operands rounded by cvt.rna.tf32.f32. The inter-chunk, A @ v and state
// products use the 3xTF32 split (hi x hi + hi x lo + lo x hi; v from bf16 is
// exact in TF32, so its lo term is left out): the state's rows span a wide
// range, and one TF32 rounding put the worst y element past its limit in the
// CPU emulation (tests/test_torch_wkv6_chunked.py, which runs this algorithm
// in torch); with one rounding of A (its diagonal block dominates y) the
// 2-layer rwkv6-3b logits on the card moved past chip_smoke.py's allclose
// limit against the plain path. The scores keep one rounding. A ragged last chunk is zero-filled (r, k, v) with log2 w = 0,
// so no token past S reaches y or the state.
//
// Tile plan (per chunk): cp.async stages r, k, v, w rows (16-byte pieces,
// zero-filled past S) into shared memory; all threads take log2 w (lg2 on
// the SFU), then 128 / dh adjacent lanes scan each channel and add their
// totals in order; each warp then computes its 16 rows of y (accumulators in
// registers, the scores turned from accumulator into operand layout by warp
// shuffles, the diagonal block two channels a load, 2^x by ex2 on the SFU)
// and, if it owns state rows, updates them in registers; the state is
// written to shared memory at the next chunk's start for the inter-chunk
// product. Four barriers per chunk. At bf16, dh 64, shared memory is
// 73,232 B a block, so 3 blocks (12 warps) fit an SM and the serving shape's
// 320 blocks run in one wave on 132 SMs; __launch_bounds__(128, 3) caps
// registers at 168. ptxas (sm_90a, nvcc 12.9; dynamic shared memory is
// sizeof(Smem)):
//   bf16, dh 64: 168 registers, 8 B spilled, 73,232 B shared
//   bf16, dh 16: 121 registers, 0 spilled, 19,088 B shared
//   fp32, dh 64: 168 registers, 0 spilled, 106,000 B shared (2 blocks an SM)
//   fp32, dh 16: 159 registers, 0 spilled, 27,280 B shared

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kC = 64;                 // tokens per chunk
constexpr int kSub = 16;               // tokens per sub-chunk (one warp's rows of y)
constexpr int kWarps = kC / kSub;
constexpr int kThreads = kWarps * 32;
constexpr float kMinDecay = 1e-12f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float2 to_f2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 to_f2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}

// 2^x and log2 x on the SFU (x <= 0 here, so 2^x only underflows: to 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ float lg2(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

// An input element as a TF32 operand: a bf16 value is one already.
__device__ __forceinline__ uint32_t operand(bf16 x) { return __float_as_uint(to_f(x)); }
__device__ __forceinline__ uint32_t operand(float x) { return tf32(x); }

// d += a (16x8, row) b (8x8, col). Lane (g, c) = (lane / 4, lane % 4) holds
// a = A[g][c], A[g+8][c], A[g][c+4], A[g+8][c+4]; b = B[c][g], B[c+4][g];
// d = D[g][2c], D[g][2c+1], D[g+8][2c], D[g+8][2c+1].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with a = ah + al and b = v0, v1 as 3xTF32 (al b + ah b_lo + ah
// b_hi): a bf16 v is exact in TF32, so its lo product is left out.
template <typename T>
__device__ __forceinline__ void mma3_v(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], T v0, T v1) {
    const uint32_t b0 = operand(v0), b1 = operand(v1);
    mma(d, al, b0, b1);
    if constexpr (std::is_same<T, float>::value)
        mma(d, ah, tf32(v0 - __uint_as_float(b0)), tf32(v1 - __uint_as_float(b1)));
    mma(d, ah, b0, b1);
}

// Lane (g, c)'s operand fragment of a 16x8 tile held in accumulator layout
// (the lanes of a quad swap halves by shuffles).
__device__ __forceinline__ void to_operand(const float (&d)[4], int lane, float (&a)[4]) {
    const int c = lane & 3, src = (lane & ~3) | (c >> 1);
    const bool odd = c & 1;
#pragma unroll
    for (int x = 0; x < 4; ++x) {  // rows g, g+8 of column c, then of column c+4
        const int from = src + (x >> 1) * 2, hi = (x & 1) * 2;
        const float e0 = __shfl_sync(0xffffffffu, d[hi], from);
        const float e1 = __shfl_sync(0xffffffffu, d[hi + 1], from);
        a[x] = odd ? e1 : e0;
    }
}

// 16 bytes global -> shared; `bytes` 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                 "r"(bytes));
}

// Rows t0 .. t0 + kC - 1 of one head of a (B, S, H, D) input (`src` at its
// token 0) into `dst` by 16-byte cp.async pieces; rows past S are zero-filled.
template <typename T, int D, int kIn>
__device__ __forceinline__ void stage(T (*dst)[kIn], const T* src, int t0, int S,
                                      size_t step) {
    constexpr int kPieces = D * sizeof(T) / 16;  // 16-byte pieces of a token row
    const int n = min(kC, S - t0);
    for (int e = threadIdx.x; e < kC * kPieces; e += kThreads) {
        const int t = e / kPieces, e16 = (e % kPieces) * (16 / sizeof(T));
        cp_async16(&dst[t][e16], src + (size_t)(t0 + min(t, n - 1)) * step + e16,
                   t < n ? 16 : 0);
    }
}

template <typename T, int D>
struct __align__(16) Smem {
    static constexpr int kIn = D + 16 / sizeof(T);  // token row of r, k, v, w: 16 B pad
    static constexpr int kP = D + 4;                // row of P (floats)
    static constexpr int kS = D + 8;                // row of the state (floats)
    T r[kC][kIn], k[kC][kIn], v[kC][kIn], w[kC][kIn];
    float P[kC + 1][kP];
    float S[D][kS];
    float u[D];
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 3)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ w, const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ state, int S, int H) {
    constexpr int kN = D / 8;          // 8-wide tiles of dh: n-tiles and k-steps
    constexpr int kMTiles = D / 16;    // 16-row tiles of the state
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<T, D>& sm = *reinterpret_cast<Smem<T, D>*>(smem_raw);

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, c = lane & 3;
    const int ta = warp * kSub;  // this warp's sub-chunk: chunk rows ta..ta+15
    const size_t step = (size_t)H * D;  // elements between consecutive tokens
    const size_t base = ((size_t)b * S * H + h) * D;

    for (int i = threadIdx.x; i < D; i += kThreads) sm.u[i] = u[h * D + i];
    float st[kN][4] = {};  // state rows 16 warp + g, + 8 (warp < kMTiles)

    for (int t0 = 0; t0 < S; t0 += kC) {
        const int n = min(kC, S - t0);
        stage<T, D>(sm.r, r + base, t0, S, step);
        stage<T, D>(sm.k, k + base, t0, S, step);
        stage<T, D>(sm.v, v + base, t0, S, step);
        stage<T, D>(sm.w, w + base, t0, S, step);
        if (warp < kMTiles) {  // the state so far, the inter-chunk product's operand
#pragma unroll
            for (int nn = 0; nn < kN; ++nn) {
                store2(&sm.S[16 * warp + g][8 * nn + 2 * c], st[nn][0], st[nn][1]);
                store2(&sm.S[16 * warp + g + 8][8 * nn + 2 * c], st[nn][2], st[nn][3]);
            }
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncthreads();

        // P: log2 of the clamped decays (tokens past S decay by 1), then one
        // scan per channel by kSeg adjacent lanes of kLen tokens each, whose
        // totals add in order, so P falls monotonically along the chunk
        for (int e = threadIdx.x; e < kC * D; e += kThreads) {
            const int t = e / D, i = e % D;
            sm.P[t + 1][i] = t < n ? lg2(fmaxf(to_f(sm.w[t][i]), kMinDecay)) : 0.f;
        }
        __syncthreads();
        {
            constexpr int kSeg = kThreads / D, kLen = kC / kSeg;
            const int i = threadIdx.x / kSeg, seg = threadIdx.x % kSeg, t1 = seg * kLen + 1;
            float part[kLen], run = 0.f;
#pragma unroll
            for (int m = 0; m < kLen; ++m) part[m] = run += sm.P[t1 + m][i];
            float off = 0.f;
#pragma unroll
            for (int j = 0; j + 1 < kSeg; ++j) {
                const float total = __shfl_sync(0xffffffffu, run, (lane & ~(kSeg - 1)) | j);
                if (j < seg) off += total;
            }
#pragma unroll
            for (int m = 0; m < kLen; ++m) sm.P[t1 + m][i] = off + part[m];
            if (seg == 0) sm.P[0][i] = 0.f;
        }
        __syncthreads();

        // ---- y of sub-chunk `warp` ------------------------------------------------
        float acc[kN][4] = {};
        const int t_0 = ta + g, t_1 = ta + g + 8;
        if (t0 > 0) {  // inter-chunk, 3xTF32: (r 2^P[t]) @ S
#pragma unroll
            for (int kk = 0; kk < kN; ++kk) {
                const int i0 = 8 * kk + c, i1 = i0 + 4;
                uint32_t ah[4], al[4];
                split(to_f(sm.r[t_0][i0]) * ex2(sm.P[t_0][i0]), ah[0], al[0]);
                split(to_f(sm.r[t_1][i0]) * ex2(sm.P[t_1][i0]), ah[1], al[1]);
                split(to_f(sm.r[t_0][i1]) * ex2(sm.P[t_0][i1]), ah[2], al[2]);
                split(to_f(sm.r[t_1][i1]) * ex2(sm.P[t_1][i1]), ah[3], al[3]);
#pragma unroll
                for (int nn = 0; nn < kN; ++nn) {
                    uint32_t bh0, bl0, bh1, bl1;
                    split(sm.S[i0][8 * nn + g], bh0, bl0);
                    split(sm.S[i1][8 * nn + g], bh1, bl1);
                    mma(acc[nn], al, bh0, bh1);
                    mma(acc[nn], ah, bl0, bl1);
                    mma(acc[nn], ah, bh0, bh1);
                }
            }
        }

        // scores against key sub-chunks b < warp, factored about row ta
        float sc[kWarps - 1][2][4] = {};
        if (warp > 0) {
#pragma unroll
            for (int kk = 0; kk < kN; ++kk) {
                const int i0 = 8 * kk + c, i1 = i0 + 4;
                const float b0 = sm.P[ta][i0], b1 = sm.P[ta][i1];
                const uint32_t qa[4] = {
                    tf32(to_f(sm.r[t_0][i0]) * ex2(sm.P[t_0][i0] - b0)),
                    tf32(to_f(sm.r[t_1][i0]) * ex2(sm.P[t_1][i0] - b0)),
                    tf32(to_f(sm.r[t_0][i1]) * ex2(sm.P[t_0][i1] - b1)),
                    tf32(to_f(sm.r[t_1][i1]) * ex2(sm.P[t_1][i1] - b1))};
#pragma unroll
                for (int bb = 0; bb < kWarps - 1; ++bb) {
                    if (bb >= warp) continue;
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt) {
                        const int s = 16 * bb + 8 * nt + g;
                        mma(sc[bb][nt], qa,
                            tf32(to_f(sm.k[s][i0]) * ex2(b0 - sm.P[s + 1][i0])),
                            tf32(to_f(sm.k[s][i1]) * ex2(b1 - sm.P[s + 1][i1])));
                    }
                }
            }
        }

        // the diagonal 16x16 block, fp32, in operand layout: dg[q][x] is slot x
        // of k-step q (keys ta + 8q ..); slots 0 and 2 of k-step 1 (rows g < 8,
        // keys >= 8) are always above the diagonal
        float dg[2][4] = {};
        {
            int tl[2][4], sl[2][4];
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                    tl[q][x] = g + (x & 1) * 8;
                    sl[q][x] = 8 * q + (x >> 1) * 4 + c;
                }
            for (int i = 0; i < D; i += 2) {  // two channels at a time
                const float2 rt[2] = {to_f2(&sm.r[t_0][i]), to_f2(&sm.r[t_1][i])};
                const float2 pt[2] = {ld2(&sm.P[t_0][i]), ld2(&sm.P[t_1][i])};
                const float2 ui = ld2(&sm.u[i]);
#pragma unroll
                for (int q = 0; q < 2; ++q)
#pragma unroll
                    for (int x = 0; x < 4; ++x) {
                        if (q == 1 && (x & 1) == 0) continue;
                        const int tt = tl[q][x], ss = sl[q][x];
                        // above the diagonal 2^-inf = 0; on it the u bonus alone
                        const float mask = ss < tt ? 0.f : -INFINITY;
                        const float bonus = ss == tt ? 1.f : 0.f;
                        const float2 ks = to_f2(&sm.k[ta + ss][i]);
                        const float2 ps = ld2(&sm.P[ta + ss + 1][i]);
                        const float2 r2 = rt[x & 1], p2 = pt[x & 1];
                        dg[q][x] += r2.x * ks.x * fmaf(bonus, ui.x, ex2(p2.x - ps.x + mask));
                        dg[q][x] += r2.y * ks.y * fmaf(bonus, ui.y, ex2(p2.y - ps.y + mask));
                    }
            }
        }

        // y += A @ v over keys 0 .. ta + 15, 3xTF32
#pragma unroll
        for (int ks = 0; ks < 2 * kWarps; ++ks) {
            if (ks > 2 * warp + 1) break;
            float af[4];
            if (ks < 2 * (kWarps - 1) && ks < 2 * warp) {
                to_operand(sc[ks / 2][ks % 2], lane, af);
            } else {
#pragma unroll
                for (int x = 0; x < 4; ++x) af[x] = ks == 2 * warp ? dg[0][x] : dg[1][x];
            }
            uint32_t ah[4], al[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) split(af[x], ah[x], al[x]);
            const int s0 = 8 * ks + c, s1 = s0 + 4;
#pragma unroll
            for (int nn = 0; nn < kN; ++nn)
                mma3_v(acc[nn], ah, al, sm.v[s0][8 * nn + g], sm.v[s1][8 * nn + g]);
        }

#pragma unroll
        for (int nn = 0; nn < kN; ++nn) {
            const size_t col = base + 8 * nn + 2 * c;
            if (t_0 < n) store2(y + col + (size_t)(t0 + t_0) * step, acc[nn][0], acc[nn][1]);
            if (t_1 < n) store2(y + col + (size_t)(t0 + t_1) * step, acc[nn][2], acc[nn][3]);
        }

        // ---- state rows 16 warp .. + 15: 2^P[C] S + (k 2^(P[C] - P[s+1]))^T @ v --
        if (warp < kMTiles) {
            const int i_0 = 16 * warp + g, i_1 = i_0 + 8;
            const float last0 = sm.P[kC][i_0], last1 = sm.P[kC][i_1];
            const float dec0 = ex2(last0), dec1 = ex2(last1);
#pragma unroll
            for (int nn = 0; nn < kN; ++nn) {
                st[nn][0] *= dec0;
                st[nn][1] *= dec0;
                st[nn][2] *= dec1;
                st[nn][3] *= dec1;
            }
#pragma unroll
            for (int ks = 0; ks < kC / 8; ++ks) {
                const int s0 = 8 * ks + c, s1 = s0 + 4;
                uint32_t ah[4], al[4];
                split(to_f(sm.k[s0][i_0]) * ex2(last0 - sm.P[s0 + 1][i_0]), ah[0], al[0]);
                split(to_f(sm.k[s0][i_1]) * ex2(last1 - sm.P[s0 + 1][i_1]), ah[1], al[1]);
                split(to_f(sm.k[s1][i_0]) * ex2(last0 - sm.P[s1 + 1][i_0]), ah[2], al[2]);
                split(to_f(sm.k[s1][i_1]) * ex2(last1 - sm.P[s1 + 1][i_1]), ah[3], al[3]);
#pragma unroll
                for (int nn = 0; nn < kN; ++nn)
                    mma3_v(st[nn], ah, al, sm.v[s0][8 * nn + g], sm.v[s1][8 * nn + g]);
            }
        }
        __syncthreads();  // every warp is done with this chunk's shared memory
    }

    if (warp < kMTiles) {
        float* sb = state + (size_t)bh * D * D;
#pragma unroll
        for (int nn = 0; nn < kN; ++nn) {
            store2(sb + (16 * warp + g) * D + 8 * nn + 2 * c, st[nn][0], st[nn][1]);
            store2(sb + (16 * warp + g + 8) * D + 8 * nn + 2 * c, st[nn][2], st[nn][3]);
        }
    }
}

template <typename T, int D>
int launch_dh(const T* r, const T* k, const T* v, const T* w, const float* u, T* y,
              float* state, int B, int S, int H, cudaStream_t st) {
    constexpr int smem = sizeof(Smem<T, D>);
    const cudaError_t attr = cudaFuncSetAttribute(
        wkv6_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    wkv6_kernel<T, D><<<B * H, kThreads, smem, st>>>(r, k, v, w, u, y, state, S, H);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           void* y, float* state, int B, int S, int H, int dh, cudaStream_t st) {
    const T* rp = static_cast<const T*>(r);
    const T* kp = static_cast<const T*>(k);
    const T* vp = static_cast<const T*>(v);
    const T* wp = static_cast<const T*>(w);
    T* yp = static_cast<T*>(y);
    switch (dh) {
        case 16: return launch_dh<T, 16>(rp, kp, vp, wp, u, yp, state, B, S, H, st);
        case 64: return launch_dh<T, 64>(rp, kp, vp, wp, u, yp, state, B, S, H, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// r, k, v, w, y: (B, S, H, dh) contiguous, 16-byte aligned, bf16 (is_bf16 = 1)
// or fp32 (is_bf16 = 0); u: (H, dh) fp32; state: (B, H, dh, dh) fp32, written
// whole. dh in {16, 64} (the smoke and full rwkv6-3b heads), S >= 1 (the
// Python wrapper checks).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, void* y, void* state, int B, int S, int H, int dh,
                        int is_bf16, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* up = static_cast<const float*>(u);
    float* sp = static_cast<float*>(state);
    if (is_bf16) return launch<bf16>(r, k, v, w, up, y, sp, B, S, H, dh, st);
    return launch<float>(r, k, v, w, up, y, sp, B, S, H, dh, st);
}
