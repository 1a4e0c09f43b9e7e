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
// token 0) into `dst` by 16-byte cp.async pieces from kThr threads; rows past
// S are zero-filled.
template <int D, int kThr, typename T, int kIn>
__device__ __forceinline__ void stage_rows(T (*dst)[kIn], const T* src, int t0, int S,
                                           size_t step) {
    constexpr int kPieces = D * sizeof(T) / 16;
    const int n = min(kC, S - t0);
    for (int e = threadIdx.x; e < kC * kPieces; e += kThr) {
        const int t = e / kPieces, e16 = (e % kPieces) * (16 / sizeof(T));
        cp_async16(&dst[t][e16], src + (size_t)(t0 + min(t, n - 1)) * step + e16,
                   t < n ? 16 : 0);
    }
}

// P[t][i], t = 0 .. kC: the chunk's exclusive (P[t]) and inclusive (P[t + 1])
// sums of log2(max(w, 1e-12)) over its n tokens (later ones decay by 1): one
// scan per channel by kSeg adjacent lanes of kLen tokens each, whose totals add
// in order, so P falls monotonically along the chunk. Ends with a barrier.
template <int D, int kThr, typename T, int kIn, int kP>
__device__ __forceinline__ void log_decays(float (*P)[kP], const T (*w)[kIn], int n) {
    for (int e = threadIdx.x; e < kC * D; e += kThr) {
        const int t = e / D, i = e % D;
        P[t + 1][i] = t < n ? lg2(fmaxf(to_f(w[t][i]), kMinDecay)) : 0.f;
    }
    __syncthreads();
    constexpr int kSeg = kThr / D, kLen = kC / kSeg;
    const int lane = threadIdx.x & 31;
    const int i = threadIdx.x / kSeg, seg = threadIdx.x % kSeg, t1 = seg * kLen + 1;
    float part[kLen], run = 0.f;
#pragma unroll
    for (int m = 0; m < kLen; ++m) part[m] = run += P[t1 + m][i];
    float off = 0.f;
#pragma unroll
    for (int j = 0; j + 1 < kSeg; ++j) {
        const float total = __shfl_sync(0xffffffffu, run, (lane & ~(kSeg - 1)) | j);
        if (j < seg) off += total;
    }
#pragma unroll
    for (int m = 0; m < kLen; ++m) P[t1 + m][i] = off + part[m];
    if (seg == 0) P[0][i] = 0.f;
    __syncthreads();
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
        stage_rows<D, kThreads>(sm.r, r + base, t0, S, step);
        stage_rows<D, kThreads>(sm.k, k + base, t0, S, step);
        stage_rows<D, kThreads>(sm.v, v + base, t0, S, step);
        stage_rows<D, kThreads>(sm.w, w + base, t0, S, step);
        if (warp < kMTiles) {  // the state so far, the inter-chunk product's operand
#pragma unroll
            for (int nn = 0; nn < kN; ++nn) {
                store2(&sm.S[16 * warp + g][8 * nn + 2 * c], st[nn][0], st[nn][1]);
                store2(&sm.S[16 * warp + g + 8][8 * nn + 2 * c], st[nn][2], st[nn][3]);
            }
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncthreads();

        log_decays<D, kThreads>(sm.P, sm.w, n);

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

// ==== K4's backward ==========================================================
//
// (dr, dk, dv, dw, du) of y = WKV6(r, k, v, w, u) from a zero state against the
// cotangent gy, the functions the plain rule differentiates (kernels/wkv6/ref.py
// wkv6_chunked): each gradient in its input's type, du fp32 summed over the
// batch, and dw zero wherever w < 1e-12 (the clamp passes no gradient there).
// The chunked form again, on the forward's plan (chunks of C = 64 tokens,
// base-2 partial sums P of log2(max(w, 1e-12)), every exponent <= 0), in three
// launches and a small fourth:
//   1. wkv6_bwd_states, forward: one block per (b, h) walks the chunks in order
//      and writes the state at each chunk's start, S_c, to fp32 scratch.
//   2. wkv6_bwd_states, reverse: the same walk backwards over r and gy writes the
//      state's cotangent at each chunk's end, dS_c (0 for the last chunk):
//          dS_{c-1} = 2^P[C] dS_c + (r 2^P[t])^T gy
//      and each chunk's cross term X_c[i] = sum_j S_{c+1}[i][j] dS_c[i][j].
//   3. wkv6_bwd_chunks: one block of 8 warps per (b, h, chunk), every chunk at
//      once. With dA = gy v^T and A the forward's scores (u on the diagonal),
//          dv = A^T gy + (k 2^(P[C] - P[s+1])) dS_c
//          dr = dr~ + u k diag(dA),  dr~_t = 2^P[t] (S_c gy_t) + sum_{s<t} dA_ts k_s 2^(P[t] - P[s+1])
//          dk = dk~ + u r diag(dA),  dk~_s = 2^(P[C] - P[s+1]) (dS_c v_s) + sum_{t>s} dA_ts r_t 2^(P[t] - P[s+1])
//      and the log-decay's cotangent, chunk-local: a pair (s < j < t) that
//      straddles token j's decay has either t in the chunk (r ⊙ dr~) or s in it
//      up to the chunk's end (k ⊙ dk~), or crosses the chunk's end (X_c), so
//          dlog w_j = X_c + sum_{t > j in chunk} r_t ⊙ dr~_t - sum_{s >= j in chunk} k_s ⊙ dk~_s
//      and dw = dlog w / w. Its sums cancel within a chunk only, as the plain
//      rule's do (a running sum over the whole sequence would cancel over S).
//      Each block writes its chunk's partial of du.
//   4. wkv6_bwd_du sums the partials over the batch and the chunks in a fixed
//      order: no atomics, so two runs are bit-identical.
// Products run on mma.sync.m16n8k8 TF32 with fp32 accumulators, every operand
// that is not exact in TF32 split 3xTF32 (hi x hi + hi x lo + lo x hi; inputs
// from bf16 are exact); the decays are factored about a sub-chunk's edge as in
// the forward, and the diagonal 16 x 16 blocks run elementwise in fp32
// (tests/test_torch_wkv6_backward.py emulates this on the CPU). Scratch: S_c
// and dS_c, (B, H, NC, dh, dh) fp32 each, X and du's partials (B, H, NC, dh).

namespace {

constexpr int kBwdWarps = 8;            // wkv6_bwd_chunks: (row sub-chunk, column half)
constexpr int kBwdThreads = kBwdWarps * 32;

// A D x D fp32 tile (row-major) into `dst`.
template <int D, int kThr, int kS>
__device__ __forceinline__ void stage_tile(float (*dst)[kS], const float* src) {
    for (int e = threadIdx.x; e < D * D / 4; e += kThr) {
        const int i = e / (D / 4), j = (e % (D / 4)) * 4;
        cp_async16(&dst[i][j], src + i * D + j, 16);
    }
}

// acc (a warp's 16 x 8 NT tile; tiles from ntn on left alone) += sum over k in
// [k0, k1) of A(m, k) B(k, n), A(m, k) = fa(m, k) for the tile's row m, B(k, n)
// = fb(k, n) for its column n. An operand that is not exact in TF32 (kSplit)
// takes the 3xTF32 split.
template <bool kSplitA, bool kSplitB, int NT, typename FA, typename FB>
__device__ __forceinline__ void mm(float (&acc)[NT][4], int k0, int k1, FA fa, FB fb,
                                   int ntn = NT) {
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
    for (int kk = k0; kk < k1; kk += 8) {
        const float av[4] = {fa(g, kk + c), fa(g + 8, kk + c), fa(g, kk + c + 4),
                             fa(g + 8, kk + c + 4)};
        uint32_t ah[4], al[4] = {};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            if (kSplitA) split(av[x], ah[x], al[x]);
            else ah[x] = tf32(av[x]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            if (nt >= ntn) break;
            const float b0 = fb(kk + c, 8 * nt + g), b1 = fb(kk + c + 4, 8 * nt + g);
            uint32_t bh0, bl0 = 0, bh1, bl1 = 0;
            if (kSplitB) {
                split(b0, bh0, bl0);
                split(b1, bh1, bl1);
            } else {
                bh0 = tf32(b0);
                bh1 = tf32(b1);
            }
            if (kSplitA) mma(acc[nt], al, bh0, bh1);
            if (kSplitB) mma(acc[nt], ah, bl0, bl1);
            mma(acc[nt], ah, bh0, bh1);
        }
    }
}

// A warp's 16 x 8 NT accumulator tile into rows t0 + row0 .. of a (B, S, H, D)
// output at column col0 (rows from n on left out).
template <int NT, typename T>
__device__ __forceinline__ void store_tile(T* dst, const float (&acc)[NT][4], int t0,
                                           int row0, int col0, int n, size_t step) {
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        const int col = col0 + 8 * nt + 2 * c;
        if (row0 + g < n)
            store2(dst + (size_t)(t0 + row0 + g) * step + col, acc[nt][0], acc[nt][1]);
        if (row0 + g + 8 < n)
            store2(dst + (size_t)(t0 + row0 + g + 8) * step + col, acc[nt][2], acc[nt][3]);
    }
}

template <typename T, int D>
struct __align__(16) SmemStates {
    static constexpr int kIn = D + 16 / sizeof(T);
    static constexpr int kP = D + 4;
    T a[kC][kIn], b[kC][kIn], w[kC][kIn];
    float P[kC + 1][kP];
};

// Forward (kReverse false; a = k, b = v): out[b, h, c] = S at chunk c's start,
//     S <- 2^P[C] S + (k 2^(P[C] - P[s+1]))^T v.
// Reverse (a = r, b = gy): out[b, h, c] = dS at chunk c's end,
//     dS <- 2^P[C] dS + (r 2^P[t])^T gy,
// and cross[b, h, c, i] = sum_j states[b, h, c + 1][i][j] dS[i][j].
// Warp m owns rows 16m .. 16m + 15 in registers, as the forward's state.
template <typename T, int D, bool kReverse>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_states(const T* __restrict__ a, const T* __restrict__ bsrc,
                const T* __restrict__ w, const float* __restrict__ states,
                float* __restrict__ out, float* __restrict__ cross, int S, int H, int NC) {
    constexpr int kN = D / 8, kMTiles = D / 16;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    SmemStates<T, D>& sm = *reinterpret_cast<SmemStates<T, D>*>(smem_raw);
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, c = lane & 3;
    const size_t step = (size_t)H * D, base = ((size_t)b * S * H + h) * D;
    const int i_0 = 16 * warp + g, i_1 = i_0 + 8;
    float x[kN][4] = {};

    for (int it = 0; it < NC; ++it) {
        const int ch = kReverse ? NC - 1 - it : it, t0 = ch * kC;
        stage_rows<D, kThreads>(sm.a, a + base, t0, S, step);
        stage_rows<D, kThreads>(sm.b, bsrc + base, t0, S, step);
        stage_rows<D, kThreads>(sm.w, w + base, t0, S, step);
        if (warp < kMTiles) {
            const size_t tile = ((size_t)bh * NC + ch) * D * D;
            float* o = out + tile;
#pragma unroll
            for (int nn = 0; nn < kN; ++nn) {
                store2(o + i_0 * D + 8 * nn + 2 * c, x[nn][0], x[nn][1]);
                store2(o + i_1 * D + 8 * nn + 2 * c, x[nn][2], x[nn][3]);
            }
            if (kReverse) {
                float s0 = 0.f, s1 = 0.f;
                if (ch + 1 < NC) {
                    const float* sn = states + tile + D * D;
#pragma unroll
                    for (int nn = 0; nn < kN; ++nn) {
                        const float2 p0 = ld2(sn + i_0 * D + 8 * nn + 2 * c);
                        const float2 p1 = ld2(sn + i_1 * D + 8 * nn + 2 * c);
                        s0 += p0.x * x[nn][0] + p0.y * x[nn][1];
                        s1 += p1.x * x[nn][2] + p1.y * x[nn][3];
                    }
                }
                s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
                s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
                s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
                s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
                if (c == 0) {
                    cross[((size_t)bh * NC + ch) * D + i_0] = s0;
                    cross[((size_t)bh * NC + ch) * D + i_1] = s1;
                }
            }
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncthreads();
        log_decays<D, kThreads>(sm.P, sm.w, min(kC, S - t0));

        if (warp < kMTiles) {
            const float last0 = sm.P[kC][i_0], last1 = sm.P[kC][i_1];
            const float dec0 = ex2(last0), dec1 = ex2(last1);
#pragma unroll
            for (int nn = 0; nn < kN; ++nn) {
                x[nn][0] *= dec0;
                x[nn][1] *= dec0;
                x[nn][2] *= dec1;
                x[nn][3] *= dec1;
            }
            // a's decay: to the chunk's end (forward) or from its start (reverse)
            auto ea = [&](int s, int i, float last) {
                return kReverse ? sm.P[s][i] : last - sm.P[s + 1][i];
            };
#pragma unroll
            for (int ks = 0; ks < kC / 8; ++ks) {
                const int s0 = 8 * ks + c, s1 = s0 + 4;
                uint32_t ah[4], al[4];
                split(to_f(sm.a[s0][i_0]) * ex2(ea(s0, i_0, last0)), ah[0], al[0]);
                split(to_f(sm.a[s0][i_1]) * ex2(ea(s0, i_1, last1)), ah[1], al[1]);
                split(to_f(sm.a[s1][i_0]) * ex2(ea(s1, i_0, last0)), ah[2], al[2]);
                split(to_f(sm.a[s1][i_1]) * ex2(ea(s1, i_1, last1)), ah[3], al[3]);
#pragma unroll
                for (int nn = 0; nn < kN; ++nn)
                    mma3_v(x[nn], ah, al, sm.b[s0][8 * nn + g], sm.b[s1][8 * nn + g]);
            }
        }
        __syncthreads();  // every warp is done with this chunk's shared memory
    }
}

template <typename T, int D>
struct __align__(16) SmemChunk {
    static constexpr int kIn = D + 16 / sizeof(T);
    static constexpr int kP = D + 4;
    static constexpr int kS = D + 4;
    static constexpr int kM = kC + 4;
    T r[kC][kIn], k[kC][kIn], v[kC][kIn], g[kC][kIn];
    float P[kC + 1][kP];
    float S0[D][kS], dS1[D][kS];  // S at the chunk's start, dS at its end
    // A(t, s) at M[t][s] and dA(t, s) at M[s][t] for s < t; w is staged here
    // first, and the log-decay's summands r ⊙ dr~ - k ⊙ dk~ last
    float M[kC][kM];
    float Ad[kC], dAd[kC];        // the diagonals of A and dA
    float u[D];
};

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
wkv6_bwd_chunks(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ w, const T* __restrict__ gy,
                const float* __restrict__ u, const float* __restrict__ states,
                const float* __restrict__ dstates, const float* __restrict__ cross,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                T* __restrict__ dw, float* __restrict__ du_part, int S, int H, int NC) {
    constexpr bool kRaw = std::is_same<T, float>::value;  // fp32 inputs are not TF32
    constexpr int kNT = D / 16;  // 8-wide tiles in a warp's half of dh
    using Sm = SmemChunk<T, D>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
    T (*ws)[Sm::kIn] = reinterpret_cast<T (*)[Sm::kIn]>(&sm.M[0][0]);
    float (*E)[D + 4] = reinterpret_cast<float (*)[D + 4]>(&sm.M[0][0]);

    const int bh = blockIdx.x / NC, ch = blockIdx.x % NC, b = bh / H, h = bh % H;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, c = lane & 3;
    const int ta = kSub * (warp >> 1);      // the warp's 16 rows (tokens) of the chunk
    const int half = warp & 1;
    const int s_lo = 32 * half;             // its 32 columns of the C x C matrices
    const int j_lo = half * (D / 2);        // its D / 2 columns of a (C, D) gradient
    const int t0 = ch * kC, n = min(kC, S - t0);
    const bool first = ch == 0, last = ch + 1 == NC;
    const size_t step = (size_t)H * D, base = ((size_t)b * S * H + h) * D;
    const size_t tile = ((size_t)bh * NC + ch) * D * D;

    stage_rows<D, kBwdThreads>(sm.r, r + base, t0, S, step);
    stage_rows<D, kBwdThreads>(sm.k, k + base, t0, S, step);
    stage_rows<D, kBwdThreads>(sm.v, v + base, t0, S, step);
    stage_rows<D, kBwdThreads>(sm.g, gy + base, t0, S, step);
    stage_rows<D, kBwdThreads>(ws, w + base, t0, S, step);
    stage_tile<D, kBwdThreads>(sm.S0, states + tile);
    stage_tile<D, kBwdThreads>(sm.dS1, dstates + tile);
    for (int i = threadIdx.x; i < D; i += kBwdThreads) sm.u[i] = u[h * D + i];
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    log_decays<D, kBwdThreads>(sm.P, ws, n);

    // ---- dA = gy v^T and A into M ------------------------------------------------
    if (s_lo <= ta + kSub - 1) {
        float acc[4][4] = {};
        mm<kRaw, kRaw>(acc, 0, D, [&](int m, int i) { return to_f(sm.g[ta + m][i]); },
                       [&](int i, int nl) { return to_f(sm.v[s_lo + nl][i]); });
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int t = ta + g + (x >> 1) * 8, s = s_lo + 8 * nt + 2 * c + (x & 1);
                if (s < t) sm.M[s][t] = acc[nt][x];
                else if (s == t) sm.dAd[t] = acc[nt][x];
            }
    }
    // A left of the diagonal block, factored about ta as in the forward
    const int nt_off = min(4, max(0, (ta - s_lo) / 8));
    if (nt_off > 0) {
        float acc[4][4] = {};
        mm<true, true>(
            acc, 0, D,
            [&](int m, int i) {
                return to_f(sm.r[ta + m][i]) * ex2(sm.P[ta + m][i] - sm.P[ta][i]);
            },
            [&](int i, int nl) {
                const int s = s_lo + nl;
                return to_f(sm.k[s][i]) * ex2(sm.P[ta][i] - sm.P[s + 1][i]);
            },
            nt_off);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int x = 0; x < 4; ++x)
                if (nt < nt_off)
                    sm.M[ta + g + (x >> 1) * 8][s_lo + 8 * nt + 2 * c + (x & 1)] = acc[nt][x];
    }
    // the diagonal block, fp32 elementwise, by the warp whose half holds it
    if (half == (ta >> 5)) {
        for (int e = lane; e < kSub * kSub; e += 32) {
            const int tl = e / kSub, sl = e % kSub;
            if (sl > tl) continue;
            const int t = ta + tl, s = ta + sl;
            float acc = 0.f;
            for (int i = 0; i < D; ++i) {
                const float rk = to_f(sm.r[t][i]) * to_f(sm.k[s][i]);
                acc += sl < tl ? rk * ex2(sm.P[t][i] - sm.P[s + 1][i]) : rk * sm.u[i];
            }
            if (sl < tl) sm.M[t][s] = acc;
            else sm.Ad[t] = acc;
        }
    }
    __syncthreads();

    // ---- dv, rows ta .. ta + 15: A^T gy + (k 2^(P[C] - P[s+1])) dS_c ---------------
    {
        float acc[kNT][4] = {};
        mm<true, kRaw>(
            acc, ta, kC,
            [&](int m, int t) {
                const int s = ta + m;
                return t > s ? sm.M[t][s] : (t == s ? sm.Ad[s] : 0.f);
            },
            [&](int t, int nl) { return to_f(sm.g[t][j_lo + nl]); });
        if (!last)
            mm<true, true>(
                acc, 0, D,
                [&](int m, int i) {
                    const int s = ta + m;
                    return to_f(sm.k[s][i]) * ex2(sm.P[kC][i] - sm.P[s + 1][i]);
                },
                [&](int i, int nl) { return sm.dS1[i][j_lo + nl]; });
        store_tile(dv + base, acc, t0, ta, j_lo, n, step);
    }

    // ---- dr~, rows ta .. ta + 15, factored about ta ----------------------------------
    float ra[kNT][4] = {};
    if (!first)  // 2^P[t] (S_c gy_t) = 2^(P[t] - P[ta]) (gy_t . S_c[i] 2^P[ta])
        mm<kRaw, true>(ra, 0, D, [&](int m, int j) { return to_f(sm.g[ta + m][j]); },
                       [&](int j, int nl) {
                           const int i = j_lo + nl;
                           return sm.S0[i][j] * ex2(sm.P[ta][i]);
                       });
    if (ta > 0)  // keys s < ta
        mm<true, true>(
            ra, 0, ta, [&](int m, int s) { return sm.M[s][ta + m]; },
            [&](int s, int nl) {
                const int i = j_lo + nl;
                return to_f(sm.k[s][i]) * ex2(sm.P[ta][i] - sm.P[s + 1][i]);
            });
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int t = ta + g + (x >> 1) * 8, i = j_lo + 8 * nt + 2 * c + (x & 1);
            float d = ra[nt][x] * ex2(sm.P[t][i] - sm.P[ta][i]);
            for (int s = ta; s < t; ++s)
                d += sm.M[s][t] * to_f(sm.k[s][i]) * ex2(sm.P[t][i] - sm.P[s + 1][i]);
            ra[nt][x] = d;
        }

    // ---- dk~, rows (keys) ta .. ta + 15, factored about e = ta + 16 -------------------
    float ka[kNT][4] = {};
    const int e = ta + kSub;
    if (!last)  // 2^(P[C] - P[s+1]) (dS_c v_s)
        mm<kRaw, true>(ka, 0, D, [&](int m, int j) { return to_f(sm.v[ta + m][j]); },
                       [&](int j, int nl) {
                           const int i = j_lo + nl;
                           return sm.dS1[i][j] * ex2(sm.P[kC][i] - sm.P[e][i]);
                       });
    if (e < kC)  // queries t >= e
        mm<true, true>(
            ka, e, kC, [&](int m, int t) { return sm.M[ta + m][t]; },
            [&](int t, int nl) {
                const int i = j_lo + nl;
                return to_f(sm.r[t][i]) * ex2(sm.P[t][i] - sm.P[e][i]);
            });
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int s = ta + g + (x >> 1) * 8, i = j_lo + 8 * nt + 2 * c + (x & 1);
            float d = ka[nt][x] * ex2(sm.P[e][i] - sm.P[s + 1][i]);
            for (int t = s + 1; t < e; ++t)
                d += sm.M[s][t] * to_f(sm.r[t][i]) * ex2(sm.P[t][i] - sm.P[s + 1][i]);
            ka[nt][x] = d;
        }

    // ---- dr, dk (the u bonus added) and du's partial --------------------------------
    {
        float o[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int t = ta + g + (x >> 1) * 8, i = j_lo + 8 * nt + 2 * c + (x & 1);
                o[nt][x] = ra[nt][x] + sm.u[i] * to_f(sm.k[t][i]) * sm.dAd[t];
            }
        store_tile(dr + base, o, t0, ta, j_lo, n, step);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int s = ta + g + (x >> 1) * 8, i = j_lo + 8 * nt + 2 * c + (x & 1);
                o[nt][x] = ka[nt][x] + sm.u[i] * to_f(sm.r[s][i]) * sm.dAd[s];
            }
        store_tile(dk + base, o, t0, ta, j_lo, n, step);
    }
    for (int i = threadIdx.x; i < D; i += kBwdThreads) {
        float acc = 0.f;
        for (int t = 0; t < kC; ++t) acc += to_f(sm.r[t][i]) * to_f(sm.k[t][i]) * sm.dAd[t];
        du_part[((size_t)bh * NC + ch) * D + i] = acc;
    }
    __syncthreads();  // every warp is done with M

    // ---- dw: the log-decay's cotangent, a reverse scan within the chunk -----------------
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int t = ta + g + (x >> 1) * 8, i = j_lo + 8 * nt + 2 * c + (x & 1);
            ka[nt][x] *= to_f(sm.k[t][i]);                      // k ⊙ dk~
            E[t][i] = to_f(sm.r[t][i]) * ra[nt][x] - ka[nt][x];  // r ⊙ dr~ - k ⊙ dk~
        }
    __syncthreads();
    {  // E[t] <- sum over t' > t, by kSeg adjacent lanes of kLen tokens a channel
        constexpr int kSeg = kBwdThreads / D, kLen = kC / kSeg;
        const int i = threadIdx.x / kSeg, seg = threadIdx.x % kSeg, tb = seg * kLen;
        float part[kLen], run = 0.f;
#pragma unroll
        for (int m = kLen - 1; m >= 0; --m) {
            part[m] = run;
            run += E[tb + m][i];
        }
        float off = 0.f;
#pragma unroll
        for (int j = kSeg - 1; j > 0; --j) {
            const float total = __shfl_sync(0xffffffffu, run, (lane & ~(kSeg - 1)) | j);
            if (j > seg) off += total;
        }
#pragma unroll
        for (int m = 0; m < kLen; ++m) E[tb + m][i] = off + part[m];
    }
    __syncthreads();
    {
        const float* X = cross + ((size_t)bh * NC + ch) * D;
        float o[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int t = ta + g + (x >> 1) * 8, i = j_lo + 8 * nt + 2 * c + (x & 1);
                const float dl = X[i] + E[t][i] - ka[nt][x];
                const float wt = t < n ? to_f(w[base + (size_t)(t0 + t) * step + i]) : 1.f;
                o[nt][x] = wt >= kMinDecay ? dl / wt : 0.f;
            }
        store_tile(dw + base, o, t0, ta, j_lo, n, step);
    }
}

// du[h][i] = sum over b, then chunks, of the partials: one thread an element.
__global__ void wkv6_bwd_du(const float* __restrict__ part, float* __restrict__ du, int B,
                            int H, int NC, int D) {
    const int h = blockIdx.x, i = threadIdx.x;
    if (i >= D) return;
    float acc = 0.f;
    for (int b = 0; b < B; ++b)
        for (int ch = 0; ch < NC; ++ch) acc += part[(((size_t)b * H + h) * NC + ch) * D + i];
    du[h * D + i] = acc;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
int launch_bwd_dh(const T* r, const T* k, const T* v, const T* w, const T* gy,
                  const float* u, T* dr, T* dk, T* dv, T* dw, float* du, float* states,
                  float* dstates, float* cross, float* du_part, int B, int S, int H,
                  cudaStream_t st) {
    const int NC = (S + kC - 1) / kC;
    constexpr int s_states = sizeof(SmemStates<T, D>), s_chunks = sizeof(SmemChunk<T, D>);
    cudaError_t err = allow_smem(wkv6_bwd_states<T, D, false>, s_states);
    if (err == cudaSuccess) err = allow_smem(wkv6_bwd_states<T, D, true>, s_states);
    if (err == cudaSuccess) err = allow_smem(wkv6_bwd_chunks<T, D>, s_chunks);
    if (err != cudaSuccess) return static_cast<int>(err);
    wkv6_bwd_states<T, D, false><<<B * H, kThreads, s_states, st>>>(
        k, v, w, nullptr, states, nullptr, S, H, NC);
    wkv6_bwd_states<T, D, true><<<B * H, kThreads, s_states, st>>>(
        r, gy, w, states, dstates, cross, S, H, NC);
    wkv6_bwd_chunks<T, D><<<B * H * NC, kBwdThreads, s_chunks, st>>>(
        r, k, v, w, gy, u, states, dstates, cross, dr, dk, dv, dw, du_part, S, H, NC);
    wkv6_bwd_du<<<H, D, 0, st>>>(du_part, du, B, H, NC, D);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(void* const* p, float* const* f, int B, int S, int H, int dh,
               cudaStream_t st) {
    const T* in[5];
    T* out[4];
    for (int x = 0; x < 5; ++x) in[x] = static_cast<const T*>(p[x]);
    for (int x = 0; x < 4; ++x) out[x] = static_cast<T*>(p[5 + x]);
    switch (dh) {
        case 16:
            return launch_bwd_dh<T, 16>(in[0], in[1], in[2], in[3], in[4], f[0], out[0],
                                        out[1], out[2], out[3], f[1], f[2], f[3], f[4],
                                        f[5], B, S, H, st);
        case 64:
            return launch_bwd_dh<T, 64>(in[0], in[1], in[2], in[3], in[4], f[0], out[0],
                                        out[1], out[2], out[3], f[1], f[2], f[3], f[4],
                                        f[5], B, S, H, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// r, k, v, w, gy in, dr, dk, dv, dw out: (B, S, H, dh) contiguous, 16-byte
// aligned, bf16 (is_bf16 = 1) or fp32; u (H, dh) fp32 in, du (H, dh) fp32 out;
// scratch, fp32: states and dstates (B, H, NC, dh, dh), cross and du_part
// (B, H, NC, dh), NC = ceil(S / 64). dh in {16, 64}, S >= 1 (the Python
// wrapper checks). Four launches on `stream`, no host sync.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                        const void* gy, const void* u, void* dr, void* dk, void* dv,
                        void* dw, void* du, void* states, void* dstates, void* cross,
                        void* du_part, int B, int S, int H, int dh, int is_bf16,
                        void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    void* const p[9] = {const_cast<void*>(r), const_cast<void*>(k), const_cast<void*>(v),
                        const_cast<void*>(w), const_cast<void*>(gy), dr, dk, dv, dw};
    float* const f[6] = {static_cast<float*>(const_cast<void*>(u)), static_cast<float*>(du),
                         static_cast<float*>(states), static_cast<float*>(dstates),
                         static_cast<float*>(cross), static_cast<float*>(du_part)};
    if (is_bf16) return launch_bwd<bf16>(p, f, B, S, H, dh, st);
    return launch_bwd<float>(p, f, B, S, H, dh, st);
}
