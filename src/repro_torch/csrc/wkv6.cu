// WKV6 recurrence for Hopper (sm_90a): bf16 or fp32 in/out, fp32 state.
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
// Bound: at the serving shape (8, 1000, 40, 64) bf16 the recurrence is
// 4 dh^2 fp32 operations per token and head, 5.2 GFLOP, ~0.078 ms at the
// card's 67 TFLOP/s outside the tensor cores; the bytes (r, k, v, w in, y
// out, 5.2 MB of state) are ~210 MB, ~0.063 ms. So operations bound it, and
// they are sequential along S.
//
// Design: the TPU kernel makes the chunk index a sequential grid axis and
// carries the state across grid steps in VMEM. Blocks on Hopper carry
// nothing between them, so one block per (b, h) walks the whole sequence and
// keeps the dh x dh state in registers: thread (j, p) owns column j, rows
// i = ii * kP + p (dh / kP of them), and the kP partial sums of y_t[j] meet
// by warp shuffles (the kP threads of a column are adjacent lanes). The block
// stages kTile steps of r, k, w (fp32, laid out [p][ii] with a 4-float pad so
// each lane's rows are one run of float4 loads on distinct banks) and v in
// shared memory, then steps through them token by token. The per-step form
// takes no exponential at all, so the chunked form's masked exp(diff), which
// overflows above the diagonal, has no counterpart here; a ragged S simply
// ends the last tile early, so no padded step reaches the state. At the
// serving shape B*H = 320 blocks of 256 threads is ~2.4 blocks per SM on 132
// SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kP = 4;  // threads sharing one column of the state
constexpr float kMinDecay = 1e-12f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// One row i of column j at one step: y += r_i (S_ij + u_i k_i v_j), then
// S_ij = w_i S_ij + k_i v_j.
__device__ __forceinline__ void cell(float r, float k, float w, float u, float vj,
                                     float& s, float& acc) {
    const float kv = k * vj;
    acc = fmaf(r, fmaf(u, kv, s), acc);
    s = fmaf(w, s, kv);
}

template <typename T, int DH>
__global__ void __launch_bounds__(DH * kP)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ w, const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ state, int S, int H) {
    constexpr int kThreads = DH * kP;
    constexpr int kRows = DH / kP;        // state rows per thread
    constexpr int kStride = kRows + 4;    // padded row of one lane group in shared memory
    constexpr int kTile = 32;  // steps staged at once (< 48 KB static)
    static_assert(kRows % 4 == 0, "float4 loads of each lane's rows");
    __shared__ __align__(16) float sr[kTile][kP][kStride];
    __shared__ __align__(16) float sk[kTile][kP][kStride];
    __shared__ __align__(16) float sw[kTile][kP][kStride];
    __shared__ float sv[kTile][DH];

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int j = threadIdx.x / kP, p = threadIdx.x % kP;

    float uu[kRows], s[kRows];
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii) {
        uu[ii] = u[h * DH + ii * kP + p];
        s[ii] = 0.f;
    }

    const size_t step = (size_t)H * DH;  // elements between consecutive tokens
    const size_t base = ((size_t)b * S * H + h) * DH;
    for (int t0 = 0; t0 < S; t0 += kTile) {
        const int n = min(kTile, S - t0);
        __syncthreads();  // the previous tile is consumed
        for (int e = threadIdx.x; e < n * DH; e += kThreads) {
            const int t = e / DH, d = e % DH;
            const size_t off = base + (size_t)(t0 + t) * step + d;
            const int q = d % kP, c = d / kP;  // row d belongs to lane group q, slot c
            sr[t][q][c] = to_f(r[off]);
            sk[t][q][c] = to_f(k[off]);
            sw[t][q][c] = fmaxf(to_f(w[off]), kMinDecay);
            sv[t][d] = to_f(v[off]);
        }
        __syncthreads();
        for (int t = 0; t < n; ++t) {
            const float vj = sv[t][j];
            const float4* r4 = reinterpret_cast<const float4*>(&sr[t][p][0]);
            const float4* k4 = reinterpret_cast<const float4*>(&sk[t][p][0]);
            const float4* w4 = reinterpret_cast<const float4*>(&sw[t][p][0]);
            float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
            for (int c = 0; c < kRows / 4; ++c) {
                const float4 rr = r4[c], kk = k4[c], ww = w4[c];
                cell(rr.x, kk.x, ww.x, uu[4 * c + 0], vj, s[4 * c + 0], a0);
                cell(rr.y, kk.y, ww.y, uu[4 * c + 1], vj, s[4 * c + 1], a1);
                cell(rr.z, kk.z, ww.z, uu[4 * c + 2], vj, s[4 * c + 2], a2);
                cell(rr.w, kk.w, ww.w, uu[4 * c + 3], vj, s[4 * c + 3], a3);
            }
            float acc = (a0 + a1) + (a2 + a3);
#pragma unroll
            for (int off = kP / 2; off > 0; off >>= 1)
                acc += __shfl_xor_sync(0xffffffffu, acc, off);
            if (p == 0) store(y + base + (size_t)(t0 + t) * step + j, acc);
        }
    }

    float* sb = state + (size_t)bh * DH * DH;
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii) sb[(ii * kP + p) * DH + j] = s[ii];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           void* y, float* state, int B, int S, int H, int dh, cudaStream_t st) {
    const T* rp = static_cast<const T*>(r);
    const T* kp = static_cast<const T*>(k);
    const T* vp = static_cast<const T*>(v);
    const T* wp = static_cast<const T*>(w);
    T* yp = static_cast<T*>(y);
    const dim3 grid(B * H);
    switch (dh) {
        case 16: wkv6_kernel<T, 16><<<grid, 16 * kP, 0, st>>>(rp, kp, vp, wp, u, yp, state, S, H); break;
        case 64: wkv6_kernel<T, 64><<<grid, 64 * kP, 0, st>>>(rp, kp, vp, wp, u, yp, state, S, H); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, y: (B, S, H, dh) contiguous, bf16 (is_bf16 = 1) or fp32
// (is_bf16 = 0); u: (H, dh) fp32; state: (B, H, dh, dh) fp32, written whole.
// dh in {16, 64} (the smoke and full rwkv6-3b heads), S >= 1 (the Python
// wrapper checks).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, void* y, void* state, int B, int S, int H, int dh,
                        int is_bf16, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* up = static_cast<const float*>(u);
    float* sp = static_cast<float*>(state);
    if (is_bf16) return launch<bf16>(r, k, v, w, up, y, sp, B, S, H, dh, st);
    return launch<float>(r, k, v, w, up, y, sp, B, S, H, dh, st);
}
