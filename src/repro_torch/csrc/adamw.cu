// K5: AdamW with global-norm clipping for Hopper (sm_90a), multi-tensor.
//
// Replaces no Pallas kernel: the JAX package's AdamW (repro/train/
// optimizer.py) is plain jnp that XLA fuses. The port's plain version
// (repro_torch/train/optimizer.py) runs it as ~19 separate fp32 elementwise
// passes over each 64 MB piece of every leaf, ~168 B of HBM traffic a
// parameter. This kernel does the same arithmetic in two passes over a
// table of leaves.
//
// Bound: memory. The clip scale depends on the norm of every gradient, so
// the gradients are read once before any update (4 B an fp32 element);
// the update then reads fp32 p, g, m and v and writes p, m and v (28 B):
// 32 B a parameter. granite-8b-l8's 2.148 B parameters: 68.7 GB, 20.5 ms at
// 3.35 TB/s; qwen3-vl-30b-a3b-l4's 3.11 B: 99.5 GB, 29.7 ms. A handful of
// fp32 operations an element (two IEEE divisions and a square root) stay
// far below the card's flop/byte balance point.
//
// Design:
//  - Leaf table by value. The launcher copies up to kMaxLeaves leaves'
//    pointers, element counts (64-bit), flags (decay, 16-byte vectors) and
//    the prefix sum of their chunk counts into a struct passed as a kernel
//    argument: no device copy of the table, no host sync. The parameters
//    and moments stay per-leaf tensors, updated in place.
//  - Chunk walk. A leaf is cut into chunks of kChunk elements; a launch's
//    chunks are numbered leaf after leaf (LeafTable::first). A persistent
//    grid of a fixed number of blocks an SM walks them (block b takes
//    chunks b, b + grid, ...), so a 805 M-element expert leaf and a 4 K
//    norm scale share the same blocks. Inside a chunk, each thread issues
//    kUnroll 16-byte vectors (8-byte for bf16) of each operand before it
//    uses the first; a leaf whose pointers are not vector-aligned, and the
//    last chunk's ragged tail, go element by element.
//  - Pass 1 (adamw_sumsq_kernel): each block sums the squares of its
//    gradient elements in fp64 (products of fp32 values are exact there)
//    and writes one partial. adamw_scale_kernel, one block, sums the
//    partials of every pass-1 launch of the step in a fixed order and
//    writes gnorm (fp32) and scale = min(clip / max(gnorm, 1e-9), 1). No
//    atomics: the same grid gives the same bits on a given card.
//  - Pass 2 (adamw_update_kernel): the same walk; per element, in fp32 and
//    in the plain version's order, with the round-to-nearest intrinsics so
//    that no FMA contraction changes a bit:
//        gf = g scale;  m = m b1 + gf (1 - b1);  v = v b2 + gf^2 (1 - b2)
//        delta = (m / bc1) / (sqrt(v / bc2) + eps) [+ p wd]
//        p = p - delta lr
//    scale, lr, bc1 and bc2 are read through device pointers. bf16
//    operands load as fp32 and store round-to-nearest-even, as the plain
//    version's .copy_() does. Given the same scale, p, m and v are
//    bit-identical to the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 48;
constexpr int64_t kChunk = 1 << 16;
constexpr int kThreads = 256;
constexpr int kVec = 4;         // elements of a vector load
constexpr int kUnrollNorm = 4;  // vectors a thread has in flight in pass 1
constexpr int kUnroll = 2;      // vectors of each of p, g, m, v in pass 2
constexpr int kDecay = 1, kAligned = 2;

typedef __nv_bfloat16 bf16;

struct LeafTable {
    void* p[kMaxLeaves];
    const void* g[kMaxLeaves];
    void* m[kMaxLeaves];
    void* v[kMaxLeaves];
    int64_t n[kMaxLeaves];
    int64_t first[kMaxLeaves + 1];  // first chunk of each leaf; first[leaves] = chunks
    int32_t flags[kMaxLeaves];
    int32_t leaves;
};
static_assert(sizeof(LeafTable) + 256 <= 4096, "kernel arguments exceed 4 KB");

struct Hyper {
    float b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b, rounded from the double
};

template <typename T>
struct Io;

template <>
struct Io<float> {
    static __device__ __forceinline__ float4 load4(const float* p, int64_t i) {
        return reinterpret_cast<const float4*>(p)[i];
    }
    static __device__ __forceinline__ void store4(float* p, int64_t i, float4 x) {
        reinterpret_cast<float4*>(p)[i] = x;
    }
    static __device__ __forceinline__ float load(const float* p, int64_t e) { return p[e]; }
    static __device__ __forceinline__ void store(float* p, int64_t e, float x) { p[e] = x; }
};

template <>
struct Io<bf16> {
    static __device__ __forceinline__ float4 load4(const bf16* p, int64_t i) {
        const uint2 u = reinterpret_cast<const uint2*>(p)[i];
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        return make_float4(a.x, a.y, b.x, b.y);
    }
    static __device__ __forceinline__ void store4(bf16* p, int64_t i, float4 x) {
        const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
        const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
        uint2 u;
        u.x = *reinterpret_cast<const uint32_t*>(&a);
        u.y = *reinterpret_cast<const uint32_t*>(&b);
        reinterpret_cast<uint2*>(p)[i] = u;
    }
    static __device__ __forceinline__ float load(const bf16* p, int64_t e) {
        return __bfloat162float(p[e]);
    }
    static __device__ __forceinline__ void store(bf16* p, int64_t e, float x) {
        p[e] = __float2bfloat16_rn(x);
    }
};

// Chunk c's leaf (advanced from the block's previous one: a block walks its
// chunks in increasing order), and its first element and length.
__device__ __forceinline__ void locate(const LeafTable& t, int64_t c, int& leaf, int64_t& off,
                                       int64_t& len) {
    while (t.first[leaf + 1] <= c) ++leaf;
    off = (c - t.first[leaf]) * kChunk;
    len = t.n[leaf] - off < kChunk ? t.n[leaf] - off : kChunk;
}

// The block's sum in a fixed order (butterfly within each warp, then the
// warps in order); valid in thread 0.
__device__ __forceinline__ double block_sum(double x) {
    __shared__ double warp_sums[kThreads / 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = x;
    __syncthreads();
    double total = 0.0;
    if (threadIdx.x == 0)
        for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    return total;
}

__device__ __forceinline__ double sq(float x) {
    const double d = x;
    return d * d;
}

template <typename G>
__global__ void __launch_bounds__(kThreads) adamw_sumsq_kernel(const LeafTable t,
                                                                double* __restrict__ partials) {
    double acc = 0.0;
    int leaf = 0;
    const int64_t chunks = t.first[t.leaves];
    for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
        int64_t off, len;
        locate(t, c, leaf, off, len);
        const G* g = static_cast<const G*>(t.g[leaf]) + off;
        const int64_t nv = (t.flags[leaf] & kAligned) ? len / kVec : 0;
        for (int64_t base = threadIdx.x; base < nv; base += kThreads * kUnrollNorm) {
            float4 x[kUnrollNorm];
#pragma unroll
            for (int u = 0; u < kUnrollNorm; ++u) {
                const int64_t i = base + u * kThreads;
                x[u] = i < nv ? Io<G>::load4(g, i) : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int u = 0; u < kUnrollNorm; ++u)
                acc += (sq(x[u].x) + sq(x[u].y)) + (sq(x[u].z) + sq(x[u].w));
        }
        for (int64_t e = nv * kVec + threadIdx.x; e < len; e += kThreads)
            acc += sq(Io<G>::load(g, e));
    }
    const double total = block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads) adamw_scale_kernel(const double* __restrict__ partials,
                                                                int count, float clip,
                                                                float* __restrict__ out) {
    double acc = 0.0;
    for (int i = threadIdx.x; i < count; i += kThreads) acc += partials[i];
    const double total = block_sum(acc);
    if (threadIdx.x == 0) {
        const float gnorm = static_cast<float>(sqrt(total));
        float scale = 1.f;
        if (clip > 0.f) {
            // torch.clamp's rules: a NaN norm gives a NaN scale
            const float q = __fdiv_rn(clip, gnorm < 1e-9f ? 1e-9f : gnorm);
            scale = q > 1.f ? 1.f : q;
        }
        out[0] = gnorm;
        out[1] = scale;
    }
}

struct Step {
    float scale, lr, bc1, bc2;
};

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, const Step& s,
                                     const Hyper& h, bool decay) {
    const float gf = __fmul_rn(g, s.scale);
    m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(gf, h.omb1));
    v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(gf, gf), h.omb2));
    float delta = __fdiv_rn(__fdiv_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps));
    if (decay) delta = __fadd_rn(delta, __fmul_rn(p, h.wd));
    p = __fsub_rn(p, __fmul_rn(delta, s.lr));
}

template <typename P, typename G, typename S>
__global__ void __launch_bounds__(kThreads, 4)
adamw_update_kernel(const LeafTable t, const float* __restrict__ scale,
                    const float* __restrict__ lr, const float* __restrict__ bc1,
                    const float* __restrict__ bc2, const Hyper h) {
    const Step s{*scale, *lr, *bc1, *bc2};
    int leaf = 0;
    const int64_t chunks = t.first[t.leaves];
    for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
        int64_t off, len;
        locate(t, c, leaf, off, len);
        P* p = static_cast<P*>(t.p[leaf]) + off;
        const G* g = static_cast<const G*>(t.g[leaf]) + off;
        S* m = static_cast<S*>(t.m[leaf]) + off;
        S* v = static_cast<S*>(t.v[leaf]) + off;
        const bool decay = t.flags[leaf] & kDecay;
        const int64_t nv = (t.flags[leaf] & kAligned) ? len / kVec : 0;
        for (int64_t base = threadIdx.x; base < nv; base += kThreads * kUnroll) {
            float4 pv[kUnroll], gv[kUnroll], mv[kUnroll], vv[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int64_t i = base + u * kThreads;
                if (i < nv) {
                    pv[u] = Io<P>::load4(p, i);
                    gv[u] = Io<G>::load4(g, i);
                    mv[u] = Io<S>::load4(m, i);
                    vv[u] = Io<S>::load4(v, i);
                }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int64_t i = base + u * kThreads;
                if (i < nv) {
                    adam(pv[u].x, gv[u].x, mv[u].x, vv[u].x, s, h, decay);
                    adam(pv[u].y, gv[u].y, mv[u].y, vv[u].y, s, h, decay);
                    adam(pv[u].z, gv[u].z, mv[u].z, vv[u].z, s, h, decay);
                    adam(pv[u].w, gv[u].w, mv[u].w, vv[u].w, s, h, decay);
                    Io<P>::store4(p, i, pv[u]);
                    Io<S>::store4(m, i, mv[u]);
                    Io<S>::store4(v, i, vv[u]);
                }
            }
        }
        for (int64_t e = nv * kVec + threadIdx.x; e < len; e += kThreads) {
            float pe = Io<P>::load(p, e), me = Io<S>::load(m, e), ve = Io<S>::load(v, e);
            adam(pe, Io<G>::load(g, e), me, ve, s, h, decay);
            Io<P>::store(p, e, pe);
            Io<S>::store(m, e, me);
            Io<S>::store(v, e, ve);
        }
    }
}

// The table the wrapper lays out as int64s: p, g, m, v pointers, element
// counts and flags, `leaves` each, then the leaves + 1 chunk offsets.
bool make_table(const int64_t* a, int leaves, LeafTable& t) {
    if (leaves < 1 || leaves > kMaxLeaves) return false;
    t = LeafTable{};
    t.leaves = leaves;
    for (int i = 0; i < leaves; ++i) {
        t.p[i] = reinterpret_cast<void*>(a[i]);
        t.g[i] = reinterpret_cast<const void*>(a[leaves + i]);
        t.m[i] = reinterpret_cast<void*>(a[2 * leaves + i]);
        t.v[i] = reinterpret_cast<void*>(a[3 * leaves + i]);
        t.n[i] = a[4 * leaves + i];
        t.flags[i] = static_cast<int32_t>(a[5 * leaves + i]);
    }
    for (int i = 0; i <= leaves; ++i) t.first[i] = a[6 * leaves + i];
    return true;
}

template <typename P, typename G, typename S>
int launch_update(const LeafTable& t, int blocks, const void* scale, const void* lr,
                  const void* bc1, const void* bc2, const Hyper& h, cudaStream_t st) {
    adamw_update_kernel<P, G, S><<<blocks, kThreads, 0, st>>>(
        t, static_cast<const float*>(scale), static_cast<const float*>(lr),
        static_cast<const float*>(bc1), static_cast<const float*>(bc2), h);
    return static_cast<int>(cudaGetLastError());
}

template <typename P, typename G>
int update_by_state(int s_dtype, const LeafTable& t, int blocks, const void* scale,
                    const void* lr, const void* bc1, const void* bc2, const Hyper& h,
                    cudaStream_t st) {
    return s_dtype ? launch_update<P, G, bf16>(t, blocks, scale, lr, bc1, bc2, h, st)
                   : launch_update<P, G, float>(t, blocks, scale, lr, bc1, bc2, h, st);
}

template <typename P>
int update_by_grad(int g_dtype, int s_dtype, const LeafTable& t, int blocks, const void* scale,
                   const void* lr, const void* bc1, const void* bc2, const Hyper& h,
                   cudaStream_t st) {
    return g_dtype ? update_by_state<P, bf16>(s_dtype, t, blocks, scale, lr, bc1, bc2, h, st)
                   : update_by_state<P, float>(s_dtype, t, blocks, scale, lr, bc1, bc2, h, st);
}

}  // namespace

// Dtype codes: 0 float32, 1 bfloat16. `table` is the wrapper's int64 layout
// (make_table); pointers are checked by the wrapper (one CUDA device,
// contiguous, vector alignment in the flags).

// Pass 1: `blocks` partial sums of squares of the table's gradients into
// partials[0, blocks) (fp64).
extern "C" int adamw_sumsq(const int64_t* table, int leaves, int g_dtype, int blocks,
                           void* partials, void* stream) {
    LeafTable t;
    if (!make_table(table, leaves, t) || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    double* out = static_cast<double*>(partials);
    if (g_dtype)
        adamw_sumsq_kernel<bf16><<<blocks, kThreads, 0, st>>>(t, out);
    else
        adamw_sumsq_kernel<float><<<blocks, kThreads, 0, st>>>(t, out);
    return static_cast<int>(cudaGetLastError());
}

// The step's `count` partials, summed in order: out[0] = gnorm, out[1] =
// the clip scale (1 where clip <= 0).
extern "C" int adamw_scale(const void* partials, int count, float clip, void* out,
                           void* stream) {
    adamw_scale_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(partials), count, clip, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

// Pass 2: the update of the table's leaves in place. scale, lr, bc1, bc2:
// fp32 device scalars.
extern "C" int adamw_fwd(const int64_t* table, int leaves, int p_dtype, int g_dtype,
                         int s_dtype, int blocks, const void* scale, const void* lr,
                         const void* bc1, const void* bc2, float b1, float omb1, float b2,
                         float omb2, float eps, float wd, void* stream) {
    LeafTable t;
    if (!make_table(table, leaves, t) || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    const Hyper h{b1, omb1, b2, omb2, eps, wd};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return p_dtype ? update_by_grad<bf16>(g_dtype, s_dtype, t, blocks, scale, lr, bc1, bc2, h, st)
                   : update_by_grad<float>(g_dtype, s_dtype, t, blocks, scale, lr, bc1, bc2, h, st);
}
