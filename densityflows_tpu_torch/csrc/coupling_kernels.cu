// Per-layer affine coupling kernels for Hopper (sm_90a): coupling_fwd, and
// coupling_bwd with its kernels coupling_product, coupling_pullback and
// coupling_bwd_reduce.
//
// They replace the two Pallas TPU kernels of the JAX package,
// densityflows_tpu/ops/pallas_coupling.py::_fwd_kernel and ::_bwd_kernel:
// one RealNVP or NICE coupling on 2-D row tiles. The conditioner input h
// (B, K = n + |id|) goes through the s- and t-MLPs (K -> H -> ... -> A, the
// last dense layer linear), then y * exp(s) + t (forward) or (y - t) * exp(-s)
// (inverse), NICE y +- t, and ldj = +-sum s (0 for NICE).
//
// What bounds them on this card: arithmetic. At the opt-in train step's
// shapes (K 24, A 16, H 256, three dense layers per net, 8192 rows) the
// forward does 2.5 GFLOP against 2.5 MB of I/O, the backward 7.5 GFLOP. No
// library: the backward's products are f32 FMA on the CUDA cores in this
// file's own loops; the forward's run on the tensor cores in 3xTF32 in the
// chain kernels' fold (wgmma_fold.cuh, hand-written too).
//
// coupling_fwd. The coupling as a one-coupling program of the chain
// kernels' format, folded on the tensor cores (coupling_fwd_tc_kernel, see
// "coupling_fwd on the tensor cores" below): 0.07 ms of device time at the
// shapes above on an H100, against 0.24 ms for the FMA body it replaced.
// Where the fold's tile does not fit a block at 16 rows (a hidden layer of
// some thousands), the FMA body runs (coupling_fwd_kernel): one block per
// tile of TB rows; the tile's input rows, two ping-pong hidden buffers and
// the two net outputs lie in shared memory; the weights of a coupling (610
// KB at hidden 256) do not fit there, so they stay in device memory and the
// L2 cache serves the blocks' re-reads. A thread of a dense layer owns one
// output column of RM rows, so one weight load serves RM FMAs. The ragged
// last tile is masked here: rows past B read zeros and are not written.
//
// coupling_bwd. Every product of the backward is a matrix product over all B
// rows: the forward again, U_i = A_i W_i + b_i (A_0 = h, A_{i+1} = act(U_i));
// the pullback delta_{i-1} = (delta_i W_i^T) * act'(U_{i-1}); the weight
// gradient dW_i = A_i^T delta_i, and db_i (the sum of delta_i over the rows)
// as the product of a column of ones with delta_i; and
// dh = delta_0^s W_0^s^T + delta_0^t W_0^t^T. (The first design recomputed
// both nets per 8-row tile and summed dW one element per thread over all
// rows: 3 % of the f32 rate.) One device routine, tile_product, computes an
// output tile of 128 x 128 (128 x 32 or 32 x 128 for the narrow products)
// with 256 threads, each owning a register tile of 8 x 8 (4 x 4). The
// reduction dimension is staged through shared memory in chunks of BK rows,
// STAGES deep: while one chunk is multiplied, cp.async brings the next ones
// (csrc/async_copy.cuh). An operand is read in the orientation the product
// needs by how its tile is loaded (element (o, r) at o * ld + r or at
// r * ld + o), so W serves as W and as W^T and nothing is transposed.
// Epilogues: bias and activation, keeping the pre-activation (the forward);
// times act'(U) in place over U (the pullback); plain stores (dh, dW).
//
// Launches, in order on one stream: each layer of the forward (one group of
// both nets' products); coupling_pullback, the coupling's pullback with g_ldj
// into ds; each layer of the backward (dW_i and delta_{i-1} of both nets, dh
// with the last); coupling_bwd_reduce. A dW product cuts the rows into
// `segs` fixed segments, one per block, and the reduction sums the segments
// in index order: no float atomics, two launches give the same bits. The
// workspace holds U_i, A_{i+1} and the nets' outputs for every row (68 MB at
// the main path) and the segments' partials.
//
// expf / tanhf / expm1f / log1pf are the full-precision ones (the build has
// no --use_fast_math). relu is written `u < 0 ? 0 : u`, which keeps a NaN.
//
// With DF_HOST_EMULATION defined the file compiles as plain C++ and the CPU
// tests run it, threads and blocks in either order (a thread's register tile
// is then its slice of a block-wide array: DF_PRIVATE / DF_MINE); the
// tensor-core fold (inline PTX) is left out, its weight tiling is not.
//
// C interface (ctypes): df_coupling_fwd_tc, df_coupling_fwd (the FMA body),
// df_coupling_bwd. Each launches on the given stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (or -2 when the
// shared memory or the workspace handed in is too small or the layout
// disagrees with the nets).

#ifndef DF_HOST_EMULATION
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#define DF_FN __device__ __forceinline__
// one phase: every thread of the block runs `body`, then the block meets
#define DF_PHASE(...)                                   \
    {                                                   \
        const int tid = threadIdx.x, nt = blockDim.x;   \
        (void)tid; (void)nt;                            \
        __VA_ARGS__;                                    \
    }                                                   \
    __syncthreads();
#define DF_HD __host__ __device__ inline
#define DF_NOINLINE __device__ __noinline__
// a thread's own array, kept across the phases of a block (registers)
#define DF_PRIVATE(type, name, n) type name[n]
#define DF_MINE(name, n) name
#else
#include <vector>
#define DF_HD static inline
#define DF_NOINLINE static
#define DF_PRIVATE(type, name, n) \
    std::vector<type> name((size_t)df_emulation_threads * (n))
#define DF_MINE(name, n) (name.data() + (size_t)tid * (n))
#endif

#include "async_copy.cuh"
#ifndef DF_HOST_EMULATION
#include "wgmma_fold.cuh"
#endif

namespace {

constexpr int MAX_LAYERS = 16;   // dense layers per net
constexpr int RM = 4;            // rows per thread of a dense layer
// activation codes (same order as ops/coupling_kernels.py::ACT_CODES)
enum : int { ACT_IDENTITY = 0, ACT_RELU = 1, ACT_TANH = 2, ACT_SIGMOID = 3,
             ACT_SILU = 4, ACT_GELU = 5, ACT_SOFTPLUS = 6, ACT_ELU = 7,
             ACT_LEAKY_RELU = 8 };
enum : int { KIND_NVP = 0, KIND_NICE = 1 };
enum : int { DIR_FWD = 0, DIR_INV = 1 };

struct Net {
    int n;                        // dense layers; 0: absent (NICE's s-net)
    int act;
    int dims[MAX_LAYERS + 1];     // [in, h1, ..., out]
    const float* w[MAX_LAYERS];   // (dims[i], dims[i + 1]), row-major
    const float* b[MAX_LAYERS];   // (dims[i + 1]) or null
    float* dw[MAX_LAYERS];
    float* db[MAX_LAYERS];
};

struct Args {
    Net net[2];                   // 0: the s-net, 1: the t-net
    const float* h; const float* y; const float* gy; const float* gldj;
    float* out; float* ldj;       // coupling_fwd
    float* dh; float* dy; float* ws;   // coupling_bwd; ws: the workspace
    int kind, dirn, with_ldj, B, K, A, tile;
};

// ---- sizes (the Python wrapper computes the same numbers) -----------------

DF_HD int hidden_max(const Args& a) {
    int h = 0;
    for (int w = 0; w < 2; ++w)
        for (int i = 1; i < a.net[w].n; ++i)
            h = a.net[w].dims[i] > h ? a.net[w].dims[i] : h;
    return h;
}

DF_HD long long fwd_shared_floats(const Args& a) {
    return (long long)a.tile * (a.K + 2 * hidden_max(a) + 2 * a.A);
}

// The backward's workspace of one net from `base`: U[i] and A[i + 1]
// (i < n - 1) and OUT (the net's output), B rows each; then P[i], the
// segments' partials of layer i: segs x (dims[i] + bias) x dims[i + 1].
struct NetWs {
    float* U[MAX_LAYERS];
    float* A[MAX_LAYERS];    // A[0] is h itself
    float* OUT;
    float* P[MAX_LAYERS];
};

DF_HD float* net_workspace(const Net& net, float* base, long long rows,
                           int segs, NetWs& ws) {
    for (int i = 0; i + 1 < net.n; ++i) {
        ws.U[i] = base; base += rows * net.dims[i + 1];
        ws.A[i + 1] = base; base += rows * net.dims[i + 1];
    }
    ws.OUT = base;
    if (net.n > 0) base += rows * net.dims[net.n];
    for (int i = 0; i < net.n; ++i) {
        ws.P[i] = base;
        base += (long long)segs * (net.dims[i] + (net.b[i] != nullptr)) *
                net.dims[i + 1];
    }
    return base;
}

// where delta_i lies: over U[i], or in OUT for the last layer
DF_HD float* delta_of(const Net& net, const NetWs& ws, int i) {
    return i == net.n - 1 ? ws.OUT : ws.U[i];
}

// ---- activations --------------------------------------------------------

DF_FN float sigmoid_f(float u) { return 1.f / (1.f + expf(-u)); }

DF_FN float act_fn(int act, float u) {
    switch (act) {
        // not fmaxf: it would swallow a NaN, which the plain version keeps
        case ACT_RELU: return u < 0.f ? 0.f : u;
        case ACT_TANH: return tanhf(u);
        case ACT_SIGMOID: return sigmoid_f(u);
        case ACT_SILU: return u * sigmoid_f(u);
        case ACT_GELU: {
            const float inner = 0.7978845608028654f * (u + 0.044715f * u * u * u);
            return 0.5f * u * (1.f + tanhf(inner));
        }
        // log(1 + e^u) as jax.nn.softplus computes it (logaddexp(u, 0))
        case ACT_SOFTPLUS: return fmaxf(u, 0.f) + log1pf(expf(-fabsf(u)));
        case ACT_ELU: return u > 0.f ? u : expm1f(u);
        case ACT_LEAKY_RELU: return u >= 0.f ? u : 0.01f * u;
        default: return u;
    }
}

// act'(u) from the PRE-activation u
DF_FN float dact_fn(int act, float u) {
    switch (act) {
        case ACT_RELU: return u > 0.f ? 1.f : 0.f;
        case ACT_TANH: {
            const float th = tanhf(u);
            return 1.f - th * th;
        }
        case ACT_SIGMOID: {
            const float s = sigmoid_f(u);
            return s * (1.f - s);
        }
        case ACT_SILU: {
            const float s = sigmoid_f(u);
            return s * (1.f + u * (1.f - s));
        }
        case ACT_GELU: {
            const float c = 0.7978845608028654f;
            const float th = tanhf(c * (u + 0.044715f * u * u * u));
            const float dinner = c * (1.f + 3.f * 0.044715f * u * u);
            return 0.5f * (1.f + th) + 0.5f * u * (1.f - th * th) * dinner;
        }
        case ACT_SOFTPLUS: return sigmoid_f(u);
        case ACT_ELU: return u > 0.f ? 1.f : expf(u);
        case ACT_LEAKY_RELU: return u >= 0.f ? 1.f : 0.01f;
        default: return 1.f;
    }
}

// ---- phases of a tile ---------------------------------------------------

// rows [row0, row0 + TB) of a (B, W) array; rows past B are zeros
DF_FN void load_rows(float* dst, const float* src, int W, int B, int row0,
                     int TB, int tid, int nt) {
    for (int idx = tid; idx < TB * W; idx += nt) {
        const int g = row0 + idx / W;
        dst[idx] = g < B ? src[(long long)row0 * W + idx] : 0.f;
    }
}

// u = in[TB, Kd] @ W[Kd, N] + bias. `pre` (if not null) gets u, `out` (if
// not null) gets act(u), or u for the last layer. An item is one column c of
// RM rows; the sum over k runs in order.
DF_FN void dense(const float* in, int Kd, const float* W, const float* bias,
                 int N, int act, bool last, float* out, float* pre, int TB,
                 int tid, int nt) {
    const int groups = (TB + RM - 1) / RM;
    for (int item = tid; item < groups * N; item += nt) {
        const int g = item / N, c = item - g * N, r0 = g * RM;
        int rows[RM];
        for (int j = 0; j < RM; ++j)
            rows[j] = r0 + j < TB ? r0 + j : TB - 1;
        float acc[RM];
        for (int j = 0; j < RM; ++j) acc[j] = 0.f;
        const float* wc = W + c;
        for (int k = 0; k < Kd; ++k) {
            const float w = wc[(long long)k * N];
            for (int j = 0; j < RM; ++j)
                acc[j] = fmaf(in[rows[j] * Kd + k], w, acc[j]);
        }
        const float b = bias != nullptr ? bias[c] : 0.f;
        for (int j = 0; j < RM; ++j) {
            if (r0 + j >= TB) break;
            const float u = bias != nullptr ? acc[j] + b : acc[j];
            const int o = (r0 + j) * N + c;
            if (pre != nullptr) pre[o] = u;
            if (out != nullptr) out[o] = last ? u : act_fn(act, u);
        }
    }
}

// The coupling update, one thread per row (the ldj sums columns in order).
DF_FN void couple_fwd(const Args& a, const float* so, const float* to,
                      int row0, int TB, int tid, int nt) {
    const int A = a.A;
    for (int r = tid; r < TB; r += nt) {
        const long long g = row0 + r;
        if (g >= a.B) continue;
        const float* y = a.y + g * A;
        float* o = a.out + g * A;
        float sum = 0.f;
        for (int j = 0; j < A; ++j) {
            const float t = to[r * A + j];
            if (a.kind == KIND_NVP) {
                const float s = so[r * A + j];
                sum += s;
                o[j] = a.dirn == DIR_FWD ? y[j] * expf(s) + t
                                         : (y[j] - t) * expf(-s);
            } else {
                o[j] = a.dirn == DIR_FWD ? y[j] + t : y[j] - t;
            }
        }
        if (a.with_ldj)
            a.ldj[g] = a.kind == KIND_NVP ? (a.dirn == DIR_FWD ? sum : -sum)
                                          : 0.f;
    }
}

// ---- coupling_bwd: products over all rows ---------------------------------

constexpr int PT = 256;        // threads of a product block
// The reduction is staged in chunks of BK rows, STAGES chunks in shared
// memory at once: the copies of the next STAGES - 1 fly while one is
// multiplied. 32 and 3 were the fastest of BK 16 / 32 and STAGES 2 / 3 on an
// H100 (by 2-5 %, timed in turns in one call).
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int PAD = 4;         // floats after each staged row (banks)
constexpr int MAX_PROBS = 8;   // products of one launch
// register-tile configurations: BM x BN output tile, FM x FN fragments of 4
// x 4 per thread (rows f * BM / FM + 4 ty + i, columns g * BN / FN + 4 tx + j)
enum : int { CFG_WIDE = 0, CFG_NARROW_N = 1, CFG_NARROW_M = 2 };
// epilogues
enum : int { E_FWD_HIDDEN = 0, E_FWD_LAST = 1, E_DELTA = 2, E_STORE = 3 };

// element (o, r) of an operand: p[o * ld + r] (red: the reduction index r
// runs along memory) or p[r * ld + o]
struct Operand {
    const float* p;
    int ld, red;
};

// one stretch of the reduction: rows r0 .. r1 of A (M x R) and B (N x R)
struct Part {
    Operand a, b;
    int r0, r1;
};

struct Prob {
    int epi, cfg, act;
    int M, N;            // the output
    int ones;            // A's outer index that reads as 1 (db), or -1
    int n_parts;
    Part part[2];
    int segs;            // > 1: part 0 is cut into segments, one per block
    const float* bias;   // E_FWD_*
    float* out;          // E_FWD_HIDDEN: U; E_FWD_LAST / E_STORE: out;
                         // E_DELTA: U read and overwritten by the delta
    float* out2;         // E_FWD_HIDDEN: act(U)
    long long seg_stride;  // E_STORE over segments: floats between partials
    int tiles_m, tiles_n;
};

struct Group {
    int n;
    int first[MAX_PROBS + 1];    // first block of each product, then the total
    Prob p[MAX_PROBS];
};

template <int CFG> struct Tile;
template <> struct Tile<CFG_WIDE> {
    static constexpr int BM = 128, BN = 128, FM = 2, FN = 2;
};
template <> struct Tile<CFG_NARROW_N> {
    static constexpr int BM = 128, BN = 32, FM = 1, FN = 1;
};
template <> struct Tile<CFG_NARROW_M> {
    static constexpr int BM = 32, BN = 128, FM = 1, FN = 1;
};

DF_HD int tile_bm(int cfg) {
    return cfg == CFG_NARROW_M ? 32 : 128;
}
DF_HD int tile_bn(int cfg) {
    return cfg == CFG_NARROW_N ? 32 : 128;
}
// floats of one staged chunk of a configuration (A's rows, then B's)
DF_HD int stage_floats(int cfg) {
    return BK * (tile_bm(cfg) + PAD + tile_bn(cfg) + PAD);
}
constexpr int PRODUCT_SHARED_FLOATS = STAGES * BK * (128 + PAD + 128 + PAD);

// The rows [lo, hi) of part 0 that segment `seg` sums
DF_FN void seg_range(const Prob& p, int seg, int& lo, int& hi) {
    lo = p.part[0].r0;
    hi = p.part[0].r1;
    if (p.segs > 1) {
        const int len = (hi - lo + p.segs - 1) / p.segs;
        lo = lo + seg * len;
        hi = lo + len < hi ? lo + len : hi;
    }
}

// The reduction chunk c of a block of segment `seg`: which part, which rows.
DF_FN void chunk_of(const Prob& p, int seg, int c, int& part, int& r,
                    int& r_end) {
    int lo, hi;
    seg_range(p, seg, lo, hi);
    const int c0 = hi > lo ? (hi - lo + BK - 1) / BK : 0;
    if (c < c0) {
        part = 0; r = lo + c * BK; r_end = hi;
    } else {
        part = 1; r = p.part[1].r0 + (c - c0) * BK; r_end = p.part[1].r1;
    }
}

DF_FN int chunk_count(const Prob& p, int seg) {
    int lo, hi;
    seg_range(p, seg, lo, hi);
    int c = hi > lo ? (hi - lo + BK - 1) / BK : 0;
    if (p.n_parts > 1 && p.part[1].r1 > p.part[1].r0)
        c += (p.part[1].r1 - p.part[1].r0 + BK - 1) / BK;
    return c;
}

// Stage rows r .. r + BK of an operand's tile (outer o0 .. o0 + BO) as
// dst[rr * (BO + PAD) + o]. Consecutive threads take consecutive addresses
// of device memory. Outside the operand: 0, or 1 on A's `ones` index.
template <int BO>
DF_FN void stage_operand(const Operand& op, int dim, int ones, int o0, int r,
                         int r_end, float* dst, int tid) {
    constexpr int LD = BO + PAD;
    for (int e = tid; e < BK * BO; e += PT) {
        int o, rr;
        if (op.red) { rr = e % BK; o = e / BK; }
        else { o = e % BO; rr = e / BO; }
        const int og = o0 + o, rg = r + rr;
        float* d = dst + rr * LD + o;
        const bool in = rg < r_end;
        if (in && og < dim) {
            df_cp_async4(d, op.red ? op.p + (long long)og * op.ld + rg
                                   : op.p + (long long)rg * op.ld + og, true);
        } else {
            *d = in && og == ones ? 1.f : 0.f;
        }
    }
}

template <int CFG>
DF_FN void stage_chunk(const Prob& p, int seg, int c, float* stage, int m0,
                       int n0, int tid) {
    using T = Tile<CFG>;
    int part, r, r_end;
    chunk_of(p, seg, c, part, r, r_end);
    const Part& pt = p.part[part];
    stage_operand<T::BM>(pt.a, p.M - (p.ones >= 0), p.ones, m0, r, r_end,
                         stage, tid);
    stage_operand<T::BN>(pt.b, p.N, -1, n0, r, r_end,
                         stage + BK * (T::BM + PAD), tid);
}

// 4 floats of shared memory (16-byte aligned)
DF_FN void shared4(const float* s, float* v) {
#ifndef DF_HOST_EMULATION
    const float4 q = *reinterpret_cast<const float4*>(s);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
#else
    for (int i = 0; i < 4; ++i) v[i] = s[i];
#endif
}

// acc += the staged chunk's A^T B for this thread's register tile; the sum
// over the chunk's rows runs in order
template <int CFG>
DF_FN void multiply_chunk(const float* stage, float* acc, int tid) {
    using T = Tile<CFG>;
    constexpr int TX = T::BN / (4 * T::FN), RM = 4 * T::FM, RN = 4 * T::FN;
    const int ty = tid / TX, tx = tid % TX;
    const float* As = stage;
    const float* Bs = stage + BK * (T::BM + PAD);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
        float a[RM], b[RN];
#pragma unroll
        for (int f = 0; f < T::FM; ++f)
            shared4(As + k * (T::BM + PAD) + f * (T::BM / T::FM) + 4 * ty,
                    a + 4 * f);
#pragma unroll
        for (int g = 0; g < T::FN; ++g)
            shared4(Bs + k * (T::BN + PAD) + g * (T::BN / T::FN) + 4 * tx,
                    b + 4 * g);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j)
                acc[i * RN + j] = fmaf(a[i], b[j], acc[i * RN + j]);
    }
}

// The epilogue's elementwise work on 4 consecutive outputs, one call per 4
// (not inlined into every element of the unrolled register tile)
struct V4 {
    float v[4];
};

DF_NOINLINE V4 act4(int act, V4 u) {
    for (int j = 0; j < 4; ++j) u.v[j] = act_fn(act, u.v[j]);
    return u;
}

// d * act'(u), elementwise
DF_NOINLINE V4 dact4(int act, V4 u, V4 d) {
    for (int j = 0; j < 4; ++j) d.v[j] *= dact_fn(act, u.v[j]);
    return d;
}

// the same two for relu, inline (the conditioners' default activation)
DF_FN V4 relu4(V4 u) {
    for (int j = 0; j < 4; ++j) u.v[j] = act_fn(ACT_RELU, u.v[j]);
    return u;
}

DF_FN V4 drelu4(V4 u, V4 d) {
    for (int j = 0; j < 4; ++j) d.v[j] *= dact_fn(ACT_RELU, u.v[j]);
    return d;
}

// n <= 4 floats of device memory (one 16-byte load where vec)
DF_FN void load4(const float* src, V4& x, int n, bool vec) {
    if (vec) {
#ifndef DF_HOST_EMULATION
        const float4 q = *reinterpret_cast<const float4*>(src);
        x.v[0] = q.x; x.v[1] = q.y; x.v[2] = q.z; x.v[3] = q.w;
#else
        for (int j = 0; j < 4; ++j) x.v[j] = src[j];
#endif
    } else {
        for (int j = 0; j < 4; ++j) x.v[j] = j < n ? src[j] : 0.f;
    }
}

DF_FN void store4(float* dst, const V4& x, int n, bool vec) {
    if (vec) {
#ifndef DF_HOST_EMULATION
        *reinterpret_cast<float4*>(dst) =
            make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
#else
        for (int j = 0; j < 4; ++j) dst[j] = x.v[j];
#endif
    } else {
        for (int j = 0; j < n; ++j) dst[j] = x.v[j];
    }
}

// Each thread's register tile out, 4 consecutive columns at a time (one
// 16-byte store where the output's rows allow it). The bias of the thread's
// columns is read once, and an E_DELTA row reads its U before it stores.
template <int CFG>
DF_FN void epilogue(const Prob& p, const float* acc, int m0, int n0, int seg,
                    int tid) {
    using T = Tile<CFG>;
    constexpr int TX = T::BN / (4 * T::FN), RN = 4 * T::FN;
    const int ty = tid / TX, tx = tid % TX;
    float* out = p.out + (long long)seg * p.seg_stride;
    const bool aligned =
        p.N % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
        (reinterpret_cast<uintptr_t>(p.out2) & 15) == 0;
    float bias[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) {
        const int n = n0 + (j / 4) * (T::BN / T::FN) + 4 * tx + j % 4;
        bias[j] = p.bias != nullptr && n < p.N ? p.bias[n] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4 * T::FM; ++i) {
        const int m = m0 + (i / 4) * (T::BM / T::FM) + 4 * ty + i % 4;
        if (m >= p.M) continue;
        V4 v[T::FN], u[T::FN];
        int cnt[T::FN];
        // the row's values, and (E_DELTA) its U, before any of its stores
#pragma unroll
        for (int g = 0; g < T::FN; ++g) {
            const int n = n0 + g * (T::BN / T::FN) + 4 * tx;
            cnt[g] = p.N - n < 0 ? 0 : (p.N - n < 4 ? p.N - n : 4);
#pragma unroll
            for (int j = 0; j < 4; ++j) v[g].v[j] = acc[i * RN + 4 * g + j];
            if (p.epi == E_DELTA)
                load4(p.out + (long long)m * p.N + n, u[g], cnt[g],
                      aligned && cnt[g] == 4);
        }
#pragma unroll
        for (int g = 0; g < T::FN; ++g) {
            if (cnt[g] == 0) continue;
            const int n = n0 + g * (T::BN / T::FN) + 4 * tx;
            const bool vec = aligned && cnt[g] == 4;
            const long long o = (long long)m * p.N + n;
            if (p.epi == E_FWD_HIDDEN || p.epi == E_FWD_LAST) {
#pragma unroll
                for (int j = 0; j < 4; ++j) v[g].v[j] += bias[4 * g + j];
                store4(p.out + o, v[g], cnt[g], vec);
                if (p.epi == E_FWD_HIDDEN)
                    store4(p.out2 + o, p.act == ACT_RELU ? relu4(v[g])
                                                         : act4(p.act, v[g]),
                           cnt[g], vec);
            } else if (p.epi == E_DELTA) {
                store4(p.out + o, p.act == ACT_RELU ? drelu4(u[g], v[g])
                                                    : dact4(p.act, u[g], v[g]),
                       cnt[g], vec);
            } else {
                store4(out + o, v[g], cnt[g], vec);
            }
        }
    }
}

// One output tile (and, for dW, one segment of the rows): the chunks of the
// reduction staged two at a time, the next one copied while this one is
// multiplied; each thread's register tile summed in chunk order.
template <int CFG>
DF_FN void tile_product(const Prob& p, float* S, int tm, int tn, int seg) {
    using T = Tile<CFG>;
    constexpr int ACC = 16 * T::FM * T::FN;
    const int m0 = tm * T::BM, n0 = tn * T::BN;
    const int n_chunks = chunk_count(p, seg);
    const int SF = stage_floats(CFG);
    DF_PRIVATE(float, acc_, ACC);
    // the first STAGES - 1 chunks in flight; every phase commits one group
    // (empty past the last chunk), so that waiting for all but the newest
    // STAGES - 2 groups leaves the next chunk in place
    DF_PHASE(
        float* acc = DF_MINE(acc_, ACC);
        for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
        for (int c = 0; c < STAGES - 1; ++c) {
            if (c < n_chunks) stage_chunk<CFG>(p, seg, c, S + c * SF, m0, n0,
                                               tid);
            df_cp_async_commit();
        }
        df_cp_async_wait_group<STAGES - 2>();
    )
    for (int c = 0; c < n_chunks; ++c) {
        DF_PHASE(
            float* acc = DF_MINE(acc_, ACC);
            const int next = c + STAGES - 1;
            if (next < n_chunks)
                stage_chunk<CFG>(p, seg, next, S + (next % STAGES) * SF, m0,
                                 n0, tid);
            df_cp_async_commit();
            multiply_chunk<CFG>(S + (c % STAGES) * SF, acc, tid);
            df_cp_async_wait_group<STAGES - 2>();
        )
    }
    DF_PHASE(epilogue<CFG>(p, DF_MINE(acc_, ACC), m0, n0, seg, tid))
}

// Block `block` of a launch: its product, output tile and segment.
DF_FN void product_block(const Group& g, float* S, int block) {
    int j = 0;
    while (j + 1 < g.n && block >= g.first[j + 1]) ++j;
    const Prob& p = g.p[j];
    const int local = block - g.first[j];
    const int per_seg = p.tiles_m * p.tiles_n;
    const int seg = local / per_seg, rem = local - seg * per_seg;
    const int tm = rem / p.tiles_n, tn = rem - tm * p.tiles_n;
    if (p.cfg == CFG_WIDE)
        tile_product<CFG_WIDE>(p, S, tm, tn, seg);
    else if (p.cfg == CFG_NARROW_N)
        tile_product<CFG_NARROW_N>(p, S, tm, tn, seg);
    else
        tile_product<CFG_NARROW_M>(p, S, tm, tn, seg);
}

// The coupling's pullback, one element of (B, A) per item:
//   forward  x = y e^s + t, ldj = +sum s:  dy = g e^s, dt = g,
//                                          ds = g y e^s + g_ldj
//   inverse  z = (y - t) e^-s, ldj = -sum s: dy = g e^-s, dt = -g e^-s,
//                                            ds = -g z - g_ldj
//   NICE: dy = g, dt = +-g.
// ds / dt replace s / t in the nets' output buffers; dy goes out.
DF_FN void pullback_item(const Args& a, float* ds, float* dt, long long idx) {
    const int A = a.A;
    const long long g = idx / A;
    const float gv = a.gy[idx];
    float dy;
    if (a.kind == KIND_NVP) {
        const float s = ds[idx], t = dt[idx], yv = a.y[idx];
        if (a.dirn == DIR_FWD) {
            const float es = expf(s);
            dy = gv * es;
            dt[idx] = gv;
            ds[idx] = gv * yv * es + a.gldj[g];
        } else {
            const float ems = expf(-s);
            const float z = (yv - t) * ems;
            dy = gv * ems;
            dt[idx] = -dy;
            ds[idx] = -gv * z - a.gldj[g];
        }
    } else {
        dy = gv;
        dt[idx] = a.dirn == DIR_FWD ? gv : -gv;
    }
    a.dy[idx] = dy;
}

// Entry `idx` of all dW / db (per net, per layer: dW row-major, then db):
// the segments' partials summed in index order.
DF_FN void reduce_item(const Args& a, int segs, long long idx) {
    float* base = a.ws;
    for (int w = 0; w < 2; ++w) {
        const Net& net = a.net[w];
        NetWs ws;
        base = net_workspace(net, base, a.B, segs, ws);
        for (int i = 0; i < net.n; ++i) {
            const int Kd = net.dims[i], N = net.dims[i + 1];
            const int rows = Kd + (net.b[i] != nullptr);
            const long long items = (long long)rows * N;
            if (idx < items) {
                float acc = 0.f;
                for (int s = 0; s < segs; ++s) acc += ws.P[i][s * items + idx];
                if (idx < (long long)Kd * N) net.dw[i][idx] = acc;
                else net.db[i][idx - (long long)Kd * N] = acc;
                return;
            }
            idx -= items;
        }
    }
}

// ---- the launches of coupling_bwd ------------------------------------------

DF_HD int pick_cfg(int M, int N) {
    return N <= 32 ? CFG_NARROW_N : (M <= 32 ? CFG_NARROW_M : CFG_WIDE);
}

DF_HD void add_prob(Group& g, const Prob& p0, int segs) {
    Prob p = p0;
    p.cfg = pick_cfg(p.M, p.N);
    p.segs = segs;
    p.tiles_m = (p.M + tile_bm(p.cfg) - 1) / tile_bm(p.cfg);
    p.tiles_n = (p.N + tile_bn(p.cfg) - 1) / tile_bn(p.cfg);
    g.first[g.n + 1] = g.first[g.n] + p.tiles_m * p.tiles_n * segs;
    g.p[g.n++] = p;
}

DF_HD Prob blank_prob() {
    Prob p = {};
    p.ones = -1;
    p.n_parts = 1;
    p.segs = 1;
    return p;
}

// The groups of one coupling_bwd, in launch order: `fwd` forward layers,
// then the backward layers; the caller puts the pullback between them.
// Returns the number of groups.
DF_HD int plan_groups(const Args& a, int segs, NetWs* ws, Group* groups,
                      int& fwd) {
    int depth = 0;
    for (int w = 0; w < 2; ++w)
        depth = a.net[w].n > depth ? a.net[w].n : depth;
    int k = 0;
    for (int j = 0; j < depth; ++j, ++k) {
        Group& g = groups[k];
        g = Group{};
        for (int w = 0; w < 2; ++w) {
            const Net& net = a.net[w];
            if (j >= net.n) continue;
            Prob p = blank_prob();
            const bool last = j == net.n - 1;
            p.epi = last ? E_FWD_LAST : E_FWD_HIDDEN;
            p.act = net.act;
            p.M = a.B;
            p.N = net.dims[j + 1];
            const float* in = j == 0 ? a.h : ws[w].A[j];
            p.part[0] = Part{Operand{in, net.dims[j], 1},
                             Operand{net.w[j], net.dims[j + 1], 0}, 0,
                             net.dims[j]};
            p.bias = net.b[j];
            p.out = last ? ws[w].OUT : ws[w].U[j];
            p.out2 = last ? nullptr : ws[w].A[j + 1];
            add_prob(g, p, 1);
        }
    }
    fwd = k;
    for (int j = 0; j < depth; ++j, ++k) {
        Group& g = groups[k];
        g = Group{};
        for (int w = 0; w < 2; ++w) {
            const Net& net = a.net[w];
            if (j >= net.n) continue;
            const int i = net.n - 1 - j;
            const float* ai = i == 0 ? a.h : ws[w].A[i];
            float* di = delta_of(net, ws[w], i);
            const int Kd = net.dims[i], N = net.dims[i + 1];
            // dW_i = A_i^T delta_i over the rows, by segment
            Prob p = blank_prob();
            p.epi = E_STORE;
            p.M = Kd;
            p.N = N;
            p.part[0] = Part{Operand{ai, Kd, 0}, Operand{di, N, 0}, 0, a.B};
            p.out = ws[w].P[i];
            p.seg_stride = (long long)(Kd + (net.b[i] != nullptr)) * N;
            add_prob(g, p, segs);
            if (net.b[i] != nullptr) {
                // db_i = 1^T delta_i: the same product with A a column of
                // ones, into the partials' row after dW_i's
                Prob q = p;
                q.M = 1;
                q.ones = 0;
                q.out = ws[w].P[i] + (long long)Kd * N;
                add_prob(g, q, segs);
            }
            if (i >= 1) {
                // delta_{i-1} = (delta_i W_i^T) * act'(U_{i-1}), over U_{i-1}
                Prob q = blank_prob();
                q.epi = E_DELTA;
                q.act = net.act;
                q.M = a.B;
                q.N = Kd;
                q.part[0] = Part{Operand{di, N, 1}, Operand{net.w[i], N, 1},
                                 0, N};
                q.out = ws[w].U[i - 1];
                add_prob(g, q, 1);
            }
        }
        if (j == depth - 1) {
            // dh = sum over the nets of delta_0 W_0^T
            Prob p = blank_prob();
            p.epi = E_STORE;
            p.M = a.B;
            p.N = a.K;
            p.n_parts = 0;
            for (int w = 0; w < 2; ++w) {
                const Net& net = a.net[w];
                if (net.n == 0) continue;
                const int N = net.dims[1];
                p.part[p.n_parts++] = Part{
                    Operand{delta_of(net, ws[w], 0), N, 1},
                    Operand{net.w[0], N, 1}, 0, N};
            }
            p.out = a.dh;
            add_prob(g, p, 1);
        }
    }
    return k;
}

// ---- the forward kernel's body ---------------------------------------------

DF_FN void fwd_body(const Args& a, float* S, int tile) {
    const int TB = a.tile, K = a.K, A = a.A, row0 = tile * TB;
    const int hmax = hidden_max(a);
    float* H = S;
    float* P = H + TB * K;
    float* Q = P + TB * hmax;
    float* so = Q + TB * hmax;
    float* to = so + TB * A;
    DF_PHASE(load_rows(H, a.h, K, a.B, row0, TB, tid, nt))
    for (int w = 0; w < 2; ++w) {
        const Net& net = a.net[w];
        const float* in = H;
        for (int i = 0; i < net.n; ++i) {
            const bool last = i == net.n - 1;
            float* o = last ? (w == 0 ? so : to) : (i % 2 ? Q : P);
            DF_PHASE(dense(in, net.dims[i], net.w[i], net.b[i], net.dims[i + 1],
                           net.act, last, o, nullptr, TB, tid, nt))
            in = o;
        }
    }
    DF_PHASE(couple_fwd(a, so, to, row0, TB, tid, nt))
}

// ---- coupling_fwd on the tensor cores --------------------------------------
//
// The coupling as a one-coupling program of the chain kernels' format
// (ops/coupling_kernels.py::tc_plan: each net's dense layers, the s-net's
// into BUF_S and the t-net's into BUF_T, then OP_COUPLE), folded by
// wgmma_fold.cuh's apply_tile with h as the tile's theta part and y as its
// x part. Its weights change with every train step, so each call first
// lays them out as the fold streams them: coupling_tile_kernel writes the
// biases, each zero-padded to a multiple of 4, then every dense layer's
// chunks in the order and the core-matrix layout of
// ops/chain_kernels.py::tile_weights, into the workspace (one thread per
// float, read from the row-major weights as they lie).

constexpr int TC_LAYERS = 2 * MAX_LAYERS;

// the dense layers of both nets in program order (ops/coupling_kernels.py::
// tc_plan gives K, N and the two offsets of each)
struct TcPack {
    int n_layers;
    long long bias_floats, total;   // the bias area; it + the chunks
    const float* w[TC_LAYERS];
    const float* b[TC_LAYERS];
    int K[TC_LAYERS], N[TC_LAYERS];
    long long t_off[TC_LAYERS];     // first float of its chunks, after the
                                    // bias area
    int b_off[TC_LAYERS];           // its bias in the bias area, or -1
    float* ws;
};

// columns of a chunk by the columns a pass of 256 has left (wgmma_fold.cuh's
// chunk_cols, which the host build does not see)
DF_HD int tc_chunk_cols(int left) {
    return left <= 32 ? 32 : (left <= 128 ? 128 : 256);
}

// float i of the workspace
DF_HD void tile_item(const TcPack& p, long long i) {
    if (i < p.bias_floats) {
        for (int l = 0; l < p.n_layers; ++l) {
            const int bo = p.b_off[l];
            if (bo < 0 || i < bo || i >= bo + ((p.N[l] + 3) & ~3)) continue;
            const int j = (int)(i - bo);
            p.ws[i] = j < p.N[l] ? p.b[l][j] : 0.f;
            return;
        }
        p.ws[i] = 0.f;
        return;
    }
    const long long o = i - p.bias_floats;
    int l = 0;
    while (l + 1 < p.n_layers && o >= p.t_off[l + 1]) ++l;
    long long off = o - p.t_off[l];
    const int K = p.K[l], N = p.N[l];
    const int K4 = (K + 3) & ~3, N4 = (N + 3) & ~3, k16 = (K4 + 15) / 16 * 16;
    for (int c0 = 0; c0 < N4; c0 += 256) {
        const int cw = tc_chunk_cols(N4 - c0);
        const long long pass = (long long)k16 * cw;
        if (off >= pass) {
            off -= pass;
            continue;
        }
        const int chunk = (int)(off / (16 * cw)), e = (int)(off % (16 * cw));
        const int cm = e / 32, q = e % 32;
        const int n = c0 + (cm / 4) * 8 + q / 4;
        const int k = chunk * 16 + (cm % 4) * 4 + q % 4;
        p.ws[i] = k < K && n < N ? p.w[l][(long long)k * N + n] : 0.f;
        return;
    }
}

// ---- arguments ------------------------------------------------------------

// iargs: kind, dirn, with_ldj, B, K, A, tile, then per net (s, t): n, act,
// has_bias, dims[0..n]. ptrs: h, y, gy, gldj, out, ldj, dh, dy, ws, then
// per net: w[0..n), b[0..n) (with bias), then only where the backward runs
// (grads != 0) dw[0..n), db[0..n) (with bias).
Args make_args(const long long* p, const int* ia, int grads) {
    Args a;
    a.kind = ia[0]; a.dirn = ia[1]; a.with_ldj = ia[2]; a.B = ia[3];
    a.K = ia[4]; a.A = ia[5]; a.tile = ia[6];
    a.h = (const float*)p[0]; a.y = (const float*)p[1];
    a.gy = (const float*)p[2]; a.gldj = (const float*)p[3];
    a.out = (float*)p[4]; a.ldj = (float*)p[5];
    a.dh = (float*)p[6]; a.dy = (float*)p[7]; a.ws = (float*)p[8];
    int q = 7, k = 9;
    for (int w = 0; w < 2; ++w) {
        Net& net = a.net[w];
        net.n = ia[q]; net.act = ia[q + 1];
        const int bias = ia[q + 2];
        q += 3;
        for (int i = 0; i < MAX_LAYERS + 1; ++i)
            net.dims[i] = i <= net.n ? ia[q + i] : 0;
        q += net.n + 1;
        for (int i = 0; i < MAX_LAYERS; ++i) {
            net.w[i] = nullptr; net.b[i] = nullptr;
            net.dw[i] = nullptr; net.db[i] = nullptr;
        }
        for (int i = 0; i < net.n; ++i) net.w[i] = (const float*)p[k++];
        if (bias)
            for (int i = 0; i < net.n; ++i) net.b[i] = (const float*)p[k++];
        if (grads) {
            for (int i = 0; i < net.n; ++i) net.dw[i] = (float*)p[k++];
            if (bias)
                for (int i = 0; i < net.n; ++i) net.db[i] = (float*)p[k++];
        }
    }
    return a;
}

// The backward's plan: the nets' workspaces and the product groups. Returns
// -2 where the workspace handed in is too small.
struct BwdPlan {
    NetWs ws[2];
    Group groups[2 * MAX_LAYERS];
    int n_groups, fwd;
    long long pull_items, reduce_items;
};

int plan_bwd(const Args& a, long long ws_floats, int segs, BwdPlan& bp) {
    float* base = a.ws;
    for (int w = 0; w < 2; ++w)
        base = net_workspace(a.net[w], base, a.B, segs, bp.ws[w]);
    if (base - a.ws > ws_floats) return -2;
    bp.n_groups = plan_groups(a, segs, bp.ws, bp.groups, bp.fwd);
    bp.pull_items = (long long)a.B * a.A;
    bp.reduce_items = 0;
    for (int w = 0; w < 2; ++w) {
        const Net& net = a.net[w];
        for (int i = 0; i < net.n; ++i)
            bp.reduce_items += (long long)(net.dims[i] + (net.b[i] != nullptr))
                               * net.dims[i + 1];
    }
    return 0;
}

// layout: per dense layer of the program K, N, chunk offset, bias offset
// (ops/coupling_kernels.py::tc_plan). Returns -2 where it disagrees with the
// nets' shapes.
int make_tc_pack(const Args& a, const int* layout, int n_layers,
                 long long bias_floats, long long tiled_floats, TcPack& p) {
    if (n_layers < 1 || n_layers > TC_LAYERS) return -2;
    p.n_layers = n_layers;
    p.bias_floats = bias_floats;
    p.total = bias_floats + tiled_floats;
    p.ws = a.ws;
    int l = 0;
    for (int w = 0; w < 2; ++w) {
        const Net& net = a.net[w];
        for (int i = 0; i < net.n; ++i, ++l) {
            if (l >= n_layers) return -2;
            const int* q = layout + 4 * l;
            if (q[0] != net.dims[i] || q[1] != net.dims[i + 1]) return -2;
            p.w[l] = net.w[i];
            p.b[l] = net.b[i];
            p.K[l] = q[0];
            p.N[l] = q[1];
            p.t_off[l] = q[2];
            p.b_off[l] = net.b[i] != nullptr ? q[3] : -1;
        }
    }
    return l == n_layers ? 0 : -2;
}

#ifndef DF_HOST_EMULATION
__global__ void __launch_bounds__(256)
coupling_fwd_kernel(const __grid_constant__ Args a) {
    extern __shared__ float4 smem4[];
    fwd_body(a, reinterpret_cast<float*>(smem4), blockIdx.x);
}

__global__ void __launch_bounds__(256)
coupling_tile_kernel(const __grid_constant__ TcPack p) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < p.total) tile_item(p, i);
}

// rows blockIdx.x * TB .. + TB: y (B, A) as the tile's x part, h (B, K) as
// its theta part
template <int TB>
__global__ void __launch_bounds__(wgf::THREADS, 1)
coupling_fwd_tc_kernel(const float* __restrict__ y,
                       const float* __restrict__ h, float* __restrict__ out,
                       float* __restrict__ ldj, const int* __restrict__ prog,
                       int n_instr, const float* __restrict__ P,
                       const float* __restrict__ tiled, long long rows, int A,
                       int K, int ldh) {
    extern __shared__ float4 smem4[];
    wgf::apply_tile<TB>(reinterpret_cast<float*>(smem4), y, h, out, ldj, prog,
                        n_instr, P, tiled, rows, A, K, ldh);
}

__global__ void __launch_bounds__(PT, 2)
coupling_product_kernel(const __grid_constant__ Group g) {
    extern __shared__ float4 smem4[];
    product_block(g, reinterpret_cast<float*>(smem4), blockIdx.x);
}

// raise a kernel's dynamic shared memory limit once per device (a call
// costs as much as a launch)
int raise_shared(const void* kernel, int bytes, int* done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (bytes > done[dev]) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return (int)err;
        done[dev] = bytes;
    }
    return 0;
}

__global__ void __launch_bounds__(256)
coupling_pullback_kernel(const __grid_constant__ Args a, float* ds,
                         float* dt, long long items) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < items) pullback_item(a, ds, dt, i);
}

__global__ void __launch_bounds__(256)
coupling_bwd_reduce_kernel(const __grid_constant__ Args a, int segs,
                           long long items) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < items) reduce_item(a, segs, i);
}

template <int TB>
int launch_fwd_tc(const Args& a, const int* prog, int n_instr,
                  long long bias_floats, int ldh, cudaStream_t s) {
    static int attr_bytes[64] = {};
    const int bytes = (int)(wgf::block_floats(TB, a.A, a.K, ldh) *
                            sizeof(float));
    const int err = raise_shared((const void*)coupling_fwd_tc_kernel<TB>,
                                 bytes, attr_bytes);
    if (err != 0) return err;
    const unsigned grid = (unsigned)((a.B + TB - 1) / TB);
    coupling_fwd_tc_kernel<TB><<<grid, wgf::THREADS, bytes, s>>>(
        a.y, a.h, a.out, a.ldj, prog, n_instr, a.ws, a.ws + bias_floats, a.B,
        a.A, a.K, ldh);
    return (int)cudaGetLastError();
}
#endif

}  // namespace

extern "C" {

#ifndef DF_HOST_EMULATION
int df_coupling_fwd(const long long* ptrs, const int* iargs, int threads,
                    int shared_bytes, void* stream) {
    const Args a = make_args(ptrs, iargs, 0);
    if ((long long)shared_bytes < 4 * fwd_shared_floats(a)) return -2;
    static int attr_bytes[64] = {};
    const int err = raise_shared((const void*)coupling_fwd_kernel,
                                 shared_bytes, attr_bytes);
    if (err != 0) return err;
    const int n_tiles = (a.B + a.tile - 1) / a.tile;
    coupling_fwd_kernel<<<n_tiles, threads, shared_bytes,
                          static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

// The tensor-core forward: the weight tiling, then the fold, in order on
// one stream. ptrs and iargs as df_coupling_fwd's, ptrs[8] the workspace of
// bias_floats + tiled_floats floats; layout, n_layers: tc_plan's; prog,
// n_instr: the one-coupling program (8 words an instruction); ldh: the
// hidden buffers' row stride; tile_rows: 64, 32 or 16.
int df_coupling_fwd_tc(const long long* ptrs, const int* iargs,
                       const int* layout, int n_layers,
                       long long bias_floats, long long tiled_floats,
                       const int* prog, int n_instr, int ldh, int tile_rows,
                       void* stream) {
    const Args a = make_args(ptrs, iargs, 0);
    TcPack pack;
    if (make_tc_pack(a, layout, n_layers, bias_floats, tiled_floats,
                     pack) != 0 || bias_floats % 4 != 0)
        return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    coupling_tile_kernel<<<(unsigned)((pack.total + 255) / 256), 256, 0, s>>>(
        pack);
    const cudaError_t tiled = cudaGetLastError();
    if (tiled != cudaSuccess) return (int)tiled;
    if (tile_rows == 64)
        return launch_fwd_tc<64>(a, prog, n_instr, bias_floats, ldh, s);
    if (tile_rows == 32)
        return launch_fwd_tc<32>(a, prog, n_instr, bias_floats, ldh, s);
    if (tile_rows == 16)
        return launch_fwd_tc<16>(a, prog, n_instr, bias_floats, ldh, s);
    return -1;
}

// ws: a workspace of ws_floats floats (U, A and net outputs of every row,
// then the segments' partials); segs: row segments of the dW products. The
// launches go out in order on one stream.
int df_coupling_bwd(const long long* ptrs, const int* iargs,
                    long long ws_floats, int segs, void* stream) {
    const Args a = make_args(ptrs, iargs, 1);
    if (segs < 1) return -2;
    BwdPlan bp;
    if (plan_bwd(a, ws_floats, segs, bp) != 0) return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    static int attr_bytes[64] = {};
    const int shared = 4 * PRODUCT_SHARED_FLOATS;
    const int err = raise_shared((const void*)coupling_product_kernel, shared,
                                 attr_bytes);
    if (err != 0) return err;
    for (int k = 0; k < bp.n_groups; ++k) {
        if (k == bp.fwd) {
            const long long blocks = (bp.pull_items + 255) / 256;
            coupling_pullback_kernel<<<(unsigned)blocks, 256, 0, s>>>(
                a, a.net[0].n ? bp.ws[0].OUT : nullptr, bp.ws[1].OUT,
                bp.pull_items);
        }
        const Group& g = bp.groups[k];
        coupling_product_kernel<<<g.first[g.n], PT, shared, s>>>(g);
        const cudaError_t launched = cudaGetLastError();
        if (launched != cudaSuccess) return (int)launched;
    }
    const long long blocks = (bp.reduce_items + 255) / 256;
    coupling_bwd_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        a, segs, bp.reduce_items);
    return (int)cudaGetLastError();
}
#else
// The same work on host pointers: the tiles (and the products' blocks) one
// after another, each with a fresh NaN-filled shared array (reverse bit 1:
// last first), the threads of a phase in the order the -include'd header is
// told (reverse bit 0: last thread first), the elementwise kernels' items
// last first with bit 1. A product block runs its PT threads; the forward
// tile and the elementwise kernels run `threads`.
int df_coupling_fwd_emulated(const long long* ptrs, const int* iargs,
                             int threads, int shared_bytes, int reverse) {
    const Args a = make_args(ptrs, iargs, 0);
    if ((long long)shared_bytes < 4 * fwd_shared_floats(a)) return -2;
    df_emulation_threads = threads;
    df_emulation_reverse = reverse & 1;
    df_emulation_block_reverse = (reverse >> 1) & 1;
    const int floats = shared_bytes / 4;
    float* S = new float[floats > 0 ? floats : 1];
    df_grid_phase((a.B + a.tile - 1) / a.tile, S, floats,
                  [&](int tile) { fwd_body(a, S, tile); });
    delete[] S;
    return 0;
}

// The weight tiling on host pointers, the floats last first with reverse.
int df_coupling_tile_emulated(const long long* ptrs, const int* iargs,
                              const int* layout, int n_layers,
                              long long bias_floats, long long tiled_floats,
                              int reverse) {
    const Args a = make_args(ptrs, iargs, 0);
    TcPack* pack = new TcPack;
    if (make_tc_pack(a, layout, n_layers, bias_floats, tiled_floats,
                     *pack) != 0 || bias_floats % 4 != 0) {
        delete pack;
        return -2;
    }
    for (long long i = 0; i < pack->total; ++i)
        tile_item(*pack, reverse ? pack->total - 1 - i : i);
    delete pack;
    return 0;
}

int df_coupling_bwd_emulated(const long long* ptrs, const int* iargs,
                             long long ws_floats, int segs, int reverse) {
    const Args a = make_args(ptrs, iargs, 1);
    if (segs < 1) return -2;
    BwdPlan* bp = new BwdPlan;
    if (plan_bwd(a, ws_floats, segs, *bp) != 0) {
        delete bp;
        return -2;
    }
    df_emulation_reverse = reverse & 1;
    df_emulation_block_reverse = (reverse >> 1) & 1;
    const bool back = (reverse & 2) != 0;
    float* S = new float[PRODUCT_SHARED_FLOATS];
    for (int k = 0; k < bp->n_groups; ++k) {
        if (k == bp->fwd) {
            for (long long i = 0; i < bp->pull_items; ++i)
                pullback_item(a, a.net[0].n ? bp->ws[0].OUT : nullptr,
                              bp->ws[1].OUT,
                              back ? bp->pull_items - 1 - i : i);
        }
        const Group& g = bp->groups[k];
        df_emulation_threads = PT;
        df_grid_phase(g.first[g.n], S, PRODUCT_SHARED_FLOATS,
                      [&](int block) { product_block(g, S, block); });
    }
    for (long long i = 0; i < bp->reduce_items; ++i)
        reduce_item(a, segs, back ? bp->reduce_items - 1 - i : i);
    delete[] S;
    delete bp;
    return 0;
}
#endif

}  // extern "C"
