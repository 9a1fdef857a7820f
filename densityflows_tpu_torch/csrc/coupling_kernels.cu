// Per-layer affine coupling kernels for Hopper (sm_90a): coupling_fwd,
// coupling_bwd and its reduction coupling_bwd_reduce.
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
// forward does 2.5 GFLOP against 2.5 MB of I/O. All products are f32 FMA on
// the CUDA cores in this file's own loops (no tensor cores, no library).
//
// coupling_fwd. One block per tile of TB rows. The tile's input rows, two
// ping-pong hidden buffers and the two net outputs lie in shared memory; the
// weights of a coupling (610 KB at hidden 256) do not fit there, so they stay
// in device memory and the L2 cache serves the blocks' re-reads. A thread of
// a dense layer owns one output column of RM rows, so one weight load serves
// RM FMAs. The ragged last tile is masked here: rows past B read zeros and
// are not written.
//
// coupling_bwd. The TPU kernel recomputes the forward per tile and adds each
// tile's dW / db into output blocks that stay resident across its grid:
// that relies on the grid running in order. Hopper blocks run in no order,
// so the sum over rows is a second kernel. Per tile, coupling_bwd recomputes
// both nets keeping every layer's input a_i and pre-activation u_i, forms
// ds / dt / dy by the coupling's pullback (g_ldj into ds), walks each net
// back (delta <- (delta W^T) * act'(u), act' of the PRE-activation, with W^T
// laid out by the wrapper so that a warp's loads are contiguous), writes
// dh (the sum of the s- and t-chains) and dy, and stores every layer's a_i
// and delta_i of its rows in a device workspace of B rows. Then
// coupling_bwd_reduce gives each thread whole dW / db elements:
// dW_i[k, c] = sum over all rows, in row order, of a_i[r, k] delta_i[r, c].
// The workspace (68 MB at the main path) is smaller than per-block dW
// partials would be (G blocks x 610 KB, 80 MB at G = 132, more than L2).
// No float atomics: two launches give the same bits.
//
// expf / tanhf / expm1f / log1pf are the full-precision ones (the build has
// no --use_fast_math). relu is written `u < 0 ? 0 : u`, which keeps a NaN.
//
// With DF_HOST_EMULATION defined the file compiles as plain C++ and the CPU
// tests run it, threads and blocks in either order.
//
// C interface (ctypes): df_coupling_fwd, df_coupling_bwd. Each launches on
// the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or -2 when the shared memory handed in is too small).

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
#else
#define DF_HD static inline
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
    const float* wt[MAX_LAYERS];  // w[i] transposed, (dims[i + 1], dims[i])
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

// a_1 .. a_{n-1} and delta_0 .. delta_{n-1} of one row
DF_HD long long net_row_floats(const Net& net) {
    long long f = 0;
    for (int i = 1; i < net.n; ++i) f += net.dims[i];
    for (int i = 0; i < net.n; ++i) f += net.dims[i + 1];
    return f;
}

DF_HD long long fwd_shared_floats(const Args& a) {
    return (long long)a.tile * (a.K + 2 * hidden_max(a) + 2 * a.A);
}

DF_HD long long bwd_shared_floats(const Args& a) {
    return (long long)a.tile *
           (a.K + net_row_floats(a.net[0]) + net_row_floats(a.net[1]));
}

// The buffers of one net for `rows` rows from `base`: act[i] (i >= 1) the
// input of layer i, d[i] the pre-activation of layer i, later its delta.
DF_FN float* net_buffers(const Net& net, float* base, long long rows,
                         float** act, float** d) {
    for (int i = 1; i < net.n; ++i) { act[i] = base; base += rows * net.dims[i]; }
    for (int i = 0; i < net.n; ++i) { d[i] = base; base += rows * net.dims[i + 1]; }
    return base;
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

// The coupling's pullback, one thread per element:
//   forward  x = y e^s + t, ldj = +sum s:  dy = g e^s, dt = g,
//                                          ds = g y e^s + g_ldj
//   inverse  z = (y - t) e^-s, ldj = -sum s: dy = g e^-s, dt = -g e^-s,
//                                            ds = -g z - g_ldj
//   NICE: dy = g, dt = +-g.
// ds / dt replace s / t in the nets' last buffers; dy goes out.
DF_FN void couple_bwd(const Args& a, float* ds, float* dt, int row0, int TB,
                      int tid, int nt) {
    const int A = a.A;
    for (int idx = tid; idx < TB * A; idx += nt) {
        const long long g = row0 + idx / A;
        const int j = idx % A;
        const bool on = g < a.B;
        const float gv = on ? a.gy[g * A + j] : 0.f;
        const float yv = on ? a.y[g * A + j] : 0.f;
        const float gl = on ? a.gldj[g] : 0.f;
        float dy;
        if (a.kind == KIND_NVP) {
            const float s = ds[idx], t = dt[idx];
            if (a.dirn == DIR_FWD) {
                const float es = expf(s);
                dy = gv * es;
                dt[idx] = gv;
                ds[idx] = gv * yv * es + gl;
            } else {
                const float ems = expf(-s);
                const float z = (yv - t) * ems;
                dy = gv * ems;
                dt[idx] = -dy;
                ds[idx] = -gv * z - gl;
            }
        } else {
            dy = gv;
            dt[idx] = a.dirn == DIR_FWD ? gv : -gv;
        }
        if (on) a.dy[g * A + j] = dy;
    }
}

// acc[j] = sum_c delta[r0 + j, c] W^T[c, k] over c in order, for the RM rows
// from r0 (clamped to the tile). W^T is (N, Kd): the lanes of a warp, which
// differ in k, read neighbouring addresses.
DF_FN void back_rows(const float* delta, int N, const float* WT, int Kd,
                     int k, int r0, int TB, float (&acc)[RM]) {
    int rows[RM];
    for (int j = 0; j < RM; ++j) {
        rows[j] = r0 + j < TB ? r0 + j : TB - 1;
        acc[j] = 0.f;
    }
    const float* wk = WT + k;
    for (int c = 0; c < N; ++c) {
        const float w = wk[(long long)c * Kd];
        for (int j = 0; j < RM; ++j)
            acc[j] = fmaf(delta[rows[j] * N + c], w, acc[j]);
    }
}

// delta_{i-1} = (delta_i @ W_i^T) * act'(u_{i-1}), written over u_{i-1}:
// each element is read and written by the thread that owns it.
DF_FN void back_dense(const float* delta, int N, const float* WT, int Kd,
                      int act, float* dprev, int TB, int tid, int nt) {
    const int groups = (TB + RM - 1) / RM;
    for (int item = tid; item < groups * Kd; item += nt) {
        const int g = item / Kd, k = item - g * Kd, r0 = g * RM;
        float acc[RM];
        back_rows(delta, N, WT, Kd, k, r0, TB, acc);
        for (int j = 0; j < RM && r0 + j < TB; ++j) {
            const int o = (r0 + j) * Kd + k;
            dprev[o] = acc[j] * dact_fn(act, dprev[o]);
        }
    }
}

// dh = delta_s0 @ W_s0^T + delta_t0 @ W_t0^T (the s-chain first)
DF_FN void input_cotangent(const Args& a, float* const* d0, int row0, int TB,
                           int tid, int nt) {
    const int K = a.K, groups = (TB + RM - 1) / RM;
    for (int item = tid; item < groups * K; item += nt) {
        const int g = item / K, k = item - g * K, r0 = g * RM;
        float sum[RM];
        bool first = true;
        for (int w = 0; w < 2; ++w) {
            const Net& net = a.net[w];
            if (net.n == 0) continue;
            float acc[RM];
            back_rows(d0[w], net.dims[1], net.wt[0], K, k, r0, TB, acc);
            for (int j = 0; j < RM; ++j)
                sum[j] = first ? acc[j] : sum[j] + acc[j];
            first = false;
        }
        for (int j = 0; j < RM && r0 + j < TB; ++j) {
            const long long gr = row0 + r0 + j;
            if (gr < a.B) a.dh[gr * K + k] = sum[j];
        }
    }
}

// the tile's rows of every a_i (i >= 1) and delta_i into the workspace
DF_FN void store_caches(const Args& a, float* const* sa, float* const* sd,
                        float* const* wa, float* const* wd, const Net& net,
                        int row0, int TB, int tid, int nt) {
    const int rows = a.B - row0 < TB ? a.B - row0 : TB;
    for (int i = 0; i < net.n; ++i) {
        for (int part = 0; part < 2; ++part) {
            if (part == 0 && i == 0) continue;   // a_0 is h itself
            const int W = part == 0 ? net.dims[i] : net.dims[i + 1];
            const float* src = part == 0 ? sa[i] : sd[i];
            float* dst = (part == 0 ? wa[i] : wd[i]) + (long long)row0 * W;
            for (int idx = tid; idx < rows * W; idx += nt) dst[idx] = src[idx];
        }
    }
}

// ---- the kernels' bodies --------------------------------------------------

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

DF_FN void bwd_body(const Args& a, float* S, int tile) {
    const int TB = a.tile, K = a.K, row0 = tile * TB;
    float* H = S;
    float* sa[2][MAX_LAYERS] = {};
    float* sd[2][MAX_LAYERS] = {};
    float* wa[2][MAX_LAYERS] = {};
    float* wd[2][MAX_LAYERS] = {};
    float* p = H + TB * K;
    float* q = a.ws;
    for (int w = 0; w < 2; ++w) {
        sa[w][0] = H;
        p = net_buffers(a.net[w], p, TB, sa[w], sd[w]);
        q = net_buffers(a.net[w], q, a.B, wa[w], wd[w]);
    }
    DF_PHASE(load_rows(H, a.h, K, a.B, row0, TB, tid, nt))
    // the forward again, keeping every layer's input and pre-activation
    for (int w = 0; w < 2; ++w) {
        const Net& net = a.net[w];
        for (int i = 0; i < net.n; ++i) {
            const bool last = i == net.n - 1;
            DF_PHASE(dense(sa[w][i], net.dims[i], net.w[i], net.b[i],
                           net.dims[i + 1], net.act, last,
                           last ? nullptr : sa[w][i + 1], sd[w][i], TB, tid,
                           nt))
        }
    }
    const Net& ns = a.net[0];
    const Net& nt_ = a.net[1];
    DF_PHASE(couple_bwd(a, ns.n ? sd[0][ns.n - 1] : nullptr,
                        sd[1][nt_.n - 1], row0, TB, tid, nt))
    for (int w = 0; w < 2; ++w) {
        const Net& net = a.net[w];
        for (int i = net.n - 1; i >= 1; --i) {
            DF_PHASE(back_dense(sd[w][i], net.dims[i + 1], net.wt[i],
                                net.dims[i], net.act, sd[w][i - 1], TB, tid,
                                nt))
        }
    }
    float* d0[2] = {sd[0][0], sd[1][0]};
    DF_PHASE(input_cotangent(a, d0, row0, TB, tid, nt))
    DF_PHASE(
        for (int w = 0; w < 2; ++w)
            store_caches(a, sa[w], sd[w], wa[w], wd[w], a.net[w], row0, TB,
                         tid, nt);
    )
}

// Item `idx` of all dW / db entries (per net: weights and biases layer by
// layer): a sum over all B rows in row order.
DF_FN void reduce_item(const Args& a, long long idx) {
    float* base = a.ws;
    for (int w = 0; w < 2; ++w) {
        const Net& net = a.net[w];
        float* act[MAX_LAYERS] = {};
        float* d[MAX_LAYERS] = {};
        base = net_buffers(net, base, a.B, act, d);
        for (int i = 0; i < net.n; ++i) {
            const int Kd = net.dims[i], N = net.dims[i + 1];
            const long long nw = (long long)Kd * N;
            if (idx < nw) {
                const int k = (int)(idx / N), c = (int)(idx - (long long)k * N);
                const float* x = i == 0 ? a.h : act[i];
                const float* dl = d[i];
                float acc = 0.f;
                for (long long r = 0; r < a.B; ++r)
                    acc = fmaf(x[r * Kd + k], dl[r * N + c], acc);
                net.dw[i][idx] = acc;
                return;
            }
            idx -= nw;
            if (net.b[i] != nullptr) {
                if (idx < N) {
                    const float* dl = d[i] + idx;
                    float acc = 0.f;
                    for (long long r = 0; r < a.B; ++r) acc += dl[r * N];
                    net.db[i][idx] = acc;
                    return;
                }
                idx -= N;
            }
        }
    }
}

// ---- arguments ------------------------------------------------------------

// iargs: kind, dirn, with_ldj, B, K, A, tile, then per net (s, t): n, act,
// has_bias, dims[0..n]. ptrs: h, y, gy, gldj, out, ldj, dh, dy, ws, then
// per net: w[0..n), b[0..n) (with bias), then only where the backward runs
// (grads != 0) wt[0..n) (w transposed), dw[0..n), db[0..n) (with bias).
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
            net.w[i] = nullptr; net.b[i] = nullptr; net.wt[i] = nullptr;
            net.dw[i] = nullptr; net.db[i] = nullptr;
        }
        for (int i = 0; i < net.n; ++i) net.w[i] = (const float*)p[k++];
        if (bias)
            for (int i = 0; i < net.n; ++i) net.b[i] = (const float*)p[k++];
        if (grads) {
            for (int i = 0; i < net.n; ++i) net.wt[i] = (const float*)p[k++];
            for (int i = 0; i < net.n; ++i) net.dw[i] = (float*)p[k++];
            if (bias)
                for (int i = 0; i < net.n; ++i) net.db[i] = (float*)p[k++];
        }
    }
    return a;
}

#ifndef DF_HOST_EMULATION
__global__ void __launch_bounds__(256)
coupling_fwd_kernel(const __grid_constant__ Args a) {
    extern __shared__ float4 smem4[];
    fwd_body(a, reinterpret_cast<float*>(smem4), blockIdx.x);
}

__global__ void __launch_bounds__(256)
coupling_bwd_kernel(const __grid_constant__ Args a) {
    extern __shared__ float4 smem4[];
    bwd_body(a, reinterpret_cast<float*>(smem4), blockIdx.x);
}

__global__ void __launch_bounds__(256)
coupling_bwd_reduce_kernel(const __grid_constant__ Args a, long long items) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < items) reduce_item(a, i);
}
#endif

}  // namespace

extern "C" {

#ifndef DF_HOST_EMULATION
int df_coupling_fwd(const long long* ptrs, const int* iargs, int threads,
                    int shared_bytes, void* stream) {
    const Args a = make_args(ptrs, iargs, 0);
    if ((long long)shared_bytes < 4 * fwd_shared_floats(a)) return -2;
    cudaError_t err = cudaFuncSetAttribute(
        coupling_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = (a.B + a.tile - 1) / a.tile;
    coupling_fwd_kernel<<<n_tiles, threads, shared_bytes,
                          static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

// phases: bit 0 the tile kernel, bit 1 the reduction (3: the backward; one
// alone only to time it on a workspace that an earlier launch filled)
int df_coupling_bwd(const long long* ptrs, const int* iargs, int threads,
                    int shared_bytes, long long items, int phases,
                    void* stream) {
    const Args a = make_args(ptrs, iargs, 1);
    if ((long long)shared_bytes < 4 * bwd_shared_floats(a)) return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (phases & 1) {
        cudaError_t err = cudaFuncSetAttribute(
            coupling_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            shared_bytes);
        if (err != cudaSuccess) return (int)err;
        const int n_tiles = (a.B + a.tile - 1) / a.tile;
        coupling_bwd_kernel<<<n_tiles, threads, shared_bytes, s>>>(a);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (phases & 2) {
        const long long blocks = (items + 255) / 256;
        coupling_bwd_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(a, items);
    }
    return (int)cudaGetLastError();
}
#else
// The same work on host pointers: the tiles one after another, each with a
// fresh NaN-filled shared array (reverse bit 1: last tile first), the
// threads of a phase in the order the -include'd header is told (reverse
// bit 0: last thread first), the reduction's items last first with bit 1.
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

int df_coupling_bwd_emulated(const long long* ptrs, const int* iargs,
                             int threads, int shared_bytes, long long items,
                             int reverse) {
    const Args a = make_args(ptrs, iargs, 1);
    if ((long long)shared_bytes < 4 * bwd_shared_floats(a)) return -2;
    df_emulation_threads = threads;
    df_emulation_reverse = reverse & 1;
    df_emulation_block_reverse = (reverse >> 1) & 1;
    const int floats = shared_bytes / 4;
    float* S = new float[floats > 0 ? floats : 1];
    df_grid_phase((a.B + a.tile - 1) / a.tile, S, floats,
                  [&](int tile) { bwd_body(a, S, tile); });
    delete[] S;
    for (long long k = 0; k < items; ++k)
        reduce_item(a, (reverse & 2) ? items - 1 - k : k);
    return 0;
}
#endif

}  // extern "C"
