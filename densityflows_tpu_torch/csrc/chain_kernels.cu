// Whole-chain fold kernels for Hopper (sm_90a): chain_apply and chain_sample.
//
// They replace the two Pallas TPU kernels of the JAX package,
// densityflows_tpu/ops/pallas_chain.py::_chain_kernel and ::_sample_kernel:
// one row tile is folded through every op of a chain plan (folded conditioner
// MLPs, the affine coupling update, affine / linear / logit layers, optional
// per-row log-det-Jacobian) without the batch leaving the chip in between.
//
// What bounds them on this card: arithmetic. Per row a wide chain does a few
// MFLOP of conditioner products against a few hundred bytes of I/O, so the
// f32 FMA rate is the limit and device-memory traffic is negligible.
//
// Design. The weights of a wide chain (several MB) do not fit the 227 KB of
// shared memory a block can have, so they stay in device memory (they fit
// the L2 cache many times over) and every thread reads its weight columns
// through L1/L2 with 16-byte loads, one k-step ahead of their use. What
// stays on chip is the row tile: the [theta | x] input tile, two ping-pong
// hidden-activation buffers and the d-wide s/t conditioner outputs, all in
// shared memory. A block has 8 threads per tile row (256 threads for 32
// rows, 512 for 64), which puts 16 warps on an SM at either tile. Every
// product is a register-tiled f32 FMA loop in this file's own `dense`
// (8 x 4 outputs per thread for the wide layers); no tensor cores, no TF32,
// no library call.
//
// The Python wrapper (ops/chain_kernels.py::pack_plan) lowers a chain plan
// into a flat program of 8-word steps plus one flat f32 parameter
// buffer. Every matrix is stored row-major (in, out) with both extents
// zero-padded to a multiple of 4 so all weight and activation loads are
// aligned float4 loads; padded rows/columns contribute exact zeros.
//
// C interface (ctypes): df_chain_apply, df_chain_sample. Each launches on
// the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or -1 for an unsupported tile size).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INSTR_WORDS = 8;   // words per program instruction

// instruction opcodes (word 0); the remaining words are op-specific
enum : int { OP_DENSE = 0, OP_COUPLE = 1, OP_AFFINE = 2, OP_COMMIT = 3,
             OP_LOGIT = 4 };
// shared-memory buffer ids used by OP_DENSE
enum : int { BUF_IN = 0, BUF_HA = 1, BUF_HB = 2, BUF_S = 3, BUF_T = 4,
             BUF_X = 5 };
// activation codes (same order as ops/chain_kernels.py::ACT_CODES)
enum : int { ACT_IDENTITY = 0, ACT_RELU = 1, ACT_TANH = 2, ACT_SIGMOID = 3,
             ACT_SILU = 4, ACT_GELU = 5, ACT_SOFTPLUS = 6, ACT_ELU = 7,
             ACT_LEAKY_RELU = 8 };
enum : int { KIND_NVP = 0, KIND_NICE = 1 };
enum : int { DIR_FWD = 0, DIR_INV = 1 };

struct Tile {
    float* in;    // (TB, ldx): [theta padded to n4 | x padded to d4 | pad]
    float* ha;    // (TB, ldh) hidden activations, ping
    float* hb;    // (TB, ldh) hidden activations, pong
    float* s;     // (TB, ldd) d-wide log-scale / linear-op output
    float* t;     // (TB, ldd) d-wide shift
    float* ldj;   // (TB,)
    int ldx, ldh, ldd, n4, d;
};

__device__ __forceinline__ float softplus_f(float u) {
    return fmaxf(u, 0.f) + log1pf(expf(-fabsf(u)));
}

__device__ __forceinline__ float sigmoid_f(float u) {
    return 1.f / (1.f + expf(-u));
}

__device__ __forceinline__ float act_fn(int act, float u) {
    switch (act) {
        // not fmaxf: it would swallow a NaN, which the plain version keeps
        case ACT_RELU: return u < 0.f ? 0.f : u;
        case ACT_TANH: return tanhf(u);
        case ACT_SIGMOID: return sigmoid_f(u);
        case ACT_SILU: return u * sigmoid_f(u);
        case ACT_GELU: {
            const float c = 0.7978845608028654f;
            return 0.5f * u * (1.f + tanhf(c * (u + 0.044715f * u * u * u)));
        }
        case ACT_SOFTPLUS: return softplus_f(u);
        case ACT_ELU: return u > 0.f ? u : expm1f(u);
        case ACT_LEAKY_RELU: return u >= 0.f ? u : 0.01f * u;
        default: return u;
    }
}

// out[TB, N4] = act(in[TB, K4] @ W[K4, N4] + bias). `in`/`out` are distinct
// shared-memory buffers, W/bias live in device memory.
//
// Thread layout: CL threads along the columns (each owning one float4 column
// group), NT/CL row groups (each thread owning RM interleaved rows), so a
// thread holds an RM x 4 register tile (8 x 4 for the wide layers). Inside a
// warp the lanes form a 2-D patch, WC column lanes by 32/WC row groups: one
// k-step then costs the warp few distinct 16-byte weight addresses and few
// distinct activation rows, which keeps the load/store unit below the FMA
// pipe. Rows are interleaved (row = rg + RG*i) so the row groups of a warp
// read consecutive shared-memory rows, which the +4 padding of every leading
// dimension spreads over the banks. The k loop carries no predicate: a
// column group past N4 is clamped to the last valid one (its results are not
// stored), and the next k-step's weights are prefetched into a second
// register set while the current one is multiplied.
template <int RM>
__device__ __forceinline__ void load_w(float4 (&w)[4], const float* wp,
                                       size_t stride) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
        w[kk] = __ldg(reinterpret_cast<const float4*>(wp + kk * stride));
}

template <int RM>
__device__ __forceinline__ void fma_step(float (&acc)[RM][4],
                                         const float4 (&w)[4],
                                         const float* ap, int row_stride) {
    float a[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(ap + i * row_stride);
        a[i][0] = a4.x; a[i][1] = a4.y; a[i][2] = a4.z; a[i][3] = a4.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            acc[i][0] = fmaf(a[i][kk], w[kk].x, acc[i][0]);
            acc[i][1] = fmaf(a[i][kk], w[kk].y, acc[i][1]);
            acc[i][2] = fmaf(a[i][kk], w[kk].z, acc[i][2]);
            acc[i][3] = fmaf(a[i][kk], w[kk].w, acc[i][3]);
        }
    }
}

template <int TB, int NT, int CL>
__device__ __forceinline__ void dense(const float* __restrict__ in, int ldin,
                                      int K4, const float* __restrict__ W,
                                      int N4, const float* __restrict__ bias,
                                      int act, float* __restrict__ out,
                                      int ldout) {
    constexpr int WC = CL < 8 ? CL : 8;          // column lanes per warp
    constexpr int WPC = CL / WC;                 // warps along the columns
    constexpr int RPW = 32 / WC;                 // row groups per warp
    constexpr int RG = NT / CL;                  // row groups per block
    constexpr int RM = TB >= RG ? TB / RG : 1;   // rows per thread
    static_assert(WPC >= 1 && WPC <= NT / 32, "warp layout");
    static_assert(TB >= RG ? (TB % RG == 0) : true, "row tiling");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int cl = (lane % WC) + WC * (warp % WPC);
    const int rg = (lane / WC) + RPW * (warp / WPC);
    if (rg >= TB) return;
    const size_t stride = (size_t)N4;
    const int row_stride = RG * ldin;

    for (int c0 = 0; c0 < N4; c0 += 4 * CL) {
        const int col_raw = c0 + 4 * cl;
        const bool on = col_raw < N4;
        const int col = on ? col_raw : N4 - 4;
        float acc[RM][4];
        {
            float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
            if (bias != nullptr)
                b = __ldg(reinterpret_cast<const float4*>(bias + col));
#pragma unroll
            for (int i = 0; i < RM; ++i) {
                acc[i][0] = b.x; acc[i][1] = b.y;
                acc[i][2] = b.z; acc[i][3] = b.w;
            }
        }
        const float* wp = W + col;
        const float* ap = in + rg * ldin;
        float4 wa[4], wb[4];
        load_w<RM>(wa, wp, stride);
        int k = 0;
        while (k + 8 <= K4) {
            load_w<RM>(wb, wp + (size_t)(k + 4) * stride, stride);
            fma_step<RM>(acc, wa, ap + k, row_stride);
            if (k + 8 < K4)
                load_w<RM>(wa, wp + (size_t)(k + 8) * stride, stride);
            fma_step<RM>(acc, wb, ap + k + 4, row_stride);
            k += 8;
        }
        if (k < K4) fma_step<RM>(acc, wa, ap + k, row_stride);

        if (!on) continue;
        float* op = out + rg * ldout + col;
        const int out_stride = RG * ldout;
        const bool relu = act == ACT_RELU;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            if (relu) {   // u < 0 ? 0 : u keeps a NaN, fmaxf would not
                o.x = o.x < 0.f ? 0.f : o.x; o.y = o.y < 0.f ? 0.f : o.y;
                o.z = o.z < 0.f ? 0.f : o.z; o.w = o.w < 0.f ? 0.f : o.w;
            }
            *reinterpret_cast<float4*>(op + i * out_stride) = o;
        }
        if (act != ACT_RELU && act != ACT_IDENTITY) {
            // the other activations: a rolled pass over this thread's own
            // outputs, so their code exists once per layout, not per element
#pragma unroll 1
            for (int e = 0; e < RM * 4; ++e) {
                float* q = op + (e >> 2) * out_stride + (e & 3);
                *q = act_fn(act, *q);
            }
        }
    }
}

// Pick the thread layout from the output width: the widest layers get the
// largest register tile (8 x 4).
template <int TB, int NT>
__device__ void dense_dispatch(const float* in, int ldin, int K4,
                               const float* W, int N4, const float* bias,
                               int act, float* out, int ldout) {
    if (N4 > 128)
        dense<TB, NT, 64>(in, ldin, K4, W, N4, bias, act, out, ldout);
    else if (N4 > 64)
        dense<TB, NT, 32>(in, ldin, K4, W, N4, bias, act, out, ldout);
    else if (N4 > 32)
        dense<TB, NT, 16>(in, ldin, K4, W, N4, bias, act, out, ldout);
    else if (N4 > 16)
        dense<TB, NT, 8>(in, ldin, K4, W, N4, bias, act, out, ldout);
    else
        dense<TB, NT, 4>(in, ldin, K4, W, N4, bias, act, out, ldout);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Affine coupling update on the x part of the tile, one warp per row:
// fwd x = x*exp(s)+t, inv x = (x-t)*exp(-s); s/t are exactly zero on the
// identity dims (folded scatter), so the full-width update is the coupling.
template <int TB, int NT>
__device__ void couple(const Tile& t, int kind, int dirn, float clamp,
                       bool with_ldj) {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < TB; r += NT / 32) {
        float* x = t.in + r * t.ldx + t.n4;
        const float* sv = t.s + r * t.ldd;
        const float* tv = t.t + r * t.ldd;
        float sum = 0.f;
        for (int j = lane; j < t.d; j += 32) {
            float xv = x[j];
            const float sh = tv[j];
            if (kind == KIND_NVP) {
                float s = sv[j];
                if (clamp > 0.f) s = clamp * tanhf(s / clamp);
                xv = dirn == DIR_FWD ? xv * expf(s) + sh : (xv - sh) * expf(-s);
                sum += s;
            } else {
                xv = dirn == DIR_FWD ? xv + sh : xv - sh;
            }
            x[j] = xv;
        }
        if (with_ldj && kind == KIND_NVP) {
            sum = warp_sum(sum);
            if (lane == 0) t.ldj[r] += dirn == DIR_FWD ? sum : -sum;
        }
    }
}

template <int TB, int NT>
__device__ void logit(const Tile& t, int dirn, float eps, const float* lo,
                      const float* hi, const float* wlog, bool with_ldj) {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < TB; r += NT / 32) {
        float* x = t.in + r * t.ldx + t.n4;
        float sum = 0.f;
        for (int j = lane; j < t.d; j += 32) {
            const float l = __ldg(lo + j), h = __ldg(hi + j);
            float z;
            if (dirn == DIR_FWD) {
                z = x[j];
                x[j] = l + (h - l) * sigmoid_f(z);
            } else {
                float u = (x[j] - l) / (h - l);
                // a clamp that keeps a NaN, as the plain version's does
                if (u == u) u = fminf(fmaxf(u, eps), 1.f - eps);
                z = logf(u) - log1pf(-u);
                x[j] = z;
            }
            sum += -softplus_f(-z) - softplus_f(z) + __ldg(wlog + j);
        }
        if (with_ldj) {
            sum = warp_sum(sum);
            if (lane == 0) t.ldj[r] += dirn == DIR_FWD ? sum : -sum;
        }
    }
}

template <int TB, int NT>
__device__ void fold(const int* __restrict__ prog, int n_instr,
                     const float* __restrict__ P, const Tile& t,
                     bool with_ldj) {
    for (int pc = 0; pc < n_instr; ++pc) {
        const int* I = prog + pc * INSTR_WORDS;
        const int op = __ldg(I);
        if (op == OP_DENSE) {
            const int ib = __ldg(I + 1), ob = __ldg(I + 2);
            const int K4 = __ldg(I + 3), N4 = __ldg(I + 4);
            const int woff = __ldg(I + 5), boff = __ldg(I + 6);
            const int act = __ldg(I + 7);
            const float* in; int ldin;
            if (ib == BUF_IN) { in = t.in; ldin = t.ldx; }
            else if (ib == BUF_X) { in = t.in + t.n4; ldin = t.ldx; }
            else if (ib == BUF_HA) { in = t.ha; ldin = t.ldh; }
            else { in = t.hb; ldin = t.ldh; }
            float* out; int ldout;
            if (ob == BUF_HA) { out = t.ha; ldout = t.ldh; }
            else if (ob == BUF_HB) { out = t.hb; ldout = t.ldh; }
            else if (ob == BUF_S) { out = t.s; ldout = t.ldd; }
            else { out = t.t; ldout = t.ldd; }
            dense_dispatch<TB, NT>(in, ldin, K4, P + woff, N4,
                               boff >= 0 ? P + boff : nullptr, act, out, ldout);
        } else if (op == OP_COUPLE) {
            couple<TB, NT>(t, __ldg(I + 1), __ldg(I + 2),
                       __int_as_float(__ldg(I + 3)), with_ldj);
        } else if (op == OP_AFFINE) {
            const float* a = P + __ldg(I + 1);
            const float* b = P + __ldg(I + 2);
            for (int idx = threadIdx.x; idx < TB * t.d; idx += NT) {
                const int r = idx / t.d, j = idx - r * t.d;
                float* x = t.in + r * t.ldx + t.n4 + j;
                *x = *x * __ldg(a + j) + __ldg(b + j);
            }
            if (with_ldj && threadIdx.x < TB)
                t.ldj[threadIdx.x] += __ldg(P + __ldg(I + 3));
        } else if (op == OP_COMMIT) {  // x <- s (result of a linear op)
            for (int idx = threadIdx.x; idx < TB * t.d; idx += NT) {
                const int r = idx / t.d, j = idx - r * t.d;
                t.in[r * t.ldx + t.n4 + j] = t.s[r * t.ldd + j];
            }
            if (with_ldj && threadIdx.x < TB)
                t.ldj[threadIdx.x] += __ldg(P + __ldg(I + 1));
        } else if (op == OP_LOGIT) {
            logit<TB, NT>(t, __ldg(I + 1), __int_as_float(__ldg(I + 2)),
                      P + __ldg(I + 3), P + __ldg(I + 4), P + __ldg(I + 5),
                      with_ldj);
        }
        __syncthreads();
    }
}

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

// floats of dynamic shared memory a block needs; mirrored by
// ops/chain_kernels.py::shared_memory_bytes
__host__ __device__ inline size_t tile_floats(int tb, int d, int n, int ldh) {
    return (size_t)tb * (up4(n) + up4(d) + 4) + 2 * (size_t)tb * ldh +
           2 * (size_t)tb * (up4(d) + 4) + tb;
}

template <int TB>
__device__ Tile carve(float* smem, int d, int n, int ldh) {
    Tile t;
    t.n4 = up4(n); t.d = d;
    // +4 floats: consecutive rows start on different shared-memory banks
    t.ldx = up4(n) + up4(d) + 4; t.ldh = ldh; t.ldd = up4(d) + 4;
    t.in = smem;
    t.ha = t.in + TB * t.ldx;
    t.hb = t.ha + TB * ldh;
    t.s = t.hb + TB * ldh;
    t.t = t.s + TB * t.ldd;
    t.ldj = t.t + TB * t.ldd;
    return t;
}

// ---- chain_apply -------------------------------------------------------

template <int TB, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
chain_apply_kernel(const float* __restrict__ x, const float* __restrict__ theta,
                   float* __restrict__ y, float* __restrict__ ldj_out,
                   const int* __restrict__ prog, int n_instr,
                   const float* __restrict__ P, long long rows, int d, int n,
                   int ldh) {
    extern __shared__ float4 smem4[];
    const Tile t = carve<TB>(reinterpret_cast<float*>(smem4), d, n, ldh);
    const long long row0 = (long long)blockIdx.x * TB;
    const bool with_ldj = ldj_out != nullptr;

    // load the [theta | x] tile; rows past the end and pad columns are zero
    for (int idx = threadIdx.x; idx < TB * t.ldx; idx += NT) {
        const int r = idx / t.ldx, c = idx - r * t.ldx;
        const long long g = row0 + r;
        float v = 0.f;
        if (g < rows) {
            if (c < n) v = theta[g * n + c];
            else if (c >= t.n4 && c < t.n4 + d) v = x[g * d + (c - t.n4)];
        }
        t.in[idx] = v;
    }
    if (threadIdx.x < TB) t.ldj[threadIdx.x] = 0.f;
    __syncthreads();

    fold<TB, NT>(prog, n_instr, P, t, with_ldj);

    for (int idx = threadIdx.x; idx < TB * d; idx += NT) {
        const int r = idx / d, j = idx - r * d;
        const long long g = row0 + r;
        if (g < rows) y[g * d + j] = t.in[r * t.ldx + t.n4 + j];
    }
    if (with_ldj && threadIdx.x < TB && row0 + threadIdx.x < rows)
        ldj_out[row0 + threadIdx.x] = t.ldj[threadIdx.x];
}

// ---- chain_sample ------------------------------------------------------

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", 2011): counter-based, so a draw is a pure function of (key, counter).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
    const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
    const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
    for (int round = 0; round < 10; ++round) {
        const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
        const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
        c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
        k.x += W0; k.y += W1;
    }
    return c;
}

// Box-Muller on 24-bit-mantissa uniforms: u1 in [0,1) keeps log1p(-u1)
// finite; the tail caps at sqrt(-2 ln 2^-24) ~ 5.8 sigma.
__device__ __forceinline__ float box_muller(uint32_t b1, uint32_t b2) {
    const float u1 = (float)(b1 >> 8) * (1.0f / 16777216.0f);
    const float u2 = (float)(b2 >> 8) * (1.0f / 16777216.0f);
    return sqrtf(-2.0f * log1pf(-u1)) * cosf(6.283185307179586f * u2);
}

template <int TB, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
chain_sample_kernel(float* __restrict__ y, float* __restrict__ r_out,
                    const float* __restrict__ theta, int theta_broadcast,
                    const int* __restrict__ prog, int n_instr,
                    const float* __restrict__ P, long long rows, int d, int n,
                    int ldh, uint32_t seed_lo, uint32_t seed_hi) {
    extern __shared__ float4 smem4[];
    const Tile t = carve<TB>(reinterpret_cast<float*>(smem4), d, n, ldh);
    const long long row0 = (long long)blockIdx.x * TB;

    // theta part (one shared row is broadcast here, never materialised) and
    // zeroed pads; the x part is filled by the generator below
    for (int idx = threadIdx.x; idx < TB * t.ldx; idx += NT) {
        const int r = idx / t.ldx, c = idx - r * t.ldx;
        const long long g = row0 + r;
        float v = 0.f;
        if (g < rows && c < n) v = theta[(theta_broadcast ? 0 : g) * n + c];
        t.in[idx] = v;
    }
    __syncthreads();

    // base draw: counter = (row, column pair), so a draw depends on
    // (seed, row, column) and not on the tile size or the launch shape
    const int pairs = (d + 1) / 2;
    for (int idx = threadIdx.x; idx < TB * pairs; idx += NT) {
        const int r = idx / pairs, p = idx - r * pairs;
        const long long g = row0 + r;
        if (g >= rows) continue;
        const uint4 bits = philox4x32_10(
            make_uint4((uint32_t)g, (uint32_t)((unsigned long long)g >> 32),
                       (uint32_t)p, 0u),
            make_uint2(seed_lo, seed_hi));
        const int j = 2 * p;
        const float z0 = box_muller(bits.x, bits.y);
        t.in[r * t.ldx + t.n4 + j] = z0;
        if (r_out != nullptr) r_out[g * d + j] = z0;
        if (j + 1 < d) {
            const float z1 = box_muller(bits.z, bits.w);
            t.in[r * t.ldx + t.n4 + j + 1] = z1;
            if (r_out != nullptr) r_out[g * d + j + 1] = z1;
        }
    }
    __syncthreads();

    fold<TB, NT>(prog, n_instr, P, t, false);

    for (int idx = threadIdx.x; idx < TB * d; idx += NT) {
        const int r = idx / d, j = idx - r * d;
        const long long g = row0 + r;
        if (g < rows) y[g * d + j] = t.in[r * t.ldx + t.n4 + j];
    }
}

// Launch shape per row tile: 8 threads per row, so both tiles put 16 warps on
// an SM at the wide widths (one 512-thread block of 64 rows, or two
// 256-thread blocks of 32 rows).
template <int TB>
struct Launch {
    static constexpr int threads = 8 * TB;
    static constexpr int min_blocks = TB >= 64 ? 1 : 2;
};

template <int TB>
int launch_apply(const float* x, const float* theta, float* y, float* ldj,
                 const int* prog, int n_instr, const float* P, long long rows,
                 int d, int n, int ldh, cudaStream_t stream) {
    constexpr int NT = Launch<TB>::threads, MINB = Launch<TB>::min_blocks;
    const size_t bytes = tile_floats(TB, d, n, ldh) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        chain_apply_kernel<TB, NT, MINB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((rows + TB - 1) / TB);
    chain_apply_kernel<TB, NT, MINB><<<grid, NT, bytes, stream>>>(
        x, theta, y, ldj, prog, n_instr, P, rows, d, n, ldh);
    return (int)cudaGetLastError();
}

template <int TB>
int launch_sample(float* y, float* r_out, const float* theta,
                  int theta_broadcast, const int* prog, int n_instr,
                  const float* P, long long rows, int d, int n, int ldh,
                  uint32_t seed_lo, uint32_t seed_hi, cudaStream_t stream) {
    constexpr int NT = Launch<TB>::threads, MINB = Launch<TB>::min_blocks;
    const size_t bytes = tile_floats(TB, d, n, ldh) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        chain_sample_kernel<TB, NT, MINB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((rows + TB - 1) / TB);
    chain_sample_kernel<TB, NT, MINB><<<grid, NT, bytes, stream>>>(
        y, r_out, theta, theta_broadcast, prog, n_instr, P, rows, d, n, ldh,
        seed_lo, seed_hi);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, d), theta (rows, n) or null when n == 0, y (rows, d), ldj (rows,)
// or null for a fold without log-det-Jacobian.
int df_chain_apply(const void* x, const void* theta, void* y, void* ldj,
                   const void* prog, int n_instr, const void* params,
                   long long rows, int d, int n, int ldh, int tile_rows,
                   void* stream) {
    if (rows <= 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    auto xf = static_cast<const float*>(x);
    auto tf = static_cast<const float*>(theta);
    auto yf = static_cast<float*>(y);
    auto lf = static_cast<float*>(ldj);
    auto pg = static_cast<const int*>(prog);
    auto pf = static_cast<const float*>(params);
    if (tile_rows == 64)
        return launch_apply<64>(xf, tf, yf, lf, pg, n_instr, pf, rows, d, n, ldh, s);
    if (tile_rows == 32)
        return launch_apply<32>(xf, tf, yf, lf, pg, n_instr, pf, rows, d, n, ldh, s);
    return -1;
}

// y (rows, d); r_out (rows, d) or null; theta (rows, n), (1, n) with
// theta_broadcast = 1, or null when n == 0.
int df_chain_sample(void* y, void* r_out, const void* theta,
                    int theta_broadcast, const void* prog, int n_instr,
                    const void* params, long long rows, int d, int n, int ldh,
                    unsigned int seed_lo, unsigned int seed_hi, int tile_rows,
                    void* stream) {
    if (rows <= 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    auto yf = static_cast<float*>(y);
    auto rf = static_cast<float*>(r_out);
    auto tf = static_cast<const float*>(theta);
    auto pg = static_cast<const int*>(prog);
    auto pf = static_cast<const float*>(params);
    if (tile_rows == 64)
        return launch_sample<64>(yf, rf, tf, theta_broadcast, pg, n_instr, pf,
                                 rows, d, n, ldh, seed_lo, seed_hi, s);
    if (tile_rows == 32)
        return launch_sample<32>(yf, rf, tf, theta_broadcast, pg, n_instr, pf,
                                 rows, d, n, ldh, seed_lo, seed_hi, s);
    return -1;
}

}  // extern "C"
