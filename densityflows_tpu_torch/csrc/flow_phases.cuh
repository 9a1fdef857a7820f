// The instruction phases that the training kernels share: the forward and
// backward programs of a folded flow on one tile of rows.
//
// Included by train_kernels.cu (train_run: one persistent block, parameters
// and gradients in shared memory) and step_kernels.cu (step_grads: one block
// per batch tile, parameters read from device memory, gradients written to
// the block's partial). A phase does not know which: it reads parameters
// through Mem::P, constants through Mem::C and writes gradients through
// Mem::G, while the tile's rows and caches lie in the shared array Mem::S.
//
// The Python wrapper (ops/train_kernels.py::pack_train_plan) lowers a plan
// into a forward and a backward list of 16-word instructions; every offset an
// instruction names is an offset into S (rows, caches), P / G (weights,
// biases) or C (constants). Weight gradients a^T.delta contract the row axis:
// each thread owns whole output elements and loops over the rows in a fixed
// order, so there are no atomics and a launch gives the same bits every time.
// expf / tanhf are the full precision ones (the build has no
// --use_fast_math).
//
// Every phase is a function of (tid, nt) and carries nothing across a
// barrier except values that are uniform over the block. The including file
// defines DF_FN and DF_PHASE before it includes this header (for the card,
// or for the host emulation the CPU tests compile with -DDF_HOST_EMULATION).

#pragma once

namespace {

constexpr int INSTR_WORDS = 16;
constexpr int HEADER_WORDS = 32;
// opcodes (word 0), as in ops/train_kernels.py
enum : int { F_DENSE = 0, F_COUPLE = 1, F_ANORM = 2, F_AFFINE = 3,
             B_COUPLE = 4, B_DENSE = 5, B_ANORM = 6, B_AFFINE = 7 };
enum : int { ACT_IDENTITY = 0, ACT_RELU = 1, ACT_TANH = 2, ACT_SIGMOID = 3 };
enum : int { KIND_NVP = 0, KIND_NICE = 1 };
// header words
enum : int { H_NP = 0, H_NC, H_B, H_D, H_N, H_P, H_MU, H_NU, H_G, H_C, H_TH,
             H_X0, H_Z, H_GZ, H_LDJ, H_MASK, H_JBAR, H_LP, H_SCAL, H_NFWD,
             H_NBWD, H_TOTAL };

// The buffers of one block. S is the block's shared array; P, G and C lie in
// it (train_run) or in device memory (step_grads); MU, NU and the scalars
// are train_run's.
struct Mem {
    float* S;
    float* P; float* MU; float* NU; float* G; float* C;
    float* TH; float* X0; float* Z; float* GZ;
    float* LDJ; float* MASK; float* JBAR; float* LP; float* SCAL;
    int np, nc, B, d, n;
    int acc;        // != 0: a backward instruction adds to G, else it writes
};

// the per-tile buffers of S, from the program's header
DF_FN void tile_buffers(Mem& m, float* S, const int* hdr) {
    m.S = S;
    m.np = hdr[H_NP]; m.nc = hdr[H_NC]; m.B = hdr[H_B]; m.d = hdr[H_D];
    m.n = hdr[H_N];
    m.TH = S + (hdr[H_TH] >= 0 ? hdr[H_TH] : 0);
    m.X0 = S + hdr[H_X0]; m.Z = S + hdr[H_Z]; m.GZ = S + hdr[H_GZ];
    m.LDJ = S + hdr[H_LDJ]; m.MASK = S + hdr[H_MASK];
    m.JBAR = S + hdr[H_JBAR]; m.LP = S + hdr[H_LP]; m.SCAL = S + hdr[H_SCAL];
    m.acc = 0;
}

DF_FN bool finite_f(float v) { return fabsf(v) <= 3.402823466e+38f; }
DF_FN bool nan_f(float v) { return v != v; }

DF_FN float act_fn(int act, float u) {
    switch (act) {
        // not fmaxf: it would swallow a NaN, which the plain version keeps
        case ACT_RELU: return u < 0.f ? 0.f : u;
        case ACT_TANH: return tanhf(u);
        case ACT_SIGMOID: return 1.f / (1.f + expf(-u));
        default: return u;
    }
}

// sigma'(u) from the activation VALUE a = sigma(u)
DF_FN float dact_fn(int act, float a) {
    switch (act) {
        case ACT_RELU: return a > 0.f ? 1.f : 0.f;
        case ACT_TANH: return 1.f - a * a;
        case ACT_SIGMOID: return a * (1.f - a);
        default: return 1.f;
    }
}

// a gradient entry: written, or added to what the block's earlier tiles left
DF_FN void put_grad(const Mem& m, int i, float v) {
    m.G[i] = m.acc ? m.G[i] + v : v;
}

// ---- forward instructions ----------------------------------------------

// out[B, N] = act(in1[B, K1] @ W1[K1, N] (+ in2[B, K2] @ W2[K2, N]) + bias)
DF_FN void f_dense(const Mem& m, const int* I, int tid, int nt) {
    const int in1 = I[1], K1 = I[2], w1 = I[3], in2 = I[4], K2 = I[5],
              w2 = I[6], N = I[7], bias = I[8], act = I[9], out = I[10];
    for (int idx = tid; idx < m.B * N; idx += nt) {
        const int r = idx / N, c = idx - r * N;
        float acc = bias >= 0 ? m.P[bias + c] : 0.f;
        const float* a = m.S + in1 + r * K1;
        const float* w = m.P + w1 + c;
        for (int k = 0; k < K1; ++k) acc = fmaf(a[k], w[k * N], acc);
        if (K2 > 0) {
            a = m.S + in2 + r * K2;
            w = m.P + w2 + c;
            for (int k = 0; k < K2; ++k) acc = fmaf(a[k], w[k * N], acc);
        }
        m.S[out + idx] = act_fn(act, acc);
    }
}

// inverse coupling, one thread per row: z = (x - t) * exp(-s), ldj -= sum s
// (s clamped to M*tanh(s/M) first); NICE: z = x - t. Caches e and the
// clamped s for the backward.
DF_FN void f_couple(const Mem& m, const int* I, int tid, int nt) {
    const int kind = I[1];
    const float* x = m.S + I[2]; float* z = m.S + I[3];
    const float* s = m.S + I[4]; const float* t = m.S + I[5];
    float* e = m.S + I[6]; float* sc = m.S + I[7];
    const float clamp = __int_as_float(I[8]);
    const int d = m.d;
    for (int r = tid; r < m.B; r += nt) {
        float sum = 0.f;
        for (int j = 0; j < d; ++j) {
            const int i = r * d + j;
            if (kind == KIND_NVP) {
                float sv = s[i];
                if (clamp > 0.f) sv = clamp * tanhf(sv / clamp);
                const float ev = expf(-sv);
                sc[i] = sv;
                e[i] = ev;
                z[i] = (x[i] - t[i]) * ev;
                sum += sv;
            } else {
                z[i] = x[i] - t[i];
            }
        }
        if (kind == KIND_NVP) m.LDJ[r] -= sum;
    }
}

// ActNorm, inverse direction: z = (x - b) * exp(s), ldj += sum s
DF_FN void f_anorm(const Mem& m, const int* I, int tid, int nt) {
    const float* x = m.S + I[1]; float* z = m.S + I[2];
    const float* s = m.P + I[3]; const float* b = m.P + I[4];
    const int d = m.d;
    for (int r = tid; r < m.B; r += nt) {
        float sum = 0.f;
        for (int j = 0; j < d; ++j) {
            z[r * d + j] = (x[r * d + j] - b[j]) * expf(s[j]);
            sum += s[j];
        }
        m.LDJ[r] += sum;
    }
}

// Normalization constants: z = x * a + b, ldj += c
DF_FN void f_affine(const Mem& m, const int* I, int tid, int nt) {
    const float* x = m.S + I[1]; float* z = m.S + I[2];
    const float* a = m.C + I[3]; const float* b = m.C + I[4];
    const float c = m.C[I[5]];
    const int d = m.d;
    for (int r = tid; r < m.B; r += nt) {
        for (int j = 0; j < d; ++j)
            z[r * d + j] = x[r * d + j] * a[j] + b[j];
        m.LDJ[r] += c;
    }
}

// ---- backward instructions ---------------------------------------------

// sbar = (-gz * z - jbar) * (1 - (s_c / M)^2), tbar = -gz * e, gx = gz * e;
// NICE: tbar = -gz, gx = gz.
DF_FN void b_couple(const Mem& m, const int* I, int tid, int nt) {
    const int kind = I[1];
    float* gz = m.S + I[2]; const float* z = m.S + I[3];
    const float* e = m.S + I[4]; const float* sc = m.S + I[5];
    float* sbar = m.S + I[6]; float* tbar = m.S + I[7];
    const float clamp = __int_as_float(I[8]);
    const int d = m.d;
    for (int idx = tid; idx < m.B * d; idx += nt) {
        const float g = gz[idx];
        if (kind == KIND_NVP) {
            float sb = -g * z[idx] - m.JBAR[idx / d];
            if (clamp > 0.f) {
                const float q = sc[idx] / clamp;
                sb *= 1.f - q * q;
            }
            sbar[idx] = sb;
            tbar[idx] = -g * e[idx];
            gz[idx] = g * e[idx];
        } else {
            tbar[idx] = -g;
        }
    }
}

// One dense layer's backward over one index space: the weight gradient
// G[w] = a^T @ delta (K * N items, each a loop over the rows in order), the
// bias gradient (N items), and the input cotangent
// dout = (delta @ W^T [+ dout]) * dact(a) (B * K items). All three read
// delta and write disjoint outputs. The input-cotangent loop starts at
// column k and wraps, so the threads of a warp, which differ in k, read
// different banks of W.
DF_FN void b_dense(const Mem& m, const int* I, int tid, int nt) {
    const int src = I[1], K = I[2], w = I[3], N = I[4], dl = I[5],
              bias = I[6], dout = I[7], acc_flag = I[8], dact = I[9];
    const float* a = m.S + src;
    const float* delta = m.S + dl;
    const int n_w = K * N, n_b = bias >= 0 ? N : 0,
              n_d = dout >= 0 ? m.B * K : 0;
    for (int idx = tid; idx < n_w + n_b + n_d; idx += nt) {
        if (idx < n_w) {
            const int k = idx / N, c = idx - k * N;
            float acc = 0.f;
            for (int r = 0; r < m.B; ++r)
                acc = fmaf(a[r * K + k], delta[r * N + c], acc);
            put_grad(m, w + idx, acc);
        } else if (idx < n_w + n_b) {
            const int c = idx - n_w;
            float acc = 0.f;
            for (int r = 0; r < m.B; ++r) acc += delta[r * N + c];
            put_grad(m, bias + c, acc);
        } else {
            const int i = idx - n_w - n_b;
            const int r = i / K, k = i - r * K;
            const float* dr = delta + r * N;
            const float* wr = m.P + w + k * N;
            float acc = 0.f;
            int c = k % N;
            for (int it = 0; it < N; ++it) {
                acc = fmaf(dr[c], wr[c], acc);
                c = c + 1 == N ? 0 : c + 1;
            }
            float* o = m.S + dout + i;
            if (acc_flag) acc += *o;
            *o = acc * dact_fn(dact, a[i]);
        }
    }
}

// ActNorm: ds_j = sum_r gz*z + sum_r jbar, db_j = -(sum_r gz) * e_j, then
// gx = gz * e; one thread per column, which owns that column of gz.
DF_FN void b_anorm(const Mem& m, const int* I, int tid, int nt) {
    float* gz = m.S + I[1]; const float* z = m.S + I[2];
    const int s_off = I[3], b_off = I[4];
    const int d = m.d;
    for (int j = tid; j < d; j += nt) {
        float sgz = 0.f, sg = 0.f, sj = 0.f;
        for (int r = 0; r < m.B; ++r) {
            sgz = fmaf(gz[r * d + j], z[r * d + j], sgz);
            sg += gz[r * d + j];
            sj += m.JBAR[r];
        }
        const float e = expf(m.P[s_off + j]);
        put_grad(m, s_off + j, sgz + sj);
        put_grad(m, b_off + j, -sg * e);
        for (int r = 0; r < m.B; ++r) gz[r * d + j] *= e;
    }
}

DF_FN void b_affine(const Mem& m, const int* I, int tid, int nt) {
    float* gz = m.S + I[1]; const float* a = m.C + I[2];
    const int d = m.d;
    for (int idx = tid; idx < m.B * d; idx += nt) gz[idx] *= a[idx % d];
}

DF_FN void step(const Mem& m, const int* I, int tid, int nt) {
    switch (I[0]) {
        case F_DENSE: f_dense(m, I, tid, nt); break;
        case F_COUPLE: f_couple(m, I, tid, nt); break;
        case F_ANORM: f_anorm(m, I, tid, nt); break;
        case F_AFFINE: f_affine(m, I, tid, nt); break;
        case B_COUPLE: b_couple(m, I, tid, nt); break;
        case B_DENSE: b_dense(m, I, tid, nt); break;
        case B_ANORM: b_anorm(m, I, tid, nt); break;
        case B_AFFINE: b_affine(m, I, tid, nt); break;
        default: break;
    }
}

// ---- phases around the programs ----------------------------------------

// One tile of a row set, rows [row0, row0 + B) as they lie; rows past the
// end are zeros with mask 0. ws: per-row weights, or null for 1.
DF_FN void load_rows(const Mem& m, const float* xs, const float* ths,
                     const float* ws, int rows, int row0, int tid, int nt) {
    const int d = m.d, n = m.n;
    for (int idx = tid; idx < m.B * d; idx += nt) {
        const int r = idx / d, j = idx - r * d, g = row0 + r;
        m.X0[idx] = g < rows ? xs[(long long)g * d + j] : 0.f;
    }
    for (int idx = tid; idx < m.B * n; idx += nt) {
        const int r = idx / n, j = idx - r * n, g = row0 + r;
        m.TH[idx] = g < rows ? ths[(long long)g * n + j] : 0.f;
    }
    for (int r = tid; r < m.B; r += nt) {
        const int g = row0 + r;
        m.MASK[r] = g < rows ? (ws != nullptr ? ws[g] : 1.f) : 0.f;
        m.LDJ[r] = 0.f;
    }
}

// lp_r = -0.5 * sum z^2 - 0.5 * d * log(2 pi) + ldj_r
DF_FN void row_log_prob(const Mem& m, int tid, int nt) {
    const int d = m.d;
    for (int r = tid; r < m.B; r += nt) {
        float ss = 0.f;
        for (int j = 0; j < d; ++j) ss = fmaf(m.Z[r * d + j], m.Z[r * d + j], ss);
        m.LP[r] = -0.5f * ss - 0.5f * (float)d * 1.8378770664093453f + m.LDJ[r];
    }
}

// jbar = dL/dlp = -m / den, gz = dL/dz = -jbar * z
DF_FN void loss_cotangents(const Mem& m, float den, int tid, int nt) {
    const int d = m.d;
    for (int r = tid; r < m.B; r += nt) {
        const float jb = -m.MASK[r] / den;
        m.JBAR[r] = jb;
        for (int j = 0; j < d; ++j) m.GZ[r * d + j] = -jb * m.Z[r * d + j];
    }
}

}  // namespace
