// Whole-run training kernel for Hopper (sm_90a): train_run.
//
// It replaces the Pallas TPU kernel of the JAX package,
// densityflows_tpu/ops/pallas_train.py::_train_kernel: one launch runs a whole
// multi-epoch training run on folded parameters. Per batch: gather the rows,
// inverse fold with activation caches, masked (optionally weighted) Gaussian
// NLL, hand-derived backward, select-masked gradients, non-finite guard, Adam.
// Per epoch: full-split train and validation NLL from the parameters after the
// epoch's last batch, best-validation snapshot, histories.
//
// Order. Every batch's Adam update must be seen by the next batch, and blocks
// of a grid run at once, so the run is ONE persistent thread block that loops
// `for epoch: for batch: load -> forward -> loss -> backward -> mask ->
// guard -> Adam; eval; best; history`, with __syncthreads() between phases and
// no communication between blocks.
//
// Residency. The block's dynamic shared memory is one float array laid out by
// the Python wrapper (ops/train_kernels.py::pack_train_plan): the flat
// parameter buffer, both Adam moments and the gradients (the same order, so
// the mask, the finite check and Adam are one elementwise pass), the
// Normalization constants, one batch's activation caches and scratch, and,
// where they fit, both programs (staged by the first phase; else the phases
// read them from device memory, with the same bits). Data rows, the
// per-epoch gather indices, the 0/1 gradient masks and the best snapshot
// stay in device memory. The kernel holds no layout logic of its own: every
// offset comes from the programs' headers and instructions, so the
// wrapper's byte count is exact.
//
// What bounds it on this card: latency and shared-memory loads. The work is
// a few hundred kFLOP per batch on one SM, a serial chain of small phases
// each ended by a barrier. Cycles at the README config on an H100 (the
// DF_TRAIN_CLOCKS build of tools/chip_probe.py --variants): the design
// before this one ran 56 phases a step at 2.8k cycles each (61 % in
// b_dense, one thread per weight gradient over the batch's 64 rows; 25 %
// in f_dense) and 25 phases an evaluation tile of 64 rows. This one:
//   - fewer phases. A coupling's s- and t-nets read the same input and write
//     disjoint outputs, so the lowering puts their layers into shared phases
//     (word 15 of an instruction: it joins the phase of the one before; word
//     14: the items of the phase before it, so that the threads take the
//     items of all of a phase's instructions in one round). The batch's
//     denominator is summed while the batch loads, so the log-prob, the
//     loss cotangents and the loss are one phase. The per-epoch evaluation
//     runs a second, forward-only program on tiles as large as the batch
//     caches' floats hold (buffers reused, no caches), its sums over rows
//     folded into the next tile's load phase;
//   - shorter phases. The block has at most 512 threads, so a thread may
//     hold 128 registers (at 1,024 the phases spilled). The dense layers run
//     on register tiles of four outputs that share loads (f_dense4,
//     b_dense4). The weight and bias gradients are summed over segments of
//     the batch's rows into copies of the gradient buffer, which the mask
//     phase adds in order: more items, shorter serial chains. Sums over rows
//     that were one thread's serial loop (the loss, the denominator, the
//     evaluation) are cut into partial sums over consecutive rows, added in
//     index order.
// At the README config a step is then 33 phases at 4.1k cycles, an
// evaluation tile 15 phases over 311 rows. The sums run in other orders
// than flow_phases.cuh's handlers do.
//
// Program. The wrapper lowers the plan into a forward and a backward list of
// 16-word instructions, and an evaluation list. Weight gradients a^T.delta
// contract the batch axis: each thread owns whole output elements and loops
// over the rows in a fixed order, so there are no atomics and a run is the
// same bit for bit from call to call. expf / tanhf are the full precision
// ones (the build has no --use_fast_math).
//
// Every phase is written as a function of (tid, nt) and carries nothing in
// registers across a barrier except values that are uniform over the block.
// With DF_HOST_EMULATION defined, the file compiles as plain C++: whoever
// builds it that way supplies DF_FN, DF_PHASE (a phase runs its threads one
// after another) and the few CUDA builtins used here in a header given to the
// compiler with -include. That is how the CPU tests execute this source.
//
// Members. A launch of K blocks trains K independent runs of one plan, block
// k member k (a deep ensemble: ensemble.py). The rows, weights, constants,
// gradient masks and programs are shared; each member has its own parameters,
// moments, batch order, histories and best snapshot, at a stride of one
// member's size in every such buffer (member_args). Block k runs
// train_run_body on its own view, exactly as a launch of one block would, so
// member k of a K-block launch equals its own one-block launch bit for bit.
//
// C interface (ctypes): df_train_run_members (one run is a launch of one
// member). It launches on the given stream, allocate nothing, do not synchronise, and
// returns cudaGetLastError().

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
#endif

#include "flow_phases.cuh"

namespace {

// scalars in shared memory
enum : int { S_OK = 2 };
// train_run's header words (ops/train_kernels.py): where the programs are
// staged (-1: not), the partial sums over a batch's rows, the gradient's
// row segments and where its copies lie; the evaluation program's own words
enum : int { H_PROG_S = 22, H_PARTS = 24, H_PART = 25, H_GSEGS = 26,
             H_GCOPY = 27 };
enum : int { E_LPM = 22, E_MW = 23, E_PARTS = 24, E_ACC = 25 };
// an instruction's words: the phase's items before it, joins the phase
// before
enum : int { W_START = 14, W_JOIN = 15 };

struct Args {
    const float* x; const float* th; const float* w; const int* perm;
    const float* xv; const float* thv; const float* wv;
    const float* p_in; const float* mu_in; const float* nu_in;
    const float* gmask; const float* consts; const int* prog;
    float* p_out; float* mu_out; float* nu_out;
    float* hist_t; float* hist_v; float* hist_s; float* best;
    const int* eval_prog;
    float* clk;     // DF_TRAIN_CLOCKS: the phase cycles, else null
    // DF_TRAIN_CLOCKS: each block's first and last %globaltimer (ns), two
    // words a block, or null
    unsigned long long* stamps;
    int epochs, n_batches, n_train, n_valid, count0, track_best, weighted,
        guard;
    float lr, b1, b2, eps, omb1, omb2, logb1, logb2;
};

// rows [j * seg, min(rows, (j + 1) * seg)) of partial sum j of P
DF_FN int seg_rows(int rows, int parts) { return (rows + parts - 1) / parts; }

// ---- the dense layers on register tiles -----------------------------------
//
// A phase's dense items are bound by their shared-memory loads (two a
// multiply-add in flow_phases.cuh's f_dense and b_dense; a warp-wide load a
// cycle, more where its words share a bank). These handlers give an item
// four outputs that share loads (five loads feed four multiply-adds), each
// output a scalar of its own (a guard inside, not in a loop's bound), so
// that they stay in registers. An item's loop is ordered so that the
// threads of a warp read different banks or one broadcast word: f_dense4's
// k loop starts at g mod K and wraps (rows 4 K floats apart would share a
// bank), so its sums run in another order than f_dense's; b_dense4 sums in
// b_dense's order.

// f_dense: item (g, c) owns rows 4g .. 4g + 3 of column c
DF_FN void f_dense4(const Mem& m, const int* I, int tid, int nt) {
    const int in1 = I[1], K1 = I[2], w1 = I[3], in2 = I[4], K2 = I[5],
              w2 = I[6], N = I[7], bias = I[8], act = I[9], out = I[10];
    const int groups = (m.B + 3) / 4;
    for (int idx = tid; idx < groups * N; idx += nt) {
        const int g = idx / N, c = idx - g * N, r0 = 4 * g;
        const float b = bias >= 0 ? m.P[bias + c] : 0.f;
        float acc0 = b, acc1 = b, acc2 = b, acc3 = b;
        for (int blk = 0; blk < 2; ++blk) {
            const int K = blk ? K2 : K1, in = blk ? in2 : in1;
            if (K <= 0) continue;
            const float* w = m.P + (blk ? w2 : w1) + c;
            const float* a0 = m.S + in + (r0 < m.B ? r0 : m.B - 1) * K;
            const float* a1 = m.S + in + (r0 + 1 < m.B ? r0 + 1 : m.B - 1) * K;
            const float* a2 = m.S + in + (r0 + 2 < m.B ? r0 + 2 : m.B - 1) * K;
            const float* a3 = m.S + in + (r0 + 3 < m.B ? r0 + 3 : m.B - 1) * K;
            // from k = g mod K round: the items of a warp, which differ in
            // g, then read different banks of their rows (4 K floats apart)
            int k = g % K;
#pragma unroll 2
            for (int it = 0; it < K; ++it) {
                const float wv = w[k * N];
                acc0 = fmaf(a0[k], wv, acc0);
                acc1 = fmaf(a1[k], wv, acc1);
                acc2 = fmaf(a2[k], wv, acc2);
                acc3 = fmaf(a3[k], wv, acc3);
                k = k + 1 == K ? 0 : k + 1;
            }
        }
        float* o = m.S + out + r0 * N + c;
        o[0] = act_fn(act, acc0);
        if (r0 + 1 < m.B) o[N] = act_fn(act, acc1);
        if (r0 + 2 < m.B) o[2 * N] = act_fn(act, acc2);
        if (r0 + 3 < m.B) o[3 * N] = act_fn(act, acc3);
    }
}

// The gradient's copies: the weight and bias gradients are summed over
// `segs` segments of the batch's rows, segment s into the gradient buffer
// (s = 0) or its copy s (at `copy`, np floats each); the mask phase adds
// them in order. Entries no segmented handler writes stay 0 in the copies.
struct GradCopies {
    float* copy;
    int segs;
};

// b_dense: weight-gradient items (s, k, c) own the columns c, c + q,
// c + 2q, c + 3q (q = ceil(N / 4)) of weight row k over row segment s, bias
// items (s, c) one column, input-cotangent items (r4, k) rows 4 r4 .. + 3
// of column k (as grads_tile.cuh's b_dense4)
DF_FN void b_dense4(const Mem& m, const GradCopies& gc, const int* I,
                    int tid, int nt) {
    const int src = I[1], K = I[2], w = I[3], N = I[4], dl = I[5],
              bias = I[6], dout = I[7], acc_flag = I[8], dact = I[9];
    const float* a = m.S + src;
    const float* delta = m.S + dl;
    const int q = (N + 3) / 4, groups = (m.B + 3) / 4;
    const int seg = (m.B + gc.segs - 1) / gc.segs;
    const int n_w = K * q * gc.segs, n_b = bias >= 0 ? N * gc.segs : 0,
              n_d = dout >= 0 ? groups * K : 0;
    for (int idx = tid; idx < n_w + n_b + n_d; idx += nt) {
        if (idx < n_w + n_b) {
            const bool wt = idx < n_w;
            const int j = wt ? idx : idx - n_w;
            const int per = wt ? K * q : N;
            const int s = j / per, e = j - s * per;
            const int r0 = s * seg, r1 = r0 + seg < m.B ? r0 + seg : m.B;
            float* G = s == 0 ? m.G : gc.copy + (s - 1) * m.np;
            if (wt) {
                const int k = e / q, c = e - k * q;
                const int c1 = c + q < N ? c + q : N - 1;
                const int c2 = c + 2 * q < N ? c + 2 * q : N - 1;
                const int c3 = c + 3 * q < N ? c + 3 * q : N - 1;
                float g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f;
#pragma unroll 2
                for (int r = r0; r < r1; ++r) {
                    const float av = a[r * K + k];
                    const float* dr = delta + r * N;
                    g0 = fmaf(av, dr[c], g0);
                    g1 = fmaf(av, dr[c1], g1);
                    g2 = fmaf(av, dr[c2], g2);
                    g3 = fmaf(av, dr[c3], g3);
                }
                G[w + k * N + c] = g0;
                if (c + q < N) G[w + k * N + c + q] = g1;
                if (c + 2 * q < N) G[w + k * N + c + 2 * q] = g2;
                if (c + 3 * q < N) G[w + k * N + c + 3 * q] = g3;
            } else {
                float g = 0.f;
                for (int r = r0; r < r1; ++r) g += delta[r * N + e];
                G[bias + e] = g;
            }
        } else {
            const int i = idx - n_w - n_b;
            const int r4 = i / K, k = i - r4 * K, r0 = 4 * r4;
            const float* d0 = delta + (r0 < m.B ? r0 : m.B - 1) * N;
            const float* d1 = delta + (r0 + 1 < m.B ? r0 + 1 : m.B - 1) * N;
            const float* d2 = delta + (r0 + 2 < m.B ? r0 + 2 : m.B - 1) * N;
            const float* d3 = delta + (r0 + 3 < m.B ? r0 + 3 : m.B - 1) * N;
            const float* wr = m.P + w + k * N;
            float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
            int c = k % N;
            for (int it = 0; it < N; ++it) {
                const float wv = wr[c];
                s0 = fmaf(d0[c], wv, s0);
                s1 = fmaf(d1[c], wv, s1);
                s2 = fmaf(d2[c], wv, s2);
                s3 = fmaf(d3[c], wv, s3);
                c = c + 1 == N ? 0 : c + 1;
            }
            float* o = m.S + dout + r0 * K + k;
            const float* ai = a + r0 * K + k;
            o[0] = ((acc_flag ? s0 + o[0] : s0)) * dact_fn(dact, ai[0]);
            if (r0 + 1 < m.B)
                o[K] = (acc_flag ? s1 + o[K] : s1) * dact_fn(dact, ai[K]);
            if (r0 + 2 < m.B)
                o[2 * K] = (acc_flag ? s2 + o[2 * K] : s2) *
                           dact_fn(dact, ai[2 * K]);
            if (r0 + 3 < m.B)
                o[3 * K] = (acc_flag ? s3 + o[3 * K] : s3) *
                           dact_fn(dact, ai[3 * K]);
        }
    }
}

// One instruction of a phase: its items start at thread I[W_START] mod nt
// (the threads are renumbered), so that a phase's instructions share the
// threads in one round. The handlers are inlined into every phase.
DF_FN void run_instr(const Mem& m, const GradCopies& gc, const int* I,
                     int tid, int nt) {
    const int rot = I[W_START] % nt;
    const int t = tid >= rot ? tid - rot : tid - rot + nt;
    switch (I[0]) {
        case F_DENSE: f_dense4(m, I, t, nt); break;
        case B_DENSE: b_dense4(m, gc, I, t, nt); break;
        default: step(m, I, t, nt); break;
    }
}

// the end of the phase that starts at instruction pc of n
DF_FN int phase_end(const int* prog, int pc, int n) {
    int e = pc + 1;
    while (e < n && prog[e * INSTR_WORDS + W_JOIN]) ++e;
    return e;
}

// ---- phases around the programs (the shared ones are in flow_phases.cuh) --

// Gather one batch through the epoch's index row. Pad entries of the index
// point at row 0 and carry mask 0 by position; importance weights are
// gathered with the same index and multiply the mask. Partial sum j of the
// masks over its rows goes to PART[j] (read from device memory here, the
// same values the mask rows get), and the guard's flag starts at 1.
DF_FN void load_batch(const Mem& m, const Args& a, const int* perm_row,
                      float* part, int parts, int b, int tid, int nt) {
    const int d = m.d, n = m.n, p0 = b * m.B;
    for (int idx = tid; idx < m.B * d; idx += nt) {
        const int r = idx / d, j = idx - r * d;
        m.X0[idx] = a.x[(long long)perm_row[p0 + r] * d + j];
    }
    for (int idx = tid; idx < m.B * n; idx += nt) {
        const int r = idx / n, j = idx - r * n;
        m.TH[idx] = a.th[(long long)perm_row[p0 + r] * n + j];
    }
    for (int r = tid; r < m.B; r += nt) {
        float mk = p0 + r < a.n_train ? 1.f : 0.f;
        if (a.weighted) mk *= a.w[perm_row[p0 + r]];
        m.MASK[r] = mk;
        m.LDJ[r] = 0.f;
    }
    const int seg = seg_rows(m.B, parts);
    for (int j = tid; j < parts; j += nt) {
        float s = 0.f;
        for (int r = j * seg; r < m.B && r < (j + 1) * seg; ++r) {
            float mk = p0 + r < a.n_train ? 1.f : 0.f;
            if (a.weighted) mk *= a.w[perm_row[p0 + r]];
            s += mk;
        }
        part[j] = s;
    }
    if (tid == 0) m.SCAL[S_OK] = 1.f;
}

// den = max(sum of the mask partials in order, 1e-12)
DF_FN float batch_denom(const float* part, int parts) {
    float den = 0.f;
    for (int j = 0; j < parts; ++j) den += part[j];
    return fmaxf(den, 1e-12f);
}

// lp_r = -0.5 * sum z^2 - 0.5 * d * log(2 pi) + ldj_r, then the loss
// cotangents jbar = dL/dlp = -m / den and gz = dL/dz = -jbar * z
DF_FN void lp_cotangents(const Mem& m, const float* part, int parts, int tid,
                         int nt) {
    const int d = m.d;
    for (int r = tid; r < m.B; r += nt) {
        const float den = batch_denom(part, parts);
        float ss = 0.f;
        for (int j = 0; j < d; ++j) ss = fmaf(m.Z[r * d + j], m.Z[r * d + j], ss);
        m.LP[r] = -0.5f * ss - 0.5f * (float)d * 1.8378770664093453f + m.LDJ[r];
        const float jb = -m.MASK[r] / den;
        m.JBAR[r] = jb;
        for (int j = 0; j < d; ++j) m.GZ[r * d + j] = -jb * m.Z[r * d + j];
    }
}

// the guard's loss, partial sums of lp * m over consecutive rows into
// PART[parts + j]
DF_FN void loss_partials(const Mem& m, float* part, int parts, int tid,
                         int nt) {
    const int seg = seg_rows(m.B, parts);
    for (int j = tid; j < parts; j += nt) {
        float num = 0.f;
        for (int r = j * seg; r < m.B && r < (j + 1) * seg; ++r)
            num = fmaf(m.LP[r], m.MASK[r], num);
        part[parts + j] = num;
    }
}

// The row segments' gradients added in order, the 0/1 masks as a SELECT
// (inf * 0 would be NaN), then the finite check on the masked gradients and
// (thread 0) on the loss -num / den: a failed check writes 0 to the flag,
// nothing writes 1.
DF_FN void mask_and_check(const Mem& m, const Args& a, const GradCopies& gc,
                          const float* part, int parts, int tid, int nt) {
    for (int i = tid; i < m.np; i += nt) {
        float sum = m.G[i];
        for (int s = 1; s < gc.segs; ++s) sum += gc.copy[(s - 1) * m.np + i];
        const float g = a.gmask[i] > 0.5f ? sum : 0.f;
        m.G[i] = g;
        if (a.guard && !finite_f(g)) m.SCAL[S_OK] = 0.f;
    }
    if (a.guard && tid == 0) {
        float num = 0.f;
        for (int j = 0; j < parts; ++j) num += part[parts + j];
        if (!finite_f(-num / batch_denom(part, parts))) m.SCAL[S_OK] = 0.f;
    }
}

// optax.adam: moments, bias correction, step of -lr
DF_FN void adam_update(const Mem& m, const Args& a, float bc1, float bc2,
                       int tid, int nt) {
    for (int i = tid; i < m.np; i += nt) {
        const float g = m.G[i];
        const float mu = a.b1 * m.MU[i] + a.omb1 * g;
        const float nu = a.b2 * m.NU[i] + a.omb2 * g * g;
        m.P[i] = m.P[i] - a.lr * (mu / bc1) / (sqrtf(nu / bc2) + a.eps);
        m.MU[i] = mu;
        m.NU[i] = nu;
    }
}

// ---- the evaluation ------------------------------------------------------
//
// The evaluation program's buffers (its own header) overlay the batch
// caches. A tile of B rows ends with eval_lp, which leaves per row lp * m
// and m; the next phase (the next tile's load, or the epoch's fold) adds
// them into partial sums over consecutive rows, one per thread, kept per
// split: ACC[set][0][j] (lp * m) and ACC[set][1][j] (m).

struct EvalTile {
    int set, rows;   // the tile whose products wait to be added, or rows 0
};

DF_FN void eval_lp(const Mem& e, const int* eh, int tid, int nt) {
    const int d = e.d;
    float* lpm = e.S + eh[E_LPM];
    float* mw = e.S + eh[E_MW];
    for (int r = tid; r < e.B; r += nt) {
        float ss = 0.f;
        for (int j = 0; j < d; ++j) ss = fmaf(e.Z[r * d + j], e.Z[r * d + j], ss);
        const float lp =
            -0.5f * ss - 0.5f * (float)d * 1.8378770664093453f + e.LDJ[r];
        lpm[r] = lp * e.MASK[r];
        mw[r] = e.MASK[r];
    }
}

// add the waiting tile's products into its split's partials; `first`: the
// epoch's first tile zeroes every partial first
DF_FN void eval_fold(const Mem& e, const int* eh, EvalTile prev, bool first,
                     int tid, int nt) {
    const int parts = eh[E_PARTS];
    float* acc = e.S + eh[E_ACC];
    const float* lpm = e.S + eh[E_LPM];
    const float* mw = e.S + eh[E_MW];
    const int seg = seg_rows(prev.rows, parts);
    for (int j = tid; j < parts; j += nt) {
        if (first)
            for (int q = 0; q < 4; ++q) acc[q * parts + j] = 0.f;
        float num = acc[(2 * prev.set) * parts + j];
        float den = acc[(2 * prev.set + 1) * parts + j];
        for (int r = j * seg; r < prev.rows && r < (j + 1) * seg; ++r) {
            num += lpm[r];
            den += mw[r];
        }
        acc[(2 * prev.set) * parts + j] = num;
        acc[(2 * prev.set + 1) * parts + j] = den;
    }
}

// thread 0: each split's partials added in order, after the 4 * parts
// partials: (num, den) of the training split, then of the validation split
DF_FN void eval_total(const Mem& e, const int* eh, int tid) {
    if (tid != 0) return;
    const int parts = eh[E_PARTS];
    float* acc = e.S + eh[E_ACC];
    for (int q = 0; q < 4; ++q) {
        float s = 0.f;
        for (int j = 0; j < parts; ++j) s += acc[q * parts + j];
        acc[4 * parts + q] = s;
    }
}

// DF_TRAIN_CLOCKS (a measurement build of tools/chip_probe.py --variants):
// thread 0 writes the cycles of every phase of one training step (epoch 1,
// batch 0) and of one evaluation tile (epoch 1, the training split's first
// tile) to Args::clk: clk[0] and clk[1] the numbers of phases recorded,
// clk[2 + i] the step's phase i, clk[2 + CLK_PHASES + i] the tile's.
constexpr int CLK_PHASES = 256;
struct RunTicks {
#if defined(DF_TRAIN_CLOCKS) && !defined(DF_HOST_EMULATION)
    float* out;
    int slot, n;
    long long last;
    DF_FN void begin(float* o, int s) {
        out = o;
        slot = s;
        n = 0;
        last = clock64();
    }
    DF_FN void tick() {
        if (out == nullptr || threadIdx.x != 0 || n >= CLK_PHASES) return;
        const long long now = clock64();
        out[2 + slot * CLK_PHASES + n++] = (float)(now - last);
        out[slot] = (float)n;
        last = now;
    }
    DF_FN void end() { out = nullptr; }
#else
    DF_FN void begin(float*, int) {}
    DF_FN void tick() {}
    DF_FN void end() {}
#endif
};

// the phases of a program (n instructions from `prog`) on the buffers of m
DF_FN void run_program(const Mem& m, const GradCopies& gc, const int* prog,
                       int n, RunTicks& ticks) {
    for (int pc = 0; pc < n;) {
        const int end = phase_end(prog, pc, n);
        DF_PHASE(
            for (int q = pc; q < end; ++q)
                run_instr(m, gc, prog + q * INSTR_WORDS, tid, nt);
        )
        ticks.tick();
        pc = end;
    }
}

// ---- the run -------------------------------------------------------------

// Uniform control flow: everything outside a DF_PHASE is computed alike by
// every thread of the block from uniform values.
DF_FN void train_run_body(const Args& a, float* S) {
    const int* hdr = a.prog;
    Mem m;
    tile_buffers(m, S, hdr);
    m.P = S + hdr[H_P]; m.MU = S + hdr[H_MU]; m.NU = S + hdr[H_NU];
    m.G = S + hdr[H_G]; m.C = S + hdr[H_C];
    const int n_fwd = hdr[H_NFWD], n_bwd = hdr[H_NBWD];
    const int prog_words = HEADER_WORDS + (n_fwd + n_bwd) * INSTR_WORDS;
    const int eval_words = HEADER_WORDS + a.eval_prog[H_NFWD] * INSTR_WORDS;
    const int prog_s = hdr[H_PROG_S];
    const int parts = hdr[H_PARTS];
    float* part = S + hdr[H_PART];
    GradCopies gc;
    gc.copy = S + hdr[H_GCOPY];
    gc.segs = hdr[H_GSEGS];
    const int n_pad = a.n_batches * m.B;

    DF_PHASE(
        for (int i = tid; i < m.np; i += nt) {
            m.P[i] = a.p_in[i]; m.MU[i] = a.mu_in[i]; m.NU[i] = a.nu_in[i];
        }
        for (int i = tid; i < m.nc; i += nt) m.C[i] = a.consts[i];
        if (prog_s >= 0) {
            int* staged = reinterpret_cast<int*>(S + prog_s);
            for (int i = tid; i < prog_words; i += nt) staged[i] = a.prog[i];
            for (int i = tid; i < eval_words; i += nt)
                staged[prog_words + i] = a.eval_prog[i];
        }
    )
    const int* prog = prog_s >= 0 ? reinterpret_cast<const int*>(S + prog_s)
                                  : a.prog;
    const int* eh = prog_s >= 0 ? prog + prog_words : a.eval_prog;
    const int* fwd = prog + HEADER_WORDS;
    const int* bwd = fwd + n_fwd * INSTR_WORDS;
    const int n_eval = eh[H_NFWD];
    const int* efwd = eh + HEADER_WORDS;
    const int eval_rows = eh[H_B];
    Mem em;
    tile_buffers(em, S, eh);
    em.P = m.P; em.C = m.C; em.G = m.G; em.MU = m.MU; em.NU = m.NU;
    const float* eacc = S + eh[E_ACC] + 4 * eh[E_PARTS];

    RunTicks ticks;
    ticks.end();
    int applied = 0;            // updates applied in this call
    float prev_best = INFINITY; // min of the earlier epochs' valid NLL (NaN
                                // once any of them was NaN)
    for (int e = 0; e < a.epochs; ++e) {
        const int* perm_row = a.perm + (long long)e * n_pad;
        int skips = 0;
        for (int b = 0; b < a.n_batches; ++b) {
            if (e == 1 && b == 0) ticks.begin(a.clk, 0);
            DF_PHASE(
                load_batch(m, a, perm_row, part, parts, b, tid, nt);
                // the evaluation overlays the copies: zero them again
                if (b == 0)
                    for (int i = tid; i < (gc.segs - 1) * m.np; i += nt)
                        gc.copy[i] = 0.f;
            )
            ticks.tick();
            run_program(m, gc, fwd, n_fwd, ticks);
            DF_PHASE(lp_cotangents(m, part, parts, tid, nt))
            ticks.tick();
            for (int pc = 0; pc < n_bwd;) {
                const int end = phase_end(bwd, pc, n_bwd);
                // the guard's loss partials ride on the first phase
                DF_PHASE(
                    if (pc == 0 && a.guard) loss_partials(m, part, parts, tid, nt);
                    for (int q = pc; q < end; ++q)
                        run_instr(m, gc, bwd + q * INSTR_WORDS, tid, nt);
                )
                ticks.tick();
                pc = end;
            }
            DF_PHASE(mask_and_check(m, a, gc, part, parts, tid, nt))
            ticks.tick();
            const bool ok = !a.guard || m.SCAL[S_OK] != 0.f;
            if (ok) {
                // the Adam step is count0 + APPLIED updates + 1
                const float t = (float)(a.count0 + applied + 1);
                const float bc1 = 1.f - expf(t * a.logb1);
                const float bc2 = 1.f - expf(t * a.logb2);
                DF_PHASE(adam_update(m, a, bc1, bc2, tid, nt))
                ticks.tick();
                ++applied;
            } else {
                ++skips;
            }
            ticks.end();
        }

        // full-split evaluations from the parameters after the last batch,
        // in tiles of eval_rows (the last one of a split shorter)
        EvalTile prev = {0, 0};
        bool first = true;
        for (int set = 0; set < 2; ++set) {
            const float* xs = set == 0 ? a.x : a.xv;
            const float* ths = set == 0 ? a.th : a.thv;
            const float* ws = a.weighted ? (set == 0 ? a.w : a.wv) : nullptr;
            const int rows = set == 0 ? a.n_train : a.n_valid;
            for (int row0 = 0; row0 < rows; row0 += eval_rows) {
                if (e == 1 && set == 0 && row0 == 0) ticks.begin(a.clk, 1);
                em.B = rows - row0 < eval_rows ? rows - row0 : eval_rows;
                DF_PHASE(
                    eval_fold(em, eh, prev, first, tid, nt);
                    load_rows(em, xs, ths, ws, rows, row0, tid, nt);
                )
                ticks.tick();
                run_program(em, gc, efwd, n_eval, ticks);
                DF_PHASE(eval_lp(em, eh, tid, nt))
                ticks.tick();
                ticks.end();
                prev.set = set;
                prev.rows = em.B;
                first = false;
            }
        }
        DF_PHASE(eval_fold(em, eh, prev, false, tid, nt))
        DF_PHASE(eval_total(em, eh, tid))
        // unweighted: over the row count; weighted: over max(sum w, 1e-12)
        float nll[2];
        for (int set = 0; set < 2; ++set) {
            const int rows = set == 0 ? a.n_train : a.n_valid;
            const float den = a.weighted ? fmaxf(eacc[2 * set + 1], 1e-12f)
                                         : (float)rows;
            nll[set] = -eacc[2 * set] / den;
        }
        const float vl = nll[1];
        // epoch 0 writes unconditionally; `<` is false on NaN
        const bool better = e == 0 || vl < prev_best;
        prev_best = (nan_f(vl) || nan_f(prev_best)) ? NAN : fminf(prev_best, vl);
        DF_PHASE(
            if (tid == 0) {
                a.hist_t[e] = nll[0];
                a.hist_v[e] = vl;
                a.hist_s[e] = (float)skips;
            }
            if (a.track_best && better)
                for (int i = tid; i < m.np; i += nt) a.best[i] = m.P[i];
        )
    }

    DF_PHASE(
        for (int i = tid; i < m.np; i += nt) {
            a.p_out[i] = m.P[i]; a.mu_out[i] = m.MU[i]; a.nu_out[i] = m.NU[i];
        }
    )
}

Args make_args(const void* const* p, const int* ia, const float* fa) {
    Args a;
    a.x = (const float*)p[0]; a.th = (const float*)p[1];
    a.w = (const float*)p[2]; a.perm = (const int*)p[3];
    a.xv = (const float*)p[4]; a.thv = (const float*)p[5];
    a.wv = (const float*)p[6];
    a.p_in = (const float*)p[7]; a.mu_in = (const float*)p[8];
    a.nu_in = (const float*)p[9]; a.gmask = (const float*)p[10];
    a.consts = (const float*)p[11]; a.prog = (const int*)p[12];
    a.p_out = (float*)p[13]; a.mu_out = (float*)p[14];
    a.nu_out = (float*)p[15]; a.hist_t = (float*)p[16];
    a.hist_v = (float*)p[17]; a.hist_s = (float*)p[18];
    a.best = (float*)p[19];
    a.eval_prog = (const int*)p[20];
#if defined(DF_TRAIN_CLOCKS)
    a.clk = (float*)p[21];
    a.stamps = (unsigned long long*)p[22];
#else
    a.clk = nullptr;
    a.stamps = nullptr;
#endif
    a.epochs = ia[0]; a.n_batches = ia[1]; a.n_train = ia[2];
    a.n_valid = ia[3]; a.count0 = ia[4]; a.track_best = ia[5];
    a.weighted = ia[6]; a.guard = ia[7];
    a.lr = fa[0]; a.b1 = fa[1]; a.b2 = fa[2]; a.eps = fa[3];
    a.omb1 = fa[4]; a.omb2 = fa[5]; a.logb1 = fa[6]; a.logb2 = fa[7];
    return a;
}

// member k's view of the arguments: its parameters, moments, outputs and
// best snapshot np floats apart, its batch order epochs x n_batches * B
// ints apart, its histories epochs floats apart; the clocks are block 0's
DF_FN Args member_args(Args a, int k) {
    const long long np = a.prog[H_NP];
    const long long n_pad = (long long)a.n_batches * a.prog[H_B];
    const long long e = a.epochs;
    a.p_in += k * np; a.mu_in += k * np; a.nu_in += k * np;
    a.p_out += k * np; a.mu_out += k * np; a.nu_out += k * np;
    if (a.best != nullptr) a.best += k * np;
    a.perm += k * e * n_pad;
    a.hist_t += k * e; a.hist_v += k * e; a.hist_s += k * e;
    if (k != 0) a.clk = nullptr;
    return a;
}

// at most 512 threads: 128 registers a thread (at 1,024 the phases spilled)
#ifndef DF_HOST_EMULATION
__global__ void __launch_bounds__(512, 1)
train_run_kernel(Args a) {
    extern __shared__ float4 smem4[];
#if defined(DF_TRAIN_CLOCKS)
    unsigned long long t0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
#endif
    train_run_body(member_args(a, blockIdx.x), reinterpret_cast<float*>(smem4));
#if defined(DF_TRAIN_CLOCKS)
    unsigned long long t1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    if (threadIdx.x == 0 && a.stamps != nullptr) {
        a.stamps[2 * blockIdx.x] = t0;
        a.stamps[2 * blockIdx.x + 1] = t1;
    }
#endif
}
#endif

}  // namespace

extern "C" {

// ptrs (21 device pointers, null where absent): x, theta, w, perm (int32,
// epochs x n_batches*B), x_valid, theta_valid, w_valid, params, mu, nu,
// gradient mask, constants, program, params out, mu out, nu out, train
// history, valid history, skip history, best snapshot, evaluation program;
// in the DF_TRAIN_CLOCKS build a 22nd, the clock buffer (2 + 2 *
// CLK_PHASES floats), and a 23rd, two 64-bit words a block for its first
// and last %globaltimer (or null).
// iargs: epochs, n_batches, n_train, n_valid, count0, track_best, weighted,
// guard. fargs: lr, b1, b2, eps, 1-b1, 1-b2, log b1, log b2.
// `members` runs, one block each: the per-member buffers (params, mu, nu, perm, the outputs, the histories and
// the best snapshot) hold the members one after another.
#ifndef DF_HOST_EMULATION
int df_train_run_members(const void* const* ptrs, const int* iargs,
                         const float* fargs, int members, int threads,
                         int shared_bytes, void* stream) {
    const Args a = make_args(ptrs, iargs, fargs);
    cudaError_t err = cudaFuncSetAttribute(
        train_run_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return (int)err;
    train_run_kernel<<<members, threads, shared_bytes,
                       static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}
#else
// The same runs on host pointers, the blocks one after another (reverse_
// blocks != 0: last member first), each block's threads one after another
// in the order the -include'd header is told (reverse != 0: last thread
// first), each block on a fresh shared array filled with NaN.
int df_train_run_members_emulated(const void* const* ptrs, const int* iargs,
                                  const float* fargs, int members,
                                  int threads, int shared_bytes, int reverse,
                                  int reverse_blocks) {
    const Args a = make_args(ptrs, iargs, fargs);
    df_emulation_threads = threads;
    df_emulation_reverse = reverse;
    float* S = new float[shared_bytes / 4];
    for (int j = 0; j < members; ++j) {
        const int k = reverse_blocks ? members - 1 - j : j;
        for (int i = 0; i < shared_bytes / 4; ++i) S[i] = NAN;
        train_run_body(member_args(a, k), S);
    }
    delete[] S;
    return 0;
}
#endif

}  // extern "C"
