// The tile body of the two grads kernels: step_grads (step_kernels.cu) and
// train_stream (stream_kernels.cu). One block takes the row tiles k,
// k + grid, k + 2 grid, ... of a batch and leaves its gradient partial and
// its share of the loss in its own row of a (grid, np + 1) partial buffer:
// per tile the inverse fold with activation caches, the tile's share of the
// masked NLL -sum m.lp / denom, and the hand-derived backward. The first tile
// writes the gradients, the later ones add (Mem::acc). The kernels differ
// only in where a tile's rows come from (as they lie, or gathered through a
// permutation: the caller's loader) and in what they do around the body.
//
// What bounds it: latency. A tile is some 55 barrier-ended phases on 8
// rows, each a short loop; the arithmetic of a batch is small (0.2 GFLOP at
// d 16 / hidden 64 / batch 1024). Three things keep the phases short:
//   - the folded parameters, the constants and the program are staged in
//     shared memory (cp.async, async_copy.cuh) wherever they fit beside the
//     tile, so that no phase waits on L2 for a weight or an instruction
//     (stage_buffers: after the tile's floats, each part rounded up to 16
//     bytes); else the phases read them from device memory, with the same
//     bits;
//   - the handlers are inlined into each phase (step_instr): one shared,
//     called copy measured 19 % slower at hidden 64 on an H100;
//   - the weight gradients of a layer with N >= 32 run on register tiles
//     (b_dense4), which sum in flow_phases.cuh's order and give its bits.
// A kernel that includes this header launches at most 512 threads a block
// (128 registers a thread; 1,024 threads left 64 and spilled).
//
// The including file defines DF_FN and DF_PHASE and includes
// flow_phases.cuh and async_copy.cuh first.

#pragma once

namespace {

// scalar in shared memory: the block's loss so far
enum : int { S_LOSS = 0 };

// floats rounded up to 16 bytes
DF_FN int align4(int floats) { return (floats + 3) / 4 * 4; }

// Where the staged parameters, constants and program lie in a block's
// shared array S: after the tile's floats, each part rounded up to 16 bytes
// (mirrored by ops/step_kernels.py::StepPlan.shared_bytes).
struct Staged {
    float* P;
    float* C;
    float* I;
    int prog_words;
};

DF_FN Staged stage_buffers(float* S, const int* hdr) {
    Staged s;
    s.P = S + align4(hdr[H_TOTAL]);
    s.C = s.P + align4(hdr[H_NP]);
    s.I = s.C + align4(hdr[H_NC]);
    s.prog_words = HEADER_WORDS + (hdr[H_NFWD] + hdr[H_NBWD]) * INSTR_WORDS;
    return s;
}

// The tile's share of the loss, added to the block's: thread 0, rows in
// order. `first`: the block's first tile starts the sum.
DF_FN void tile_loss(const Mem& m, float den, bool first, int tid) {
    if (tid != 0) return;
    float num = 0.f;
    for (int r = 0; r < m.B; ++r) num = fmaf(m.LP[r], m.MASK[r], num);
    const float loss = -num / den;
    m.SCAL[S_LOSS] = first ? loss : m.SCAL[S_LOSS] + loss;
}

// ---- the weight gradients on register tiles -------------------------------
//
// flow_phases.cuh's b_dense gives a thread one output element at a time: two
// shared loads, an integer division and some index arithmetic per
// multiply-add, so that at hidden 64 the phase is bound by the instructions
// it issues (per-phase cycles on an H100, the DF_STEP_CLOCKS build of
// tools/chip_probe.py --variants: b_dense 66 % of a tile's 258k cycles, the
// forward dense layers 21 %). b_dense4 gives a thread four outputs that
// share a load, so that five loads feed four multiply-adds; every output is
// summed in flow_phases.cuh's order, so it gives its bits. It pays where
// the layer is wide (N >= 32): at hidden 16 the phases have too few items
// to share, and the same tiling of f_dense lost at both widths.

// b_dense over three kinds of items: weight-gradient items (k, c) own the
// columns c, c + q, c + 2q, c + 3q (q = ceil(N / 4)) of weight row k, each a
// sum over the rows in order; bias items own one column; input-cotangent
// items (r4, k) own rows 4 r4 .. 4 r4 + 3 of column k, each a sum over the
// columns from k % N round, as flow_phases.cuh's b_dense.
DF_FN void b_dense4(const Mem& m, const int* I, int tid, int nt) {
    const int src = I[1], K = I[2], w = I[3], N = I[4], dl = I[5],
              bias = I[6], dout = I[7], acc_flag = I[8], dact = I[9];
    const float* a = m.S + src;
    const float* delta = m.S + dl;
    const int q = (N + 3) / 4, groups = (m.B + 3) / 4;
    const int n_w = K * q, n_b = bias >= 0 ? N : 0,
              n_d = dout >= 0 ? groups * K : 0;
    for (int idx = tid; idx < n_w + n_b + n_d; idx += nt) {
        if (idx < n_w) {
            const int k = idx / q, c = idx - k * q;
            float g[4] = {0.f, 0.f, 0.f, 0.f};
            for (int r = 0; r < m.B; ++r) {
                const float av = a[r * K + k];
                for (int j = 0; j < 4; ++j) {
                    const int cj = c + j * q < N ? c + j * q : N - 1;
                    g[j] = fmaf(av, delta[r * N + cj], g[j]);
                }
            }
            for (int j = 0; j < 4 && c + j * q < N; ++j)
                put_grad(m, w + k * N + c + j * q, g[j]);
        } else if (idx < n_w + n_b) {
            const int c = idx - n_w;
            float g = 0.f;
            for (int r = 0; r < m.B; ++r) g += delta[r * N + c];
            put_grad(m, bias + c, g);
        } else {
            const int i = idx - n_w - n_b;
            const int r4 = i / K, k = i - r4 * K, r0 = 4 * r4;
            int rows[4];
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            for (int j = 0; j < 4; ++j)
                rows[j] = r0 + j < m.B ? r0 + j : m.B - 1;
            const float* wr = m.P + w + k * N;
            int c = k % N;
            for (int it = 0; it < N; ++it) {
                const float wv = wr[c];
                for (int j = 0; j < 4; ++j)
                    acc[j] = fmaf(delta[rows[j] * N + c], wv, acc[j]);
                c = c + 1 == N ? 0 : c + 1;
            }
            for (int j = 0; j < 4 && r0 + j < m.B; ++j) {
                float* o = m.S + dout + (r0 + j) * K + k;
                float v = acc[j];
                if (acc_flag) v += *o;
                *o = v * dact_fn(dact, a[(r0 + j) * K + k]);
            }
        }
    }
}

// DF_STEP_TILED, a tuning switch that tools/chip_probe.py --variants times
// on the card (the default is the one kept): b_dense4 for layers with
// N >= 32 (1) or flow_phases.cuh's b_dense everywhere (0; the CPU tests hold
// the two to the same bits).
#ifndef DF_STEP_TILED
#define DF_STEP_TILED 1
#endif

DF_FN void step_instr(const Mem& m, const int* I, int tid, int nt) {
#if DF_STEP_TILED
    if (I[0] == B_DENSE && I[4] >= 32) return b_dense4(m, I, tid, nt);
#endif
    step(m, I, tid, nt);
}

// DF_STEP_CLOCKS (a measurement build of tools/chip_probe.py --variants):
// thread 0 writes the cycles of each phase of its block's tiles to `out`,
// in phase order (the caller passes out = null but for block 0).
struct PhaseTicks {
#if defined(DF_STEP_CLOCKS) && !defined(DF_HOST_EMULATION)
    float* out;
    int n;
    long long last;
    DF_FN void start(float* o) {
        out = o;
        n = 0;
        last = clock64();
    }
    DF_FN void tick() {
        if (out == nullptr || threadIdx.x != 0 || n >= 4096) return;
        const long long now = clock64();
        out[n++] = (float)(now - last);
        last = now;
    }
#else
    DF_FN void start(float*) {}
    DF_FN void tick() {}
#endif
};

// The block's tiles of one batch into its partial row m.G, then the block's
// loss into m.G[np]. m holds the tile's buffers and where the parameters,
// constants and gradients lie; `prog` is the program (staged or not);
// load(row0, tid, nt) fills rows row0 .. row0 + B of the tile (X0, TH, MASK
// and LDJ = 0). Uniform control flow: everything outside a DF_PHASE is
// computed alike by every thread of the block from uniform values.
template <class Load>
DF_FN void grads_tiles(Mem& m, const int* prog, int n_tiles, int block,
                       int n_blocks, float den, Load&& load,
                       PhaseTicks& ticks) {
    const int n_fwd = prog[H_NFWD], n_bwd = prog[H_NBWD];
    const int* fwd = prog + HEADER_WORDS;
    const int* bwd = fwd + n_fwd * INSTR_WORDS;
    for (int tile = block; tile < n_tiles; tile += n_blocks) {
        const bool first = tile == block;
        m.acc = first ? 0 : 1;
        DF_PHASE(load(tile * m.B, tid, nt))
        ticks.tick();
        for (int pc = 0; pc < n_fwd; ++pc) {
            DF_PHASE(step_instr(m, fwd + pc * INSTR_WORDS, tid, nt))
            ticks.tick();
        }
        DF_PHASE(row_log_prob(m, tid, nt))
        ticks.tick();
        // the loss reads LP and MASK, the cotangents read MASK and Z and
        // write JBAR and GZ: one phase
        DF_PHASE(
            tile_loss(m, den, first, tid);
            loss_cotangents(m, den, tid, nt);
        )
        ticks.tick();
        for (int pc = 0; pc < n_bwd; ++pc) {
            DF_PHASE(step_instr(m, bwd + pc * INSTR_WORDS, tid, nt))
            ticks.tick();
        }
    }
    // thread 0 wrote S_LOSS last in a phase that a barrier ended
    DF_PHASE(if (tid == 0) m.G[m.np] = m.SCAL[S_LOSS])
}

}  // namespace
