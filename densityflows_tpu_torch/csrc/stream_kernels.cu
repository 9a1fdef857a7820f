// Streaming whole-run training kernel for Hopper (sm_90a): train_stream.
//
// It replaces the Pallas TPU kernel of the JAX package,
// densityflows_tpu/ops/pallas_train_stream.py::_stream_kernel: one launch runs
// a chunk of epochs, `for epoch: for batch:` gather the batch through the
// epoch's permutation row, inverse fold with activation caches, masked
// (optionally weighted) NLL over the batch's sum of the mask, hand-derived
// backward, the 0/1 gradient masks as a select, the non-finite guard, the
// optax.adam update (step = count0 + updates applied + 1), per-epoch skip
// counts, and after an epoch's last batch a snapshot of the folded parameters.
// The per-epoch histories are computed outside, from the snapshots.
//
// Residency. train_run (train_kernels.cu) keeps parameters, both moments and
// the gradients in ONE block's shared memory, which caps the model. Here
// they lie in device memory (L2 holds them at these sizes), and a block's
// shared memory holds one row tile's rows, caches and scratch, laid out by
// ops/train_kernels.py::pack_train_plan(state_in_shared=False) as for
// step_grads. Where they fit beside the tile (iargs `stage`; 39,264
// parameters at d 16 / hidden 64 take 157 KB of the 227 KB), a block also
// holds a copy of the parameters, staged anew after every update, and the
// constants and the program, staged once per launch (grads_tile.cuh's
// layout). The envelope is the caches of one row.
//
// Order. The TPU grid over epochs x batches runs in order on one core; here a
// batch is split over many blocks, and every block must see the previous
// step's update. The run is ONE persistent cooperative launch (no more blocks
// than can be resident at once) with grid-wide barriers between the phases
// of a step:
//   (a) tiles: block k stages the parameters and takes the batch's row tiles
//       k, k + grid, ... into row k of the (grid, np + 1) partial buffer:
//       grads_tile.cuh's body, the one step_grads runs, with the rows
//       gathered through the permutation;
//   (b) reduce: block k owns a contiguous slice of the np + 1 entries and
//       sums the partial rows over the blocks in index order, the select
//       mask applied;
//   (c) update: Adam on the block's slice and, at an epoch's end, its
//       snapshot.
// Without the guard, (b) and (c) are one phase: a block updates the entries
// it has just summed, so a step has two barriers. With the guard, (b) also
// writes whether its slice is finite, and (c) follows a third barrier:
// every block reads every slice's flag, so all blocks take the same
// decision and keep the same count of applied updates.
// No float atomics: two launches give the same bits, for any order of blocks.
// The batch denominators (the sums of the mask, in 32 fixed lanes) come in
// from the wrapper, computed before the launch.
//
// Two designs, one launch each (ops/stream_kernels.py::launch_shape picks
// from the plan's shape and the batch, uses_tc):
//   - the tile body above (train_stream_kernel). What bounds it: latency,
//     as for step_grads (grads_tile.cuh): some 55 block-wide phases on a few
//     hundred kFLOP per tile, then the barriers and the reduction of the
//     partial buffer. It wins where one round of its tiles covers the batch
//     (d 16 / hidden 64 at batch 1024: 0.14 against 0.56 ms a step on an
//     H100);
//   - the tensor-core design (train_stream_tc_kernel, stream_tc.cuh): tiles
//     of 64 rows with their caches in a device workspace, the products on
//     mma.sync in 3xTF32, the weight gradients summed over segments of the
//     batch, then (R) over the segments' rows. It wins where the tile body
//     would take several rounds of small tiles (the emulator32 step: 4.0
//     against 47 ms), up to the batch whose workspace (every tile's
//     caches, about 72 KB a row there) passes TC_WORKSPACE_BYTES.
//
// Each grid phase is a function of (block, n_blocks, step) that carries
// nothing in shared memory into the next one but the staged constants and
// program; what a block carries across steps (its count of applied
// updates, the epoch's skips) is in `Counters`. With DF_HOST_EMULATION
// defined the file compiles as plain C++ and the CPU tests run each phase
// over all blocks, in either order, before the next.
//
// C interface (ctypes): df_train_stream (launches either design, iargs
// word 9, on the given stream, allocates nothing, does not synchronise,
// returns the CUDA error code) and df_train_stream_max_blocks (how many
// blocks of a design's shape can be resident).

#ifndef DF_HOST_EMULATION
#include <cooperative_groups.h>
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

#include "async_copy.cuh"
#include "flow_phases.cuh"
#include "grads_tile.cuh"
#include "stream_tc.cuh"

namespace {

// scalar in shared memory besides grads_tile.cuh's S_LOSS: a finite flag
enum : int { S_OK = 2 };

struct StreamArgs {
    const float* x; const float* th; const float* w; const int* perm;
    const float* gmask; const float* consts; const int* prog;
    float* p; float* mu; float* nu;   // the run's state, updated in place
    float* partial;                   // (grid, np + 1)
    float* grad;                      // np + 1: reduced gradient, then loss
    float* flags;                     // grid: 1 where a slice is finite
    float* snaps;                     // (epochs, np)
    float* skips;                     // epochs
    float* losses;                    // epochs * n_batches, or null
    float* clocks;                    // DF_STREAM_CLOCKS: cycles, or null
    const float* denoms;              // epochs * n_batches, clamped
    float* ws;                        // tc: the tiles' caches, their losses
    const int* items;                 // tc: the W items, 4 words each
    int epochs, n_batches, batchsize, n_train, n_tiles, count0, weighted,
        guard, stage;
    int tc, n_seg, seg_tiles, n_items;  // the tensor-core design
    float lr, b1, b2, eps, omb1, omb2, logb1, logb2;
};

// DF_STREAM_CLOCKS (a measurement build of tools/chip_probe.py --variants):
// thread 0 of block 0 adds the cycles of each part of a step to its slot,
// and writes the sums and the step count to StreamArgs::clocks at the end.
// Slots that a design does not have stay 0 (CK_DENOM: the parent design's
// in-kernel denominator; CK_SYNC_REDUCE and CK_UPDATE: the guard's path;
// CK_WGRADS, CK_SYNC_WGRADS and CK_TC_DENSE, the tile products inside
// CK_TILES' phase: the tensor-core design's).
// CK_P_* / CK_W_*: the waits for copies, the splits and the products inside
// the tile products and the W items.
enum : int { CK_DENOM = 0, CK_STAGE, CK_TILES, CK_SYNC_TILES, CK_REDUCE,
             CK_SYNC_REDUCE, CK_UPDATE, CK_SYNC_UPDATE, CK_WGRADS,
             CK_SYNC_WGRADS, CK_TC_DENSE, CK_P_WAIT, CK_P_SPLIT, CK_P_MMA,
             CK_W_WAIT, CK_W_SPLIT, CK_W_MMA, CK_STEPS, CK_SLOTS };
struct Clock {
#if defined(DF_STREAM_CLOCKS) && !defined(DF_HOST_EMULATION)
    long long c[CK_SLOTS];
    long long last;
    DF_FN void start() {
        for (int i = 0; i < CK_SLOTS; ++i) c[i] = 0;
        last = clock64();
    }
    DF_FN void tick(int slot) {
        if (blockIdx.x != 0 || threadIdx.x != 0) return;
        const long long now = clock64();
        c[slot] += now - last;
        last = now;
    }
    DF_FN void write(float* out, int steps) {
        if (out == nullptr || blockIdx.x != 0 || threadIdx.x != 0) return;
        for (int i = 0; i < CK_STEPS; ++i) out[i] = (float)c[i];
        out[CK_STEPS] = (float)steps;
    }
#else
    DF_FN void start() {}
    DF_FN void tick(int) {}
    DF_FN void write(float*, int) {}
#endif
};

// what a block carries from one step to the next; the same in every block
struct Counters {
    int applied;   // updates applied in this launch
    int skips;     // steps of the current epoch the guard skipped
};

// Mask of position `pos` of the epoch's (padded) order: 1 inside the
// training rows, 0 on the pad entries, times the row's importance weight.
DF_FN float batch_mask(const StreamArgs& a, const int* perm_row, int pos) {
    float mk = pos < a.n_train ? 1.f : 0.f;
    if (a.weighted) mk *= a.w[perm_row[pos]];
    return mk;
}

// Rows t0 .. t0 + B of the batch that starts at position p0, gathered
// through the permutation row; rows past the batch's end are zeros with
// mask 0.
DF_FN void load_tile(const Mem& m, const StreamArgs& a, const int* perm_row,
                     int p0, int t0, int tid, int nt) {
    const int d = m.d, n = m.n, bs = a.batchsize;
    for (int idx = tid; idx < m.B * d; idx += nt) {
        const int r = idx / d, j = idx - r * d, q = t0 + r;
        m.X0[idx] = q < bs ? a.x[(long long)perm_row[p0 + q] * d + j] : 0.f;
    }
    for (int idx = tid; idx < m.B * n; idx += nt) {
        const int r = idx / n, j = idx - r * n, q = t0 + r;
        m.TH[idx] = q < bs ? a.th[(long long)perm_row[p0 + q] * n + j] : 0.f;
    }
    for (int r = tid; r < m.B; r += nt) {
        const int q = t0 + r;
        m.MASK[r] = q < bs ? batch_mask(a, perm_row, p0 + q) : 0.f;
        m.LDJ[r] = 0.f;
    }
}

// the slice of the np + 1 entries (gradients, then the loss) a block owns
DF_FN void block_slice(int len, int block, int n_blocks, int& lo, int& hi) {
    const int per = (len + n_blocks - 1) / n_blocks;
    lo = block * per;
    hi = lo + per < len ? lo + per : len;
}

// Entry i of the batch's gradient (or the loss, i = np): the `rows` partial
// rows (the blocks', or the tensor-core design's segments') in index order,
// then the 0/1 mask as a select (inf * 0 would be NaN). The loads go out
// sixteen at a time; the adds keep their order.
DF_FN float reduced_entry(const StreamArgs& a, int np, int rows, int i) {
    const long long len = np + 1;
    const float* col = a.partial + i;
    float acc = 0.f;
    int g = 0;
    for (; g + 16 <= rows; g += 16) {
        float v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = col[(g + j) * len];
#pragma unroll
        for (int j = 0; j < 16; ++j) acc += v[j];
    }
    for (; g < rows; ++g) acc += col[g * len];
    if (i < np && !(a.gmask[i] > 0.5f)) acc = 0.f;
    return acc;
}

// Adam on entry i with gradient g at bias corrections bc1, bc2
DF_FN void adam_entry(const StreamArgs& a, int i, float g, float bc1,
                      float bc2) {
    const float mu = a.b1 * a.mu[i] + a.omb1 * g;
    const float nu = a.b2 * a.nu[i] + a.omb2 * g * g;
    a.p[i] = a.p[i] - a.lr * (mu / bc1) / (sqrtf(nu / bc2) + a.eps);
    a.mu[i] = mu;
    a.nu[i] = nu;
}

// ---- the phases of a launch ------------------------------------------------

// Once per launch: the constants and the program into the block's shared
// memory, where the parameters are staged too; they stay for the launch.
DF_FN void stream_stage_once(const StreamArgs& a, float* S) {
    if (!a.stage) return;
    const Staged st = stage_buffers(S, a.prog);
    const int nc = a.prog[H_NC];
    DF_PHASE(
        if (nc > 0) df_cp_async_floats(st.C, a.consts, nc, tid, nt);
        df_cp_async_floats(st.I, reinterpret_cast<const float*>(a.prog),
                           st.prog_words, tid, nt);
        df_cp_async_wait_all();
    )
}

// (a) the parameters staged, then the block's tiles of batch b of epoch e
// into its partial row.
DF_FN void stream_tiles(const StreamArgs& a, float* S, int block,
                        int n_blocks, int e, int b, Clock& ck) {
    const int* hdr = a.prog;
    Mem m;
    tile_buffers(m, S, hdr);
    m.P = a.p;                               // read only in this phase
    m.C = const_cast<float*>(a.consts);
    m.MU = nullptr; m.NU = nullptr;
    const int* prog = a.prog;
    if (a.stage) {
        const Staged st = stage_buffers(S, hdr);
        DF_PHASE(
            df_cp_async_floats(st.P, a.p, m.np, tid, nt);
            df_cp_async_wait_all();
        )
        m.P = st.P;
        m.C = st.C;
        prog = reinterpret_cast<const int*>(st.I);
    }
    ck.tick(CK_STAGE);
    m.G = a.partial + (long long)block * (m.np + 1);
    const int* perm_row = a.perm + (long long)e * a.n_batches * a.batchsize;
    const int p0 = b * a.batchsize;
    const float den = a.denoms[e * a.n_batches + b];
    PhaseTicks ticks;
    ticks.start(nullptr);
    grads_tiles(m, prog, a.n_tiles, block, n_blocks, den,
                [&](int row0, int tid, int nt) {
                    load_tile(m, a, perm_row, p0, row0, tid, nt);
                },
                ticks);
    ck.tick(CK_TILES);
}

// (b) + (c) without the guard: the block's slice summed and, where it holds
// gradients, updated by Adam at once (and snapshot at an epoch's end); the
// owner of the loss entry records the step's loss.
DF_FN void stream_reduce_update(const StreamArgs& a, int block, int n_blocks,
                                int rows, int e, int b, Counters& c) {
    const int np = a.prog[H_NP];
    int lo, hi;
    block_slice(np + 1, block, n_blocks, lo, hi);
    const float t = (float)(a.count0 + c.applied + 1);
    const float bc1 = 1.f - expf(t * a.logb1);
    const float bc2 = 1.f - expf(t * a.logb2);
    const bool snap = b == a.n_batches - 1;
    const int step_index = e * a.n_batches + b;
    DF_PHASE(
        for (int i = lo + tid; i < hi; i += nt) {
            const float g = reduced_entry(a, np, rows, i);
            if (i == np) {
                if (a.losses != nullptr) a.losses[step_index] = g;
                continue;
            }
            adam_entry(a, i, g, bc1, bc2);
            if (a.tc) tc_plane_entry(a.ws, a.prog, a.n_tiles, a.p, i);
            if (snap) a.snaps[(long long)e * np + i] = a.p[i];
        }
        if (snap && block == 0 && tid == 0) a.skips[e] = 0.f;
    )
    ++c.applied;
}

// (b) with the guard: the block's slice into the reduced gradient, the
// slice's finite flag; the owner of the loss entry records the step's loss.
// scal: the block's scalars in shared memory.
DF_FN void stream_reduce(const StreamArgs& a, float* scal, int block,
                         int n_blocks, int rows, int step_index) {
    const int np = a.prog[H_NP], len = np + 1;
    int lo, hi;
    block_slice(len, block, n_blocks, lo, hi);
    DF_PHASE(if (tid == 0) scal[S_OK] = 1.f)
    DF_PHASE(
        for (int i = lo + tid; i < hi; i += nt) {
            const float acc = reduced_entry(a, np, rows, i);
            a.grad[i] = acc;
            if (!finite_f(acc)) scal[S_OK] = 0.f;
        }
    )
    DF_PHASE(
        if (tid == 0) {
            a.flags[block] = scal[S_OK];
            if (a.losses != nullptr && lo <= np && np < hi)
                a.losses[step_index] = a.grad[np];
        }
    )
}

// (c) with the guard: the decision from every slice's flag, Adam on the
// block's slice, and at the epoch's end its snapshot. Each thread reads
// back the reduced entries it wrote itself in (b): the same slice, the same
// stride.
DF_FN void stream_update(const StreamArgs& a, float* scal, int block,
                         int n_blocks, int e, int b, Counters& c) {
    const int np = a.prog[H_NP];
    int lo, hi;
    block_slice(np + 1, block, n_blocks, lo, hi);
    if (hi > np) hi = np;
    DF_PHASE(if (tid == 0) scal[S_OK] = 1.f)
    DF_PHASE(
        for (int g = tid; g < n_blocks; g += nt)
            if (a.flags[g] == 0.f) scal[S_OK] = 0.f;
    )
    const bool ok = scal[S_OK] != 0.f;
    if (ok) {
        // the Adam step is count0 + APPLIED updates + 1
        const float t = (float)(a.count0 + c.applied + 1);
        const float bc1 = 1.f - expf(t * a.logb1);
        const float bc2 = 1.f - expf(t * a.logb2);
        DF_PHASE(
            for (int i = lo + tid; i < hi; i += nt) {
                adam_entry(a, i, a.grad[i], bc1, bc2);
                if (a.tc) tc_plane_entry(a.ws, a.prog, a.n_tiles, a.p, i);
            }
        )
        ++c.applied;
    } else {
        ++c.skips;
    }
    if (b == a.n_batches - 1) {
        DF_PHASE(
            for (int i = lo + tid; i < hi; i += nt)
                a.snaps[(long long)e * np + i] = a.p[i];
            if (block == 0 && tid == 0) a.skips[e] = (float)c.skips;
        )
        c.skips = 0;
    }
}

// ---- the phases of the tensor-core design (stream_tc.cuh) ---------------

// (T) the block's tiles of batch b of epoch e: each folded forward on the
// tile's rows in the workspace, its share of the loss into the workspace's
// slot after the tiles, then the backward's pullbacks and coupling steps
DF_FN void tc_tiles(const StreamArgs& a, float* sm, int block, int n_blocks,
                    int e, int b, Clock& ck) {
    const int* prog = a.prog;
    const int n_fwd = prog[H_NFWD], n_bwd = prog[H_NBWD];
    const int* fwd = prog + HEADER_WORDS;
    const int* bwd = fwd + n_fwd * INSTR_WORDS;
    const long long stride = tc_tile_stride(prog);
    float* tile_loss = a.ws + (long long)a.n_tiles * stride;
    const int* perm_row = a.perm + (long long)e * a.n_batches * a.batchsize;
    const int p0 = b * a.batchsize;
    const float den = a.denoms[e * a.n_batches + b];
    const TcW wp = tc_planes(a.ws, prog, a.n_tiles);
    for (int tile = block; tile < a.n_tiles; tile += n_blocks) {
        Mem m;
        tile_buffers(m, a.ws + tile * stride, prog);
        m.P = a.p;
        m.C = const_cast<float*>(a.consts);
        m.MU = nullptr; m.NU = nullptr; m.G = nullptr;
        DF_PHASE(load_tile(m, a, perm_row, p0, tile * TC_ROWS, tid, nt))
        for (int pc = 0; pc < n_fwd; ++pc) {
            const int* I = fwd + pc * INSTR_WORDS;
            if (I[0] == F_DENSE) {
                ck.tick(CK_TILES);
                tc_dense_fwd(m, wp, I, sm, ck, CK_P_WAIT);
                ck.tick(CK_TC_DENSE);
            } else {
                DF_PHASE(step(m, I, tid, nt))
            }
        }
        DF_PHASE(row_log_prob(m, tid, nt))
        DF_PHASE(
            if (tid == 0) {
                float num = 0.f;
                for (int r = 0; r < m.B; ++r)
                    num = fmaf(m.LP[r], m.MASK[r], num);
                tile_loss[tile] = -num / den;
            }
            loss_cotangents(m, den, tid, nt);
        )
        for (int pc = 0; pc < n_bwd; ++pc) {
            const int* I = bwd + pc * INSTR_WORDS;
            if (I[0] == B_DENSE) {
                // the weight and bias gradients wait for phase (W)
                if (I[7] >= 0) {
                    ck.tick(CK_TILES);
                    tc_dense_pullback(m, wp, I, sm, ck, CK_P_WAIT);
                    ck.tick(CK_TC_DENSE);
                }
            } else {
                DF_PHASE(step(m, I, tid, nt))
            }
        }
    }
}

// Once per launch: the block's slice of the parameters into the weights'
// planes
DF_FN void tc_planes_once(const StreamArgs& a, int block, int n_blocks) {
    const int np = a.prog[H_NP];
    int lo, hi;
    block_slice(np + 1, block, n_blocks, lo, hi);
    if (hi > np) hi = np;
    DF_PHASE(
        for (int i = lo + tid; i < hi; i += nt)
            tc_plane_entry(a.ws, a.prog, a.n_tiles, a.p, i);
    )
}

// (W) the block's W items into their segments' partial rows; the owner of
// segment s (block s mod grid) sums its tiles' losses in tile order
DF_FN void tc_wgrads(const StreamArgs& a, float* sm, int block,
                     int n_blocks, Clock& ck) {
    const int np = a.prog[H_NP];
    const long long len = np + 1;
    const long long stride = tc_tile_stride(a.prog);
    const float* tile_loss = a.ws + (long long)a.n_tiles * stride;
    for (int s = block; s < a.n_seg; s += n_blocks) {
        const int t0 = s * a.seg_tiles;
        const int t1 = t0 + a.seg_tiles < a.n_tiles ? t0 + a.seg_tiles
                                                     : a.n_tiles;
        DF_PHASE(
            if (tid == 0) {
                float acc = 0.f;
                for (int t = t0; t < t1; ++t) acc += tile_loss[t];
                a.partial[s * len + np] = acc;
            }
        )
    }
    for (int it = block; it < a.n_items; it += n_blocks) {
        const int* item = a.items + 4 * it;
        const int s = item[3], t0 = s * a.seg_tiles;
        const int t1 = t0 + a.seg_tiles < a.n_tiles ? t0 + a.seg_tiles
                                                     : a.n_tiles;
        tc_wgrad(a.ws, stride, a.prog + item[0], item[1], item[2], t0, t1,
                 a.partial + s * len, sm, ck, CK_W_WAIT);
    }
}

StreamArgs make_stream_args(const void* const* p, const int* ia,
                            const float* fa) {
    StreamArgs a;
    a.x = (const float*)p[0]; a.th = (const float*)p[1];
    a.w = (const float*)p[2]; a.perm = (const int*)p[3];
    a.gmask = (const float*)p[4]; a.consts = (const float*)p[5];
    a.prog = (const int*)p[6];
    a.p = (float*)p[7]; a.mu = (float*)p[8]; a.nu = (float*)p[9];
    a.partial = (float*)p[10]; a.grad = (float*)p[11];
    a.flags = (float*)p[12]; a.snaps = (float*)p[13];
    a.skips = (float*)p[14]; a.losses = (float*)p[15];
    a.clocks = (float*)p[16]; a.denoms = (const float*)p[17];
    a.ws = (float*)p[18]; a.items = (const int*)p[19];
    a.epochs = ia[0]; a.n_batches = ia[1]; a.batchsize = ia[2];
    a.n_train = ia[3]; a.n_tiles = ia[4]; a.count0 = ia[5];
    a.weighted = ia[6]; a.guard = ia[7]; a.stage = ia[8];
    a.tc = ia[9]; a.n_seg = ia[10]; a.seg_tiles = ia[11]; a.n_items = ia[12];
    a.lr = fa[0]; a.b1 = fa[1]; a.b2 = fa[2]; a.eps = fa[3];
    a.omb1 = fa[4]; a.omb2 = fa[5]; a.logb1 = fa[6]; a.logb2 = fa[7];
    return a;
}

#ifndef DF_HOST_EMULATION
// at most 512 threads, as step_grads (ops/step_kernels.py::STEP_MAX_THREADS)
__global__ void __launch_bounds__(512, 1) train_stream_kernel(StreamArgs a) {
    extern __shared__ float4 smem4[];
    float* S = reinterpret_cast<float*>(smem4);
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    const int block = blockIdx.x, n_blocks = gridDim.x;
    Counters c = {0, 0};
    Clock ck;
    ck.start();
    stream_stage_once(a, S);
    for (int e = 0; e < a.epochs; ++e) {
        for (int b = 0; b < a.n_batches; ++b) {
            stream_tiles(a, S, block, n_blocks, e, b, ck);
            grid.sync();
            ck.tick(CK_SYNC_TILES);
            if (a.guard) {
                stream_reduce(a, S + a.prog[H_SCAL], block, n_blocks,
                              n_blocks, e * a.n_batches + b);
                ck.tick(CK_REDUCE);
                grid.sync();
                ck.tick(CK_SYNC_REDUCE);
                stream_update(a, S + a.prog[H_SCAL], block, n_blocks, e, b,
                              c);
                ck.tick(CK_UPDATE);
            } else {
                stream_reduce_update(a, block, n_blocks, n_blocks, e, b, c);
                ck.tick(CK_REDUCE);
            }
            grid.sync();
            ck.tick(CK_SYNC_UPDATE);
        }
    }
    ck.write(a.clocks, a.epochs * a.n_batches);
}

// the tensor-core design: the same step in tiles (T), W items (W) and the
// reduction and update (R) over the segments' partial rows
__global__ void __launch_bounds__(TC_THREADS, 1)
train_stream_tc_kernel(StreamArgs a) {
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    float* scal = sm + TC_SCAL;
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    const int block = blockIdx.x, n_blocks = gridDim.x;
    Counters c = {0, 0};
    Clock ck;
    ck.start();
    tc_planes_once(a, block, n_blocks);
    grid.sync();
    for (int e = 0; e < a.epochs; ++e) {
        for (int b = 0; b < a.n_batches; ++b) {
            tc_tiles(a, sm, block, n_blocks, e, b, ck);
            ck.tick(CK_TILES);
            grid.sync();
            ck.tick(CK_SYNC_TILES);
            tc_wgrads(a, sm, block, n_blocks, ck);
            ck.tick(CK_WGRADS);
            grid.sync();
            ck.tick(CK_SYNC_WGRADS);
            if (a.guard) {
                stream_reduce(a, scal, block, n_blocks, a.n_seg,
                              e * a.n_batches + b);
                ck.tick(CK_REDUCE);
                grid.sync();
                ck.tick(CK_SYNC_REDUCE);
                stream_update(a, scal, block, n_blocks, e, b, c);
                ck.tick(CK_UPDATE);
            } else {
                stream_reduce_update(a, block, n_blocks, a.n_seg, e, b, c);
                ck.tick(CK_REDUCE);
            }
            grid.sync();
            ck.tick(CK_SYNC_UPDATE);
        }
    }
    ck.write(a.clocks, a.epochs * a.n_batches);
}

const void* stream_kernel(int tc) {
    return tc ? (const void*)train_stream_tc_kernel
              : (const void*)train_stream_kernel;
}
#endif

}  // namespace

extern "C" {

// the tensor-core design's shared floats a block (ops/stream_kernels.py's
// TC_SHARED_BYTES mirrors it)
int df_train_stream_tc_shared_floats() { return TC_SHARED_FLOATS; }

// ptrs (20 device pointers, null where absent): x (n_train, d), theta
// (n_train, n), w (n_train), perm (int32, epochs x n_batches*batchsize),
// flat 0/1 gradient mask, constants, program, parameters, mu, nu (all three
// updated in place), partial buffer (n_blocks x (np + 1)), reduced gradient
// (np + 1), flags (n_blocks), snapshots (epochs x np), skips (epochs),
// per-step losses (epochs x n_batches) or null, cycle counts (CK_SLOTS,
// the DF_STREAM_CLOCKS build) or null, the batches' denominators (epochs x
// n_batches, each the sum of the batch's mask in DENOM_LANES lanes of
// ops/stream_kernels.py, clamped at 1e-12), the tensor-core design's
// workspace (its tiles, their losses, the weights' planes) and W items.
// iargs: epochs, n_batches, batchsize, n_train, n_tiles, count0, weighted,
// guard, stage, tc (the design), segments, tiles a segment, W items. fargs:
// lr, b1, b2, eps, 1-b1, 1-b2, log b1, log b2. The tensor-core design's
// partial buffer has a row per segment and its grid any size.
// n_blocks <= n_tiles (every block has a tile) and no more than can be
// resident at once (df_train_stream_max_blocks, asked with the same threads
// and shared bytes): the launch is cooperative. stage: the parameters, the
// constants and the program go to shared memory after the tile's floats
// (shared_bytes then counts them).
#ifndef DF_HOST_EMULATION
int df_train_stream_max_blocks(int tc, int threads, int shared_bytes,
                               int* out) {
    const void* kernel = stream_kernel(tc);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, dev = 0, sms = 0, coop = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, shared_bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    *out = coop ? per_sm * sms : 0;
    return 0;
}

int df_train_stream(const void* const* ptrs, const int* iargs,
                    const float* fargs, int threads, int shared_bytes,
                    int n_blocks, void* stream) {
    StreamArgs a = make_stream_args(ptrs, iargs, fargs);
    const void* kernel = stream_kernel(a.tc);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel(
        kernel, dim3(n_blocks), dim3(threads), args, (size_t)shared_bytes,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
#else
// The tensor-core design's run on host pointers (the stand-in products),
// each grid phase over all blocks before the next, each block on a shared
// array of its own refilled with NaN before every grid phase
static int tc_emulated(const StreamArgs& a, int floats, int n_blocks) {
    float* S = new float[(long long)n_blocks * floats];
    Counters* c = new Counters[n_blocks];
    for (int k = 0; k < n_blocks; ++k) c[k] = Counters{0, 0};
    Clock ck;
    df_grid_phase_kept(n_blocks, S, floats, floats, [&](int k, float* Sk) {
        (void)Sk;
        tc_planes_once(a, k, n_blocks);
    });
    for (int e = 0; e < a.epochs; ++e) {
        for (int b = 0; b < a.n_batches; ++b) {
            df_grid_phase_kept(n_blocks, S, floats, floats,
                               [&](int k, float* Sk) {
                tc_tiles(a, Sk, k, n_blocks, e, b, ck);
            });
            df_grid_phase_kept(n_blocks, S, floats, floats,
                               [&](int k, float* Sk) {
                tc_wgrads(a, Sk, k, n_blocks, ck);
            });
            if (a.guard) {
                df_grid_phase_kept(n_blocks, S, floats, floats,
                                   [&](int k, float* Sk) {
                    stream_reduce(a, Sk + TC_SCAL, k, n_blocks, a.n_seg,
                                  e * a.n_batches + b);
                });
                df_grid_phase_kept(n_blocks, S, floats, floats,
                                   [&](int k, float* Sk) {
                    stream_update(a, Sk + TC_SCAL, k, n_blocks, e, b, c[k]);
                });
            } else {
                df_grid_phase_kept(n_blocks, S, floats, floats,
                                   [&](int k, float* Sk) {
                    (void)Sk;
                    stream_reduce_update(a, k, n_blocks, a.n_seg, e, b, c[k]);
                });
            }
        }
    }
    delete[] c;
    delete[] S;
    return 0;
}

// The same run on host pointers: each grid phase over all blocks (reverse
// bit 1: last block first) before the next. Every block has a shared array
// of its own, refilled with NaN before each grid phase but for the staged
// constants and program, which the kernel keeps for the launch; the threads
// of a block phase run in the order the -include'd header is told (reverse
// bit 0: last thread first).
int df_train_stream_emulated(const void* const* ptrs, const int* iargs,
                             const float* fargs, int threads,
                             int shared_bytes, int n_blocks, int reverse) {
    const StreamArgs a = make_stream_args(ptrs, iargs, fargs);
    df_emulation_threads = threads;
    df_emulation_reverse = reverse & 1;
    df_emulation_block_reverse = (reverse >> 1) & 1;
    if (a.tc) return tc_emulated(a, shared_bytes / 4, n_blocks);
    const int floats = shared_bytes / 4;
    // what a grid phase may not find again: all but the constants and the
    // program when they are staged
    const int fresh = a.stage ? align4(a.prog[H_TOTAL]) + align4(a.prog[H_NP])
                              : floats;
    float* S = new float[(long long)n_blocks * floats];
    for (long long i = 0; i < (long long)n_blocks * floats; ++i) S[i] = NAN;
    Counters* c = new Counters[n_blocks];
    for (int k = 0; k < n_blocks; ++k) c[k] = Counters{0, 0};
    Clock ck;
    df_grid_phase_kept(n_blocks, S, floats, floats, [&](int k, float* Sk) {
        stream_stage_once(a, Sk);
    });
    for (int e = 0; e < a.epochs; ++e) {
        for (int b = 0; b < a.n_batches; ++b) {
            df_grid_phase_kept(n_blocks, S, floats, fresh, [&](int k, float* Sk) {
                stream_tiles(a, Sk, k, n_blocks, e, b, ck);
            });
            if (a.guard) {
                df_grid_phase_kept(n_blocks, S, floats, fresh,
                              [&](int k, float* Sk) {
                    stream_reduce(a, Sk + a.prog[H_SCAL], k, n_blocks,
                                  n_blocks, e * a.n_batches + b);
                });
                df_grid_phase_kept(n_blocks, S, floats, fresh,
                              [&](int k, float* Sk) {
                    stream_update(a, Sk + a.prog[H_SCAL], k, n_blocks, e, b,
                                  c[k]);
                });
            } else {
                df_grid_phase_kept(n_blocks, S, floats, fresh,
                              [&](int k, float* Sk) {
                    (void)Sk;
                    stream_reduce_update(a, k, n_blocks, n_blocks, e, b, c[k]);
                });
            }
        }
    }
    delete[] c;
    delete[] S;
    return 0;
}
#endif

}  // extern "C"
