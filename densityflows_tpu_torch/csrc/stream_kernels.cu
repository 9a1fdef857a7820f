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
// the gradients in ONE block's shared memory, which caps the model. Here they
// lie in device memory (L2 holds them at these sizes) and shared memory holds
// one row tile's rows, caches and scratch only, laid out by
// ops/train_kernels.py::pack_train_plan(state_in_shared=False) as for
// step_grads, plus DENOM_LANES floats after it. The envelope is the caches of
// one row.
//
// Order. The TPU grid over epochs x batches runs in order on one core; here a
// batch is split over many blocks, and every block must see the previous
// step's update. The run is ONE persistent cooperative launch (no more blocks
// than can be resident at once) with three grid-wide barriers per step:
//   (a) tiles: block k takes the batch's row tiles k, k + grid, ... and leaves
//       its gradient partial and its share of the loss in row k of the
//       (grid, np + 1) partial buffer -- step_grads_body of step_kernels.cu,
//       with the rows gathered through the permutation;
//   (b) reduce: block k owns a contiguous slice of the np + 1 entries, sums
//       the partial rows over the blocks in index order, applies the select
//       mask and writes whether its slice is finite;
//   (c) update: every block reads every slice's flag, so all blocks take the
//       same decision and keep the same count of applied updates; each
//       applies Adam to its own slice and, at an epoch's end, snapshots it.
// No float atomics: two launches give the same bits, for any order of blocks.
// Every block computes the batch's denominator itself, in one fixed order.
//
// What bounds it on this card: latency. A step is about 55 block-wide phases
// on a few hundred kFLOP per tile plus three grid barriers; neither the
// arithmetic rate nor the memory rate is near. Nothing here is tuned.
//
// Each grid phase is a function of (block, n_blocks, step) that carries
// nothing in shared memory into the next one; what a block carries across
// steps (its count of applied updates, the epoch's skips) is in `Counters`.
// With DF_HOST_EMULATION defined the file compiles as plain C++ and the CPU
// tests run each phase over all blocks, in either order, before the next.
//
// C interface (ctypes): df_train_stream (launches on the given stream,
// allocates nothing, does not synchronise, returns the CUDA error code) and
// df_train_stream_max_blocks (how many blocks of a shape can be resident).

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

#include "flow_phases.cuh"

namespace {

// scalars in shared memory: the block's loss so far, the batch's
// denominator, a finite flag
enum : int { S_LOSS = 0, S_DENOM = 1, S_OK = 2 };
// the denominator is summed in this many strided lanes, then the lanes in
// order: the same bits in every block, for any thread count
constexpr int DENOM_LANES = 32;

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
    int epochs, n_batches, batchsize, n_train, n_tiles, count0, weighted,
        guard;
    float lr, b1, b2, eps, omb1, omb2, logb1, logb2;
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

// The tile's share of the loss, added to the block's: thread 0, rows in
// order. `first`: the block's first tile starts the sum.
DF_FN void tile_loss(const Mem& m, float den, bool first, int tid) {
    if (tid != 0) return;
    float num = 0.f;
    for (int r = 0; r < m.B; ++r) num = fmaf(m.LP[r], m.MASK[r], num);
    const float loss = -num / den;
    m.SCAL[S_LOSS] = first ? loss : m.SCAL[S_LOSS] + loss;
}

// the slice of the np + 1 entries (gradients, then the loss) a block owns
DF_FN void block_slice(int len, int block, int n_blocks, int& lo, int& hi) {
    const int per = (len + n_blocks - 1) / n_blocks;
    lo = block * per;
    hi = lo + per < len ? lo + per : len;
}

// ---- the three grid phases of one step ------------------------------------

// (a) the block's tiles of batch b of epoch e into its partial row.
// Uniform control flow: everything outside a DF_PHASE is computed alike by
// every thread of the block from uniform values.
DF_FN void stream_tiles(const StreamArgs& a, float* S, int block,
                        int n_blocks, int e, int b) {
    const int* hdr = a.prog;
    Mem m;
    tile_buffers(m, S, hdr);
    m.P = a.p;                               // read only in this phase
    m.C = const_cast<float*>(a.consts);
    m.MU = nullptr; m.NU = nullptr;
    m.G = a.partial + (long long)block * (m.np + 1);
    const int n_fwd = hdr[H_NFWD], n_bwd = hdr[H_NBWD];
    const int* fwd = a.prog + HEADER_WORDS;
    const int* bwd = fwd + n_fwd * INSTR_WORDS;
    const int* perm_row = a.perm + (long long)e * a.n_batches * a.batchsize;
    const int p0 = b * a.batchsize;
    float* lanes = S + hdr[H_TOTAL];

    // the batch's sum of the mask, clamped at 1e-12
    DF_PHASE(
        for (int l = tid; l < DENOM_LANES; l += nt) {
            float s = 0.f;
            for (int q = l; q < a.batchsize; q += DENOM_LANES)
                s += batch_mask(a, perm_row, p0 + q);
            lanes[l] = s;
        }
    )
    DF_PHASE(
        if (tid == 0) {
            float s = 0.f;
            for (int l = 0; l < DENOM_LANES; ++l) s += lanes[l];
            m.SCAL[S_DENOM] = fmaxf(s, 1e-12f);
        }
    )
    const float den = m.SCAL[S_DENOM];

    for (int tile = block; tile < a.n_tiles; tile += n_blocks) {
        const bool first = tile == block;
        m.acc = first ? 0 : 1;
        DF_PHASE(load_tile(m, a, perm_row, p0, tile * m.B, tid, nt))
        for (int pc = 0; pc < n_fwd; ++pc) {
            DF_PHASE(step(m, fwd + pc * INSTR_WORDS, tid, nt))
        }
        DF_PHASE(row_log_prob(m, tid, nt))
        // the loss reads LP and MASK, the cotangents read MASK and Z and
        // write JBAR and GZ: one phase
        DF_PHASE(
            tile_loss(m, den, first, tid);
            loss_cotangents(m, den, tid, nt);
        )
        for (int pc = 0; pc < n_bwd; ++pc) {
            DF_PHASE(step(m, bwd + pc * INSTR_WORDS, tid, nt))
        }
    }
    DF_PHASE(if (tid == 0) m.G[m.np] = m.SCAL[S_LOSS])
}

// (b) the block's slice: partial rows summed in block order, the 0/1 mask
// as a select (inf * 0 would be NaN), the slice's finite flag; the owner of
// the loss entry records the step's loss.
DF_FN void stream_reduce(const StreamArgs& a, float* S, int block,
                         int n_blocks, int step_index) {
    const int np = a.prog[H_NP], len = np + 1;
    float* scal = S + a.prog[H_SCAL];
    int lo, hi;
    block_slice(len, block, n_blocks, lo, hi);
    DF_PHASE(if (tid == 0) scal[S_OK] = 1.f)
    DF_PHASE(
        for (int i = lo + tid; i < hi; i += nt) {
            float acc = 0.f;
            for (int g = 0; g < n_blocks; ++g)
                acc += a.partial[(long long)g * len + i];
            if (i < np && !(a.gmask[i] > 0.5f)) acc = 0.f;
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

// (c) the guard's decision from every slice's flag, Adam on the block's
// slice, and at the epoch's end its snapshot. Each thread reads back the
// reduced entries it wrote itself in (b): the same slice, the same stride.
DF_FN void stream_update(const StreamArgs& a, float* S, int block,
                         int n_blocks, int e, int b, Counters& c) {
    const int np = a.prog[H_NP];
    float* scal = S + a.prog[H_SCAL];
    int lo, hi;
    block_slice(np + 1, block, n_blocks, lo, hi);
    if (hi > np) hi = np;
    DF_PHASE(if (tid == 0) scal[S_OK] = 1.f)
    DF_PHASE(
        if (a.guard)
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
                const float g = a.grad[i];
                const float mu = a.b1 * a.mu[i] + a.omb1 * g;
                const float nu = a.b2 * a.nu[i] + a.omb2 * g * g;
                a.p[i] = a.p[i] - a.lr * (mu / bc1) / (sqrtf(nu / bc2) + a.eps);
                a.mu[i] = mu;
                a.nu[i] = nu;
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
    a.epochs = ia[0]; a.n_batches = ia[1]; a.batchsize = ia[2];
    a.n_train = ia[3]; a.n_tiles = ia[4]; a.count0 = ia[5];
    a.weighted = ia[6]; a.guard = ia[7];
    a.lr = fa[0]; a.b1 = fa[1]; a.b2 = fa[2]; a.eps = fa[3];
    a.omb1 = fa[4]; a.omb2 = fa[5]; a.logb1 = fa[6]; a.logb2 = fa[7];
    return a;
}

#ifndef DF_HOST_EMULATION
__global__ void __launch_bounds__(1024, 1) train_stream_kernel(StreamArgs a) {
    extern __shared__ float4 smem4[];
    float* S = reinterpret_cast<float*>(smem4);
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    const int block = blockIdx.x, n_blocks = gridDim.x;
    Counters c = {0, 0};
    for (int e = 0; e < a.epochs; ++e) {
        for (int b = 0; b < a.n_batches; ++b) {
            stream_tiles(a, S, block, n_blocks, e, b);
            grid.sync();
            stream_reduce(a, S, block, n_blocks, e * a.n_batches + b);
            grid.sync();
            stream_update(a, S, block, n_blocks, e, b, c);
            grid.sync();
        }
    }
}
#endif

}  // namespace

extern "C" {

// ptrs (16 device pointers, null where absent): x (n_train, d), theta
// (n_train, n), w (n_train), perm (int32, epochs x n_batches*batchsize),
// flat 0/1 gradient mask, constants, program, parameters, mu, nu (all three
// updated in place), partial buffer (n_blocks x (np + 1)), reduced gradient
// (np + 1), flags (n_blocks), snapshots (epochs x np), skips (epochs),
// per-step losses (epochs x n_batches) or null.
// iargs: epochs, n_batches, batchsize, n_train, n_tiles, count0, weighted,
// guard. fargs: lr, b1, b2, eps, 1-b1, 1-b2, log b1, log b2.
// n_blocks <= n_tiles (every block has a tile) and no more than can be
// resident at once (df_train_stream_max_blocks): the launch is cooperative.
#ifndef DF_HOST_EMULATION
int df_train_stream_max_blocks(int threads, int shared_bytes, int* out) {
    cudaError_t err = cudaFuncSetAttribute(
        train_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, dev = 0, sms = 0, coop = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, train_stream_kernel, threads, shared_bytes);
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
    cudaError_t err = cudaFuncSetAttribute(
        train_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel(
        (const void*)train_stream_kernel, dim3(n_blocks), dim3(threads), args,
        (size_t)shared_bytes, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
#else
// The same run on host pointers: each grid phase over all blocks (reverse
// bit 1: last block first) before the next, each block with a fresh shared
// array; the threads of a block phase in the order the -include'd header is
// told (reverse bit 0: last thread first).
int df_train_stream_emulated(const void* const* ptrs, const int* iargs,
                             const float* fargs, int threads,
                             int shared_bytes, int n_blocks, int reverse) {
    const StreamArgs a = make_stream_args(ptrs, iargs, fargs);
    df_emulation_threads = threads;
    df_emulation_reverse = reverse & 1;
    df_emulation_block_reverse = (reverse >> 1) & 1;
    const int floats = shared_bytes / 4;
    float* S = new float[floats];
    Counters* c = new Counters[n_blocks];
    for (int k = 0; k < n_blocks; ++k) c[k] = Counters{0, 0};
    for (int e = 0; e < a.epochs; ++e) {
        for (int b = 0; b < a.n_batches; ++b) {
            df_grid_phase(n_blocks, S, floats, [&](int k) {
                stream_tiles(a, S, k, n_blocks, e, b);
            });
            df_grid_phase(n_blocks, S, floats, [&](int k) {
                stream_reduce(a, S, k, n_blocks, e * a.n_batches + b);
            });
            df_grid_phase(n_blocks, S, floats, [&](int k) {
                stream_update(a, S, k, n_blocks, e, b, c[k]);
            });
        }
    }
    delete[] c;
    delete[] S;
    return 0;
}
#endif

}  // extern "C"
