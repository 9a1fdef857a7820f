// Grads-only step kernel for Hopper (sm_90a): step_grads.
//
// It replaces the Pallas TPU kernel of the JAX package,
// densityflows_tpu/ops/pallas_step.py::_step_kernel: the masked NLL of ONE
// batch and its gradients with respect to the folded parameters. Adam is not
// in it, so that a data-parallel step can sum loss and gradients over the
// ranks between the backward pass and the update. Per tile of rows: inverse
// fold with activation caches, the tile's share of the loss
// -sum m.lp / denom, hand-derived backward. The denominator spans the GLOBAL
// batch and comes in from outside (a device scalar), so that summing over
// tiles, and over ranks, is exact.
//
// Order. The TPU grid runs its tiles one after another and adds into a
// resident output. Here tiles are thread blocks that run at once, so every
// block writes its OWN partial: block k takes the tiles k, k + grid,
// k + 2 grid, ... in that order, writes the first tile's gradients and adds
// the later ones (Mem::acc), and leaves np gradient entries and one loss in
// row k of the (grid, np + 1) partial buffer. A second small kernel,
// step_reduce, sums the rows in index order, applies the static 0/1 gradient
// masks as a SELECT (inf * 0 would be NaN) and writes the np gradients and
// the loss. No float atomics: two launches give the same bits.
//
// What bounds it. The arithmetic of a batch is small (0.2 GFLOP at the
// streaming path's d 16 / hidden 64 / batch 1024, 0.8 MFLOP at batch 64);
// what a launch costs is latency: some 55 barrier-ended phases per tile, each
// a short loop whose loads wait on memory. The first design read every
// weight of every phase from L2 (about 250 cycles a load) for 8 rows.
//
// Residency. A block stages the folded parameters, the constants and the
// program in its shared memory once (cp.async, csrc/async_copy.cuh), beside
// the tile's rows, activation caches and scratch, wherever they fit (iargs
// `stage`: 39,264 parameters at the streaming path take 157 KB of the
// 227 KB), so that no phase waits on L2 for a weight or an instruction. A
// chain whose parameters do not fit (the wide chain) reads them from device
// memory through the same phases: only Mem::P, Mem::C and the program
// pointer differ. The Python wrapper lays out the tile's
// part (ops/train_kernels.py::pack_train_plan with state_in_shared=False)
// and knows the exact byte count of both. The gradient partial lies in
// device memory.
//
// The forward and backward phases are those of train_run
// (flow_phases.cuh). With DF_HOST_EMULATION defined the file compiles as
// plain C++ and the CPU tests run it, blocks and threads in either order.
//
// C interface (ctypes): df_step_grads. It launches both kernels on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(). The dynamic shared-memory attribute is set once per
// device and byte count, not per launch.

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

#include "async_copy.cuh"
#include "flow_phases.cuh"

namespace {

// scalar in shared memory: the block's loss so far
enum : int { S_LOSS = 0 };

struct StepArgs {
    const float* x; const float* th; const float* mask; const float* denom;
    const float* params; const float* gmask; const float* consts;
    const int* prog;
    float* partial;     // (grid, np + 1): per block, gradients then loss
    float* out;         // np gradients, then the loss
    int rows, n_tiles;
    int stage;          // != 0: parameters and constants in shared memory
};

// floats rounded up to 16 bytes
DF_FN int align4(int floats) { return (floats + 3) / 4 * 4; }

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
// the two to the same bits). The handlers are inlined into each phase: one
// shared, called copy measured 19 % slower at hidden 64 on an H100.
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
// thread 0 of block 0 writes the cycles of each phase of its first tile to
// out[0..], in phase order; launched with phases = 1 (the tile kernel only),
// nothing else writes out.
#if defined(DF_STEP_CLOCKS) && !defined(DF_HOST_EMULATION)
#define DF_TICK()                                                  \
    if (block == 0 && threadIdx.x == 0 && tick < 4096) {           \
        const long long now = clock64();                           \
        a.out[tick++] = (float)(now - last);                       \
        last = now;                                                \
    }
#else
#define DF_TICK()
#endif

// Uniform control flow: everything outside a DF_PHASE is computed alike by
// every thread of the block from uniform values.
DF_FN void step_grads_body(const StepArgs& a, float* S, int block,
                           int n_blocks) {
    const int* hdr = a.prog;
#if defined(DF_STEP_CLOCKS) && !defined(DF_HOST_EMULATION)
    int tick = 0;
    long long last = clock64();
#endif
    Mem m;
    tile_buffers(m, S, hdr);
    m.MU = nullptr; m.NU = nullptr;
    // read only here, from shared memory or from device memory
    m.P = const_cast<float*>(a.params);
    m.C = const_cast<float*>(a.consts);
    const int n_fwd = hdr[H_NFWD], n_bwd = hdr[H_NBWD];
    const int* prog = a.prog;
    if (a.stage) {
        // parameters, constants and the program after the tile's floats
        float* Ps = S + align4(hdr[H_TOTAL]);
        float* Cs = Ps + align4(m.np);
        float* Is = Cs + align4(m.nc);
        const int words = HEADER_WORDS + (n_fwd + n_bwd) * INSTR_WORDS;
        DF_PHASE(
            df_cp_async_floats(Ps, a.params, m.np, tid, nt);
            if (m.nc > 0) df_cp_async_floats(Cs, a.consts, m.nc, tid, nt);
            df_cp_async_floats(Is, reinterpret_cast<const float*>(a.prog),
                               words, tid, nt);
            df_cp_async_wait_all();
        )
        DF_TICK()
        m.P = Ps;
        m.C = Cs;
        prog = reinterpret_cast<const int*>(Is);
    }
    m.G = a.partial + (long long)block * (m.np + 1);
    const int* fwd = prog + HEADER_WORDS;
    const int* bwd = fwd + n_fwd * INSTR_WORDS;
    const float den = fmaxf(a.denom[0], 1e-12f);

    for (int tile = block; tile < a.n_tiles; tile += n_blocks) {
        const bool first = tile == block;
        m.acc = first ? 0 : 1;
        DF_PHASE(load_rows(m, a.x, a.th, a.mask, a.rows, tile * m.B, tid, nt))
        DF_TICK()
        for (int pc = 0; pc < n_fwd; ++pc) {
            DF_PHASE(step_instr(m, fwd + pc * INSTR_WORDS, tid, nt))
            DF_TICK()
        }
        DF_PHASE(row_log_prob(m, tid, nt))
        DF_TICK()
        // the loss reads LP and MASK, the cotangents read MASK and Z and
        // write JBAR and GZ: one phase
        DF_PHASE(
            tile_loss(m, den, first, tid);
            loss_cotangents(m, den, tid, nt);
        )
        DF_TICK()
        for (int pc = 0; pc < n_bwd; ++pc) {
            DF_PHASE(step_instr(m, bwd + pc * INSTR_WORDS, tid, nt))
            DF_TICK()
        }
    }
    // thread 0 wrote S_LOSS last in a phase that a barrier ended
    DF_PHASE(if (tid == 0) m.G[m.np] = m.SCAL[S_LOSS])
}

// Entry i of the result: the partials of all blocks in index order, then
// the 0/1 mask as a select. Entry np is the loss.
DF_FN void step_reduce_item(const StepArgs& a, int np, int n_blocks, int i) {
    float acc = 0.f;
    for (int g = 0; g < n_blocks; ++g)
        acc += a.partial[(long long)g * (np + 1) + i];
    if (i < np && !(a.gmask[i] > 0.5f)) acc = 0.f;
    a.out[i] = acc;
}

StepArgs make_step_args(const void* const* p, const int* ia) {
    StepArgs a;
    a.x = (const float*)p[0]; a.th = (const float*)p[1];
    a.mask = (const float*)p[2]; a.denom = (const float*)p[3];
    a.params = (const float*)p[4]; a.gmask = (const float*)p[5];
    a.consts = (const float*)p[6]; a.prog = (const int*)p[7];
    a.partial = (float*)p[8]; a.out = (float*)p[9];
    a.rows = ia[0]; a.n_tiles = ia[1]; a.stage = ia[4];
    return a;
}

#ifndef DF_HOST_EMULATION
// at most 512 threads (ops/step_kernels.py::STEP_MAX_THREADS): 128
// registers a thread, where 1024 threads left 64 and spills
__global__ void __launch_bounds__(512, 1) step_grads_kernel(StepArgs a) {
    extern __shared__ float4 smem4[];
    step_grads_body(a, reinterpret_cast<float*>(smem4), blockIdx.x,
                    gridDim.x);
}

__global__ void step_reduce_kernel(StepArgs a, int np, int n_blocks) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i <= np) step_reduce_item(a, np, n_blocks, i);
}
#endif

}  // namespace

extern "C" {

// ptrs (10 device pointers, null where absent): x (rows, d), theta (rows, n),
// mask (rows), denominator (1), flat parameters, flat 0/1 gradient mask,
// constants, program, partial buffer (n_blocks x (np + 1)), out (np + 1).
// iargs: rows, n_tiles, np, phases, stage. n_blocks <= n_tiles: every block
// has a tile, so every row of the partial buffer is written. phases: bit 0
// runs the tile kernel, bit 1 the reduction (3: the step; one alone only to
// time it on a partial buffer that an earlier launch filled). stage: the
// parameters, the constants and the program go to shared memory after the
// tile's floats (shared_bytes then counts them, each part rounded up to 16
// bytes).
#ifndef DF_HOST_EMULATION
int df_step_grads(const void* const* ptrs, const int* iargs, int threads,
                  int shared_bytes, int n_blocks, void* stream) {
    const StepArgs a = make_step_args(ptrs, iargs);
    const int np = iargs[2], phases = iargs[3];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (phases & 1) {
        // the attribute is raised once per device to the largest byte count
        // asked for (a call costs as much as a launch)
        static int attr_bytes[64] = {};
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return (int)err;
        if (dev >= 64) return (int)cudaErrorInvalidDevice;
        if (shared_bytes > attr_bytes[dev]) {
            err = cudaFuncSetAttribute(
                step_grads_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
            if (err != cudaSuccess) return (int)err;
            attr_bytes[dev] = shared_bytes;
        }
        step_grads_kernel<<<n_blocks, threads, shared_bytes, s>>>(a);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (phases & 2)
        step_reduce_kernel<<<(np + 1 + 255) / 256, 256, 0, s>>>(a, np,
                                                                 n_blocks);
    return (int)cudaGetLastError();
}
#else
// The same work on host pointers: the blocks one after another (reverse
// bit 1: last block first), the threads of a phase in the order the
// -include'd header is told (reverse bit 0: last thread first).
int df_step_grads_emulated(const void* const* ptrs, const int* iargs,
                           int threads, int shared_bytes, int n_blocks,
                           int reverse) {
    const StepArgs a = make_step_args(ptrs, iargs);
    const int np = iargs[2];
    df_emulation_threads = threads;
    df_emulation_reverse = reverse & 1;
    float* S = new float[shared_bytes / 4];
    for (int k = 0; k < n_blocks; ++k) {
        for (int i = 0; i < shared_bytes / 4; ++i) S[i] = NAN;
        step_grads_body(a, S, (reverse & 2) ? n_blocks - 1 - k : k, n_blocks);
    }
    delete[] S;
    for (int k = 0; k <= np; ++k)
        step_reduce_item(a, np, n_blocks, (reverse & 2) ? np - k : k);
    return 0;
}
#endif

}  // extern "C"
