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
// Residency. Parameters and constants are read-only and stay in device
// memory (L2 serves the re-reads of the blocks); the block's shared memory
// holds one tile's rows, activation caches and scratch, laid out by the
// Python wrapper (ops/train_kernels.py::pack_train_plan with
// state_in_shared=False), which therefore knows the exact byte count. The
// gradient partial lies in device memory.
//
// The forward and backward phases are those of train_run
// (flow_phases.cuh). With DF_HOST_EMULATION defined the file compiles as
// plain C++ and the CPU tests run it, blocks and threads in either order.
//
// C interface (ctypes): df_step_grads. It launches both kernels on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

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

// scalar in shared memory: the block's loss so far
enum : int { S_LOSS = 0 };

struct StepArgs {
    const float* x; const float* th; const float* mask; const float* denom;
    const float* params; const float* gmask; const float* consts;
    const int* prog;
    float* partial;     // (grid, np + 1): per block, gradients then loss
    float* out;         // np gradients, then the loss
    int rows, n_tiles;
};

// The tile's share of the loss, added to the block's: thread 0, rows in
// order. `first`: the block's first tile starts the sum.
DF_FN void tile_loss(const Mem& m, float den, bool first, int tid) {
    if (tid != 0) return;
    float num = 0.f;
    for (int r = 0; r < m.B; ++r) num = fmaf(m.LP[r], m.MASK[r], num);
    const float loss = -num / den;
    m.SCAL[S_LOSS] = first ? loss : m.SCAL[S_LOSS] + loss;
}

// Uniform control flow: everything outside a DF_PHASE is computed alike by
// every thread of the block from uniform values.
DF_FN void step_grads_body(const StepArgs& a, float* S, int block,
                           int n_blocks) {
    const int* hdr = a.prog;
    Mem m;
    tile_buffers(m, S, hdr);
    m.P = const_cast<float*>(a.params);      // read only here
    m.C = const_cast<float*>(a.consts);
    m.MU = nullptr; m.NU = nullptr;
    m.G = a.partial + (long long)block * (m.np + 1);
    const int n_fwd = hdr[H_NFWD], n_bwd = hdr[H_NBWD];
    const int* fwd = a.prog + HEADER_WORDS;
    const int* bwd = fwd + n_fwd * INSTR_WORDS;
    const float den = fmaxf(a.denom[0], 1e-12f);

    for (int tile = block; tile < a.n_tiles; tile += n_blocks) {
        const bool first = tile == block;
        m.acc = first ? 0 : 1;
        DF_PHASE(load_rows(m, a.x, a.th, a.mask, a.rows, tile * m.B, tid, nt))
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
    a.rows = ia[0]; a.n_tiles = ia[1];
    return a;
}

#ifndef DF_HOST_EMULATION
__global__ void __launch_bounds__(1024, 1) step_grads_kernel(StepArgs a) {
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
// iargs: rows, n_tiles, np, phases. n_blocks <= n_tiles: every block has a
// tile, so every row of the partial buffer is written. phases: bit 0 runs
// the tile kernel, bit 1 the reduction (3: the step; one alone only to time
// it on a partial buffer that an earlier launch filled).
#ifndef DF_HOST_EMULATION
int df_step_grads(const void* const* ptrs, const int* iargs, int threads,
                  int shared_bytes, int n_blocks, void* stream) {
    const StepArgs a = make_step_args(ptrs, iargs);
    const int np = iargs[2], phases = iargs[3];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (phases & 1) {
        cudaError_t err = cudaFuncSetAttribute(
            step_grads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            shared_bytes);
        if (err != cudaSuccess) return (int)err;
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
