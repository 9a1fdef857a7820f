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
// What bounds it, and the tile body that step_grads shares with train_stream
// (the staging of parameters, constants and program in shared memory, the
// inlined handlers, the register-tiled weight gradients): grads_tile.cuh.
// A chain whose parameters do not fit beside the tile (the wide chain)
// reads them from device memory through the same phases. The Python
// wrapper lays out the tile's part (ops/train_kernels.py::pack_train_plan
// with state_in_shared=False) and knows the exact byte count of both. The
// gradient partial lies in device memory.
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
#include "grads_tile.cuh"

namespace {

struct StepArgs {
    const float* x; const float* th; const float* mask; const float* denom;
    const float* params; const float* gmask; const float* consts;
    const int* prog;
    float* partial;     // (grid, np + 1): per block, gradients then loss
    float* out;         // np gradients, then the loss
    int rows, n_tiles;
    int stage;          // != 0: parameters and constants in shared memory
};

// The block's tiles into its partial row, the parameters, constants and
// program staged first where `stage` says so. DF_STEP_CLOCKS: block 0's
// phase cycles go to out[0..] (launched with phases = 1, so that nothing
// else writes out).
DF_FN void step_grads_body(const StepArgs& a, float* S, int block,
                           int n_blocks) {
    const int* hdr = a.prog;
    PhaseTicks ticks;
    ticks.start(block == 0 ? a.out : nullptr);
    Mem m;
    tile_buffers(m, S, hdr);
    m.MU = nullptr; m.NU = nullptr;
    // read only here, from shared memory or from device memory
    m.P = const_cast<float*>(a.params);
    m.C = const_cast<float*>(a.consts);
    const int* prog = a.prog;
    if (a.stage) {
        const Staged st = stage_buffers(S, hdr);
        DF_PHASE(
            df_cp_async_floats(st.P, a.params, m.np, tid, nt);
            if (m.nc > 0) df_cp_async_floats(st.C, a.consts, m.nc, tid, nt);
            df_cp_async_floats(st.I, reinterpret_cast<const float*>(a.prog),
                               st.prog_words, tid, nt);
            df_cp_async_wait_all();
        )
        ticks.tick();
        m.P = st.P;
        m.C = st.C;
        prog = reinterpret_cast<const int*>(st.I);
    }
    m.G = a.partial + (long long)block * (m.np + 1);
    const float den = fmaxf(a.denom[0], 1e-12f);
    grads_tiles(m, prog, a.n_tiles, block, n_blocks, den,
                [&](int row0, int tid, int nt) {
                    load_rows(m, a.x, a.th, a.mask, a.rows, row0, tid, nt);
                },
                ticks);
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
// at most 512 threads (ops/step_kernels.py::STEP_MAX_THREADS)
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
