// Plain C++ stand-ins for the CUDA builtins that the sources of
// densityflows_tpu_torch/csrc use, so that the CPU tests can compile them
// with a host compiler (-DDF_HOST_EMULATION -include this file) and execute
// them. A phase of a block (DF_PHASE) runs its threads one after another, in
// ascending or descending order; a result that depends on that order shows a
// race inside a phase. A phase of a grid (df_grid_phase: the work between two
// grid-wide barriers of a cooperative launch) runs its blocks one after
// another, in ascending or descending order, each with a shared array
// refilled with NaN (df_grid_phase_kept: each block its own, but for what
// the kernel keeps for its launch), so that a result that depends on the
// order of the blocks or on shared memory carried across a grid barrier
// shows. What the emulation
// cannot show is a missing barrier between the phases of a block.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#define DF_FN static inline

static int df_emulation_threads = 1;
static int df_emulation_reverse = 0;
static int df_emulation_block_reverse = 0;

#define DF_PHASE(...)                                                   \
    for (int df_t_ = 0; df_t_ < df_emulation_threads; ++df_t_) {        \
        const int nt = df_emulation_threads;                            \
        const int tid = df_emulation_reverse ? nt - 1 - df_t_ : df_t_;  \
        (void)tid; (void)nt;                                            \
        __VA_ARGS__;                                                    \
    }

// body(block) for every block of the grid, on the shared array S of
// `floats` floats, refilled with NaN before each block
template <class Body>
static inline void df_grid_phase(int n_blocks, float* S, int floats,
                                 Body&& body) {
    for (int k = 0; k < n_blocks; ++k) {
        for (int i = 0; i < floats; ++i) S[i] = NAN;
        body(df_emulation_block_reverse ? n_blocks - 1 - k : k);
    }
}

// body(block, S_block) for every block of the grid, for a kernel whose
// blocks keep part of their shared memory across grid barriers: S holds
// n_blocks shared arrays of `floats` floats, one per block, and the first
// `fresh` floats of a block's array are refilled with NaN before its body
// runs (the rest is what the block keeps)
template <class Body>
static inline void df_grid_phase_kept(int n_blocks, float* S, int floats,
                                      int fresh, Body&& body) {
    for (int k = 0; k < n_blocks; ++k) {
        const int b = df_emulation_block_reverse ? n_blocks - 1 - k : k;
        float* Sb = S + (long long)b * floats;
        for (int i = 0; i < fresh; ++i) Sb[i] = NAN;
        body(b, Sb);
    }
}

static inline float __int_as_float(int v) {
    float f;
    std::memcpy(&f, &v, sizeof f);
    return f;
}
