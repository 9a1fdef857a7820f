// Plain C++ stand-ins for the CUDA builtins that csrc/train_kernels.cu uses,
// so that the CPU tests can compile that source with a host compiler
// (-DDF_HOST_EMULATION -include this file) and execute it. A phase of the kernel (DF_PHASE) runs
// its threads one after another, in ascending or descending order; a result
// that depends on that order shows a race inside a phase. What the emulation
// cannot show is a missing barrier between phases.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#define DF_FN static inline

static int df_emulation_threads = 1;
static int df_emulation_reverse = 0;

#define DF_PHASE(...)                                                   \
    for (int df_t_ = 0; df_t_ < df_emulation_threads; ++df_t_) {        \
        const int nt = df_emulation_threads;                            \
        const int tid = df_emulation_reverse ? nt - 1 - df_t_ : df_t_;  \
        (void)tid; (void)nt;                                            \
        __VA_ARGS__;                                                    \
    }

static inline float __int_as_float(int v) {
    float f;
    std::memcpy(&f, &v, sizeof f);
    return f;
}
