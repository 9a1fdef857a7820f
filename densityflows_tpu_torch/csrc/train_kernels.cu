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
// Normalization constants, and one batch's activation caches and scratch.
// Data rows, the per-epoch gather indices, the 0/1 gradient masks and the
// best snapshot stay in device memory. The kernel holds no layout logic of
// its own: every offset comes from the program's header and instructions, so
// the wrapper's byte count is exact.
//
// What bounds it on this card: latency. The work is a few hundred kFLOP per
// batch on one SM, a serial chain of small phases each ended by a barrier;
// neither the card's arithmetic rate nor its memory rate is near.
//
// Program. The wrapper lowers the plan into a forward and a backward list of
// 16-word instructions. Weight gradients a^T.delta contract the batch axis:
// each thread owns whole output elements and loops over the rows in a fixed
// order, so there are no atomics and a run is the same bit for bit from call
// to call. Reductions over rows (loss, bias gradients) are serial loops of
// one thread per output for the same reason. expf / tanhf are the full
// precision ones (the build has no --use_fast_math).
//
// Every phase is written as a function of (tid, nt) and carries nothing in
// registers across a barrier except values that are uniform over the block.
// With DF_HOST_EMULATION defined, the file compiles as plain C++: whoever
// builds it that way supplies DF_FN, DF_PHASE (a phase runs its threads one
// after another) and the few CUDA builtins used here in a header given to the
// compiler with -include. That is how the CPU tests execute this source.
//
// C interface (ctypes): df_train_run. It launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

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

// scalars in shared memory; the evaluation sums are (S_NUM, S_DEN) + 2 * set
enum : int { S_LOSS = 0, S_DENOM = 1, S_OK = 2, S_NUM = 3, S_DEN = 4 };

struct Args {
    const float* x; const float* th; const float* w; const int* perm;
    const float* xv; const float* thv; const float* wv;
    const float* p_in; const float* mu_in; const float* nu_in;
    const float* gmask; const float* consts; const int* prog;
    float* p_out; float* mu_out; float* nu_out;
    float* hist_t; float* hist_v; float* hist_s; float* best;
    int epochs, n_batches, n_train, n_valid, count0, track_best, weighted,
        guard;
    float lr, b1, b2, eps, omb1, omb2, logb1, logb2;
};

// ---- phases around the programs (the shared ones are in flow_phases.cuh) --

// Gather one batch through the epoch's index row. Pad entries of the index
// point at row 0 and carry mask 0 by position; importance weights are
// gathered with the same index and multiply the mask.
DF_FN void load_batch(const Mem& m, const Args& a, const int* perm_row,
                      int b, int tid, int nt) {
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
}

// loss = -sum m * lp / max(sum m, 1e-12); ok = the loss is finite
DF_FN void batch_loss(const Mem& m, int tid) {
    if (tid != 0) return;
    float den = 0.f, num = 0.f;
    for (int r = 0; r < m.B; ++r) {
        den += m.MASK[r];
        num = fmaf(m.LP[r], m.MASK[r], num);
    }
    den = fmaxf(den, 1e-12f);
    const float loss = -num / den;
    m.SCAL[S_LOSS] = loss;
    m.SCAL[S_DENOM] = den;
    m.SCAL[S_OK] = finite_f(loss) ? 1.f : 0.f;
}

// The 0/1 masks as a SELECT (inf * 0 would be NaN), then the finite check on
// the masked gradients.
DF_FN void mask_and_check(const Mem& m, const Args& a, int tid, int nt) {
    for (int i = tid; i < m.np; i += nt) {
        const float g = a.gmask[i] > 0.5f ? m.G[i] : 0.f;
        m.G[i] = g;
        if (a.guard && !finite_f(g)) m.SCAL[S_OK] = 0.f;
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

DF_FN void eval_accumulate(const Mem& m, int set, int tid) {
    if (tid != 0) return;
    float num = m.SCAL[S_NUM + 2 * set], den = m.SCAL[S_DEN + 2 * set];
    for (int r = 0; r < m.B; ++r) {
        num = fmaf(m.LP[r], m.MASK[r], num);
        den += m.MASK[r];
    }
    m.SCAL[S_NUM + 2 * set] = num;
    m.SCAL[S_DEN + 2 * set] = den;
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
    const int* fwd = a.prog + HEADER_WORDS;
    const int* bwd = fwd + n_fwd * INSTR_WORDS;
    const int n_pad = a.n_batches * m.B;

    DF_PHASE(
        for (int i = tid; i < m.np; i += nt) {
            m.P[i] = a.p_in[i]; m.MU[i] = a.mu_in[i]; m.NU[i] = a.nu_in[i];
        }
        for (int i = tid; i < m.nc; i += nt) m.C[i] = a.consts[i];
    )

    int applied = 0;            // updates applied in this call
    float prev_best = INFINITY; // min of the earlier epochs' valid NLL (NaN
                                // once any of them was NaN)
    for (int e = 0; e < a.epochs; ++e) {
        const int* perm_row = a.perm + (long long)e * n_pad;
        int skips = 0;
        for (int b = 0; b < a.n_batches; ++b) {
            DF_PHASE(load_batch(m, a, perm_row, b, tid, nt))
            for (int pc = 0; pc < n_fwd; ++pc) {
                DF_PHASE(step(m, fwd + pc * INSTR_WORDS, tid, nt))
            }
            DF_PHASE(row_log_prob(m, tid, nt))
            DF_PHASE(batch_loss(m, tid))
            DF_PHASE(loss_cotangents(m, m.SCAL[S_DENOM], tid, nt))
            for (int pc = 0; pc < n_bwd; ++pc) {
                DF_PHASE(step(m, bwd + pc * INSTR_WORDS, tid, nt))
            }
            DF_PHASE(mask_and_check(m, a, tid, nt))
            const bool ok = !a.guard || m.SCAL[S_OK] != 0.f;
            if (ok) {
                // the Adam step is count0 + APPLIED updates + 1
                const float t = (float)(a.count0 + applied + 1);
                const float bc1 = 1.f - expf(t * a.logb1);
                const float bc2 = 1.f - expf(t * a.logb2);
                DF_PHASE(adam_update(m, a, bc1, bc2, tid, nt))
                ++applied;
            } else {
                ++skips;
            }
        }

        // full-split evaluations from the parameters after the last batch.
        // Each set has its own sums: they are read below by every thread,
        // with no barrier before the next phase.
        float nll[2];
        DF_PHASE(if (tid < 4) m.SCAL[S_NUM + tid] = 0.f)
        for (int set = 0; set < 2; ++set) {
            const float* xs = set == 0 ? a.x : a.xv;
            const float* ths = set == 0 ? a.th : a.thv;
            const float* ws = a.weighted ? (set == 0 ? a.w : a.wv) : nullptr;
            const int rows = set == 0 ? a.n_train : a.n_valid;
            for (int row0 = 0; row0 < rows; row0 += m.B) {
                DF_PHASE(load_rows(m, xs, ths, ws, rows, row0, tid, nt))
                for (int pc = 0; pc < n_fwd; ++pc) {
                    DF_PHASE(step(m, fwd + pc * INSTR_WORDS, tid, nt))
                }
                DF_PHASE(row_log_prob(m, tid, nt))
                DF_PHASE(eval_accumulate(m, set, tid))
            }
            // unweighted: over the row count; weighted: over max(sum w, 1e-12)
            const float den = a.weighted
                ? fmaxf(m.SCAL[S_DEN + 2 * set], 1e-12f) : (float)rows;
            nll[set] = -m.SCAL[S_NUM + 2 * set] / den;
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
    a.epochs = ia[0]; a.n_batches = ia[1]; a.n_train = ia[2];
    a.n_valid = ia[3]; a.count0 = ia[4]; a.track_best = ia[5];
    a.weighted = ia[6]; a.guard = ia[7];
    a.lr = fa[0]; a.b1 = fa[1]; a.b2 = fa[2]; a.eps = fa[3];
    a.omb1 = fa[4]; a.omb2 = fa[5]; a.logb1 = fa[6]; a.logb2 = fa[7];
    return a;
}

#ifndef DF_HOST_EMULATION
__global__ void __launch_bounds__(1024, 1) train_run_kernel(Args a) {
    extern __shared__ float4 smem4[];
    train_run_body(a, reinterpret_cast<float*>(smem4));
}
#endif

}  // namespace

extern "C" {

// ptrs (20 device pointers, null where absent): x, theta, w, perm (int32,
// epochs x n_batches*B), x_valid, theta_valid, w_valid, params, mu, nu,
// gradient mask, constants, program, params out, mu out, nu out, train
// history, valid history, skip history, best snapshot.
// iargs: epochs, n_batches, n_train, n_valid, count0, track_best, weighted,
// guard. fargs: lr, b1, b2, eps, 1-b1, 1-b2, log b1, log b2.
#ifndef DF_HOST_EMULATION
int df_train_run(const void* const* ptrs, const int* iargs,
                 const float* fargs, int threads, int shared_bytes,
                 void* stream) {
    const Args a = make_args(ptrs, iargs, fargs);
    cudaError_t err = cudaFuncSetAttribute(
        train_run_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return (int)err;
    train_run_kernel<<<1, threads, shared_bytes,
                       static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}
#else
// The same run on host pointers, its threads one after another in the
// order the -include'd header is told (reverse != 0: last thread first).
int df_train_run_emulated(const void* const* ptrs, const int* iargs,
                          const float* fargs, int threads, int shared_bytes,
                          int reverse) {
    const Args a = make_args(ptrs, iargs, fargs);
    df_emulation_threads = threads;
    df_emulation_reverse = reverse;
    float* S = new float[shared_bytes / 4];
    for (int i = 0; i < shared_bytes / 4; ++i) S[i] = NAN;
    train_run_body(a, S);
    delete[] S;
    return 0;
}
#endif

}  // extern "C"
