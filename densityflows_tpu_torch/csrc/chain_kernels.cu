// Whole-chain fold kernels for Hopper (sm_90a): chain_apply and chain_sample.
//
// They replace the two Pallas TPU kernels of the JAX package,
// densityflows_tpu/ops/pallas_chain.py::_chain_kernel and ::_sample_kernel:
// one row tile is folded through every op of a chain plan (folded conditioner
// MLPs, the affine coupling update, affine / linear / logit layers, optional
// per-row log-det-Jacobian) without the batch leaving the chip in between.
//
// What bounds them on this card: arithmetic. Per row a wide chain does a few
// MFLOP of conditioner products against a few hundred bytes of I/O. At the
// serving config (d 32, n 8, 8 couplings of hidden 256, 2^18 rows) the
// products the function needs are 636 GFLOP: 9.49 ms at the f32 rate
// outside the tensor cores (67 TFLOP/s), the bound the earlier FMA design
// was held to (it reached 38.6 % of it). This design runs every product on
// the tensor cores in 3xTF32, three TF32 products per f32 product, so the
// bound it is held to is 3 x 636 GFLOP / 495 TFLOP/s = 3.85 ms.
//
// 3xTF32. Each operand v is split into big = rna(v) and small = rna(v -
// big), rna the rounding of cvt.rna.tf32.f32 (10 mantissa bits, ties away
// from zero); a product is small_a.big_b + big_a.small_b + big_a.big_b,
// accumulated in f32 with the small products first. The dropped
// small_a.small_b is below f32 rounding, so the products keep f32 accuracy
// (one TF32 product alone keeps about three decimal digits and fails the
// kernels' 1e-4 gates: tests/test_torch_chain_kernels.py holds a model of
// both to the gate). Each chunk of 16 rows of K is summed by the tensor
// cores into a fresh accumulator that is then added to the layer's in f32:
// the tensor cores' own additions do not round to nearest, and over a whole
// layer they took a mixed chain of hidden 300 past the gate on an H100.
// (big = v's high 19 bits, what wgmma reads of an f32 operand, would save
// the rounding but leaves one-signed remainders twice as large: less
// accurate on the mixed chains.) A non-finite activation enters the two
// cross products as 0 and its big part alone carries it, so a row holding a
// NaN or an inf gives the plain version's non-finite pattern. (A weight's
// remainder is split without that care: an inf weight gives NaN where the
// plain product is +-inf.)
//
// Design. The products are wgmma.mma_async m64nNk8 with TF32 operands,
// written here in inline PTX. A block is three warpgroups: two consumers
// run the program (a dense layer in passes of 256 output columns, each
// consumer 128 of them, m64n128; a pass of at most 32 columns runs m64n32
// on consumer 0; the couplings and the other ops), and one producer
// streams the weights. A comes from registers, split as it is loaded from
// the row tile in shared memory (TB = 64 rows; 32 or 16, for hidden layers
// too wide for 64, with the rest of the m64 tile zero); B from shared
// memory. The activations stay in shared memory: the [theta | x] input
// tile, the hidden buffer (one, updated in place, where no hidden layer is
// wider than a pass; else two, ping-pong) and the d-wide s / t outputs,
// rows padded by 4 floats so that a fragment load hits 32 banks. The
// weights (several MB, too many for shared memory) stream from L2 in chunks
// of 16 weight rows, pre-tiled by the wrapper in the order and the layout
// the products read (ops/chain_kernels.py::tile_weights): the producer
// brings each in with one bulk copy (cp.async.bulk, completed on an
// mbarrier) two chunks ahead, splits it in place into its big and small
// planes, and hands it over on an mbarrier; four slots let it run ahead across layers, so the
// next layer's chunks are ready while a layer's epilogue or a coupling
// runs. The producer gives most of its registers to the consumers
// (setmaxnreg), which hold a pass's accumulators and a chunk's sum.
// Epilogues (bias, the NaN-keeping relu u < 0 ? 0 : u, the other
// activations) run on the accumulators.
//
// The Python wrapper (ops/chain_kernels.py::pack_plan) lowers a chain plan
// into a flat program of 8-word steps plus one flat f32 parameter
// buffer. Every matrix is stored row-major (in, out) with both extents
// zero-padded to a multiple of 4; padded rows/columns contribute exact
// zeros.
//
// The fold itself (the stream, the producer, the products, the couplings
// and the other ops, a row tile through a program) lies in wgmma_fold.cuh,
// which coupling_kernels.cu's coupling_fwd runs too.
//
// C interface (ctypes): df_chain_apply, df_chain_sample. Each launches on
// the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or -1 for an unsupported tile size).

#include <cuda_runtime.h>
#include <stdint.h>

#define DF_FN __device__ __forceinline__

#include "wgmma_fold.cuh"

using namespace wgf;

namespace {

// ---- chain_apply -------------------------------------------------------

template <int TB>
__global__ void __launch_bounds__(THREADS, 1)
chain_apply_kernel(const float* __restrict__ x, const float* __restrict__ theta,
                   float* __restrict__ y, float* __restrict__ ldj_out,
                   const int* __restrict__ prog, int n_instr,
                   const float* __restrict__ P,
                   const float* __restrict__ tiled, long long rows, int d,
                   int n, int ldh) {
    extern __shared__ float4 smem4[];
    apply_tile<TB>(reinterpret_cast<float*>(smem4), x, theta, y, ldj_out,
                   prog, n_instr, P, tiled, rows, d, n, ldh);
}

// ---- chain_sample ------------------------------------------------------

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", 2011): counter-based, so a draw is a pure function of (key, counter).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
    const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
    const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
    for (int round = 0; round < 10; ++round) {
        const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
        const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
        c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
        k.x += W0; k.y += W1;
    }
    return c;
}

// Box-Muller on 24-bit-mantissa uniforms: u1 in [0,1) keeps log1p(-u1)
// finite; the tail caps at sqrt(-2 ln 2^-24) ~ 5.8 sigma.
__device__ __forceinline__ float box_muller(uint32_t b1, uint32_t b2) {
    const float u1 = (float)(b1 >> 8) * (1.0f / 16777216.0f);
    const float u2 = (float)(b2 >> 8) * (1.0f / 16777216.0f);
    return sqrtf(-2.0f * log1pf(-u1)) * cosf(6.283185307179586f * u2);
}

template <int TB>
__global__ void __launch_bounds__(THREADS, 1)
chain_sample_kernel(float* __restrict__ y, float* __restrict__ r_out,
                    const float* __restrict__ theta, int theta_broadcast,
                    const int* __restrict__ prog, int n_instr,
                    const float* __restrict__ P,
                    const float* __restrict__ tiled, long long rows, int d,
                    int n, int ldh, uint32_t seed_lo, uint32_t seed_hi,
                    long long row_offset) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const Tile t = carve<TB>(smem, d, n, ldh);
    const Stream st = stream_at(smem + up4((int)tile_floats(TB, d, n, ldh)));
    if (threadIdx.x == 0) stream_init(st);
    __syncthreads();
    Clk clk;
    clk.start();
    if (threadIdx.x >= CONSUMERS) {
        producer_registers();
        produce(st, tiled, prog, n_instr, clk);
        clk.write(CC_RAW_WAIT, CC_SLOTS);
        return;
    }
    consumer_registers();
    const long long row0 = (long long)blockIdx.x * TB;

    // theta part (one shared row is broadcast here, never materialised) and
    // zeroed pads; the x part is filled by the generator below
    for (int idx = threadIdx.x; idx < TB * t.ldx; idx += CONSUMERS) {
        const int r = idx / t.ldx, c = idx - r * t.ldx;
        const long long g = row0 + r;
        float v = 0.f;
        if (g < rows && c < n) v = theta[(theta_broadcast ? 0 : g) * n + c];
        t.in[idx] = v;
    }
    consumer_sync();

    // base draw: counter = (global row, column pair), so a draw depends on
    // (seed, row_offset + row, column) and not on the tile size or the
    // launch shape; a launch of rows [lo, hi) of a larger draw with
    // row_offset = lo gives exactly those rows of it
    const int pairs = (d + 1) / 2;
    for (int idx = threadIdx.x; idx < TB * pairs; idx += CONSUMERS) {
        const int r = idx / pairs, p = idx - r * pairs;
        const long long g = row0 + r;
        if (g >= rows) continue;
        const unsigned long long c = (unsigned long long)(row_offset + g);
        const uint4 bits = philox4x32_10(
            make_uint4((uint32_t)c, (uint32_t)(c >> 32), (uint32_t)p, 0u),
            make_uint2(seed_lo, seed_hi));
        const int j = 2 * p;
        const float z0 = box_muller(bits.x, bits.y);
        t.in[r * t.ldx + t.n4 + j] = z0;
        if (r_out != nullptr) r_out[g * d + j] = z0;
        if (j + 1 < d) {
            const float z1 = box_muller(bits.z, bits.w);
            t.in[r * t.ldx + t.n4 + j + 1] = z1;
            if (r_out != nullptr) r_out[g * d + j + 1] = z1;
        }
    }
    consumer_sync();

    fold<TB, CONSUMERS>(prog, n_instr, P, t, false, st, clk);
    clk.write(CC_FULL_WAIT, CC_RAW_WAIT);

    for (int idx = threadIdx.x; idx < TB * d; idx += CONSUMERS) {
        const int r = idx / d, j = idx - r * d;
        const long long g = row0 + r;
        if (g < rows) y[g * d + j] = t.in[r * t.ldx + t.n4 + j];
    }
}

template <int TB>
int launch_apply(const float* x, const float* theta, float* y, float* ldj,
                 const int* prog, int n_instr, const float* P,
                 const float* tiled, long long rows, int d, int n, int ldh,
                 cudaStream_t stream) {
    const size_t bytes = block_floats(TB, d, n, ldh) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        chain_apply_kernel<TB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((rows + TB - 1) / TB);
    chain_apply_kernel<TB><<<grid, THREADS, bytes, stream>>>(
        x, theta, y, ldj, prog, n_instr, P, tiled, rows, d, n, ldh);
    return (int)cudaGetLastError();
}

template <int TB>
int launch_sample(float* y, float* r_out, const float* theta,
                  int theta_broadcast, const int* prog, int n_instr,
                  const float* P, const float* tiled, long long rows, int d,
                  int n, int ldh, uint32_t seed_lo, uint32_t seed_hi,
                  long long row_offset, cudaStream_t stream) {
    const size_t bytes = block_floats(TB, d, n, ldh) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        chain_sample_kernel<TB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((rows + TB - 1) / TB);
    chain_sample_kernel<TB><<<grid, THREADS, bytes, stream>>>(
        y, r_out, theta, theta_broadcast, prog, n_instr, P, tiled, rows, d,
        n, ldh, seed_lo, seed_hi, row_offset);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, d), theta (rows, n) or null when n == 0, y (rows, d), ldj (rows,)
// or null for a fold without log-det-Jacobian. params: the flat parameter
// buffer; tiled: the dense layers' weights as the products consume them
// (ops/chain_kernels.py::tile_weights).
int df_chain_apply(const void* x, const void* theta, void* y, void* ldj,
                   const void* prog, int n_instr, const void* params,
                   const void* tiled, long long rows, int d, int n, int ldh,
                   int tile_rows, void* stream) {
    if (rows <= 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    auto xf = static_cast<const float*>(x);
    auto tf = static_cast<const float*>(theta);
    auto yf = static_cast<float*>(y);
    auto lf = static_cast<float*>(ldj);
    auto pg = static_cast<const int*>(prog);
    auto pf = static_cast<const float*>(params);
    auto wf = static_cast<const float*>(tiled);
    if (tile_rows == 64)
        return launch_apply<64>(xf, tf, yf, lf, pg, n_instr, pf, wf, rows, d,
                                n, ldh, s);
    if (tile_rows == 32)
        return launch_apply<32>(xf, tf, yf, lf, pg, n_instr, pf, wf, rows, d,
                                n, ldh, s);
    if (tile_rows == 16)
        return launch_apply<16>(xf, tf, yf, lf, pg, n_instr, pf, wf, rows, d,
                                n, ldh, s);
    return -1;
}

// y (rows, d); r_out (rows, d) or null; theta (rows, n), (1, n) with
// theta_broadcast = 1, or null when n == 0; params and tiled as for
// df_chain_apply. row_offset: the global index of row 0 in the generator's
// counter (the outputs are written from row 0).
int df_chain_sample(void* y, void* r_out, const void* theta,
                    int theta_broadcast, const void* prog, int n_instr,
                    const void* params, const void* tiled, long long rows,
                    int d, int n, int ldh, unsigned int seed_lo,
                    unsigned int seed_hi, long long row_offset, int tile_rows,
                    void* stream) {
    if (rows <= 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    auto yf = static_cast<float*>(y);
    auto rf = static_cast<float*>(r_out);
    auto tf = static_cast<const float*>(theta);
    auto pg = static_cast<const int*>(prog);
    auto pf = static_cast<const float*>(params);
    auto wf = static_cast<const float*>(tiled);
    if (tile_rows == 64)
        return launch_sample<64>(yf, rf, tf, theta_broadcast, pg, n_instr, pf,
                                 wf, rows, d, n, ldh, seed_lo, seed_hi,
                                 row_offset, s);
    if (tile_rows == 32)
        return launch_sample<32>(yf, rf, tf, theta_broadcast, pg, n_instr, pf,
                                 wf, rows, d, n, ldh, seed_lo, seed_hi,
                                 row_offset, s);
    if (tile_rows == 16)
        return launch_sample<16>(yf, rf, tf, theta_broadcast, pg, n_instr, pf,
                                 wf, rows, d, n, ldh, seed_lo, seed_hi,
                                 row_offset, s);
    return -1;
}

// The DF_CHAIN_CLOCKS build's cycle sums of the last fold of block 0
// (CC_SLOTS values: a consumer's waits for split chunks, its products with
// their wait, its epilogues, the other ops with the barrier after each; the
// producer's waits for raw chunks, for free slots, and its splits); -1 in
// other builds.
int df_chain_clocks(unsigned long long* out) {
#if defined(DF_CHAIN_CLOCKS)
    return (int)cudaMemcpyFromSymbol(out, df_chain_clk, sizeof(df_chain_clk));
#else
    (void)out;
    return -1;
#endif
}

}  // extern "C"

