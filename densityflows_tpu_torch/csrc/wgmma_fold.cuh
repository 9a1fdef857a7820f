// The tensor-core fold of a row tile through a program of the chain
// kernels' format: dense layers on wgmma in 3xTF32 with a producer
// warpgroup streaming pre-tiled weights, the affine coupling update, the
// other ops of a chain. Its design and its numbers are in the note at the
// top of chain_kernels.cu, whose kernels chain_apply and chain_sample were
// its first users; coupling_kernels.cu runs one coupling through it
// (coupling_fwd's tensor-core path, a one-coupling program).
//
// The including file includes <cuda_runtime.h> and <stdint.h> and defines
// DF_FN (__device__ __forceinline__) first. Everything here lies in
// namespace wgf, so that a file with names of its own (coupling_kernels.cu)
// can include it.

#pragma once

namespace wgf {

constexpr int INSTR_WORDS = 8;   // words per program instruction

// instruction opcodes (word 0); the remaining words are op-specific
enum : int { OP_DENSE = 0, OP_COUPLE = 1, OP_AFFINE = 2, OP_COMMIT = 3,
             OP_LOGIT = 4 };
// shared-memory buffer ids used by OP_DENSE
enum : int { BUF_IN = 0, BUF_HA = 1, BUF_HB = 2, BUF_S = 3, BUF_T = 4,
             BUF_X = 5 };
// activation codes (same order as ops/chain_kernels.py::ACT_CODES)
enum : int { ACT_IDENTITY = 0, ACT_RELU = 1, ACT_TANH = 2, ACT_SIGMOID = 3,
             ACT_SILU = 4, ACT_GELU = 5, ACT_SOFTPLUS = 6, ACT_ELU = 7,
             ACT_LEAKY_RELU = 8 };
enum : int { KIND_NVP = 0, KIND_NICE = 1 };
enum : int { DIR_FWD = 0, DIR_INV = 1 };

struct Tile {
    float* in;    // (TB, ldx): [theta padded to n4 | x padded to d4 | pad]
    float* ha;    // (TB, ldh) hidden activations, ping
    float* hb;    // (TB, ldh) hidden activations, pong
    float* s;     // (TB, ldd) d-wide log-scale / linear-op output
    float* t;     // (TB, ldd) d-wide shift
    float* ldj;   // (TB,)
    int ldx, ldh, ldd, n4, d;
};

__device__ __forceinline__ float softplus_f(float u) {
    return fmaxf(u, 0.f) + log1pf(expf(-fabsf(u)));
}

__device__ __forceinline__ float sigmoid_f(float u) {
    return 1.f / (1.f + expf(-u));
}

__device__ __forceinline__ float act_fn(int act, float u) {
    switch (act) {
        // not fmaxf: it would swallow a NaN, which the plain version keeps
        case ACT_RELU: return u < 0.f ? 0.f : u;
        case ACT_TANH: return tanhf(u);
        case ACT_SIGMOID: return sigmoid_f(u);
        case ACT_SILU: return u * sigmoid_f(u);
        case ACT_GELU: {
            const float c = 0.7978845608028654f;
            return 0.5f * u * (1.f + tanhf(c * (u + 0.044715f * u * u * u)));
        }
        case ACT_SOFTPLUS: return softplus_f(u);
        case ACT_ELU: return u > 0.f ? u : expm1f(u);
        case ACT_LEAKY_RELU: return u >= 0.f ? u : 0.01f * u;
        default: return u;
    }
}

// ---- dense layers on the tensor cores, in 3xTF32 ---------------------------
//
// A block is three warpgroups: two consumers, which run the program (the
// products on the tensor cores, the couplings and every other op), and one
// producer, which streams the weights: it brings each chunk in with one bulk
// copy and splits it in place into the big and small planes, while the
// consumers multiply the chunks before. They meet on mbarriers only.

constexpr int CONSUMERS = 256;   // warpgroups 0 and 1
constexpr int PRODUCERS = 128;   // warpgroup 2
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int NB = 256;          // output columns per pass of a block
constexpr int KC = 16;           // weight rows (K) per chunk
constexpr int KG = KC / 4;       // 16-byte core-matrix columns per chunk
constexpr int PLANE = NB * KC;   // floats of a chunk of the widest pass
constexpr int SLOTS = 4;         // chunks: the weights, their remainders
constexpr int LEAD = 2;          // chunks copied ahead of the split
// the slots, then the mbarriers: landed[4], full[4], empty[4]
constexpr int RING_FLOATS = SLOTS * 2 * PLANE + 24;

// the columns a pass's chunk holds: 32, 128 or NB, by the columns left
DF_FN int chunk_cols(int left) {
    return left <= 32 ? 32 : (left <= 128 ? 128 : NB);
}

// The registers of a block, moved from the producer warpgroup to the
// consumers (setmaxnreg): a consumer holds a pass's accumulators, a chunk's
// sum and the chunk's A fragments (at the launch's even share, 168, they
// spilled).
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;   // (65536 - 56 * 128) / 256, by 8
DF_FN void producer_registers() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}
DF_FN void consumer_registers() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
}

// the consumers' barrier (named barrier 1; the producer never meets it)
DF_FN void consumer_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// DF_CHAIN_CLOCKS (a measurement build of tools/chip_probe.py --variants):
// thread 0 (a consumer) and thread CONSUMERS (the producer) of block 0 add
// the cycles of each part of a fold to their slots and leave the sums in
// df_chain_clk (read by df_chain_clocks).
enum : int { CC_FULL_WAIT = 0, CC_MMA, CC_EPILOGUE, CC_OPS, CC_RAW_WAIT,
             CC_EMPTY_WAIT, CC_SPLIT, CC_SLOTS };
#if defined(DF_CHAIN_CLOCKS)
__device__ unsigned long long df_chain_clk[CC_SLOTS];
struct Clk {
    unsigned long long c[CC_SLOTS];
    long long last;
    bool on;
    DF_FN void start() {
        on = blockIdx.x == 0 &&
             (threadIdx.x == 0 || threadIdx.x == CONSUMERS);
        for (int i = 0; i < CC_SLOTS; ++i) c[i] = 0;
        last = clock64();
    }
    DF_FN void tick(int slot) {
        if (!on) return;
        const long long now = clock64();
        c[slot] += (unsigned long long)(now - last);
        last = now;
    }
    DF_FN void write(int lo, int hi) {
        if (!on) return;
        for (int i = lo; i < hi; ++i) df_chain_clk[i] = c[i];
    }
};
#else
struct Clk {
    DF_FN void start() {}
    DF_FN void tick(int) {}
    DF_FN void write(int, int) {}
};
#endif

// ---- the weight stream -------------------------------------------------------
//
// The wrapper hands the weights pre-tiled (ops/chain_kernels.py::
// tile_weights): every chunk the products consume, in the order they consume
// them, as one contiguous run of floats already in wgmma's no-swizzle
// K-major core-matrix layout, zero-padded past the matrix. Chunk (c0, kc) of
// a dense instruction holds weight rows (K) kc*KC .. +KC and columns (N) c0
// .. c0 + CW (CW = chunk_cols(N4 - c0)); core matrix (n / 8, k / 4) of 8
// rows x 16 bytes lies at ((n / 8) * KG + k / 4) * 128 bytes, row n % 8 at
// 16 bytes each.

DF_FN unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

DF_FN void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(count));
}

DF_FN void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

DF_FN void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_addr(bar))
                 : "memory");
}

// the producer's arrival, announcing the bytes the copy will deliver
DF_FN void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
}

// wait until the barrier's phase `parity` has completed
DF_FN void mbar_wait(uint64_t* bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, counted on `bar` when they land
DF_FN void bulk_copy(float* dst, const float* src, unsigned bytes,
                     uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma, which reads
// through the async proxy
DF_FN void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The stream's buffers in shared memory. A slot holds a chunk of weights,
// which the producer rounds to TF32 in place (the big plane), and their
// remainders beside it (the small plane).
struct Stream {
    float* planes;       // SLOTS x (weights, remainders)
    uint64_t* landed;    // SLOTS: a chunk's copy landed
    uint64_t* full;      // SLOTS: a slot's remainders are written
    uint64_t* empty;     // SLOTS: the consumers are done with a slot
};

DF_FN Stream stream_at(float* w) {
    Stream s;
    s.planes = w;
    uint64_t* bars = reinterpret_cast<uint64_t*>(w + SLOTS * 2 * PLANE);
    s.landed = bars;
    s.full = bars + SLOTS;
    s.empty = bars + 2 * SLOTS;
    return s;
}

// thread 0, before the block's first barrier
DF_FN void stream_init(const Stream& s) {
    for (int i = 0; i < SLOTS; ++i) {
        mbar_init(s.landed + i, 1);
        mbar_init(s.full + i, PRODUCERS);
        mbar_init(s.empty + i, CONSUMERS);
    }
    mbar_init_fence();
}

// A walk over the program's chunks in the consumers' order.
struct Cursor {
    int pc, c0, kc, K4, N4;
};

DF_FN void cursor_seek(Cursor& u, const int* prog, int n_instr) {
    while (u.pc < n_instr && __ldg(prog + u.pc * INSTR_WORDS) != OP_DENSE)
        ++u.pc;
    if (u.pc < n_instr) {
        const int* I = prog + u.pc * INSTR_WORDS;
        u.K4 = __ldg(I + 3);
        u.N4 = __ldg(I + 4);
    }
}

DF_FN void cursor_start(Cursor& u, const int* prog, int n_instr) {
    u.pc = u.c0 = u.kc = 0;
    cursor_seek(u, prog, n_instr);
}

DF_FN void cursor_next(Cursor& u, const int* prog, int n_instr) {
    if (++u.kc * KC >= u.K4) {
        u.kc = 0;
        u.c0 += NB;
        if (u.c0 >= u.N4) {
            u.c0 = 0;
            ++u.pc;
            cursor_seek(u, prog, n_instr);
        }
    }
}

// cvt.rna.tf32.f32 by bit masks: the magnitude rounded to 10 mantissa
// bits, ties away from zero (an inf stays inf, a NaN a NaN)
DF_FN float rna_bits(float v) {
    return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// a weight's 3xTF32 parts, in place: rna(w) and rna(w - rna(w)) (NaN for an
// inf w)
DF_FN void split_weight(float& w, float& small) {
    const float big = rna_bits(w);
    small = rna_bits(w - big);
    w = big;
}

// The producer warpgroup: the copy of chunk c + LEAD goes out (once the
// consumers are done with that slot's chunk c + LEAD - SLOTS) while chunk c
// is split in place into its big and small planes.
DF_FN void produce(const Stream& s, const float* tiled, const int* prog,
                   int n_instr, Clk& clk) {
    const int pt = threadIdx.x - CONSUMERS;
    Cursor issue, split;
    cursor_start(issue, prog, n_instr);
    cursor_start(split, prog, n_instr);
    const float* src = tiled;
    int issued = 0;
    auto issue_one = [&]() {
        if (issue.pc >= n_instr) return;
        const int floats = chunk_cols(issue.N4 - issue.c0) * KC;
        const int sl = issued % SLOTS;
        if (issued >= SLOTS)
            mbar_wait(s.empty + sl, (unsigned)(issued / SLOTS - 1) & 1u);
        if (pt == 0) {
            mbar_expect(s.landed + sl, (unsigned)(4 * floats));
            bulk_copy(s.planes + sl * 2 * PLANE, src, (unsigned)(4 * floats),
                      s.landed + sl);
        }
        src += floats;
        ++issued;
        cursor_next(issue, prog, n_instr);
    };
    for (int i = 0; i < LEAD; ++i) issue_one();
    for (int c = 0; split.pc < n_instr; ++c) {
        issue_one();
        clk.tick(CC_EMPTY_WAIT);
        const int sl = c % SLOTS;
        const int n4 = chunk_cols(split.N4 - split.c0) * KC / 4;
        mbar_wait(s.landed + sl, (unsigned)(c / SLOTS) & 1u);
        clk.tick(CC_RAW_WAIT);
        float4* big = reinterpret_cast<float4*>(s.planes + sl * 2 * PLANE);
        float4* small = big + PLANE / 4;
        for (int i = pt; i < n4; i += PRODUCERS) {
            float4 v = big[i], l;
            split_weight(v.x, l.x);
            split_weight(v.y, l.y);
            split_weight(v.z, l.z);
            split_weight(v.w, l.w);
            big[i] = v;
            small[i] = l;
        }
        fence_async_shared();
        mbar_arrive(s.full + sl);
        cursor_next(split, prog, n_instr);
        clk.tick(CC_SPLIT);
    }
}

// an activation split for 3xTF32: rna(v), that where v is finite (else 0),
// and rna(v - rna(v)) where v is finite (else 0)
DF_FN void split3(float v, uint32_t& big, uint32_t& big_f, uint32_t& small) {
    uint32_t b, s;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(v));
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s) : "f"(v - __uint_as_float(b)));
    const bool fin = fabsf(v) <= 3.402823466e+38f;
    big = b;
    big_f = fin ? b : 0u;
    small = fin ? s : 0u;
}

// ---- wgmma ---------------------------------------------------------------

// The shared-memory descriptor of a K-major, no-swizzle TF32 tile at `p`:
// start address, the byte offset between core matrices along K (the
// leading dimension, 128) and along N (the stride dimension, KG * 128), all
// in 16-byte units.
DF_FN uint64_t tile_desc(const float* p) {
    const uint64_t addr = (uint64_t)__cvta_generic_to_shared(p);
    const uint64_t lbo = 128 >> 4, sbo = (KG * 128) >> 4;
    return ((addr >> 4) & 0x3FFF) | (lbo << 16) | (sbo << 32);
}

DF_FN void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

DF_FN void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

DF_FN void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= a . B on an m64n128k8 tile of the warpgroup: a this thread's TF32
// A fragment (registers), B a K-major TF32 tile in shared memory
DF_FN void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                       uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d)
        : "memory");
}

// d (+)= a . B on an m64n32k8 tile of the warpgroup: a this thread's TF32
// A fragment (registers), B a K-major TF32 tile in shared memory
DF_FN void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                      uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d)
        : "memory");
}

// scale_d 0: d = a . B, else d += a . B
template <int NW>
DF_FN void wgmma_n(float (&d)[NW / 2], const uint32_t (&a)[4], uint64_t desc,
                   int scale_d);
template <>
DF_FN void wgmma_n<128>(float (&d)[64], const uint32_t (&a)[4],
                        uint64_t desc, int scale_d) {
    wgmma_n128(d, a, desc, scale_d);
}
template <>
DF_FN void wgmma_n<32>(float (&d)[16], const uint32_t (&a)[4],
                       uint64_t desc, int scale_d) {
    wgmma_n32(d, a, desc, scale_d);
}

// One pass of a dense layer on a warpgroup's NW columns (NW = 128 or 32):
// acc[NW / 2] holds the m64nNW accumulators of the warpgroup's columns
// col0 .. col0 + NW; the A fragments come from `in` (rows past the tile are
// zeros), the B tiles from the stream's slots. Per chunk a warpgroup waits
// for its slot's planes, issues KC / 8 k-steps of three wgmma
// (small_a.big_b, big_a.small_b, then big_a.big_b), waits for them and
// hands the slot back to the producer. Fragment layouts are the PTX ISA's
// for m64nNk8 .tf32 (warp w of the warpgroup holds rows 16w .. 16w + 15;
// g = lane / 4, t = lane % 4): A (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); D per n8 block j (g, 8j + 2t), (g, 8j + 2t + 1),
// (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1). With `in` == `out` (the hidden
// buffer updated in place) both warpgroups finish reading before either
// writes.
template <int TB, int NW>
DF_FN void dense_pass(const float* __restrict__ in, int ldin, int K4, int N4,
                      const float* __restrict__ bias, int act, float* out,
                      int ldout, int c0, bool on, const Stream& st,
                      int& cons, Clk& clk) {
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const int wg = threadIdx.x >> 7;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = 16 * wq;
    const bool rows_on = row0 < TB;
    const int col0 = c0 + wg * NW;       // the warpgroup's first column
    const int n_chunks = (K4 + KC - 1) / KC;
    float acc[NW / 2];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
        const int c = col0 + j * 8 + 2 * t;
        const float b0 = bias != nullptr && c < N4 ? __ldg(bias + c) : 0.f;
        const float b1 = bias != nullptr && c < N4 ? __ldg(bias + c + 1) : 0.f;
        acc[4 * j] = b0; acc[4 * j + 1] = b1;
        acc[4 * j + 2] = b0; acc[4 * j + 3] = b1;
    }
    for (int ch = 0; ch < n_chunks; ++ch, ++cons) {
        const int sl = cons % SLOTS;
        mbar_wait(st.full + sl, (unsigned)(cons / SLOTS) & 1u);
        clk.tick(CC_FULL_WAIT);
        if (on) {
            const float* hi = st.planes + sl * 2 * PLANE +
                              (wg * NW / 8) * KG * 32;
            const float* lo = hi + PLANE;
            uint32_t ab[KC / 8][4], af[KC / 8][4], as[KC / 8][4];
#pragma unroll
            for (int s = 0; s < KC / 8; ++s) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int row = row0 + g + (q & 1) * 8;
                    const int k = ch * KC + s * 8 + t + (q >> 1) * 4;
                    const float v =
                        rows_on && k < K4 ? in[row * ldin + k] : 0.f;
                    split3(v, ab[s][q], af[s][q], as[s][q]);
                }
            }
            // the chunk's products into a fresh sum, added to acc in f32
            float part[NW / 2];
            wgmma_fence();
#pragma unroll
            for (int s = 0; s < KC / 8; ++s) {
                if (ch * KC + s * 8 >= K4) break;
                const uint64_t dh = tile_desc(hi + 2 * s * 32);
                const uint64_t dl = tile_desc(lo + 2 * s * 32);
                wgmma_n<NW>(part, as[s], dh, s == 0 ? 0 : 1);
                wgmma_n<NW>(part, af[s], dl, 1);
                wgmma_n<NW>(part, ab[s], dh, 1);
            }
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int i = 0; i < NW / 2; ++i) acc[i] += part[i];
        }
        mbar_arrive(st.empty + sl);
        clk.tick(CC_MMA);
    }
    if (in == out) consumer_sync();
    if (!on || !rows_on) return;
    const bool relu = act == ACT_RELU;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
        const int c = col0 + j * 8 + 2 * t;
        if (c >= N4) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float2 o = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            if (relu) {   // u < 0 ? 0 : u keeps a NaN, fmaxf would not
                o.x = o.x < 0.f ? 0.f : o.x;
                o.y = o.y < 0.f ? 0.f : o.y;
            }
            const int row = row0 + g + 8 * h;
            *reinterpret_cast<float2*>(out + row * ldout + c) = o;
        }
    }
    if (act != ACT_RELU && act != ACT_IDENTITY) {
        // the other activations: a rolled pass over this thread's own
        // outputs, so their code exists once, not per accumulator
#pragma unroll 1
        for (int e = 0; e < NW / 4; ++e) {
            const int j = e >> 1, h = e & 1;
            const int c = col0 + j * 8 + 2 * t;
            if (c >= N4) continue;
            float* q = out + (row0 + g + 8 * h) * ldout + c;
            q[0] = act_fn(act, q[0]);
            q[1] = act_fn(act, q[1]);
        }
    }
    clk.tick(CC_EPILOGUE);
}

// out[TB, N4] = act(in[TB, K4] @ W[K4, N4] + bias): `in` and `out` are
// shared-memory buffers (the same one for a hidden layer updated in place),
// W comes through the stream, bias from device memory. Passes of NB
// columns; a pass of more than 32 columns gives each warpgroup 128 of them
// (m64n128), a narrower one runs on warpgroup 0 (m64n32) while warpgroup 1
// keeps the stream's count.
template <int TB>
DF_FN void dense(const float* __restrict__ in, int ldin, int K4, int N4,
                 const float* __restrict__ bias, int act, float* out,
                 int ldout, const Stream& st, int& cons, Clk& clk) {
    const int wg = threadIdx.x >> 7;
    for (int c0 = 0; c0 < N4; c0 += NB) {
        if (N4 - c0 > 32)
            dense_pass<TB, 128>(in, ldin, K4, N4, bias, act, out, ldout, c0,
                                c0 + wg * 128 < N4, st, cons, clk);
        else
            dense_pass<TB, 32>(in, ldin, K4, N4, bias, act, out, ldout, c0,
                               wg == 0, st, cons, clk);
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Affine coupling update on the x part of the tile, one warp per row:
// fwd x = x*exp(s)+t, inv x = (x-t)*exp(-s); s/t are exactly zero on the
// identity dims (folded scatter), so the full-width update is the coupling.
template <int TB, int NT>
__device__ void couple(const Tile& t, int kind, int dirn, float clamp,
                       bool with_ldj) {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < TB; r += NT / 32) {
        float* x = t.in + r * t.ldx + t.n4;
        const float* sv = t.s + r * t.ldd;
        const float* tv = t.t + r * t.ldd;
        float sum = 0.f;
        for (int j = lane; j < t.d; j += 32) {
            float xv = x[j];
            const float sh = tv[j];
            if (kind == KIND_NVP) {
                float s = sv[j];
                if (clamp > 0.f) s = clamp * tanhf(s / clamp);
                xv = dirn == DIR_FWD ? xv * expf(s) + sh : (xv - sh) * expf(-s);
                sum += s;
            } else {
                xv = dirn == DIR_FWD ? xv + sh : xv - sh;
            }
            x[j] = xv;
        }
        if (with_ldj && kind == KIND_NVP) {
            sum = warp_sum(sum);
            if (lane == 0) t.ldj[r] += dirn == DIR_FWD ? sum : -sum;
        }
    }
}

template <int TB, int NT>
__device__ void logit(const Tile& t, int dirn, float eps, const float* lo,
                      const float* hi, const float* wlog, bool with_ldj) {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < TB; r += NT / 32) {
        float* x = t.in + r * t.ldx + t.n4;
        float sum = 0.f;
        for (int j = lane; j < t.d; j += 32) {
            const float l = __ldg(lo + j), h = __ldg(hi + j);
            float z;
            if (dirn == DIR_FWD) {
                z = x[j];
                x[j] = l + (h - l) * sigmoid_f(z);
            } else {
                float u = (x[j] - l) / (h - l);
                // a clamp that keeps a NaN, as the plain version's does
                if (u == u) u = fminf(fmaxf(u, eps), 1.f - eps);
                z = logf(u) - log1pf(-u);
                x[j] = z;
            }
            sum += -softplus_f(-z) - softplus_f(z) + __ldg(wlog + j);
        }
        if (with_ldj) {
            sum = warp_sum(sum);
            if (lane == 0) t.ldj[r] += dirn == DIR_FWD ? sum : -sum;
        }
    }
}

// The program on the tile, by the consumers; the producer streams the
// weights of its products alongside.
template <int TB, int NT>
__device__ void fold(const int* __restrict__ prog, int n_instr,
                     const float* __restrict__ P, const Tile& t,
                     bool with_ldj, const Stream& st, Clk& clk) {
    int cons = 0;
    for (int pc = 0; pc < n_instr; ++pc) {
        const int* I = prog + pc * INSTR_WORDS;
        const int op = __ldg(I);
        if (op == OP_DENSE) {
            const int ib = __ldg(I + 1), ob = __ldg(I + 2);
            const int K4 = __ldg(I + 3), N4 = __ldg(I + 4);
            const int boff = __ldg(I + 6), act = __ldg(I + 7);
            const float* in; int ldin;
            if (ib == BUF_IN) { in = t.in; ldin = t.ldx; }
            else if (ib == BUF_X) { in = t.in + t.n4; ldin = t.ldx; }
            else if (ib == BUF_HA) { in = t.ha; ldin = t.ldh; }
            else { in = t.hb; ldin = t.ldh; }
            float* out; int ldout;
            if (ob == BUF_HA) { out = t.ha; ldout = t.ldh; }
            else if (ob == BUF_HB) { out = t.hb; ldout = t.ldh; }
            else if (ob == BUF_S) { out = t.s; ldout = t.ldd; }
            else { out = t.t; ldout = t.ldd; }
            dense<TB>(in, ldin, K4, N4, boff >= 0 ? P + boff : nullptr, act,
                      out, ldout, st, cons, clk);
        } else if (op == OP_COUPLE) {
            couple<TB, NT>(t, __ldg(I + 1), __ldg(I + 2),
                       __int_as_float(__ldg(I + 3)), with_ldj);
        } else if (op == OP_AFFINE) {
            const float* a = P + __ldg(I + 1);
            const float* b = P + __ldg(I + 2);
            for (int idx = threadIdx.x; idx < TB * t.d; idx += NT) {
                const int r = idx / t.d, j = idx - r * t.d;
                float* x = t.in + r * t.ldx + t.n4 + j;
                *x = *x * __ldg(a + j) + __ldg(b + j);
            }
            if (with_ldj && threadIdx.x < TB)
                t.ldj[threadIdx.x] += __ldg(P + __ldg(I + 3));
        } else if (op == OP_COMMIT) {  // x <- s (result of a linear op)
            for (int idx = threadIdx.x; idx < TB * t.d; idx += NT) {
                const int r = idx / t.d, j = idx - r * t.d;
                t.in[r * t.ldx + t.n4 + j] = t.s[r * t.ldd + j];
            }
            if (with_ldj && threadIdx.x < TB)
                t.ldj[threadIdx.x] += __ldg(P + __ldg(I + 1));
        } else if (op == OP_LOGIT) {
            logit<TB, NT>(t, __ldg(I + 1), __int_as_float(__ldg(I + 2)),
                      P + __ldg(I + 3), P + __ldg(I + 4), P + __ldg(I + 5),
                      with_ldj);
        }
        consumer_sync();
        clk.tick(CC_OPS);
    }
}

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

// Hidden buffers of a tile: one, updated in place, where no hidden layer is
// wider than a pass (every product reads all of its input before it writes
// any output); two, ping-pong, else.
__host__ __device__ inline int hidden_buffers(int ldh) {
    return ldh - 4 <= NB ? 1 : 2;
}

// floats of the tile's buffers, and of dynamic shared memory a block needs
// (the tile, rounded up to 16 bytes, then the weight stream); mirrored by
// ops/chain_kernels.py::shared_memory_bytes
__host__ __device__ inline size_t tile_floats(int tb, int d, int n, int ldh) {
    return (size_t)tb * (up4(n) + up4(d) + 4) +
           hidden_buffers(ldh) * (size_t)tb * ldh +
           2 * (size_t)tb * (up4(d) + 4) + tb;
}

__host__ __device__ inline size_t block_floats(int tb, int d, int n,
                                               int ldh) {
    return (size_t)up4((int)tile_floats(tb, d, n, ldh)) + RING_FLOATS;
}

template <int TB>
__device__ Tile carve(float* smem, int d, int n, int ldh) {
    Tile t;
    t.n4 = up4(n); t.d = d;
    // +4 floats: consecutive rows start on different shared-memory banks
    t.ldx = up4(n) + up4(d) + 4; t.ldh = ldh; t.ldd = up4(d) + 4;
    t.in = smem;
    t.ha = t.in + TB * t.ldx;
    t.hb = hidden_buffers(ldh) == 1 ? t.ha : t.ha + TB * ldh;
    t.s = t.hb + TB * ldh;
    t.t = t.s + TB * t.ldd;
    t.ldj = t.t + TB * t.ldd;
    return t;
}

// ---- one row tile through a program --------------------------------------

// rows blockIdx.x * TB .. + TB of x (rows, d) and theta (rows, n) through
// the program: y (rows, d), ldj (rows,) or null. The block is THREADS
// threads: the producer warpgroup streams `tiled`, the consumers load the
// [theta | x] tile, fold it and write it out.
template <int TB>
DF_FN void apply_tile(float* smem, const float* __restrict__ x,
                      const float* __restrict__ theta, float* __restrict__ y,
                      float* __restrict__ ldj_out,
                      const int* __restrict__ prog, int n_instr,
                      const float* __restrict__ P,
                      const float* __restrict__ tiled, long long rows, int d,
                      int n, int ldh) {
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
    const bool with_ldj = ldj_out != nullptr;

    // load the [theta | x] tile; rows past the end and pad columns are zero
    for (int idx = threadIdx.x; idx < TB * t.ldx; idx += CONSUMERS) {
        const int r = idx / t.ldx, c = idx - r * t.ldx;
        const long long g = row0 + r;
        float v = 0.f;
        if (g < rows) {
            if (c < n) v = theta[g * n + c];
            else if (c >= t.n4 && c < t.n4 + d) v = x[g * d + (c - t.n4)];
        }
        t.in[idx] = v;
    }
    if (threadIdx.x < TB) t.ldj[threadIdx.x] = 0.f;
    consumer_sync();

    fold<TB, CONSUMERS>(prog, n_instr, P, t, with_ldj, st, clk);
    clk.write(CC_FULL_WAIT, CC_RAW_WAIT);

    for (int idx = threadIdx.x; idx < TB * d; idx += CONSUMERS) {
        const int r = idx / d, j = idx - r * d;
        const long long g = row0 + r;
        if (g < rows) y[g * d + j] = t.in[r * t.ldx + t.n4 + j];
    }
    if (with_ldj && threadIdx.x < TB && row0 + threadIdx.x < rows)
        ldj_out[row0 + threadIdx.x] = t.ldj[threadIdx.x];
}

}  // namespace wgf
