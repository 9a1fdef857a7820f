// The tensor-core design of train_stream (stream_kernels.cu): a step of
// 64-row tiles whose activation caches lie in a device workspace, every
// product on the tensor cores in 3xTF32, and the weight gradients summed
// over fixed segments of the batch's rows before they reach device memory.
//
// Why. The tile body (grads_tile.cuh) keeps a tile's caches in shared
// memory: 38.6 KB a row at d 32 / hidden 256, so its tiles are 4 rows, and
// every tile walks all the weights from L2 three times and adds its gradient
// into its block's whole partial row in device memory, on scalar FMAs (47 ms
// a step of 8,192 rows on an H100). Here the caches go to the workspace, so
// a tile is 64 rows and a dense layer one tensor-core product; the weight
// gradients are batch-wide products a^T.delta over segments of
// TC_SEG_TILES tiles (ops/stream_kernels.py), each written once a step.
//
// A step is three grid phases (four with the guard):
//   (T) tiles: block k folds the batch's tiles k, k + grid, ... through the
//       forward program (dense layers on the tensor cores, the couplings and
//       the affine layers on flow_phases.cuh's handlers, with the tile's
//       rows in the workspace), takes the tile's share of the loss, and runs
//       the backward program's pullbacks (delta.W^T, then the activation
//       derivative; on the tensor cores) and coupling steps. Every dense
//       layer's input and output cotangent stay in the workspace
//       (ops/train_kernels.py::pack_train_plan(keep_deltas=True)).
//   (W) weight gradients: the items of ops/stream_kernels.py::tc_items, a
//       128 x 128 block of one layer's a^T.delta over one segment's rows
//       (with the bias gradient, the sum of delta over the rows, in the
//       block of the first 128 input features) into that segment's row of
//       the (segments, np + 1) partial buffer; the owner of a segment also
//       sums its tiles' losses, in tile order.
//   (R) the partial rows summed in index order, the select mask, the guard
//       and Adam: stream_kernels.cu's reduction and update, over the
//       segments' rows in place of the blocks'; each updated parameter is
//       also split into the weights' two planes (below).
// Every output is owned by one thread of one block and summed in a fixed
// order; no float atomics. The bits do not depend on the grid.
//
// 3xTF32 as in chain_kernels.cu: each operand v is split into big = rna(v)
// and small = rna(v - big); a product is small_a.big_b + big_a.small_b +
// big_a.big_b, the small products first, each 16-deep chunk of the sum
// into a fresh tensor-core accumulator that is added to the output's in
// f32. A non-finite value is split into big = 0 and small = v, so that it
// enters the product once, as it enters the plain one (a product of two
// non-finite values reads NaN where the plain one may read an inf). The
// weights are split once after every update into two planes in the
// workspace; activations and cotangents as each chunk is staged.
//
// The products are mma.sync m16n8k8 .tf32: a block is 16 warps, each owning
// 32 x 32 outputs; operands are staged in shared memory by cp.async in
// chunks of 32 deep, the next chunk copied while one is multiplied, rows
// padded so that every fragment load hits 32 banks. Fragments are loaded
// from registers, so the forward (a.W), the pullback (delta.W^T) and the
// weight gradient (a^T.delta) read the row-major caches and weights as they
// lie (TF32 wgmma takes K-major operands from shared memory only).
//
// What bounds it on an H100 (DF_STREAM_CLOCKS cycles of block 0, the
// emulator32 step, tools/chip_probe.py): the tile products ~45 % of a step
// (the copies of the weights' planes from L2, which all 132 blocks stream
// at once, and the products about equally), the W items ~35 % (their copies
// from the workspace in device memory, the splits and the products), the
// flow_phases.cuh handlers on the workspace ~6 %, barriers and the
// reduction the rest: 4.0 ms a step against a 3xTF32 bound of 0.36 ms.
//
// With DF_HOST_EMULATION the products are a C++ stand-in that splits the
// operands the same way and sums each output in the card's chunks (not in
// the tensor cores' order within a chunk); the rest is the same code.
//
// The including file defines DF_FN and DF_PHASE and includes
// flow_phases.cuh and async_copy.cuh first.

#pragma once

namespace {

constexpr int TC_ROWS = 64;        // rows of a tile (the program's H_B)
constexpr int TC_THREADS = 512;    // 16 warps
constexpr int TC_KC = 32;          // depth of one staged chunk
constexpr int TC_PASS = 256;       // output columns of a tile product's pass
constexpr int TC_ITEM = 128;       // output rows and columns of a W item
constexpr int TC_LDA = TC_KC + 4;  // row stride of a staged [rows][TC_KC]
constexpr int TC_LDW = TC_PASS + 8;  // of a staged [TC_KC][TC_PASS] chunk
constexpr int TC_LDG = TC_ITEM + 8;  // of a staged [TC_KC][TC_ITEM] chunk
// The shared array of a product: two stages (a chunk's raw activations and
// the weights' two planes, copied by cp.async), then the split planes of
// the chunk's activations. The forward's stage: A [64][TC_LDA] and W's
// planes 2 x [TC_KC][TC_LDW]; the pullback's: delta [64][TC_LDA] and W's
// planes 2 x [TC_PASS][TC_LDA]; a W item's: a and delta [TC_KC][TC_LDG].
constexpr int TC_A = TC_ROWS * TC_LDA;
constexpr int TC_FWD_STAGE = TC_A + 2 * TC_KC * TC_LDW;
constexpr int TC_BWD_STAGE = TC_A + 2 * TC_PASS * TC_LDA;
constexpr int TC_G = TC_KC * TC_LDG;
constexpr int TC_W_STAGE = 2 * TC_G;
// then the block's scalars (stream_kernels.cu's S_OK)
constexpr int TC_SCAL = 2 * TC_BWD_STAGE + 2 * TC_A;
constexpr int TC_SHARED_FLOATS = TC_SCAL + 8;
static_assert(2 * TC_FWD_STAGE + 2 * TC_A <= TC_SCAL, "forward");
static_assert(2 * TC_W_STAGE + 4 * TC_G <= TC_SCAL, "W item");

// ---- 3xTF32 splits ----------------------------------------------------------

// rna(v), the rounding of cvt.rna.tf32.f32 (the magnitude rounded to 10
// mantissa bits, ties away from zero), by integer ops, which issue at the
// full rate where the conversion does not; right for finite v, the only
// values it is given
DF_FN float tc_rna(float v) {
#ifndef DF_HOST_EMULATION
    return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
#else
    uint32_t u;
    std::memcpy(&u, &v, sizeof u);
    u = (u + 0x1000u) & 0xFFFFE000u;
    std::memcpy(&v, &u, sizeof v);
    return v;
#endif
}

// A value's parts: big = rna(v) and small = rna(v - big) where v is finite;
// else big = 0 and small = v, so that a non-finite value enters a product
// once, through small_a.big_b (or big_a.small_b), as it enters the plain
// product. Activations are split as they are staged, the weights once
// after every update.
DF_FN void tc_split(float v, float& big, float& small) {
    const float b = tc_rna(v);
    const bool fin = finite_f(v);
    big = fin ? b : 0.f;
    small = fin ? tc_rna(v - b) : v;
}

// The weights' two planes in device memory (the parameters split, after
// every update), as the parameters lie
struct TcW {
    const float* big;
    const float* small;
};

#ifndef DF_HOST_EMULATION

// ---- the products on the card ----------------------------------------------

DF_FN void tc_mma(float (&d)[4], const uint32_t (&a)[4],
                  const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k8 step of a warp's 32 x 32 outputs: A's big plane element (m, k) at
// A[m * ARS + k * ACS] and its small plane AP floats further, B's (k, n) at
// B[k * BRS + n * BCS] and BP further, both from the warp's origin, k from
// `k`; small_a.big_b, big_a.small_b, then big_a.big_b. Fragment layouts are
// the PTX ISA's for m16n8k8 .tf32 (g = lane / 4, t = lane % 4): A (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (t, g), (t + 4, g); D (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <int ARS, int ACS, int AP, int BRS, int BCS, int BP>
DF_FN void tc_k8(const float* A, const float* B, int k,
                 float (&part)[2][4][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int m = 16 * mi + g + 8 * (q & 1), kk = k + t + 4 * (q >> 1);
            ab[mi][q] = __float_as_uint(A[m * ARS + kk * ACS]);
            as[mi][q] = __float_as_uint(A[m * ARS + kk * ACS + AP]);
        }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
        uint32_t bb[2], bs[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int n = 8 * ni + g, kk = k + t + 4 * q;
            bb[q] = __float_as_uint(B[kk * BRS + n * BCS]);
            bs[q] = __float_as_uint(B[kk * BRS + n * BCS + BP]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
            tc_mma(part[mi][ni], as[mi], bb);
            tc_mma(part[mi][ni], ab[mi], bs);
            tc_mma(part[mi][ni], ab[mi], bb);
        }
    }
}

// A staged chunk of `depth` (<= TC_KC) valid k: each 16-deep part into a
// fresh accumulator, added to acc in f32
template <int ARS, int ACS, int AP, int BRS, int BCS, int BP>
DF_FN void tc_chunk(const float* A, const float* B, int depth,
                    float (&acc)[2][4][4]) {
#pragma unroll
    for (int h = 0; h < TC_KC / 16; ++h) {
        if (16 * h >= depth) break;
        float part[2][4][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int q = 0; q < 4; ++q) part[mi][ni][q] = 0.f;
        tc_k8<ARS, ACS, AP, BRS, BCS, BP>(A, B, 16 * h, part);
        if (16 * h + 8 < depth)
            tc_k8<ARS, ACS, AP, BRS, BCS, BP>(A, B, 16 * h + 8, part);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[mi][ni][q] += part[mi][ni][q];
    }
}

DF_FN void tc_zero(float (&acc)[2][4][4]) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
}

// i = r * n + c by a shift and a mask where n is a power of two (the
// staged extents nearly always are), else by a division
struct TcDiv {
    int n, shift;
    bool pow2;
    DF_FN explicit TcDiv(int n_) : n(n_), shift(0), pow2((n_ & (n_ - 1)) == 0) {
        while ((1 << shift) < n) ++shift;
    }
    DF_FN void split(int i, int& r, int& c) const {
        if (pow2) {
            r = i >> shift;
            c = i & (n - 1);
        } else {
            r = i / n;
            c = i - r * n;
        }
    }
};

// `cols` (>= 1) rounded up to a multiple of m, at most cap
DF_FN int tc_extent(int cols, int m, int cap) {
    const int e = (cols + m - 1) / m * m;
    return e < cap ? e : cap;
}

// rows r0 .. r0 + rows and columns c0 .. c0 + cols (a multiple of 4) of a
// row-major source (row stride ld; entries at or past (rmax, cmax) are 0)
// into dst (row stride dld, a multiple of 4), by cp.async: 16-byte copies
// where the source's rows allow them, else 4-byte ones; 16 bytes wholly
// outside are zeros stored directly
DF_FN void tc_stage(float* dst, int dld, const float* src, int ld, int r0,
                    int rows, int rmax, int c0, int cols, int cmax) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const bool vec = ((reinterpret_cast<uintptr_t>(src) & 15) == 0) &&
                     (ld & 3) == 0 && (c0 & 3) == 0;
    const int q = vec ? cols / 4 : cols;   // items a row
    const TcDiv div(q);
    for (int idx = tid; idx < rows * q; idx += nt) {
        int r, c;
        div.split(idx, r, c);
        const int gr = r0 + r;
        if (vec) {
            const int gc = c0 + 4 * c;
            float* d = dst + r * dld + 4 * c;
            if (gr < rmax && gc + 3 < cmax) {
                df_cp_async16(d, src + (long long)gr * ld + gc);
            } else if (gr >= rmax || gc >= cmax) {
                *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
            } else {
                for (int j = 0; j < 4; ++j) {
                    const bool ok = gc + j < cmax;
                    df_cp_async4(d + j,
                                 ok ? src + (long long)gr * ld + gc + j : src,
                                 ok);
                }
            }
        } else {
            const int gc = c0 + c;
            const bool ok = gr < rmax && gc < cmax;
            df_cp_async4(dst + r * dld + c,
                         ok ? src + (long long)gr * ld + gc : src, ok);
        }
    }
}

// a staged [rows][cols] of activations (row stride ld) into its big plane
// at big and its small plane `plane` floats further
DF_FN void tc_split_rows(const float* raw, float* big, int plane, int ld,
                         int rows, int cols) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const TcDiv div(cols);
    for (int idx = tid; idx < rows * cols; idx += nt) {
        int r, c;
        div.split(idx, r, c);
        float b, s;
        tc_split(raw[r * ld + c], b, s);
        big[r * ld + c] = b;
        big[r * ld + c + plane] = s;
    }
}

// The pipeline of a product, stages of `stage` floats: chunk ch + 1 is
// copied while chunk ch is split and multiplied. copy(ch, buf) issues a
// chunk's copies, split(ch, buf) splits its activations, run(ch, buf) uses
// it.
// ck.tick(sb), (sb + 1), (sb + 2): the waits, the splits, the products (a
// measurement build's clock; else nothing).
template <class Copy, class Split, class Run, class Ck>
DF_FN void tc_pipeline(float* sm, int stage, int n_ch, Copy&& copy,
                       Split&& split, Run&& run, Ck& ck, int sb) {
    if (n_ch > 0) copy(0, sm);
    df_cp_async_commit();
    for (int ch = 0; ch < n_ch; ++ch) {
        float* buf = sm + (ch & 1) * stage;
        df_cp_async_wait_group<0>();
        __syncthreads();
        ck.tick(sb);
        split(ch, buf);
        __syncthreads();
        ck.tick(sb + 1);
        // the next chunk's copies go out after the barrier, so that a warp
        // whose copies wait for the memory system does not hold back the
        // others' products
        if (ch + 1 < n_ch) copy(ch + 1, sm + ((ch + 1) & 1) * stage);
        df_cp_async_commit();
        run(ch, buf);
        ck.tick(sb + 2);
    }
    __syncthreads();
    ck.tick(sb);
}

// Forward dense layer of a tile: out = act(in1.W1 (+ in2.W2) + bias) over
// the tile's 64 rows, in passes of TC_PASS columns; warp w owns rows
// 32 (w % 2) .. and columns 32 (w / 2) .. of a pass.
template <class Ck>
DF_FN void tc_dense_fwd(const Mem& m, const TcW& wp, const int* I, float* sm,
                        Ck& ck, int sb) {
    const int in1 = I[1], K1 = I[2], w1 = I[3], in2 = I[4], K2 = I[5],
              w2 = I[6], N = I[7], bias = I[8], act = I[9], out = I[10];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3, wr = warp & 1, wc = warp >> 1;
    const int n1 = (K1 + TC_KC - 1) / TC_KC;
    const int n_ch = n1 + (K2 > 0 ? (K2 + TC_KC - 1) / TC_KC : 0);
    float* planes = sm + 2 * TC_FWD_STAGE;
    constexpr int WP = TC_KC * TC_LDW;
    for (int c0 = 0; c0 < N; c0 += TC_PASS) {
        const int col0 = c0 + 32 * wc;
        const bool on = col0 < N;
        const int nx = tc_extent(N - c0, 32, TC_PASS);   // columns staged
        float acc[2][4][4];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int c = col0 + 8 * ni + 2 * t + (q & 1);
                const float b = bias >= 0 && c < N ? m.P[bias + c] : 0.f;
                acc[0][ni][q] = b;
                acc[1][ni][q] = b;
            }
        auto chunk = [&](int ch, int& k0, int& K, int& a_off, int& w_off) {
            const bool second = ch >= n1;
            k0 = (second ? ch - n1 : ch) * TC_KC;
            K = second ? K2 : K1;
            a_off = second ? in2 : in1;
            w_off = second ? w2 : w1;
        };
        tc_pipeline(sm, TC_FWD_STAGE, n_ch,
            [&](int ch, float* buf) {
                int k0, K, a_off, w_off;
                chunk(ch, k0, K, a_off, w_off);
                const int kx = tc_extent(K - k0, 8, TC_KC);
                tc_stage(buf, TC_LDA, m.S + a_off, K, 0, TC_ROWS, TC_ROWS,
                         k0, kx, K);
                tc_stage(buf + TC_A, TC_LDW, wp.big + w_off, N, k0, kx, K,
                         c0, nx, N);
                tc_stage(buf + TC_A + WP, TC_LDW, wp.small + w_off, N, k0,
                         kx, K, c0, nx, N);
            },
            [&](int ch, float* buf) {
                int k0, K, a_off, w_off;
                chunk(ch, k0, K, a_off, w_off);
                tc_split_rows(buf, planes, TC_A, TC_LDA, TC_ROWS,
                              tc_extent(K - k0, 8, TC_KC));
            },
            [&](int ch, float* buf) {
                if (!on) return;
                int k0, K, a_off, w_off;
                chunk(ch, k0, K, a_off, w_off);
                const int depth = K - k0 < TC_KC ? K - k0 : TC_KC;
                tc_chunk<TC_LDA, 1, TC_A, TC_LDW, 1, WP>(
                    planes + 32 * wr * TC_LDA, buf + TC_A + 32 * wc, depth,
                    acc);
            }, ck, sb);
        if (on) {
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int r = 32 * wr + 16 * mi + g + 8 * (q >> 1);
                        const int c = col0 + 8 * ni + 2 * t + (q & 1);
                        if (c < N)
                            m.S[out + r * N + c] = act_fn(act, acc[mi][ni][q]);
                    }
        }
    }
    __syncthreads();
}

// Pullback of a dense layer on a tile: dout = (delta.W^T [+ dout]) .
// dact(a) over the tile's rows, in passes of TC_PASS input columns.
template <class Ck>
DF_FN void tc_dense_pullback(const Mem& m, const TcW& wp, const int* I,
                             float* sm, Ck& ck, int sb) {
    const int src = I[1], K = I[2], w = I[3], N = I[4], dl = I[5],
              dout = I[7], acc_flag = I[8], dact = I[9];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3, wr = warp & 1, wc = warp >> 1;
    const int n_ch = (N + TC_KC - 1) / TC_KC;
    float* planes = sm + 2 * TC_BWD_STAGE;
    constexpr int WP = TC_PASS * TC_LDA;
    for (int c0 = 0; c0 < K; c0 += TC_PASS) {
        const int col0 = c0 + 32 * wc;
        const bool on = col0 < K;
        const int kx = tc_extent(K - c0, 32, TC_PASS);   // W rows staged
        float acc[2][4][4];
        tc_zero(acc);
        tc_pipeline(sm, TC_BWD_STAGE, n_ch,
            [&](int ch, float* buf) {
                const int n0 = ch * TC_KC;
                const int nx = tc_extent(N - n0, 8, TC_KC);
                tc_stage(buf, TC_LDA, m.S + dl, N, 0, TC_ROWS, TC_ROWS, n0,
                         nx, N);
                tc_stage(buf + TC_A, TC_LDA, wp.big + w, N, c0, kx, K, n0,
                         nx, N);
                tc_stage(buf + TC_A + WP, TC_LDA, wp.small + w, N, c0, kx, K,
                         n0, nx, N);
            },
            [&](int ch, float* buf) {
                tc_split_rows(buf, planes, TC_A, TC_LDA, TC_ROWS,
                              tc_extent(N - ch * TC_KC, 8, TC_KC));
            },
            [&](int ch, float* buf) {
                if (!on) return;
                const int n0 = ch * TC_KC;
                const int depth = N - n0 < TC_KC ? N - n0 : TC_KC;
                tc_chunk<TC_LDA, 1, TC_A, 1, TC_LDA, WP>(
                    planes + 32 * wr * TC_LDA, buf + TC_A + 32 * wc * TC_LDA,
                    depth, acc);
            }, ck, sb);
        if (on) {
            // every load before the first store: the loads go out together
            float old[2][4][4], av[2][4][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int r = 32 * wr + 16 * mi + g + 8 * (q >> 1);
                        const int c = col0 + 8 * ni + 2 * t + (q & 1);
                        const bool in = c < K;
                        old[mi][ni][q] =
                            in && acc_flag ? m.S[dout + r * K + c] : 0.f;
                        av[mi][ni][q] = in ? m.S[src + r * K + c] : 0.f;
                    }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int r = 32 * wr + 16 * mi + g + 8 * (q >> 1);
                        const int c = col0 + 8 * ni + 2 * t + (q & 1);
                        if (c >= K) continue;
                        float v = acc[mi][ni][q];
                        if (acc_flag) v += old[mi][ni][q];
                        m.S[dout + r * K + c] = v * dact_fn(dact,
                                                            av[mi][ni][q]);
                    }
        }
    }
    __syncthreads();
}

// One W item: rows m0 .. m0 + 128 and columns n0 .. n0 + 128 of the layer's
// a^T.delta over the rows of tiles t0 .. t1 into g_row (the segment's
// partial row), and where the item holds the first input features, the
// bias gradient of its columns (one thread a column, rows in order). Warp w
// owns outputs 32 (w % 4) .. x 32 (w / 4) ...
template <class Ck>
DF_FN void tc_wgrad(const float* ws, long long tstride, const int* I, int m0,
                    int n0, int t0, int t1, float* g_row, float* sm, Ck& ck,
                    int sb) {
    const int src = I[1], K = I[2], w = I[3], N = I[4], dl = I[5],
              bias = I[6];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3, wm = warp & 3, wn = warp >> 2;
    const int row0 = m0 + 32 * wm, col0 = n0 + 32 * wn;
    const bool on = row0 < K && col0 < N;
    const bool b_on = bias >= 0 && m0 == 0 && tid < TC_ITEM && n0 + tid < N;
    const int per_tile = TC_ROWS / TC_KC;
    float* planes = sm + 2 * TC_W_STAGE;   // a's two planes, then delta's
    const int mx = tc_extent(K - m0, 32, TC_ITEM);   // columns staged
    const int nx = tc_extent(N - n0, 32, TC_ITEM);
    float acc[2][4][4];
    tc_zero(acc);
    float bsum = 0.f;
    tc_pipeline(sm, TC_W_STAGE, (t1 - t0) * per_tile,
        [&](int ch, float* buf) {
            const float* base = ws + (long long)(t0 + ch / per_tile) * tstride;
            const int r0 = (ch % per_tile) * TC_KC;
            tc_stage(buf, TC_LDG, base + src, K, r0, TC_KC, TC_ROWS, m0, mx,
                     K);
            tc_stage(buf + TC_G, TC_LDG, base + dl, N, r0, TC_KC, TC_ROWS,
                     n0, nx, N);
        },
        [&](int, float* buf) {
            tc_split_rows(buf, planes, TC_G, TC_LDG, TC_KC, mx);
            tc_split_rows(buf + TC_G, planes + 2 * TC_G, TC_G, TC_LDG, TC_KC,
                          nx);
        },
        [&](int, float* buf) {
            if (on)
                tc_chunk<1, TC_LDG, TC_G, TC_LDG, 1, TC_G>(
                    planes + 32 * wm, planes + 2 * TC_G + 32 * wn, TC_KC,
                    acc);
            if (b_on)
                for (int r = 0; r < TC_KC; ++r)
                    bsum += buf[TC_G + r * TC_LDG + tid];
        }, ck, sb);
    if (on) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int r = row0 + 16 * mi + g + 8 * (q >> 1);
                    const int c = col0 + 8 * ni + 2 * t + (q & 1);
                    if (r < K && c < N) g_row[w + r * N + c] = acc[mi][ni][q];
                }
    }
    if (b_on) g_row[bias + n0 + tid] = bsum;
}

#else  // DF_HOST_EMULATION

// ---- the stand-in products on the host --------------------------------------

// The 3xTF32 sum over k in [k0, k1) (at most 16) of a[k * as] (an
// activation, split) times b, whose parts are bb[k * bs] and bsm[k * bs]:
// per 8-deep step small_a.big_b, big_a.small_b, then big_a.big_b, in f32
DF_FN float tc_dot16(const float* a, int as, const float* bb,
                     const float* bsm, int bs, int k0, int k1) {
    float part = 0.f;
    for (int s = k0; s < k1; s += 8) {
        const int e = s + 8 < k1 ? s + 8 : k1;
        float ab[8], asm_[8];
        for (int k = s; k < e; ++k) tc_split(a[k * as], ab[k - s],
                                                  asm_[k - s]);
        for (int k = s; k < e; ++k)
            part = fmaf(asm_[k - s], bb[k * bs], part);
        for (int k = s; k < e; ++k)
            part = fmaf(ab[k - s], bsm[k * bs], part);
        for (int k = s; k < e; ++k)
            part = fmaf(ab[k - s], bb[k * bs], part);
    }
    return part;
}

// a.b over k in [0, K) in 16-deep parts added in f32, from acc
DF_FN float tc_dot(const float* a, int as, const float* bb, const float* bsm,
                   int bs, int K, float acc) {
    for (int k0 = 0; k0 < K; k0 += 16)
        acc += tc_dot16(a, as, bb, bsm, bs, k0, k0 + 16 < K ? k0 + 16 : K);
    return acc;
}

template <class Ck>
DF_FN void tc_dense_fwd(const Mem& m, const TcW& wp, const int* I, float* sm,
                        Ck&, int) {
    (void)sm;
    const int in1 = I[1], K1 = I[2], w1 = I[3], in2 = I[4], K2 = I[5],
              w2 = I[6], N = I[7], bias = I[8], act = I[9], out = I[10];
    DF_PHASE(
        for (int idx = tid; idx < TC_ROWS * N; idx += nt) {
            const int r = idx / N, c = idx - r * N;
            float acc = bias >= 0 ? m.P[bias + c] : 0.f;
            acc = tc_dot(m.S + in1 + r * K1, 1, wp.big + w1 + c,
                         wp.small + w1 + c, N, K1, acc);
            if (K2 > 0)
                acc = tc_dot(m.S + in2 + r * K2, 1, wp.big + w2 + c,
                             wp.small + w2 + c, N, K2, acc);
            m.S[out + idx] = act_fn(act, acc);
        }
    )
}

template <class Ck>
DF_FN void tc_dense_pullback(const Mem& m, const TcW& wp, const int* I,
                             float* sm, Ck&, int) {
    (void)sm;
    const int src = I[1], K = I[2], w = I[3], N = I[4], dl = I[5],
              dout = I[7], acc_flag = I[8], dact = I[9];
    DF_PHASE(
        for (int idx = tid; idx < TC_ROWS * K; idx += nt) {
            const int r = idx / K, k = idx - r * K;
            float v = tc_dot(m.S + dl + r * N, 1, wp.big + w + k * N,
                             wp.small + w + k * N, 1, N, 0.f);
            float* o = m.S + dout + idx;
            if (acc_flag) v += *o;
            *o = v * dact_fn(dact, m.S[src + idx]);
        }
    )
}

template <class Ck>
DF_FN void tc_wgrad(const float* ws, long long tstride, const int* I, int m0,
                    int n0, int t0, int t1, float* g_row, float* sm, Ck&,
                    int) {
    (void)sm;
    const int src = I[1], K = I[2], w = I[3], N = I[4], dl = I[5],
              bias = I[6];
    const int mk = m0 + TC_ITEM < K ? m0 + TC_ITEM : K;
    const int nk = n0 + TC_ITEM < N ? n0 + TC_ITEM : N;
    const int cols = nk - n0;
    DF_PHASE(
        for (int idx = tid; idx < (mk - m0) * cols; idx += nt) {
            const int r = m0 + idx / cols, c = n0 + idx % cols;
            float acc = 0.f;
            for (int tile = t0; tile < t1; ++tile) {
                const float* base = ws + (long long)tile * tstride;
                float db[TC_ROWS], ds[TC_ROWS];
                for (int q = 0; q < TC_ROWS; ++q)
                    tc_split(base[dl + q * N + c], db[q], ds[q]);
                for (int q0 = 0; q0 < TC_ROWS; q0 += 16)
                    acc += tc_dot16(base + src + r, K, db, ds, 1, q0,
                                    q0 + 16);
            }
            g_row[w + r * N + c] = acc;
        }
        if (bias >= 0 && m0 == 0)
            for (int c = n0 + tid; c < nk; c += nt) {
                float s = 0.f;
                for (int tile = t0; tile < t1; ++tile) {
                    const float* d = ws + (long long)tile * tstride + dl;
                    for (int q = 0; q < TC_ROWS; ++q) s += d[q * N + c];
                }
                g_row[bias + c] = s;
            }
    )
}

#endif  // DF_HOST_EMULATION

// ---- the workspace -----------------------------------------------------------

// The workspace: the tiles' floats, each tile's rounded up to 16 bytes
// (tc_tile_stride), then the tiles' losses, then the weights' two planes
DF_FN long long tc_tile_stride(const int* hdr) { return align4(hdr[H_TOTAL]); }

DF_FN float* tc_big_plane(float* ws, const int* hdr, int n_tiles) {
    return ws + n_tiles * tc_tile_stride(hdr) + align4(n_tiles);
}

DF_FN TcW tc_planes(float* ws, const int* hdr, int n_tiles) {
    const float* big = tc_big_plane(ws, hdr, n_tiles);
    return TcW{big, big + align4(hdr[H_NP])};
}

// parameter i into the weights' planes
DF_FN void tc_plane_entry(float* ws, const int* hdr, int n_tiles,
                          const float* p, int i) {
    float* big = tc_big_plane(ws, hdr, n_tiles);
    tc_split(p[i], big[i], big[align4(hdr[H_NP]) + i]);
}

}  // namespace
