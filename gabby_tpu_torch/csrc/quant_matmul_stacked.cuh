// The stacked-weight matmuls for decode-sized M (1..64), Hopper (sm_90a):
// one kernel template, four forms, instantiated by
//   quant_matmul_stacked.cu      K1 and K33 (and the stacks' tensor maps),
//   quant_matmul_int8_stacked.cu K5,
//   quant_matmul_w4a8.cu         K8.
//
// Replaces the Pallas TPU kernels of gabby_tpu/ops/pallas/quant_matmul.py
//   K1  _qmatmul_int4_stacked -> _int4_stacked_kernel: x [M, K] bf16 @
//       int4 W[layer], W stacked [L, K/2, N] half-split packed (byte (r, n)
//       holds W[r, n] + 8 in its low nibble and W[r + K/2, n] in its signed
//       high nibble), per-channel scales [L, N] f32: the f32 sum of bf16 x
//       times exact integer codes, the scale applied once per channel ->
//       [M, N] bf16;
//   K33 the same call's raw-byte-dot body, _int4_stacked_rawdot_kernel
//       (GABBY_INT4_RAWDOT=1): xo16 . b + xc . lo8 - 8 (rowsum(xc) +
//       rowsum(xo16)) with xo16 = x_odd / 16 (exact), xc = bf16(x_even -
//       xo16) rounded once, b the packed byte read as a signed value and
//       lo8 = b & 15. Since b = 16 hi + lo8, that sum is, term by term,
//         x_odd . hi + (xc + xo16) . (lo8 - 8),
//       every product exact in f32: K1's two code planes, with the lo
//       plane contracted against xc and against xo16. So K33 is K1 with
//       another x staging and one more product a stage.
//   K5  _qmatmul_int8_stacked -> _int8_stacked_kernel: x [M, K] bf16 @
//       int8 W[layer], W stacked [L, K, N] one code a byte: the f32 sum of
//       bf16 x times the exact codes, the per-channel scale once.
//   K8  _qmatmul_int4_w4a8_stacked -> _int4_w4a8_stacked_kernel: x
//       quantized per row (xs = max(absmax / 127, 1e-8), codes
//       clip(round_half_even(x / xs), +-127)), then K1's packed codes times
//       x's codes in int32, out = bf16((f32(acc) * xs) * scale).
//
// What bounds them on the H100: bytes. One Llama-3.2-1B decode step (wqkv,
// wo, w_gup, w_down x 16 layers, M = 8) reads 486 MB of packed int4 codes
// (0.149 ms at 3.35 TB/s; K1, K33, K8) or 973 MB of int8 codes (0.294 ms;
// K5), 0.6-10 us a call. At M = 8 the tensor cores need 16 us (bf16) for
// its 15.5 GFLOP; at M = 64 (the verify step, the 64-token prefill
// bucket) 124 GFLOP, 0.126 ms. Most calls are as short as a launch's
// ramp, so one launch a call and a short prologue count as much as the
// mainloop.
//
// Design (K2's machine, quant_matmul_unembed.cu, with K split inside the
// launch):
//   * The product is transposed, out^T = W^T x^T: a consumer warpgroup owns
//     64 of a strip's 128 channels and unpacks their codes from shared
//     memory (ldmatrix.x4.trans, then per form) straight into wgmma's
//     register A operand; the tokens are B: m64n8 for M <= 8 (two blocks a
//     multiprocessor), m64n64 for 9 <= M <= 64 (one). Tokens past M are
//     zero-filled by TMA and never stored. The scale is applied once, in
//     the epilogue. A producer warp's one thread issues the copies.
//   * N = 2048..28672 gives 16-224 strips of 128 channels, too few for
//     132 SMs, so a strip's stages of 64 weight rows are split over a
//     cluster of `split` blocks (1, 2, 4 or 8; the wrapper's stacked_plan
//     picks the most that keeps the grid within one wave, up to 8 at M <= 8
//     and 4 above, where a [64, 128] partial makes the reduction dearer
//     than an idle multiprocessor). Rank r streams stages r * steps ..
//     (r + 1) * steps - 1 through its own ring of TMA copies (x's tiles
//     out of L2, 64 weight rows x 128 channels of bytes; the layer is the
//     weight map's third coordinate). With programmatic dependent launch
//     the first ring's weight copies are issued before griddepcontrol.wait,
//     overlapping the tail of the kernel before; x's copies and reads and
//     the stores wait for it. Rank q owns channels q * 128 / split .. of
//     the strip: after the mainloop every rank pushes its partial of them
//     into slot r of q's inbox in shared memory (mapa + st.shared::cluster)
//     and arrives on q's inbox mbarrier (release at cluster scope); q waits
//     for all 256 arrivals, adds the slots in rank order, scales and
//     stores. One cluster barrier, arrived at the start and waited before
//     the first push, makes sure every inbox barrier is set; no block
//     waits on another after that. No workspace, no atomics, no memset, no
//     finalize pass: one launch a call, and each output is summed in one
//     fixed order, so a repeat gives the same bits.
//   * K1 (Form::kInt4): a stage is 64 packed rows (K 128) and x's two
//     64-column halves; the nibbles become bf16 through 0x4300 | u - 136
//     (exact), m64nNk16 bf16 products, f32 sums.
//   * K33 (Form::kRaw): a third x tile; once a stage lands, the consumers
//     turn x_even into xc in place and write xo16 beside it
//     (fence.proxy.async, then a barrier of the 256 consumer threads,
//     before the wgmma reads them), and the lo codes are multiplied by
//     both.
//   * K5 (Form::kInt8): a stage is 64 K rows of int8 codes (the same 8 KB
//     and layout as K1's) and one x tile. The codes become bf16 exactly
//     through f32 (c + 128 as the low byte of 2^23, less 2^23 + 128; the
//     f32's high half is the bf16), one plane: about the instructions a
//     byte of splitting c = 16 hs + lo into two nibble planes on K1's
//     0x4300 | u path, and half the products (measured faster at M = 64,
//     PERF.md). m64nNk16 bf16 products, f32 sums.
//   * K8 (Form::kW4A8): x is quantized inside the launch. Each rank takes
//     the absolute maxima of the M rows over its own columns (plain loads
//     after griddepcontrol.wait), pushes them to the cluster's other ranks
//     (st.async, completing each receiver's mbarrier), and every rank
//     folds all ranks' maxima into the rows' scales, with the reference's
//     correctly rounded absmax / 127. Once a stage's bf16 x tiles land,
//     the consumers write x's codes (the correctly rounded x / xs, through
//     the reciprocal and one exact remainder correction, rounded half to
//     even) into a third tile, K-major as the int8 wgmma reads it
//     (fence.proxy.async and the consumers' barrier, as K33). The products
//     are wgmma m64nNk32 s8 x s8 -> s32 with the weight from registers:
//     the nibbles become int8 lanes holding 16 w (((b ^ 8) << 4) & 0xF0
//     for the low one, b & 0xF0 for the high), so no rowsum correction is
//     carried, and the int32 sums are shifted right by 4 once, exactly.
//     The fragment wants four K-consecutive codes of a channel in a
//     register; ldmatrix.x4.trans gives a thread rows {2t, 2t + 1, 2t + 8,
//     2t + 9} of each 16, so one byte permute makes a register, and the x
//     codes are laid out in that order of K (unpack_stage_s8,
//     quant_stage). The ranks push int32 partials; integer sums are exact
//     in any order, and the owner computes (f32(acc) * xs) * scale in the
//     reference's order: the plain version's bits.
//   * The weight's tensor map covers the whole stack and is encoded once
//     by gabby_int4_stacked_map (the wrapper keeps it per tensor); a call
//     encodes x's map only.
// A build flag of tools/bench_stacked.py --probe (K1_PROBE, 0 in the
// library) removes parts of the consumers to split the kernel's time.

#pragma once

#include <string.h>

#include <type_traits>

#include "cluster.cuh"
#include "int4_wgmma.cuh"
#include "smem_leave.cuh"

namespace {

// What a stage holds and how it is multiplied
enum class Form {
  kInt4,  // K1: packed int4 codes, bf16 products
  kRaw,   // K33: K1's bytes, raw-byte-dot x staging
  kInt8,  // K5: int8 codes, bf16 products
  kW4A8,  // K8: packed int4 codes, int8 x codes, s8 products
};

constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kBN = 128;                   // output channels per strip
constexpr int kBKP = 64;  // weight rows per stage (int4: K 128; int8: K 64)
constexpr int kMaxSplit = 8;  // blocks a cluster: the portable limit

// 1: the consumers release every stage unread (the copies alone, no
// epilogue); 2: no unpack (the products of stale fragments); 3: no
// cross-block reduction (every rank stores its own partial); none of these
// computes the product. 4: the whole kernel, launched without
// programmatic dependent launch. K8 alone: 5: no row maxima and no
// exchange of them (every row's scale 1); 6: no quantization of the
// landed x tiles (the products of stale codes).
#ifndef K1_PROBE
#define K1_PROBE 0
#endif
constexpr bool kReduce = K1_PROBE == 0 || K1_PROBE == 2 || K1_PROBE >= 4;
constexpr bool kPdl = K1_PROBE != 4;
constexpr bool kMaxima = K1_PROBE != 1 && K1_PROBE != 5;
constexpr bool kQuantize = K1_PROBE != 6;

// Two blocks a multiprocessor at M <= 8, one above: 96 and 168 registers
// a thread (nine warps a block share four sub-partitions' register files
// unevenly). (A producer warpgroup handing its registers to the consumers
// through setmaxnreg, as K2 does, left the n8 form at 80: ptxas spilled and
// serialized the wgmma.)
template <int BT>
__host__ __device__ constexpr int blocks_per_sm() {
  return BT == 8 ? 2 : 1;
}

// The most blocks a cluster the plan takes at token tile BT (stacked_plan's
// split_cap): K8 sizes its maxima's inbox by it
template <int BT>
__host__ __device__ constexpr int split_cap() {
  return BT == 8 ? kMaxSplit : kMaxSplit / 2;
}

// Independent accumulators a stage's products rotate over, summed in a
// fixed order at the end: at n64 two (chains of four wgmma a stage in
// place of eight); at n8 one, since a second spills at the 96 registers a
// thread that two blocks of 288 threads a multiprocessor get (and ptxas
// then serializes the wgmma).
template <int BT>
__host__ __device__ constexpr int accumulators() {
  return BT == 8 ? 1 : 2;
}

// A stage: x's tiles, then the weight's 64 rows. K1: x's lo and hi halves;
// K33: xc in the lo tile, then x_odd, then xo16; K5: one tile of 64
// columns; K8: x's lo and hi halves, then their int8 codes (BT rows of
// 128 bytes). Every tile is a multiple of 1024 bytes, so each keeps the
// 128-byte swizzle's alignment.
template <Form F>
__host__ __device__ constexpr int x_tiles() {
  return F == Form::kInt8 ? 1 : F == Form::kInt4 ? 2 : 3;
}
template <int BT, Form F>
__host__ __device__ constexpr int x_bytes() {
  return x_tiles<F>() * BT * 128;
}
template <int BT, Form F>
__host__ __device__ constexpr int stage_bytes() {
  return x_bytes<BT, F>() + kBKP * kBN;
}
// the bytes TMA lands a stage: the weight rows and x's bf16 tiles
template <int BT, Form F>
__host__ __device__ constexpr uint32_t landed_bytes() {
  return (F == Form::kInt8 ? 1 : 2) * BT * 128 + kBKP * kBN;
}
// The ring's depth: six stages; five for K8's n64 form, whose third x tile,
// inbox and maxima do not fit six
template <int BT, Form F>
__host__ __device__ constexpr int stages() {
  return F == Form::kW4A8 && BT == 64 ? 5 : 6;
}
// The ring, its 2 stages() mbarriers, the inbox's and K8's maxima's, then
// the inbox: [split ranks][BT tokens][128 / split channels] of partials
// (f32; K8 int32), the ones the cluster's blocks push for this block's
// channels; then K8's row scales [BT], their reciprocals [BT] and maxima
// [split_cap][BT] f32.
template <int BT, Form F>
__host__ __device__ constexpr int inbox_offset() {
  return stages<BT, F>() * stage_bytes<BT, F>() +
         (2 * stages<BT, F>() + 2) * 8;
}
template <int BT, Form F>
__host__ __device__ constexpr int scales_offset() {
  return inbox_offset<BT, F>() + BT * kBN * 4;
}
template <int BT, Form F>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)scales_offset<BT, F>() +
         (F == Form::kW4A8 ? (2 + split_cap<BT>()) * BT * 4 : 0);
}
static_assert(smem_bytes<64, Form::kRaw>() <= 232448 &&
                  smem_bytes<64, Form::kW4A8>() <= 232448,
              "a block's shared memory");

template <int BT>
__device__ __forceinline__ void wgmma_tile(float (&d)[BT / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (BT == 8)
    wgmma_n8(d, a, desc);
  else
    wgmma_n64(d, a, desc);
}

// wgmma m64nNk32 s8 x s8 -> s32, A (the codes) from registers, B (x's
// codes, K-major) by descriptor: d += A B
template <int BT>
__device__ __forceinline__ void wgmma_tile(int (&d)[BT / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (BT == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void st_cluster2(uint32_t addr, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(x), "f"(y)
               : "memory");
}
__device__ __forceinline__ void st_cluster2(uint32_t addr, int x, int y) {
  asm volatile("st.shared::cluster.v2.s32 [%0], {%1, %2};\n" ::"r"(addr),
               "r"(x), "r"(y)
               : "memory");
}

// An asynchronous store of one f32 into another block's shared memory
// whose bytes count toward that block's mbarrier transaction
__device__ __forceinline__ void st_async(uint32_t addr, float x,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(x)), "r"(bar)
      : "memory");
}

// Arrives on another block's mbarrier, releasing this thread's earlier
// stores to it
__device__ __forceinline__ void arrive_remote(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// Programmatic dependent launch: the grid before this one on the stream
// has finished and its writes are visible (a no-op without one)
__device__ __forceinline__ void wait_prior_grid() {
  if constexpr (kPdl) asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// K33's staging of one landed stage: xc = bf16(x_even - x_odd / 16) over
// x_even, xo16 = x_odd / 16 into the third tile. The tiles share one
// swizzled layout, so the work is elementwise by byte offset; then the
// generic proxy's writes are fenced for the wgmma (async proxy).
template <int BT>
__device__ __forceinline__ void raw_stage(uint8_t* st, int tid) {
  __nv_bfloat162* xe = reinterpret_cast<__nv_bfloat162*>(st);
  const __nv_bfloat162* xo =
      reinterpret_cast<const __nv_bfloat162*>(st + BT * 128);
  __nv_bfloat162* x16 = reinterpret_cast<__nv_bfloat162*>(st + 2 * BT * 128);
#pragma unroll
  for (int w = tid; w < 32 * BT; w += kConsumers) {
    const float2 e = __bfloat1622float2(xe[w]);
    const float2 o = __bfloat1622float2(xo[w]);
    const float ox = o.x * 0.0625f, oy = o.y * 0.0625f;
    xe[w] = __floats2bfloat162_rn(e.x - ox, e.y - oy);
    x16[w] = __floats2bfloat162_rn(ox, oy);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K8's A fragments of one stage of packed codes for the int8 products,
// a[k32 step][4]: steps 0 and 1 the low nibbles of packed rows 0..31 and
// 32..63, steps 2 and 3 their high nibbles, each as an int8 lane holding
// 16 w. unpack_stage_ldm's two ldmatrix.x4.trans loads give a thread, for
// packed rows 32q + 16h + {2t, 2t + 1, 2t + 8, 2t + 9}, the bytes of its
// channels 2g and 2g + 1 (bytes 0-3 of a word: row 2t ch 2g, row 2t ch
// 2g + 1, row 2t + 1 ch 2g, row 2t + 1 ch 2g + 1); one byte permute
// gathers a channel's four, so that position 16h + 4t + i of k32 step q
// (the fragment's rows g and g + 8 are channels 2g and 2g + 1) holds
// packed row 32q + 16h + 2t + {0, 1, 8, 9}[i]. quant_stage lays x's codes
// out in the same order of K.
__device__ __forceinline__ void unpack_stage_s8(const uint8_t* w, int chunk,
                                                int lane,
                                                uint32_t (&a)[4][4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = 32 * q + lane;
    uint32_t m[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(m[0]), "=r"(m[1]), "=r"(m[2]), "=r"(m[3])
        : "r"(smem_addr(w + r * 128 + ((chunk ^ (r & 7)) << 4))));
    // [h = 0: ch 2g, ch 2g + 1; h = 1: ch 2g, ch 2g + 1]
    const uint32_t b[4] = {
        __byte_perm(m[0], m[1], 0x6420), __byte_perm(m[0], m[1], 0x7531),
        __byte_perm(m[2], m[3], 0x6420), __byte_perm(m[2], m[3], 0x7531)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // stored w + 8: flipping bit 3 gives w's 4-bit two's complement
      a[q][i] = ((b[i] ^ 0x08080808u) << 4) & 0xF0F0F0F0u;
      a[q + 2][i] = b[i] & 0xF0F0F0F0u;
    }
  }
}

// x's int8 code as the low byte of the word: the reference's round half to
// even of the correctly rounded quotient x / s, clipped to +-127 (bits:
// the bf16 in the word's high half; rs = __frcp_rn(s)). The quotient is the
// product with the correctly rounded reciprocal corrected once by its
// exact remainder (Markstein: the correctly rounded quotient, s and x / s
// normal; a quotient too small for that rounds to code 0 either way), and
// adding 1.5 2^23 rounds it half to even to an integer whose two's
// complement is the sum's low byte. |x / s| <= 127 (1 + 2^-23), so the clip
// never acts.
__device__ __forceinline__ uint32_t x_code(uint32_t bits, float s,
                                           float rs) {
  const float x = __uint_as_float(bits);
  const float q0 = __fmul_rn(x, rs);
  const float q = __fmaf_rn(__fmaf_rn(-q0, s, x), rs, q0);
  return __float_as_uint(__fadd_rn(q, 12582912.f));
}

// K8's staging of one landed stage: the codes of x's M rows into the third
// tile, K-major, 128 bytes a token: bytes 0..63 the lo half's columns
// (k32 steps 0 and 1), 64..127 the hi half's (steps 2 and 3), each step's
// 32 in unpack_stage_s8's order, so that word u of a step holds the codes
// of columns c, c + 1, c + 8, c + 9, c = 32 (step % 2) + 16 (u / 4) + 2 (u
// % 4). Warp w writes word `lane` of rows w, w + 8, ..: the rows share
// their swizzle (16-byte chunk c of row n at (c ^ (n & 7)) << 4), so a
// thread's three offsets in a row, and its rows' scales, hold for every
// stage (QuantLane). Rows past M are not written (their outputs are never
// stored). The loads go out together, then the codes; then the generic
// proxy's writes are fenced for the wgmma.
template <int BT>
struct QuantLane {
  static constexpr int kRows = BT / (kConsumers / 32);
  int lo, hi, out;            // byte offsets in a row's tiles
  float s[kRows], rs[kRows];  // the rows' scales and their reciprocals

  __device__ __forceinline__ QuantLane(const float* xs, const float* rxs,
                                       int tid) {
    const int warp = tid / 32, w = tid % 32, j = w / 8, u = w % 8;
    const int c = 32 * (j & 1) + 16 * (u >> 2) + 2 * (u & 3);
    const int tile = (j >> 1) * BT * 128, off = (2 * c) & 15;
    lo = tile + (((c >> 3) ^ warp) << 4) + off;
    hi = tile + ((((c >> 3) + 1) ^ warp) << 4) + off;
    out = 2 * BT * 128 + (((w >> 2) ^ warp) << 4) + (w & 3) * 4;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] = xs[warp + 8 * r];
      rs[r] = rxs[warp + 8 * r];
    }
  }
};

// the other forms stage nothing of the kind
struct NoQuantLane {
  __device__ __forceinline__ NoQuantLane(const float*, const float*, int) {}
};

template <int BT>
__device__ __forceinline__ void quant_stage(uint8_t* st,
                                            const QuantLane<BT>& q, int M,
                                            int tid) {
  constexpr int kRows = QuantLane<BT>::kRows;
  const int warp = tid / 32;
  uint32_t p01[kRows], p89[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const uint8_t* row = st + (warp + 8 * r) * 128;
    if (warp + 8 * r < M) {
      p01[r] = *reinterpret_cast<const uint32_t*>(row + q.lo);
      p89[r] = *reinterpret_cast<const uint32_t*>(row + q.hi);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (warp + 8 * r < M) {
      const float s = q.s[r], rs = q.rs[r];
      const uint32_t c0 = x_code(p01[r] << 16, s, rs);
      const uint32_t c1 = x_code(p01[r] & 0xFFFF0000u, s, rs);
      const uint32_t c8 = x_code(p89[r] << 16, s, rs);
      const uint32_t c9 = x_code(p89[r] & 0xFFFF0000u, s, rs);
      *reinterpret_cast<uint32_t*>(st + (warp + 8 * r) * 128 + q.out) =
          __byte_perm(__byte_perm(c0, c1, 0x0040),
                      __byte_perm(c8, c9, 0x0040), 0x5410);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K8's row scales xs[m] = max(absmax / 127, 1e-8) and their correctly
// rounded reciprocals rxs[m] for the BT token rows (rows past M: absmax
// 0). This rank's maxima over its columns of both halves (c0 .. c0 + cols
// - 1 and K/2 + c0 ..; warp w takes rows w, w + 8, .., its lanes 16-byte
// loads of all its rows at once, |x| compared as bf16 bits) go to slot
// `rank` of box; with `exchange`, pushed into the same slot of every other
// rank's box (st.async completing its mbarrier `bar`, which expects (split
// - 1) BT floats) and the cluster's maxima folded. Ends with the
// consumers' barrier.
template <int BT>
__device__ __forceinline__ void row_scales(const __nv_bfloat16* x, int M,
                                           int K, int c0, int cols,
                                           float* xs, float* rxs, float* box,
                                           uint32_t bar, int rank, int split,
                                           bool exchange, int tid) {
  float* mine = box + rank * BT;
  if constexpr (kMaxima) {
    constexpr int kRows = BT / (kConsumers / 32);  // a warp's rows
    constexpr int kDeep = kRows == 1 ? 4 : 2;  // a lane's loads in flight
    const int warp = tid / 32, lane = tid % 32;
    const int vecs = cols / 8;  // 16-byte vectors a half-row
    uint32_t mx[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) mx[r] = 0;
#pragma unroll kDeep
    for (int v = lane; v < 2 * vecs; v += 32) {
      const size_t col = v < vecs ? c0 + 8 * v : K / 2 + c0 + 8 * (v - vecs);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int m = warp + 8 * r;
        if (m < M) {
          const uint4 q =
              *reinterpret_cast<const uint4*>(x + (size_t)m * K + col);
          mx[r] = __vmaxu2(mx[r], __vmaxu2(__vmaxu2(q.x & 0x7FFF7FFFu,
                                                    q.y & 0x7FFF7FFFu),
                                           __vmaxu2(q.z & 0x7FFF7FFFu,
                                                    q.w & 0x7FFF7FFFu)));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint32_t top = __reduce_max_sync(
          0xFFFFFFFFu, max(mx[r] & 0xFFFFu, mx[r] >> 16));
      if (lane == 0) mine[warp + 8 * r] = __uint_as_float(top << 16);
    }
  } else {
    for (int m = tid; m < BT; m += kConsumers) mine[m] = 127.f;
  }
  consumers_sync();  // every row's maximum is in
  if (exchange) {
    cluster_wait();  // every rank's barrier is set
    const uint32_t slot = smem_addr(mine);
    for (int e = tid; e < (split - 1) * BT; e += kConsumers) {
      const int j = e / BT, m = e % BT, to = j < rank ? j : j + 1;
      st_async(cluster_addr(slot + 4 * m, to), mine[m],
               cluster_addr(bar, to));
    }
    mbar_wait_cluster(bar, 0);
  }
  for (int m = tid; m < BT; m += kConsumers) {
    float a = mine[m];
    if (exchange)
      for (int r = 0; r < split; ++r) a = fmaxf(a, box[r * BT + m]);
    xs[m] = fmaxf(__fdiv_rn(a, 127.f), 1e-8f);
    rxs[m] = __frcp_rn(xs[m]);
  }
  consumers_sync();
}

// One finished pair of outputs (channels n, n + 1 of token tok) from its
// sums v0, v1: K1, K33, K5 scale the f32 sums; K8 shifts out the factor 16
// of its int32 sums (exact), stores them to acc_out where given, and
// computes (f32(acc) * xs) * scale, the reference's order.
template <Form F, typename Acc>
__device__ __forceinline__ void finish(__nv_bfloat16* out, int* acc_out,
                                       const float* xs, int tok, int n,
                                       int N, Acc v0, Acc v1, float2 sc) {
  __nv_bfloat162* o =
      reinterpret_cast<__nv_bfloat162*>(out + (size_t)tok * N + n);
  if constexpr (F == Form::kW4A8) {
    const int a0 = v0 >> 4, a1 = v1 >> 4;
    if (acc_out != nullptr)
      *reinterpret_cast<int2*>(acc_out + (size_t)tok * N + n) =
          make_int2(a0, a1);
    const float s = xs[tok];
    *o = __floats2bfloat162_rn(
        __fmul_rn(__fmul_rn(__int2float_rn(a0), s), sc.x),
        __fmul_rn(__fmul_rn(__int2float_rn(a1), s), sc.y));
  } else {
    *o = __floats2bfloat162_rn(v0 * sc.x, v1 * sc.y);
  }
}

// xmap: x's tensor map with boxes of BT tokens (int4_x_map; K5
// x_rows_map); wmap: stack_map of the whole stack. x: the same x (K8 reads
// its rows' maxima). scale: the layer's [N] f32; out [M, N] bf16; acc_out
// (K8, or NULL) [M, N] int32, the accumulator before the scales. The grid
// is (split, N / 128) in clusters of (split, 1, 1): blockIdx.x is the
// block's rank in its cluster, blockIdx.y its strip; each rank takes
// `steps` stages of 64 weight rows.
template <int BT, Form F>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<BT>())
stacked_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ out, int* __restrict__ acc_out,
               int M, int K, int N, int layer, int steps, int split) {
  constexpr bool kW4A8 = F == Form::kW4A8;
  // x staged by the consumers once a stage lands
  constexpr bool kStaged = F == Form::kRaw || kW4A8;
  using Acc = std::conditional_t<kW4A8, int, float>;
  using Acc2 = std::conditional_t<kW4A8, int2, float2>;
  // a stage's A fragments: K1, K33 [half][k16 step][4]; K5 [k16 step][4];
  // K8 [k32 step][4]
  using Frags = std::conditional_t<kW4A8 || F == Form::kInt8,
                                   uint32_t[4][4], uint32_t[2][4][4]>;
  constexpr int kS = stages<BT, F>();
  constexpr int kStage = stage_bytes<BT, F>();
  constexpr int kX = x_bytes<BT, F>();
  constexpr uint32_t kTx = landed_bytes<BT, F>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + kS * kStage;  // kS barriers each
  const uint32_t empty = full + kS * 8;
  const uint32_t inbox_full = empty + kS * 8;
  const uint32_t maxima_full = inbox_full + 8;  // K8
  const uint32_t inbox = base + inbox_offset<BT, F>();
  float* xs = reinterpret_cast<float*>(smem + scales_offset<BT, F>());
  const int tid = threadIdx.x;
  const int rank = blockIdx.x, strip = blockIdx.y;
  const bool reduce = kReduce && split > 1;
  const bool exchange = kW4A8 && kMaxima && split > 1;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    // every consumer thread of the cluster whose channels are ours
    // arrives once: 2 * (128 / split) threads a rank, 256 in all
    mbar_init(inbox_full, kConsumers);
    if (exchange) {  // one arrival (this one) and the others' maxima
      mbar_init(maxima_full, 1);
      mbar_expect_tx(maxima_full, (split - 1) * BT * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the cluster's barriers are set before a push reaches one: arrive
  // here, wait before the first push
  if (reduce || exchange) cluster_arrive();
  // the next kernel on the stream may start its prologue (and its weight
  // copies) as this grid's blocks leave
  if constexpr (kPdl)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (tid >= kConsumers) {  // the producer: one thread issues every copy
    if (tid == kConsumers) {
      // the first ring's worth of weight copies needs nothing of the grid
      // before this one; x (that grid's output, perhaps) waits for it
      const int pre = steps < kS ? steps : kS;
      for (int i = 0; i < pre; ++i) {
        mbar_expect_tx(full + 8 * i, kTx);
        tma_3d(base + i * kStage + kX, wmap, strip * kBN,
               (rank * steps + i) * kBKP, layer, full + 8 * i);
      }
      wait_prior_grid();
      for (int i = 0; i < steps; ++i) {
        const int s = i % kS;
        const uint32_t st = base + s * kStage, bar = full + 8 * s;
        const int r0 = (rank * steps + i) * kBKP;
        if (i >= kS) {
          mbar_wait(empty + 8 * s, (i / kS - 1) & 1);
          mbar_expect_tx(bar, kTx);
          tma_3d(st + kX, wmap, strip * kBN, r0, layer, bar);
        }
        if constexpr (F == Form::kInt8) {
          tma_2d(st, xmap, r0, 0, bar);
        } else {
          tma_3d(st, xmap, r0, 0, 0, bar);
          tma_3d(st + BT * 128, xmap, r0, 1, 0, bar);
        }
      }
    }
    if (reduce || exchange) cluster_wait();
    return;
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row g, column pair t
  const int chunk = 4 * wg + warp;  // the warp's 16 channels of the 128
  const int cl = 64 * wg + 16 * warp + 2 * g;  // channels cl, cl + 1
  // acc[4j + e]: channel cl + e / 2, token 8j + 2t + e % 2; the sum of
  // the kA accumulators sums[] of the mainloop
  constexpr int kA = accumulators<BT>();
  Acc sums[kA][BT / 2], acc[BT / 2];
#pragma unroll
  for (int q = 0; q < BT / 2; ++q) {
    acc[q] = 0;
#pragma unroll
    for (int u = 0; u < kA; ++u) sums[u][q] = 0;
  }

  if constexpr (K1_PROBE == 1) {
    for (int i = 0; i < steps; ++i) {
      mbar_wait(full + 8 * (i % kS), (i / kS) & 1);
      if (lane == 0) mbar_arrive(empty + 8 * (i % kS));
    }
    return;
  }
  if constexpr (kW4A8) {
    wait_prior_grid();  // x may be the grid before's output
    row_scales<BT>(x, M, K, rank * steps * kBKP, steps * kBKP, xs, xs + BT,
                   xs + 2 * BT, maxima_full, rank, split, exchange, tid);
  }
  // the stage's x staging, for the forms that stage it
  const std::conditional_t<kW4A8, QuantLane<BT>, NoQuantLane> qlane(
      xs, xs + BT, tid);
  auto stage_x = [&](uint8_t* st) {
    if constexpr (F == Form::kRaw) raw_stage<BT>(st, tid);
    if constexpr (kW4A8 && kQuantize) quant_stage<BT>(st, qlane, M, tid);
  };
  auto unpack = [&](const uint8_t* w, Frags& a) {
    if constexpr (kW4A8)
      unpack_stage_s8(w, chunk, lane, a);
    else if constexpr (F == Form::kInt8)
      unpack_stage_codes8(w, chunk, lane, a);
    else
      unpack_stage_ldm(w, chunk, lane, a);
  };
  Frags a[2];  // two stages' worth
  mbar_wait(full, 0);
  if constexpr (kStaged) {
    stage_x(smem);
    consumers_sync();
  }
  unpack(smem + kX, a[0]);
  // Step i: issue stage i's products from the fragments unpacked in step
  // i - 1; while they run, wait for stage i + 1 and unpack it into the
  // other fragment buffer (K33, K8: and stage its x); then wait for the
  // products and hand the stage back to the producer. Two steps an
  // iteration, so each buffer is a fixed set of registers.
  for (int i0 = 0; i0 < steps; i0 += 2) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int i = i0 + b;
      if (i >= steps) break;
      const int s = i % kS;
      const uint32_t xa = base + s * kStage;
#pragma unroll
      for (int u = 0; u < kA; ++u) fence_operands(sums[u]);
      wgmma_fence();
      if constexpr (kW4A8) {
        // k32 step j against x's codes, into accumulator j % kA
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_tile<BT>(sums[j % kA], a[b][j],
                         sw128_desc(xa + 2 * BT * 128 + j * 32));
      } else if constexpr (F == Form::kInt8) {
        // k16 step k of the codes against x's tile, into accumulator k % kA
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_tile<BT>(sums[k % kA], a[b][k], sw128_desc(xa + k * 32));
      } else {
        // lo and hi of k16 step k into accumulators (2k) % kA, (2k + 1) %
        // kA (K33: the lo codes against xo16 into the hi's)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float(&lo)[BT / 2] = sums[(2 * k) % kA];
          float(&hi)[BT / 2] = sums[(2 * k + 1) % kA];
          wgmma_tile<BT>(lo, a[b][0][k], sw128_desc(xa + k * 32));
          if constexpr (F == Form::kRaw)
            wgmma_tile<BT>(hi, a[b][0][k],
                           sw128_desc(xa + 2 * BT * 128 + k * 32));
          wgmma_tile<BT>(hi, a[b][1][k], sw128_desc(xa + BT * 128 + k * 32));
        }
      }
      wgmma_commit();
      if (i + 1 < steps) {
        const int s1 = (i + 1) % kS;
        mbar_wait(full + 8 * s1, ((i + 1) / kS) & 1);
        if constexpr (kStaged) stage_x(smem + s1 * kStage);
        if constexpr (K1_PROBE != 2) unpack(smem + s1 * kStage + kX, a[b ^ 1]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < kA; ++u) fence_operands(sums[u]);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if constexpr (kStaged)
        if (i + 1 < steps) consumers_sync();  // stage i + 1's x is staged
    }
  }

#pragma unroll
  for (int q = 0; q < BT / 2; ++q)
#pragma unroll
    for (int u = 0; u < kA; ++u) acc[q] += sums[u][q];
  wait_prior_grid();  // before the first global write
  if (!reduce) {  // the whole sum is here: scale and store
    const int n = strip * kBN + cl;
    const float2 sc = *reinterpret_cast<const float2*>(scale + n);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const int tok = 8 * j + 2 * t;
      if (tok < M)
        finish<F>(out, acc_out, xs, tok, n, N, acc[4 * j], acc[4 * j + 2],
                  sc);
      if (tok + 1 < M)
        finish<F>(out, acc_out, xs, tok + 1, n, N, acc[4 * j + 1],
                  acc[4 * j + 3], sc);
    }
    return;
  }

  // Push this block's [BT, 128] partial to the channels' owners: rank q
  // finishes channels q * per .. (q + 1) * per - 1, and slot r of its inbox
  // holds rank r's share of them. A thread's two channels have one owner.
  const int per = kBN / split;
  const int owner = cl / per;
  const uint32_t slot = cluster_addr(
      inbox + (uint32_t)(rank * BT * per + cl - owner * per) * 4, owner);
  if (!exchange) cluster_wait();  // every block's inbox barrier is set
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    const int tok = 8 * j + 2 * t;
    if (tok < M) st_cluster2(slot + tok * per * 4, acc[4 * j], acc[4 * j + 2]);
    if (tok + 1 < M)
      st_cluster2(slot + (tok + 1) * per * 4, acc[4 * j + 1], acc[4 * j + 3]);
  }
  arrive_remote(cluster_addr(inbox_full, owner));
  // then add the ranks' shares of our channels in rank order
  mbar_wait_cluster(inbox_full, 0);
  const Acc* box = reinterpret_cast<const Acc*>(smem + inbox_offset<BT, F>());
  const int pairs = per / 2, mt = M < BT ? M : BT;
  for (int e = tid; e < mt * pairs; e += kConsumers) {
    const int tok = e / pairs, c = 2 * (e % pairs);
    Acc2 v = *reinterpret_cast<const Acc2*>(box + tok * per + c);
    for (int q = 1; q < split; ++q) {
      const Acc2 w = *reinterpret_cast<const Acc2*>(
          box + (q * BT + tok) * per + c);
      v.x += w.x;
      v.y += w.y;
    }
    const int n = strip * kBN + rank * per + c;
    const float2 sc = *reinterpret_cast<const float2*>(scale + n);
    finish<F>(out, acc_out, xs, tok, n, N, v.x, v.y, sc);
  }
}

template <int BT, Form F>
int launch(const void* x, const void* wmap_bytes, const void* scale,
           void* out, void* acc, int M, int K, int N, int layer, int split,
           cudaStream_t stream) {
  auto kernel = stacked_kernel<BT, F>;
  static gabby_smem::SmemLeave leave;
  cudaError_t err = leave.raise(kernel, (int)smem_bytes<BT, F>());
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap, wmap;
  err = F == Form::kInt8 ? x_rows_map(x, M, K, BT, &xmap)
                         : int4_x_map(x, M, K, BT, &xmap);
  if (err != cudaSuccess) return (int)err;
  memcpy(&wmap, wmap_bytes, sizeof(wmap));
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const float* s = static_cast<const float*>(scale);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  int* a = static_cast<int*>(acc);
  int steps = K / (F == Form::kInt8 ? 1 : 2) / kBKP / split;
  void* args[] = {&xmap, &wmap, &xp, &s,     &o,     &a,
                  &M,    &K,    &N,  &layer, &steps, &split};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, N / kBN, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<BT, F>();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = kPdl ? 2 : 1;
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel),
                            args);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// One call of form F: x [M, K] bf16, 1 <= M <= bt; wmap: the stack's map
// (gabby_int4_stacked_map); scale: the layer's [N] f32 (the caller offsets
// the pointer); out [M, N] bf16; acc (K8, or NULL) [M, N] int32; bt (8 or
// 64) the token tile, split the blocks a strip's weight rows are split
// over (1, 2, 4 or 8, dividing rows / 64; K8 at most split_cap): the
// wrapper's stacked_plan. The weight plane has K/2 rows (K1, K33, K8) or
// K (K5), a multiple of 64; N a multiple of 128.
template <Form F>
int entry(const void* x, const void* wmap, const void* scale, void* out,
          void* acc, int M, int K, int N, int layer, int bt, int split,
          void* stream) {
  const int per_byte = F == Form::kInt8 ? 1 : 2;  // K rows a weight row
  const int rows = K / per_byte;
  const int cap = F != Form::kW4A8 ? kMaxSplit
                  : bt == 8        ? split_cap<8>()
                                   : split_cap<64>();
  const bool split_ok =
      (split == 1 || split == 2 || split == 4 || split == kMaxSplit) &&
      split <= cap && rows >= kBKP && (rows / kBKP) % split == 0;
  if (M < 1 || M > bt || (bt != 8 && bt != 64) || K % (per_byte * kBKP) ||
      N < kBN || N % kBN || !split_ok || layer < 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 8 ||
      reinterpret_cast<uintptr_t>(out) % 4 ||
      reinterpret_cast<uintptr_t>(acc) % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bt == 8 ? launch<8, F>(x, wmap, scale, out, acc, M, K, N, layer,
                                split, s)
                 : launch<64, F>(x, wmap, scale, out, acc, M, K, N, layer,
                                 split, s);
}

}  // namespace
