// The unembed for decode-sized M (1..64), Hopper (sm_90a): one persistent
// TMA + wgmma kernel in two forms, instantiated by
//   quant_matmul_unembed.cu       K2, int4 codes with group scales;
//   quant_matmul_int8_unembed.cu  K6, int8 codes with per-channel scales.
//
// K2 (kInt8 = false): x [M, K] bf16 @ half-split packed int4 W [K/2, N]
// with scales [K/group, N] along K: the f32 product of bf16 x with exact
// integer codes for each scale group, each group's partial multiplied once
// by its group's scale, the groups summed -> [M, N] bf16. The lo nibble
// plane (packed row r <-> x[:, r]) holds groups 0 .. gh - 1, the hi plane
// (<-> x[:, r + K/2]) groups gh .. 2 gh - 1. The +8 bias is taken out of
// every code as it is unpacked (lo - 8, exact in bf16, as K7 does), where
// the reference subtracts a rank-1 correction of the row sums: the same sum
// of exact terms.
// K6 (kInt8 = true): x [M, K] bf16 @ int8 W [K, N] with scales [N]: the f32
// product of bf16 x with the codes, times the channel's scale once.
//
// What bounds it on the H100: bytes. Llama-3.2-1B's int4 unembed, [2048,
// 129024] at group 256, moves 132.1 MB of packed codes + 4.1 MB of scales
// + 2.1 MB of output: 0.041 ms at 3.35 TB/s; its int8 unembed, [2048,
// 128256], 262.7 MB + 0.5 MB + 2.1 MB: 0.079 ms. The 4.2 GFLOP of either
// at M = 8 take 4 us on the tensor cores but about 63 us on the CUDA cores
// in f32, and the unpack of every code must stay off the copy's path.
//
// Design (the machine of K7, quant_matmul_prefill.cu, with four changes):
//   * The product is transposed, out^T = W^T x^T: a consumer warpgroup owns
//     64 output channels and unpacks their codes from shared memory
//     straight into wgmma's register A operand; the tokens are B, read
//     from shared memory: wgmma m64n8k16 for M <= 8, m64n64k16 for
//     9 <= M <= 64 (the speculative verify's unembed). Tokens past M are
//     zero-filled by TMA and never stored, so the weight is read once per
//     call for any M.
//   * The unpack reads through ldmatrix (two .x4.trans loads a stage a
//     thread, in place of K7's sixteen 16-bit loads and their __byte_perm
//     pairing): the transposed 8x8 b16 tiles hand each thread its two
//     channels' bytes of two adjacent rows in one register. int4 codes
//     become bf16 by 0x4300 | u - 136, exact for both nibbles; int8 codes
//     through f32 (codes_bf16x2, K5's conversion, exact).
//   * Scales in the epilogue of each group: a stage's products run into two
//     accumulators (K2: its lo and hi nibble planes; K6: its even and odd
//     k16 steps, two chains in flight), which at the group's last stage are
//     folded into the running f32 total with the group's two scales (loaded
//     at the group's first stage) and cleared. K2's stage of 64 packed rows
//     lies inside one group when group % 64 == 0; the launch takes only
//     such groups (256 in every preset). K6 has one group, the whole of K,
//     whose two scales are the channel's: total = lo s + hi s once a strip.
//   * A persistent grid walking the 128-channel strips blockIdx.x,
//     blockIdx.x + gridDim.x, ... in order: two blocks a multiprocessor at
//     M <= 8, one at M > 8. A block's producer thread keeps a ring of 6
//     stages of TMA copies running across strip boundaries: K2's stage is
//     x's two 64-column halves (2 KB at M <= 8, 16 KB at M = 64, out of L2)
//     and 64 packed rows x 128 channels (8 KB of codes, 128 K columns);
//     K6's one 64-column x tile and 64 int8 rows x 128 channels (8 KB, 64
//     K columns). A strip's epilogue (bf16 stores of its totals) overlaps
//     the next strip's copies. K6's last strip may pass N (N a multiple of
//     16, the TMA row stride): TMA zero-fills its channels past N, which
//     are not stored.
// One launch a call, no workspace, no atomics: each output is summed in one
// fixed order, so a repeat gives the same bits.
//
// What holds K2 back (NVIDIA H100 80GB HBM3, 700 W, graph-replayed, the 1B
// unembed at M = 8; tools/bench_unembed.py --probe builds with parts
// removed): the copies alone (consumers releasing each stage unread) take
// 0.045 ms, 1.1x the bound; with the products but no unpack 0.053-0.058;
// the whole kernel 0.067, where the first form with 16-bit loads and one
// block a multiprocessor took 0.094. What is left is the unpack's integer
// work (about seven logic ops and four bf16 FMAs per register of four
// codes).

#pragma once

#include <type_traits>

#include "int4_wgmma.cuh"
#include "smem_leave.cuh"

// A build flag of tools/bench_unembed.py --probe, 0 in the library: 1 makes
// the consumers release every stage unread (the copies alone), 2 drops the
// unpack (the products of stale fragments). Neither computes the product.
#ifndef UNEMBED_PROBE
#define UNEMBED_PROBE 0
#endif

namespace {

constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kBN = 128;                    // output channels per strip
constexpr int kBKP = 64;                    // weight rows per stage
constexpr int kStages = 6;

// Two blocks a multiprocessor at M <= 8, one at M > 8. The launch gives a
// thread 65536 / (blocks x 384) registers, 80 or 168; setmaxnreg then
// moves the producer warpgroup's to the consumers: 32 against 104 a thread
// at M <= 8 (ptxas spills and serializes the wgmma at 80), 40 against 232
// at M > 8.
template <int BT>
__host__ __device__ constexpr int blocks_per_sm() {
  return BT == 8 ? 2 : 1;
}
template <int BT>
__host__ __device__ constexpr int producer_regs() {
  return BT == 8 ? 32 : 40;
}
template <int BT>
__host__ __device__ constexpr int consumer_regs() {
  return BT == 8 ? 104 : 232;
}

// x tiles of a stage (BT rows x 64 columns each): K2 the two halves', K6 one
template <bool kInt8>
__host__ __device__ constexpr int x_tiles() {
  return kInt8 ? 1 : 2;
}

template <int BT, bool kInt8>
__host__ __device__ constexpr int stage_bytes() {  // x tiles, then codes
  return x_tiles<kInt8>() * BT * 128 + kBKP * kBN;
}

template <int BT, bool kInt8>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)kStages * stage_bytes<BT, kInt8>() +
         2 * kStages * sizeof(uint64_t);
}

template <int BT>
__device__ __forceinline__ void wgmma_tile(float (&d)[BT / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (BT == 8)
    wgmma_n8(d, a, desc);
  else
    wgmma_n64(d, a, desc);
}

// xmap: int4_x_map (K2) or x_rows_map (K6) of x, wmap: plane_map of the
// weight plane, both with boxes of BT tokens. scale: K2 [2 gh, N] f32, K6
// [N] f32; out [M, N] bf16. group: K2's scale group (K6: unused).
template <int BT, bool kInt8>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<BT>())
unembed_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ out, int M, int K, int N,
               int group) {
  constexpr int kS = kStages;
  constexpr int kStage = stage_bytes<BT, kInt8>();
  constexpr int kX = x_tiles<kInt8>() * BT * 128;  // the codes' offset
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + kS * kStage;  // kS barriers each
  const uint32_t empty = full + kS * 8;
  const int tid = threadIdx.x;
  const int n_k = (kInt8 ? K : K / 2) / kBKP;  // stages a strip
  const int strips = (N + kBN - 1) / kBN;
  // this block's strips: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int steps = ((strips - 1 - (int)blockIdx.x) / gridDim.x + 1) * n_k;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        producer_regs<BT>()));
    if (tid == kConsumers) {
      int strip = blockIdx.x, j = 0;
      for (int i = 0; i < steps; ++i) {
        const int s = i % kS;
        if (i >= kS) mbar_wait(empty + 8 * s, (i / kS - 1) & 1);
        const uint32_t st = base + s * kStage, bar = full + 8 * s;
        mbar_expect_tx(bar, kStage);
        if constexpr (kInt8) {
          tma_2d(st, xmap, j * kBKP, 0, bar);
        } else {
          tma_3d(st, xmap, j * kBKP, 0, 0, bar);
          tma_3d(st + BT * 128, xmap, j * kBKP, 1, 0, bar);
        }
        tma_2d(st + kX, wmap, strip * kBN, j * kBKP, bar);
        if (++j == n_k) {
          j = 0;
          strip += gridDim.x;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      consumer_regs<BT>()));
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row g, column pair t
  const int chunk = 4 * wg + warp;  // the warp's 16 channels of the 128
  const int gsteps = kInt8 ? n_k : group / kBKP;  // stages a scale group
  const int gh = kInt8 ? 0 : K / 2 / group;  // scale groups a nibble plane

  // a group's two accumulators (K2: lo and hi planes; K6: even and odd k16
  // steps), and the strip's running total. d[4j + e] holds fragment row g +
  // 8 (e / 2) (channel 2g + e / 2 of the warp's 16), token 8j + 2t + e % 2
  float lo[BT / 2], hi[BT / 2], tot[BT / 2];
#pragma unroll
  for (int q = 0; q < BT / 2; ++q) lo[q] = hi[q] = tot[q] = 0.f;
  // [buffer]: two stages' worth of fragments. K2 [half][k16 step][4], K6
  // [k16 step][4]
  using Frags = std::conditional_t<kInt8, uint32_t[4][4], uint32_t[2][4][4]>;
  Frags a[2];
  auto unpack = [&](const uint8_t* w, Frags& f) {
    if constexpr (kInt8)
      unpack_stage_codes8(w, chunk, lane, f);
    else
      unpack_stage_ldm(w, chunk, lane, f);
  };
  float2 s_lo = make_float2(0.f, 0.f), s_hi = s_lo;

  if constexpr (UNEMBED_PROBE == 1) {
    for (int i = 0; i < steps; ++i) {
      mbar_wait(full + 8 * (i % kS), (i / kS) & 1);
      if (lane == 0) mbar_arrive(empty + 8 * (i % kS));
    }
    return;
  }
  mbar_wait(full, 0);
  unpack(smem + kX, a[0]);
  int strip = blockIdx.x, j = 0;  // the strip and stage of step i
  // Step i: issue stage i's products from the fragments unpacked in step
  // i - 1; while they run, wait for stage i + 1 and unpack it into the
  // other fragment buffer; then wait for the products, hand the stage back
  // to the producer, and fold or store. Two steps an iteration, so each
  // buffer is a fixed set of registers.
  for (int i0 = 0; i0 < steps; i0 += 2) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int i = i0 + b;
      if (i >= steps) break;
      const int s = i % kS;
      const int ch = strip * kBN + 64 * wg + 16 * warp + 2 * g;
      // channels ch, ch + 1 lie in N or past it together (N % 16 == 0)
      const bool in_n = ch < N;
      if (j % gsteps == 0 && in_n) {  // the group's scales, used at its end
        if constexpr (kInt8) {
          s_lo = *reinterpret_cast<const float2*>(scale + ch);
          s_hi = s_lo;
        } else {
          const int grp = j / gsteps;
          s_lo = *reinterpret_cast<const float2*>(scale + (size_t)grp * N +
                                                  ch);
          s_hi = *reinterpret_cast<const float2*>(scale +
                                                  (size_t)(gh + grp) * N + ch);
        }
      }
      const uint32_t xs = base + s * kStage;
      fence_operands(lo);
      fence_operands(hi);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (kInt8) {
          wgmma_tile<BT>(k % 2 ? hi : lo, a[b][k], sw128_desc(xs + k * 32));
        } else {
          wgmma_tile<BT>(lo, a[b][0][k], sw128_desc(xs + k * 32));
          wgmma_tile<BT>(hi, a[b][1][k], sw128_desc(xs + BT * 128 + k * 32));
        }
      }
      wgmma_commit();
      if (i + 1 < steps) {
        const int s1 = (i + 1) % kS;
        mbar_wait(full + 8 * s1, ((i + 1) / kS) & 1);
        if constexpr (UNEMBED_PROBE != 2)
          unpack(smem + s1 * kStage + kX, a[b ^ 1]);
      }
      wgmma_wait<0>();
      fence_operands(lo);
      fence_operands(hi);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if ((j + 1) % gsteps == 0) {  // the group's last stage: fold
#pragma unroll
        for (int q = 0; q < BT / 2; ++q) {
          const bool odd = q & 2;  // channel ch + 1
          tot[q] = fmaf(hi[q], odd ? s_hi.y : s_hi.x,
                        fmaf(lo[q], odd ? s_lo.y : s_lo.x, tot[q]));
          lo[q] = hi[q] = 0.f;
        }
      }
      if (++j == n_k) {  // the strip's last stage: store its totals
#pragma unroll
        for (int jj = 0; jj < BT / 8; ++jj) {
          const int tok = 8 * jj + 2 * t;
          if (tok < M && in_n)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)tok * N + ch) =
                __floats2bfloat162_rn(tot[4 * jj], tot[4 * jj + 2]);
          if (tok + 1 < M && in_n)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(tok + 1) * N +
                                               ch) =
                __floats2bfloat162_rn(tot[4 * jj + 1], tot[4 * jj + 3]);
        }
#pragma unroll
        for (int q = 0; q < BT / 2; ++q) tot[q] = 0.f;
        j = 0;
        strip += gridDim.x;
      }
    }
  }
}

// One launch: the persistent grid of min(strips, blocks_per_sm x the
// multiprocessors) blocks
template <int BT, bool kInt8>
int launch(const void* x, const void* w, const void* scale, void* out, int M,
           int K, int N, int group, cudaStream_t stream) {
  static gabby_smem::SmemLeave leave;
  cudaError_t err =
      leave.raise(unembed_kernel<BT, kInt8>, (int)smem_bytes<BT, kInt8>());
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = multiprocessors(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap, wmap;
  err = kInt8 ? x_rows_map(x, M, K, BT, &xmap)
              : int4_x_map(x, M, K, BT, &xmap);
  if (err != cudaSuccess) return (int)err;
  err = plane_map(w, kInt8 ? K : K / 2, N, &wmap);
  if (err != cudaSuccess) return (int)err;
  const int strips = (N + kBN - 1) / kBN, slots = blocks_per_sm<BT>() * sms;
  unembed_kernel<BT, kInt8>
      <<<strips < slots ? strips : slots, kThreads,
         smem_bytes<BT, kInt8>(), stream>>>(
          xmap, wmap, static_cast<const float*>(scale),
          static_cast<__nv_bfloat16*>(out), M, K, N, group);
  return (int)cudaGetLastError();
}

template <bool kInt8>
int launch_m(const void* x, const void* w, const void* scale, void* out,
             int M, int K, int N, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return M <= 8 ? launch<8, kInt8>(x, w, scale, out, M, K, N, group, s)
                : launch<64, kInt8>(x, w, scale, out, M, K, N, group, s);
}

}  // namespace
