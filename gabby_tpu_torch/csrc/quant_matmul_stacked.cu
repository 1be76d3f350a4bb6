// The stacked int4 matmul for decode-sized M (1..64), Hopper (sm_90a), and
// its raw-byte-dot form.
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
//
// What bounds it on the H100: bytes. One Llama-3.2-1B decode step (wqkv,
// wo, w_gup, w_down x 16 layers, M = 8) reads 486 MB of packed codes:
// 0.149 ms at 3.35 TB/s, 0.6-5 us a call. At M = 8 its 15.5 GFLOP would
// take 0.23 ms on the CUDA cores in f32 (the earlier kernel's route) and
// 16 us on the tensor cores; at M = 64 (the verify step, the 64-token
// prefill bucket) 124 GFLOP, 0.126 ms on the tensor cores. Most calls are
// as short as a launch's ramp, so one launch a call and a short prologue
// count as much as the mainloop.
//
// Design (K2's machine, quant_matmul_unembed.cu, with K split inside the
// launch):
//   * The product is transposed, out^T = W^T x^T: a consumer warpgroup owns
//     64 of a strip's 128 channels and unpacks their codes from shared
//     memory (ldmatrix.x4.trans, 0x4300 | u - 136) straight into wgmma's
//     register A operand; the tokens are B: m64n8k16 for M <= 8 (two
//     blocks a multiprocessor), m64n64k16 for 9 <= M <= 64 (one). Tokens
//     past M are zero-filled by TMA and never stored. The scale is applied
//     once, in the epilogue. A producer warp's one thread issues the
//     copies.
//   * N = 2048..28672 gives 16-224 strips of 128 channels, too few for
//     132 SMs, so a strip's K/2 / 64 stages are split over a cluster of
//     `split` blocks (1, 2, 4 or 8; the wrapper's stacked_plan picks the
//     most that keeps the grid within one wave, up to 8 at M <= 8 and 4
//     above, where a [64, 128] partial makes the reduction dearer than an
//     idle multiprocessor). Rank r streams stages r * steps ..
//     (r + 1) * steps - 1 through its own ring of TMA copies (x's two
//     64-column halves out of L2, 64 packed rows x 128 channels of codes;
//     the layer is the weight map's third coordinate). With programmatic
//     dependent launch the first ring's weight copies are issued before
//     griddepcontrol.wait, overlapping the tail of the kernel before;
//     x's copies and the stores wait for it. Rank q owns
//     channels q * 128 / split .. of the strip: after the mainloop every
//     rank pushes its f32 partial of them into slot r of q's inbox in
//     shared memory (mapa + st.shared::cluster) and arrives on q's inbox
//     mbarrier (release at cluster scope); q waits for all 256 arrivals,
//     adds the slots in rank order, scales and stores. One cluster barrier,
//     arrived at the start and waited before the first push, makes sure
//     every inbox barrier is set; no block waits on another after that.
//     No workspace, no atomics, no memset, no finalize pass: one launch a
//     call, and each output is summed in one fixed order, so a repeat
//     gives the same bits.
//   * K33 (template flag kRaw): each stage has a third x tile; once a
//     stage lands, the consumers turn x_even into xc in place and write
//     xo16 beside it (fence.proxy.async, then a barrier of the 256
//     consumer threads, before the wgmma reads them), and the lo codes are
//     multiplied by both.
//   * The weight's tensor map covers the whole stack and is encoded once
//     by gabby_int4_stacked_map (the wrapper keeps it per tensor); a call
//     encodes x's map only.
// A build flag of tools/bench_stacked.py --probe (K1_PROBE, 0 in the
// library) removes parts of the consumers to split the kernel's time.

#include <string.h>

#include "cluster.cuh"
#include "int4_wgmma.cuh"
#include "smem_leave.cuh"

namespace {

constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kBN = 128;                   // output channels per strip
constexpr int kBKP = 64;                   // packed rows per stage (K 128)
constexpr int kStages = 6;
constexpr int kMaxSplit = 8;  // blocks a cluster: the portable limit

// 1: the consumers release every stage unread (the copies alone, no
// epilogue); 2: no unpack (the products of stale fragments); 3: no
// cross-block reduction (every rank stores its own partial); none of these
// computes the product. 4: the whole kernel, launched without
// programmatic dependent launch.
#ifndef K1_PROBE
#define K1_PROBE 0
#endif
constexpr bool kReduce = K1_PROBE == 0 || K1_PROBE == 2 || K1_PROBE == 4;
constexpr bool kPdl = K1_PROBE != 4;

// Two blocks a multiprocessor at M <= 8, one above: 96 and 168 registers
// a thread (nine warps a block share four sub-partitions' register files
// unevenly). (A producer warpgroup handing its registers to the consumers
// through setmaxnreg, as K2 does, left the n8 form at 80: ptxas spilled and
// serialized the wgmma.)
template <int BT>
__host__ __device__ constexpr int blocks_per_sm() {
  return BT == 8 ? 2 : 1;
}

// Independent accumulators a stage's products rotate over, summed in a
// fixed order at the end: at n64 lo and hi apart (chains of four wgmma a
// stage in place of eight); at n8 one, since a second spills at the 96
// registers a thread that two blocks of 288 threads a multiprocessor get
// (and ptxas then serializes the wgmma).
template <int BT>
__host__ __device__ constexpr int accumulators() {
  return BT == 8 ? 1 : 2;
}

// A stage: x's lo and hi tiles (K33: xc in the lo tile, then x_odd, then
// xo16), then the codes. Every tile is a multiple of 1024 bytes, so each
// keeps the 128-byte swizzle's alignment.
template <int BT, bool kRaw>
__host__ __device__ constexpr int x_bytes() {
  return (kRaw ? 3 : 2) * BT * 128;
}
template <int BT, bool kRaw>
__host__ __device__ constexpr int stage_bytes() {
  return x_bytes<BT, kRaw>() + kBKP * kBN;
}
// The ring, its 2 kStages mbarriers and the inbox's, then the inbox:
// [split ranks][BT tokens][128 / split channels] f32, the partials the
// cluster's blocks push for this block's channels.
template <int BT, bool kRaw>
__host__ __device__ constexpr int inbox_offset() {
  return kStages * stage_bytes<BT, kRaw>() + (2 * kStages + 2) * 8;
}
template <int BT, bool kRaw>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)inbox_offset<BT, kRaw>() + BT * kBN * 4;
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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void st_cluster_f2(uint32_t addr, float x,
                                              float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(x), "f"(y)
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

// xmap: int4_x_map of x with boxes of BT tokens; wmap: int4_stack_map of
// the whole stack. scale: the layer's [N] f32; out [M, N] bf16. The grid
// is (split, N / 128) in clusters of (split, 1, 1): blockIdx.x is the
// block's rank in its cluster, blockIdx.y its strip; each rank takes
// `steps` stages of 64 packed rows.
template <int BT, bool kRaw>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<BT>())
int4_stacked_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ out, int M, int N, int layer,
                    int steps, int split) {
  constexpr int kS = kStages;
  constexpr int kStage = stage_bytes<BT, kRaw>();
  constexpr int kX = x_bytes<BT, kRaw>();
  constexpr uint32_t kTx = 2 * BT * 128 + kBKP * kBN;  // bytes TMA lands
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + kS * kStage;  // kS barriers each
  const uint32_t empty = full + kS * 8;
  const uint32_t inbox_full = empty + kS * 8;
  const uint32_t inbox = base + inbox_offset<BT, kRaw>();
  const int tid = threadIdx.x;
  const int rank = blockIdx.x, strip = blockIdx.y;
  const bool reduce = kReduce && split > 1;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    // every consumer thread of the cluster whose channels are ours
    // arrives once: 2 * (128 / split) threads a rank, 256 in all
    mbar_init(inbox_full, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the inbox barriers of the cluster are set before a push reaches one:
  // arrive here, wait before the first push
  if (reduce) cluster_arrive();
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
        tma_3d(st, xmap, r0, 0, 0, bar);
        tma_3d(st + BT * 128, xmap, r0, 1, 0, bar);
      }
    }
    if (reduce) cluster_wait();
    return;
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row g, column pair t
  const int chunk = 4 * wg + warp;  // the warp's 16 channels of the 128
  const int cl = 64 * wg + 16 * warp + 2 * g;  // channels cl, cl + 1
  // acc[4j + e]: channel cl + e / 2, token 8j + 2t + e % 2; the sum of
  // the kA accumulators sums[] of the mainloop
  constexpr int kA = accumulators<BT>();
  float sums[kA][BT / 2], acc[BT / 2];
#pragma unroll
  for (int q = 0; q < BT / 2; ++q) {
    acc[q] = 0.f;
#pragma unroll
    for (int u = 0; u < kA; ++u) sums[u][q] = 0.f;
  }

  if constexpr (K1_PROBE == 1) {
    for (int i = 0; i < steps; ++i) {
      mbar_wait(full + 8 * (i % kS), (i / kS) & 1);
      if (lane == 0) mbar_arrive(empty + 8 * (i % kS));
    }
    return;
  }
  uint32_t a[2][2][4][4];  // [buffer][half][k16 step][4], two stages' worth
  mbar_wait(full, 0);
  if constexpr (kRaw) {
    raw_stage<BT>(smem, tid);
    consumers_sync();
  }
  unpack_stage_ldm(smem + kX, chunk, lane, a[0]);
  // Step i: issue stage i's products from the fragments unpacked in step
  // i - 1; while they run, wait for stage i + 1 and unpack it into the
  // other fragment buffer (K33: and stage its x); then wait for the
  // products and hand the stage back to the producer. Two steps an
  // iteration, so each buffer is a fixed set of registers.
  for (int i0 = 0; i0 < steps; i0 += 2) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int i = i0 + b;
      if (i >= steps) break;
      const int s = i % kS;
      const uint32_t xs = base + s * kStage;
#pragma unroll
      for (int u = 0; u < kA; ++u) fence_operands(sums[u]);
      wgmma_fence();
      // lo and hi of k16 step k into accumulators (2k) % kA, (2k + 1) % kA
      // (K33: the lo codes against xo16 into the hi's)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float(&lo)[BT / 2] = sums[(2 * k) % kA];
        float(&hi)[BT / 2] = sums[(2 * k + 1) % kA];
        wgmma_tile<BT>(lo, a[b][0][k], sw128_desc(xs + k * 32));
        if constexpr (kRaw)
          wgmma_tile<BT>(hi, a[b][0][k],
                         sw128_desc(xs + 2 * BT * 128 + k * 32));
        wgmma_tile<BT>(hi, a[b][1][k], sw128_desc(xs + BT * 128 + k * 32));
      }
      wgmma_commit();
      if (i + 1 < steps) {
        const int s1 = (i + 1) % kS;
        mbar_wait(full + 8 * s1, ((i + 1) / kS) & 1);
        if constexpr (kRaw) raw_stage<BT>(smem + s1 * kStage, tid);
        if constexpr (K1_PROBE != 2)
          unpack_stage_ldm(smem + s1 * kStage + kX, chunk, lane, a[b ^ 1]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < kA; ++u) fence_operands(sums[u]);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if constexpr (kRaw)
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
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)tok * N + n) =
            __floats2bfloat162_rn(acc[4 * j] * sc.x, acc[4 * j + 2] * sc.y);
      if (tok + 1 < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(tok + 1) * N + n) =
            __floats2bfloat162_rn(acc[4 * j + 1] * sc.x,
                                  acc[4 * j + 3] * sc.y);
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
  cluster_wait();  // every block's inbox barrier is set
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    const int tok = 8 * j + 2 * t;
    if (tok < M)
      st_cluster_f2(slot + tok * per * 4, acc[4 * j], acc[4 * j + 2]);
    if (tok + 1 < M)
      st_cluster_f2(slot + (tok + 1) * per * 4, acc[4 * j + 1],
                    acc[4 * j + 3]);
  }
  arrive_remote(cluster_addr(inbox_full, owner));
  // then add the ranks' shares of our channels in rank order
  mbar_wait_cluster(inbox_full, 0);
  const float* box = reinterpret_cast<const float*>(
      smem + inbox_offset<BT, kRaw>());
  const int pairs = per / 2, mt = M < BT ? M : BT;
  for (int e = tid; e < mt * pairs; e += kConsumers) {
    const int tok = e / pairs, c = 2 * (e % pairs);
    float2 v = *reinterpret_cast<const float2*>(box + tok * per + c);
    for (int q = 1; q < split; ++q) {
      const float2 w = *reinterpret_cast<const float2*>(
          box + (q * BT + tok) * per + c);
      v.x += w.x;
      v.y += w.y;
    }
    const int n = strip * kBN + rank * per + c;
    const float2 sc = *reinterpret_cast<const float2*>(scale + n);
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)tok * N + n) =
        __floats2bfloat162_rn(v.x * sc.x, v.y * sc.y);
  }
}

template <int BT, bool kRaw>
int launch(const void* x, const void* wmap_bytes, const void* scale,
           void* out, int M, int K, int N, int layer, int split,
           cudaStream_t stream) {
  auto kernel = int4_stacked_kernel<BT, kRaw>;
  static gabby_smem::SmemLeave leave;
  cudaError_t err = leave.raise(kernel, (int)smem_bytes<BT, kRaw>());
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap, wmap;
  err = int4_x_map(x, M, K, BT, &xmap);
  if (err != cudaSuccess) return (int)err;
  memcpy(&wmap, wmap_bytes, sizeof(wmap));
  const float* s = static_cast<const float*>(scale);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  int steps = K / 2 / kBKP / split;
  void* args[] = {&xmap, &wmap, &s, &o, &M, &N, &layer, &steps, &split};
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
  cfg.dynamicSmemBytes = smem_bytes<BT, kRaw>();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = kPdl ? 2 : 1;
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel),
                            args);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool kRaw>
int entry(const void* x, const void* wmap, const void* scale, void* out,
          int M, int K, int N, int layer, int bt, int split, void* stream) {
  const bool split_ok =
      (split == 1 || split == 2 || split == 4 || split == kMaxSplit) &&
      (K / 2 / kBKP) % split == 0;
  if (M < 1 || M > bt || (bt != 8 && bt != 64) || K < 2 * kBKP ||
      K % (2 * kBKP) || N < kBN || N % kBN || !split_ok || layer < 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 8 ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bt == 8
             ? launch<8, kRaw>(x, wmap, scale, out, M, K, N, layer, split, s)
             : launch<64, kRaw>(x, wmap, scale, out, M, K, N, layer, split,
                                s);
}

}  // namespace

extern "C" {

// The tensor map of a packed stack [L, K/2, N] int8 (16-byte aligned, K a
// multiple of 128, N of 128), 128 bytes written to `map`: encoded once per
// stack and passed to every call on it.
int gabby_int4_stacked_map(const void* packed, int L, int K, int N,
                           void* map) {
  if (L < 1 || K < 2 * kBKP || K % (2 * kBKP) || N < kBN || N % kBN ||
      reinterpret_cast<uintptr_t>(packed) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  const cudaError_t err = int4_stack_map(packed, L, K, N, &m);
  if (err != cudaSuccess) return (int)err;
  memcpy(map, &m, sizeof(m));
  return 0;
}

// K1. x [M, K] bf16, 1 <= M <= bt; map: gabby_int4_stacked_map of the
// stack; scale: the layer's [N] f32 (the caller offsets the pointer); out
// [M, N] bf16; bt (8 or 64) the token tile, split the blocks a strip's K
// is split over (1, 2, 4 or 8, dividing K / 128): the wrapper's
// stacked_plan.
int gabby_int4_matmul(const void* x, const void* map, const void* scale,
                      void* out, int M, int K, int N, int layer, int bt,
                      int split, void* stream) {
  return entry<false>(x, map, scale, out, M, K, N, layer, bt, split, stream);
}

// K33, the raw-byte-dot form: the arguments of gabby_int4_matmul.
int gabby_int4_matmul_rawdot(const void* x, const void* map,
                             const void* scale, void* out, int M, int K,
                             int N, int layer, int bt, int split,
                             void* stream) {
  return entry<true>(x, map, scale, out, M, K, N, layer, bt, split, stream);
}

}  // extern "C"
