// Single-slot flash prefill attention over a bf16 KV cache, Hopper (sm_90a):
// K22 over the unpaired cache and K23 over the paired one, head_dim 64 or
// 128, any group size up to 128.
//
// Replaces gabby_tpu/ops/pallas/prefill_attention.py:_prefill_call (its
// _kernel body, reached from prefill_attention) in its k_scale=None form,
// unpaired and pair=True: the T queries of one slot's prompt chunk (global
// positions offset..offset+T-1) attend that slot's cache rows j < offset of
// one layer, and then the chunk's own k/v causally (query t sees chunk keys
// t' <= t). Both products take bf16 operands with f32 sums; the scores take
// sm_scale, and p is rounded to bf16 before the value product (its sum is
// not). The paired cache holds kv heads 2p and 2p + 1 side by side in one
// line of 2H elements; the fresh block arrives head-major in both layouts.
//
// What bounds it on the H100: operations. At T = 512, offset = 512, 32
// query heads and head_dim 64 a layer does 2 * 2 * 32 * 512 * 64 *
// (512 + 256.5) ~ 3.2 GFLOP of score and value products for ~2.1 MB of
// cache, queries and output; against 989 TFLOP/s of bf16 tensor-core rate
// that is ~3.3 us.
//
// Design: every operand is bf16 as it lies in device memory, so tiles go
// by TMA straight into the 128-byte-swizzled layout that wgmma reads, and
// the products run on warpgroup MMA.
//   * One block per (tile of P = 128 / G chunk positions, kv head, part of
//     the key range). Its rows are the P positions' G query heads, row
//     p * G + g: one TMA box {64 dims, G heads, 1, P positions} of q
//     (two at H = 128, one per 64 dims) lays them out as 128-byte rows,
//     zero past T. Two consumer warpgroups own 64 rows each; a producer
//     warpgroup gives its registers to them by setmaxnreg (40 against 232
//     a thread) and one of its threads issues every copy. 384 threads, one
//     block a multiprocessor. At G = 4, 8 kv heads and T = 512: 16 x 8 =
//     128 blocks on 132 multiprocessors; at G = 3 (Llama-3.2-3B's heads)
//     13 x 8 = 104.
//   * Keys stream in tiles of 64 through a ring of stages (four at H = 64,
//     three at H = 128) with full and empty mbarriers: the cache rows
//     j < offset, then the fresh rows up to the block's last position (the
//     causal skip). The cache's tensor map has `offset` rows, so TMA fills
//     rows at and past offset with zeros: stale or NaN rows there never
//     reach a product. The paired form's map spans the 2H-element lines
//     and its boxes start at column (head & 1) * H: it reads one head's
//     half in place, no staging, and the rest is the unpaired form's, so
//     K23 gives K22's bits. At H = 128 a 256-byte row is two boxes.
//   * Scores: H / 16 wgmma m64n64k16 a tile per warpgroup, Q and K both
//     from shared memory (K-major). The online softmax runs in registers
//     in base 2 (sm_scale * log2 e folded into the scores); a row lives in
//     the four lanes of a quad. The masks (j < offset on the last past
//     tile; j <= position, position = first + row / G, on fresh tiles
//     that reach past the block's first position) are skipped elsewhere.
//   * Values: p in bf16 registers is the A operand as it stands (the
//     accumulator layout of the scores is wgmma's A register layout), V
//     the B operand from shared memory, MN-major (keys are its K
//     dimension): 4 * H / 64 wgmma m64n64k16 a tile. The stage goes back
//     to the producer once they are done. No block barrier in the loop:
//     the two warpgroups run apart and share the tensor cores.
//   * A short chunk over a long past would leave most multiprocessors idle
//     (16 blocks at T = 64), so its key tiles are split into n_split parts
//     (min(8, SMs / blocks, tiles / 2); gabby_prefill_attention_bf16_splits)
//     whose unnormalized outputs, maxima and sums a second kernel merges in
//     part order: deterministic, no atomics.
//   * The five tensor maps (q, the layer's and slot's K and V rows, the
//     fresh K and V) are encoded on the host for every call and passed as
//     __grid_constant__ parameters.
// Registers (ptxas -v, sm_90a): 168 a thread at H = 64 and at H = 128 (the
// launch bound of 384 threads; setmaxnreg then moves them to the
// consumers), 0 bytes spilled; the merge 32.
// Times (NVIDIA H100 80GB HBM3, 700.00 W, replayed from a CUDA graph;
// tools/bench_prefill_attention.py --roots with an older checkout, whose
// K22/K23 were prefill_attention.cu's mma.sync body over bf16 rows, in the
// same call, and chip_smoke.py):
// 16 launches at T = 512, offset 512 take 0.345-0.355 ms (the mma.sync
// body 0.513-0.519, SDPA 0.468-0.479, bound 0.052); 28 at Llama-3.2-3B's
// heads 0.788-0.796 (1.219-1.241, SDPA 1.053-1.073, bound 0.137); T = 64
// over 1024 rows, 8 parts, 0.192-0.207 (0.202-0.211). The host takes
// 27-57 us to issue a call, five tensor-map encodes among it.
// What is left: ~6.6x the bound. Each warpgroup's walk is a chain (scores,
// wait, softmax, value product, wait) that two warpgroups a
// multiprocessor only partly overlap, and the causal skip leaves the
// chunk's first blocks 9 tiles against its last blocks' 16. A variant that
// issued tile k + 1's scores before tile k's value product (overlapping
// the exponentials with the tensor cores inside a warpgroup) was slower
// on the card and spilled at H = 128; it was not kept.

#include "int4_wgmma.cuh"
#include "smem_leave.cuh"

#include <algorithm>

namespace {

constexpr int kKeys = 64;             // keys a tile
constexpr int kRows = 128;            // query rows a block (at most)
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kBox = 64 * 128;        // a box of 64 rows of 128 bytes
constexpr float kNegInf = -1e30f;

template <int H>
struct Dims {
  static constexpr int kHalves = H / 64;           // 128-byte boxes a row
  static constexpr int kTile = kHalves * kBox;     // a K or V tile
  static constexpr int kQ = kHalves * kRows * 128;  // the query tile
  static constexpr int kStages = H == 64 ? 4 : 3;
  static constexpr int kPart = H + 4;  // floats a row of a part's result
  static constexpr int kBarriers = 1 + 2 * kStages;
  static constexpr size_t kSmem =
      1024 + kQ + (size_t)kStages * 2 * kTile + 8 * kBarriers;
};

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap& map,
                                       int c0, int c1, int c2, int c3,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Descriptor of an MN-major operand (V: 128-byte rows are keys, the K
// dimension; the 64 elements of a row run along N) under 128-byte
// swizzle: 8-key groups 1024 bytes apart. One 64-wide atom along N is all
// an m64n64 product reads, so the leading offset (atom to atom along N)
// is never used; it is given the same 1024.
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d = A B (+ d when acc), m64n64k16, A and B from shared memory, both
// K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A B, m64n64k16, A from registers, B from shared memory MN-major
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// qmap: q [T, Nk, G, H] (4-D, boxes {64, G, 1, P}); kmap, vmap: the
// layer's and slot's cache [Nk >> pair, offset rows, H << pair] (boxes
// {64, 64, 1}); fkmap, fvmap: the fresh block [Nk, T, H] (the same boxes).
// All 128-byte swizzled, zero past their edges.
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
prefill_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap fkmap,
                    const __grid_constant__ CUtensorMap fvmap,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part, int T, int Nq, int Nk,
                    int offset, int pair, int P, float scale_log2) {
  using D = Dims<H>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t qs = smem_addr(smem);  // the query tile, kHalves boxes
  const uint32_t ring = qs + D::kQ;     // stage s: K at s * 2 kTile, then V
  const uint32_t qbar = ring + D::kStages * 2 * D::kTile;
  const uint32_t full = qbar + 8, empty = full + 8 * D::kStages;
  const int tid = threadIdx.x;
  const int G = Nq / Nk, rows = G * P;
  const int kh = blockIdx.y, p0 = blockIdx.x * P;

  // the block's key tiles: past ones, then fresh ones up to its last
  // position; part z of n_split walks tiles [lo, hi)
  const int t_last = min(T - 1, p0 + P - 1);
  const int n_past = (offset + kKeys - 1) / kKeys;
  const int n_tiles = n_past + t_last / kKeys + 1;
  const int z = blockIdx.z, n_split = gridDim.z;
  const int lo = z * n_tiles / n_split, hi = (z + 1) * n_tiles / n_split;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < D::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      mbar_expect_tx(qbar, D::kHalves * rows * 128);
      for (int hf = 0; hf < D::kHalves; ++hf)
        tma_4d(qs + hf * kRows * 128, qmap, 64 * hf, 0, kh, p0, qbar);
      const int col = pair ? (kh & 1) * H : 0, head = kh >> pair;
      for (int i = lo; i < hi; ++i) {
        const int k = i - lo, s = k % D::kStages;
        if (k >= D::kStages)
          mbar_wait(empty + 8 * s, (k / D::kStages - 1) & 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t kst = ring + s * 2 * D::kTile, vst = kst + D::kTile;
        mbar_expect_tx(bar, 2 * D::kTile);
        if (i < n_past) {
          for (int hf = 0; hf < D::kHalves; ++hf) {
            tma_3d(kst + hf * kBox, kmap, col + 64 * hf, i * kKeys, head, bar);
            tma_3d(vst + hf * kBox, vmap, col + 64 * hf, i * kKeys, head, bar);
          }
        } else {
          const int j0 = (i - n_past) * kKeys;
          for (int hf = 0; hf < D::kHalves; ++hf) {
            tma_3d(kst + hf * kBox, fkmap, 64 * hf, j0, kh, bar);
            tma_3d(vst + hf * kBox, fvmap, 64 * hf, j0, kh, bar);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the thread's rows r and r + 8 of the block and their chunk positions
  const int r0 = 64 * wg + 16 * warp + g;
  const int pos[2] = {p0 + r0 / G, p0 + (r0 + 8) / G};

  float o[D::kHalves][32];  // o[hf][4j + e]: row r0 + 8 (e / 2), dim
#pragma unroll              // 64 hf + 8j + 2t + e % 2
  for (int hf = 0; hf < D::kHalves; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hf][i] = 0.f;
  float sc[32];  // the scores, the same layout over the tile's 64 keys
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);  // also when the part is empty: no copy outlives it
  const uint32_t qw = qs + wg * 64 * 128;  // the warpgroup's 64 rows
  for (int i = lo; i < hi; ++i) {
    const int k = i - lo, s = k % D::kStages;
    const uint32_t kst = ring + s * 2 * D::kTile, vst = kst + D::kTile;
    mbar_wait(full + 8 * s, (k / D::kStages) & 1);

    fence_operands(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk)
      wgmma_ss(sc, sw128_desc(qw + (kk / 4) * kRows * 128 + (kk % 4) * 32),
               sw128_desc(kst + (kk / 4) * kBox + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // scale (base 2) and mask; element 4j + e: row r0 + 8 (e / 2), key
    // j0 + 8j + 2t + e % 2
    const bool past = i < n_past;
    const int j0 = (past ? i : i - n_past) * kKeys;
    if (past ? j0 + kKeys > offset : j0 + kKeys - 1 > p0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = j0 + 8 * (e / 4) + 2 * t + (e & 1);
        const int limit = past ? offset - 1 : pos[(e >> 1) & 1];
        sc[e] = j <= limit ? sc[e] * scale_log2 : kNegInf;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= scale_log2;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 32; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // p (summed unrounded), in bf16 as the value product's A fragments:
    // keys 16 kk .. 16 kk + 15 are elements 8 kk .. 8 kk + 7
    uint32_t pa[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = (e >> 1) & 1;
      const float a = sc[e] > 0.5f * kNegInf ? exp2f(sc[e] - m[r]) : 0.f;
      const float b =
          sc[e + 1] > 0.5f * kNegInf ? exp2f(sc[e + 1] - m[r]) : 0.f;
      l[r] += a + b;
      pa[e / 8][(e % 8) / 2] = pack_bf16(a, b);
    }
#pragma unroll
    for (int hf = 0; hf < D::kHalves; ++hf)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[hf][e] *= alpha[(e >> 1) & 1];

#pragma unroll
    for (int hf = 0; hf < D::kHalves; ++hf) fence_operands(o[hf]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hf = 0; hf < D::kHalves; ++hf)
        wgmma_rs_mn(o[hf], pa[kk],
                    sw128_mn_desc(vst + hf * kBox + kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hf = 0; hf < D::kHalves; ++hf) fence_operands(o[hf]);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row >= rows || pos[r] >= T) continue;
    const int gq = row % G;
    if (n_split > 1) {  // the part's share, for the merge
      float* dst = part + ((size_t)(z * Nk + kh) * T * G +
                           (size_t)pos[r] * G + gq) * D::kPart;
#pragma unroll
      for (int hf = 0; hf < D::kHalves; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(dst + 64 * hf + 8 * j + 2 * t) =
              make_float2(o[hf][4 * j + 2 * r], o[hf][4 * j + 2 * r + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(dst + H) = make_float2(m[r], l[r]);
      continue;
    }
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst =
        out + ((size_t)pos[r] * Nq + kh * G + gq) * H + 2 * t;
#pragma unroll
    for (int hf = 0; hf < D::kHalves; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * hf + 8 * j) =
            __floats2bfloat162_rn(o[hf][4 * j + 2 * r] * inv,
                                  o[hf][4 * j + 2 * r + 1] * inv);
  }
}

// Merges the n_split parts of each query row in part order
// (deterministic): one warp a (row, kv head), H / 32 dims a lane. The
// parts' maxima are in base 2.
template <int H>
__global__ void __launch_bounds__(128)
prefill_bf16_merge(const float* __restrict__ part,
                   __nv_bfloat16* __restrict__ out, int rows, int Nq, int Nk,
                   int n_split) {
  constexpr int kD = H / 32, kPart = Dims<H>::kPart;
  const int w = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w >= rows * Nk) return;
  const int kh = w / rows, flat = w % rows, G = Nq / Nk;
  const float* p = part + ((size_t)kh * rows + flat) * kPart;
  const size_t zs = (size_t)Nk * rows * kPart;  // one part to the next
  float mx = kNegInf;
  for (int z = 0; z < n_split; ++z) mx = fmaxf(mx, p[z * zs + H]);
  float l = 0.f, o[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) o[d] = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float* pz = p + z * zs;
    const float e = exp2f(pz[H] - mx);
    l += pz[H + 1] * e;
#pragma unroll
    for (int d = 0; d < kD; ++d) o[d] += pz[kD * lane + d] * e;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
      out + ((size_t)(flat / G) * Nq + kh * G + flat % G) * H + kD * lane);
#pragma unroll
  for (int d = 0; d < kD; d += 2)
    dst[d / 2] = __floats2bfloat162_rn(o[d] * inv, o[d + 1] * inv);
}

// A bf16 tensor map with 128-byte swizzle, zero past its edges: `rank`
// dims (innermost first), strides in bytes of dims 1.., the box.
cudaError_t bf16_map(CUtensorMap* map, const void* base, int rank,
                     const cuuint64_t* dim, const cuuint64_t* stride,
                     const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), dim, stride, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// query positions a block: its rows are P positions' G heads
int positions_a_block(int G) { return kRows / G; }

template <int H>
int run(const void* q, const void* k, const void* v, const void* fresh_k,
        const void* fresh_v, void* out, void* part, int T, int Nq, int Nk,
        int S, int offset, int pair, int n_split, float sm_scale,
        cudaStream_t st) {
  static gabby_smem::SmemLeave leave;
  constexpr int bytes = (int)Dims<H>::kSmem;
  cudaError_t err = leave.raise(prefill_bf16_kernel<H>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int G = Nq / Nk, P = positions_a_block(G);
  const cuuint64_t e = 2;  // bytes an element
  CUtensorMap qmap, kmap, vmap, fkmap, fvmap;
  {
    const cuuint64_t dim[4] = {(cuuint64_t)H, (cuuint64_t)G, (cuuint64_t)Nk,
                               (cuuint64_t)T};
    const cuuint64_t stride[3] = {H * e, (cuuint64_t)G * H * e,
                                  (cuuint64_t)Nq * H * e};
    const cuuint32_t box[4] = {64, (cuuint32_t)G, 1, (cuuint32_t)P};
    if ((err = bf16_map(&qmap, q, 4, dim, stride, box)) != cudaSuccess)
      return (int)err;
  }
  {
    const cuuint64_t lanes = (cuuint64_t)H << pair;
    // rows at and past offset lie outside the map: TMA gives zeros
    const cuuint64_t dim[3] = {lanes, (cuuint64_t)std::max(offset, 1),
                               (cuuint64_t)(Nk >> pair)};
    const cuuint64_t stride[2] = {lanes * e, (cuuint64_t)S * lanes * e};
    const cuuint32_t box[3] = {64, kKeys, 1};
    if ((err = bf16_map(&kmap, k, 3, dim, stride, box)) != cudaSuccess ||
        (err = bf16_map(&vmap, v, 3, dim, stride, box)) != cudaSuccess)
      return (int)err;
  }
  {
    const cuuint64_t dim[3] = {(cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)Nk};
    const cuuint64_t stride[2] = {H * e, (cuuint64_t)T * H * e};
    const cuuint32_t box[3] = {64, kKeys, 1};
    if ((err = bf16_map(&fkmap, fresh_k, 3, dim, stride, box)) !=
            cudaSuccess ||
        (err = bf16_map(&fvmap, fresh_v, 3, dim, stride, box)) != cudaSuccess)
      return (int)err;
  }
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  dim3 grid((T + P - 1) / P, Nk, n_split);
  prefill_bf16_kernel<H><<<grid, kThreads, bytes, st>>>(
      qmap, kmap, vmap, fkmap, fvmap, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), T, Nq, Nk, offset, pair, P, scale_log2);
  if (n_split > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int rows = T * G;
    prefill_bf16_merge<H><<<(rows * Nk + 3) / 4, 128, 0, st>>>(
        static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out),
        rows, Nq, Nk, n_split);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// How many parts the key range of one call is split into: enough blocks
// for one a multiprocessor, each part at least two key tiles, at most 8.
int gabby_prefill_attention_bf16_splits(int T, int Nq, int Nk, int offset) {
  int dev = 0, sms = 0;
  if (T < 1 || Nk < 1 || Nq % Nk || Nq / Nk > kRows ||
      multiprocessors(&dev, &sms) != cudaSuccess)
    return 1;
  const int P = positions_a_block(Nq / Nk);
  const int blocks = (T + P - 1) / P * Nk;
  const int tiles = (offset + kKeys - 1) / kKeys + (T + kKeys - 1) / kKeys;
  return std::max(1, std::min({8, sms / blocks, tiles / 2}));
}

// q [T, Nq, H] bf16 (H 64 or 128, Nq / Nk at most 128); k/v [Nk, S, H]
// bf16 (pair = 1: [Nk/2, S, 2H]) of one (layer, slot) cache row (the
// caller offsets the pointers; 16-byte aligned); fresh_k/v [Nk, T, H]
// bf16; out [T, Nq, H] bf16. Reads cache rows j < offset. With n_split > 1
// (gabby_prefill_attention_bf16_splits) `part` holds n_split * T * Nq *
// (H + 4) floats of partial results.
int gabby_prefill_attention_bf16(const void* q, const void* k, const void* v,
                                 const void* fresh_k, const void* fresh_v,
                                 void* out, void* part, int T, int Nq, int Nk,
                                 int S, int H, int offset, int pair,
                                 int n_split, float sm_scale, void* stream) {
  if (T < 1 || Nk < 1 || Nq % Nk != 0 || Nq / Nk > kRows || offset < 0 ||
      offset > S || (pair != 0 && pair != 1) || (pair && Nk % 2) ||
      n_split < 1 || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 64)
    return run<64>(q, k, v, fresh_k, fresh_v, out, part, T, Nq, Nk, S, offset,
                   pair, n_split, sm_scale, st);
  if (H == 128)
    return run<128>(q, k, v, fresh_k, fresh_v, out, part, T, Nq, Nk, S,
                    offset, pair, n_split, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
