// GQA flash-decode attention over the KV cache at one query position,
// Hopper (sm_90a): every single-position form of the bf16/f32 decode.
//   dense int8 cache: K3 (unpaired), K12 (paired) and the slot-batched
//     launch K16;
//   dense bf16 cache: K24 (unpaired), K25 (paired) and the slot-batched
//     launch K32;
//   paged int8 pool: K10 (unpaired) and K17 (paired);
//   paged bf16 pool: K28 (unpaired) and K29 (paired).
//
// Replaces gabby_tpu/ops/pallas/attention.py:_decode_call (its
// _flash_step body, reached from decode_attention) and _paged_decode_call
// (reached from paged_decode_attention) at tq = 1, unpaired and pair=True,
// with scales and in their k_scale=None form, and _decode_call_multi of the
// same file (the same function, chosen by GABBY_ATTN_MULTI=1): one query
// position of G query heads per kv head attends cache rows j < min(pos[b],
// limit) of one layer, and then the current token's unquantized k/v,
// folded in last as an always-attended extra row. Over the paged pool row
// j of slot b lives at pool[table[b, j / page], layer, kh, j % page]; the
// table is read here, nothing gathers the pool, and entries past a slot's
// rows are never read (the loop ends at the slot's own position). The
// paired layout stores kv heads 2p and 2p + 1 side by side, a line of 2H
// elements, the scales still per head. The multi-position (verify) forms
// are flash_rows.cuh's; the s8 forms attention_s8.cu's.
//
// The arithmetic is the reference's: scores are bf16 q times bf16 k (int8
// codes are exact in bf16) summed in f32 on the tensor cores, times
// k_scale[j] * sm_scale (int8) or sm_scale (bf16); p = exp(s - m) in f32,
// summed unrounded; the value product takes bf16(p * v_scale[j]) (int8) or
// bf16(p) (bf16) against bf16 v, summed in f32; the fresh row in f32. The
// four layouts only change where a row is read, so a form equals its
// unpaired dense form bit for bit on the same rows under the same launch
// plan: K12 = K3, K25 = K24 = K32, K17 = K10, K29 = K28, K10 = K3.
//
// What bounds it on the H100: bytes. A (slot, kv head) streams 2 n H code
// bytes and 2 n 4 scale bytes (int8), or 2 n 2H bytes (bf16), for n live
// rows: at 8 slots x 8 kv heads x 1024 rows that is 8.9 MB a layer at
// H = 64 (2.7 us at 3.35 TB/s), 16.8 MB over a bf16 cache or at H = 128
// (5 us). The products (2 x 2 G H flops a row) are far below the tensor
// cores' rate. A call is as short as a launch's ramp, so one launch a call
// and enough blocks in flight count as much as the body.
//
// Design:
//   * Grid (split, Nk, B): one block of 4 warps per (slot, kv head, rank);
//     the `split` ranks of a (slot, kv head) form a thread-block cluster.
//     split comes from the wrapper's decode_plan (1, 2, 4 or 8, from the
//     read bound `limit` and the card's size alone, so a launch can be
//     captured in a CUDA graph; page * max_pages is the paged read bound).
//     The slot's live rows n = min(pos[b], limit, capacity) are cut on the
//     device into tiles of kTile rows (32; 16 over a bf16 cache at H =
//     128), and the tiles into split * 4 parts as even as can be, part p =
//     rank * 4 + warp taking tiles [p T / P, (p + 1) T / P): a short slot
//     spreads over every warp, and a warp with no tile keeps the empty
//     partial (m = -1e30, l = 0).
//   * Rows: a tile's rows follow one another from its first row's line at
//     a stride of one line (H or 2H elements, 2H or 4H paired), the block's
//     kv head at its half of a paired line. Paged, a page holds a multiple
//     of the tile, so a tile never straddles a page: a warp reads the table
//     entry of its first tile's page, and another only when a tile enters
//     the next page (its tiles are contiguous, so each page's entry once).
//   * Everything that does not depend on the position (q, the fresh k and
//     v) is requested with it, and the fresh row's score is taken in
//     registers, so a block waits on device memory twice: for the position,
//     then for its rows (paged, once more between them: for the page
//     entry). With programmatic dependent launch a block's set-up (its
//     barrier, the cluster's arrival) overlaps the kernel before it, and
//     the next kernel's overlaps this one's tail; every read, the page
//     table's too, waits for the kernel before (griddepcontrol.wait).
//   * A warp's tile: its lanes read the key and value rows straight from
//     device memory into registers as 16-byte vectors, a quad of lanes a
//     row (lane t the chunks t, t + 4, ...: 64 contiguous bytes an
//     instruction), all before the products; the bytes in flight come from
//     the 12-16 warps a multiprocessor holds. Both products run transposed
//     on mma.sync m16n8k16 (bf16 in, f32 sums), so that the 16-row side is
//     never padding: scores with keys as M, the key rows as they were read
//     being A and q the B fragment (queries as N, the head dims permuted
//     alike in q and k); values with head dims as M and queries as N, the
//     value rows turned into A by movmatrix.trans (an 8x8 transpose of bf16
//     pairs across the warp) and the probabilities into B the same way.
//     Int8 codes become bf16 in registers (exact). The online softmax runs
//     per query column in registers (a column's keys lie in 8 lanes: three
//     shuffles). No shared memory stages the cache and no block barrier runs
//     in the loop.
//   * Merge in a fixed order, inside the launch: the 4 warps' partials
//     (m, l, acc[G][H], f32) fold in warp order through shared memory; with
//     split > 1 every other rank writes its block's partial into rank 0's
//     shared memory with st.async, whose bytes complete rank 0's mbarrier
//     (one expect_tx at launch, no remote arrivals); rank 0 folds the ranks
//     in rank order, then the fresh row, and stores bf16. No workspace, no
//     atomics, no second kernel: one launch a call, and a repeat gives the
//     same bits.
//   * The slot-batched launch (K16, K32) is this kernel with the same plan:
//     a block takes one slot (the plan's sb = 1), since a block here is a
//     (slot, kv head, rank) and there is no per-grid-step cost to spread.
//     K16 equals K3 bit for bit by construction. The kernel is written for
//     SB slots a block (SB groups of 4 warps); the library builds SB =
//     DECODE_SLOTS, 1 unless a timing build sets it.
// head_dim H is 64 or 128, G any of 1, 2, 3, 4, 8 (one instantiation
// each, dense and paged, unpaired and paired). A build flag of tools/bench_decode_attention.py
// --probe (DECODE_PROBE, 0 in the library) removes parts of the kernel to
// split its time: 1 the copies alone, 2 the body without the cross-block
// merge, 3 the whole kernel without programmatic dependent launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "smem_leave.cuh"

#ifndef DECODE_PROBE
#define DECODE_PROBE 0
#endif
#ifndef DECODE_SLOTS
#define DECODE_SLOTS 1
#endif

namespace {

// programmatic dependent launch (off in the probe build that times it
// without)
constexpr bool kPdl = DECODE_PROBE != 3;

constexpr int kWarps = 4;                 // warps a slot
constexpr int kSlotThreads = 32 * kWarps;
constexpr int kMaxSplit = 8;              // the portable cluster size
constexpr float kNegInf = -1e30f;

// k16 blocks of rows a warp's tile holds: a tile's key and value vectors
// take 32 registers a lane (64 over a bf16 cache at H = 128, in 16 rows)
template <int H, bool kQuant>
__host__ __device__ constexpr int tile_blocks() {
  return (H == 128 && !kQuant) ? 1 : 2;
}

// Blocks of one slot that __launch_bounds__ asks a multiprocessor to hold,
// which caps an instantiation's registers at 65,536 / (128 x this). Left to
// itself ptxas picked the occupancy by layout, and badly for some: 168-188
// registers over int8 at head_dim 128 (2 or 3 blocks), 80 with 20-24 bytes
// spilled over bf16 at head_dim 64 (6 blocks, 20% slower than 110). So: 3
// over int8 at head_dim 128; 4 over bf16 at head_dim 64, and for the paged
// int8 forms there (unbounded, the paired one ran 5-15% slower); no bound
// (1) for the dense int8 forms at head_dim 64, 2-5% faster without it, and
// over bf16 at head_dim 128, where a bound of 4 made ptxas spill and
// unbounded it takes 144 registers (3 blocks), 15% faster than 126.
// (-Xptxas -v and tools/bench_decode_attention.py on the H100.) A timing
// build of two slots a block (DECODE_SLOTS = 2) asks for half as many,
// rounded down, and at least 1.
template <int H, bool kQuant, bool kPaged>
__host__ __device__ constexpr int slot_blocks() {
  if (H == 128) return kQuant ? 3 : 1;
  return kQuant && !kPaged ? 1 : 4;
}

// floats of one partial: acc[G][H], then m[G], then l[G]
template <int G, int H>
__host__ __device__ constexpr int partial_floats() {
  return G * (H + 2);
}

// A slot's shared memory: its warps' partials, the inbox of the other
// ranks' partials (rank 0 only reads it), the fresh row's scores; rounded
// to 16 bytes
template <int G, int H>
__host__ __device__ constexpr int slot_bytes(int split) {
  return ((kWarps + split - 1) * partial_floats<G, H>() * 4 + G * 4 + 15) &
         ~15;
}

// the block's: the inbox mbarrier (16 bytes), then SB slots
template <int G, int H>
__host__ __device__ constexpr int smem_bytes(int sb, int split) {
  return 16 + sb * slot_bytes<G, H>(split);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// D += A (16x16, row-major) * B (16x8, column-major), bf16 -> f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The 8x8 matrix of bf16 pairs the warp holds (lane 4r + c: row r, columns
// 2c and 2c + 1), transposed
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte i of w (an int8 code) as f32, exactly: 2^23 + (code + 128) - 2^23 -
// 128
__device__ __forceinline__ float code_f32(uint32_t w, int i) {
  return __int_as_float(
             __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 + i)) -
         8388736.f;
}

// 32-bit word i of a lane's vectors (i a constant once unrolled)
template <int N>
__device__ __forceinline__ uint32_t word(const uint4 (&v)[N], int i) {
  const uint4 x = v[i / 4];
  return i % 4 == 0 ? x.x : i % 4 == 1 ? x.y : i % 4 == 2 ? x.z : x.w;
}

// bf16 pair i of a lane's quarter of a row: elements 2i and 2i + 1
template <bool kQuant, int N>
__device__ __forceinline__ uint32_t pair(const uint4 (&v)[N], int i) {
  if constexpr (kQuant) {
    const uint32_t w = word(v, i / 2);
    return pack_bf16(code_f32(w, 2 * (i % 2)), code_f32(w, 2 * (i % 2) + 1));
  } else {
    return word(v, i);
  }
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

// A lane's quarter t of a row is its 16-byte chunks t, t + 4, t + 8, ...:
// the four lanes of a quad read 64 contiguous bytes an instruction. The
// head dim of element k of quarter t, for rows of int8 codes (kQuant) or
// bf16:
template <bool kQuant>
__device__ __forceinline__ int quarter_dim(int t, int k) {
  constexpr int kE = kQuant ? 16 : 8;  // elements a chunk
  return (t + 4 * (k / kE)) * kE + k % kE;
}

// A lane's quarter of row `row` of the rows at `base` (their first row's
// first byte of this kv head, plus the lane's first chunk; `stride` bytes a
// row), zeros where the row is not live (a masked row stays finite in the
// value product)
template <int N>
__device__ __forceinline__ void load_quarter(uint4 (&v)[N],
                                             const uint8_t* base, int row,
                                             int stride, bool live) {
  const uint4* src =
      reinterpret_cast<const uint4*>(base + (size_t)row * stride);
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = live ? __ldg(src + 4 * i) : make_uint4(0u, 0u, 0u, 0u);
}

// Where one layer's cache rows live. Row r of slot b is line j of lead
// `lead`: dense, (lead, j) = (b, r), k/v/ks/vs point at the layer's
// [B, Nk, S, H] rows and [B, Nk, S] scales and rows = S; paged, (lead, j)
// = (table[b, r / page] * layers + layer, r % page), they point at the
// whole pools [P, L, Nk, page, H] and [P, L, Nk, page], rows = page and
// table is [B, max_pages]. pair = 1: the rows are [.., Nk / 2, rows, 2H],
// kv head kh in half kh & 1 of a line; the scales keep Nk planes. A bf16
// cache has no scales (ks = vs = NULL).
struct KvRows {
  const uint8_t* k;
  const uint8_t* v;
  const float* ks;
  const float* vs;
  const int* table;
  int rows;
  int max_pages;
  int layers;
  int layer;
  int pair;
};

// One warp's tile of rows r0 .. r0 + 16 kKB - 1 in registers: the quarter
// a lane reads of key and value rows r0 + 16 kb + 8 hf + g (the rows of
// A's fragments, keys as M), and those rows' scales
template <int H, bool kQuant>
struct Tile {
  static constexpr int kKB = tile_blocks<H, kQuant>();
  static constexpr int kVec = (kQuant ? H : 2 * H) / 64;
  uint4 k[kKB][2][kVec];
  uint4 v[kKB][2][kVec];
  float ks[kQuant ? kKB : 1][2];
  float vs[kQuant ? kKB : 1][2];
};

// q [B, Nq, H] bf16; src: the cache rows (int8 with f32 scales, kQuant, or
// bf16), dense or paged (kPaged), unpaired or paired (kPair = src.pair: a
// line's stride a constant, so a tile's rows lie at immediate offsets from
// one address), whose pointers kc/vc/ks/vs are also passed as __restrict__
// parameters (ptxas schedules their loads more freely: 1-2% on K3); fk/fv
// [B, Nk, H] bf16; positions [B]; out [B, Nq, H] bf16. Grid (split, Nk, B /
// SB) in clusters of (split, 1, 1); SB * 128 threads, 128 a slot.
template <int G, int H, bool kQuant, bool kPaged, bool kPair, int SB>
__global__ void __launch_bounds__(
    kSlotThreads * SB,
    slot_blocks<H, kQuant, kPaged>() / SB > 1
        ? slot_blocks<H, kQuant, kPaged>() / SB
        : 1)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const uint8_t* __restrict__ kc,
                        const uint8_t* __restrict__ vc,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const KvRows src,
                        const __nv_bfloat16* __restrict__ fk,
                        const __nv_bfloat16* __restrict__ fv,
                        const int* __restrict__ positions,
                        __nv_bfloat16* __restrict__ out, int Nq, int Nk,
                        int limit, float sm_scale) {
  using T = Tile<H, kQuant>;
  constexpr int kKB = T::kKB;
  constexpr int kTile = 16 * kKB;
  constexpr int kRowBytes = kQuant ? H : 2 * H;
  constexpr int kPairs = H / 8;  // bf16 pairs of a quarter row
  constexpr int kPart = partial_floats<G, H>();
  constexpr int kPer = (G * H + kSlotThreads - 1) / kSlotThreads;
  constexpr bool kCopiesOnly = DECODE_PROBE == 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = gridDim.x, rank = blockIdx.x, kh = blockIdx.y;
  const int group = threadIdx.x / kSlotThreads;
  const int b = blockIdx.z * SB + group;
  const int tid = threadIdx.x % kSlotThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row g, column pair t
  const bool merge = split > 1 && DECODE_PROBE != 1 && DECODE_PROBE != 2;
  const bool stores = rank == 0 || !merge;  // folds the ranks and stores
  const uint32_t inbox_bar = smem_addr(smem_raw);
  float* parts = reinterpret_cast<float*>(smem_raw + 16 +
                                          group * slot_bytes<G, H>(split));
  float* fresh_s = parts + (kWarps + split - 1) * kPart;

  if (merge) {
    if (threadIdx.x == 0 && rank == 0) {
      // one arrival (this one) and the bytes every other rank pushes
      asm volatile(
          "mbarrier.init.shared::cta.b64 [%0], 1;\n"
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              inbox_bar),
          "r"((split - 1) * SB * partial_floats<G, H>() * 4)
          : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // rank 0's barrier is set before a push reaches it: arrive here, wait
    // before the first push
    cluster_arrive();
  }
  // Programmatic dependent launch: the next kernel on the stream may start
  // its prologue now; nothing a kernel before this one may write (the
  // positions, q, the fresh rows, the cache, the page table, the output)
  // is touched until that kernel is done
  if constexpr (kPdl) {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  }

  // everything that does not depend on the position, requested with it:
  // query row g at the head dims of the cache rows' quarter t, which is
  // the B fragment of the score product (queries as N; elements 4s + {0,
  // 1} (b0) and 4s + {2, 3} (b1) of k16 step s; rows past G are zero), the
  // fresh key at the same dims, the fresh value's elements this thread
  // stores
  const int pos = positions[b];
  const size_t plane = (size_t)b * Nk + kh;
  uint32_t qa[kPairs], fka[kPairs];
  {
    uint4 qv[H / 32], fkv[H / 32];
    const uint4* qsrc = reinterpret_cast<const uint4*>(
        q + ((size_t)b * Nq + kh * G + min(g, G - 1)) * H);
    const uint4* fsrc = reinterpret_cast<const uint4*>(fk + plane * H);
#pragma unroll
    for (int i = 0; i < H / 32; ++i) {  // elements 8i .. 8i + 7
      const int c = quarter_dim<kQuant>(t, 8 * i) / 8;
      qv[i] = g < G ? __ldg(qsrc + c) : make_uint4(0u, 0u, 0u, 0u);
      fkv[i] = __ldg(fsrc + c);
    }
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      qa[i] = word(qv, i);
      fka[i] = word(fkv, i);
    }
  }
  float fvv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + kSlotThreads * i;
    fvv[i] = stores && e < G * H ? __bfloat162float(fv[plane * H + e % H])
                                 : 0.f;
  }

  const int capacity = kPaged ? src.rows * src.max_pages : src.rows;
  const int n = max(0, min(min(pos, limit), capacity));
  // a line's bytes (one row of one kv head, of two paired), this kv head's
  // line plane and its place in the line, plus the lane's first chunk
  constexpr int kStride = kPair ? 2 * kRowBytes : kRowBytes;
  const size_t line_planes = (size_t)(kPair ? Nk / 2 : Nk);
  const int line_plane = kPair ? kh / 2 : kh;
  const int at = (kPair ? (kh % 2) * kRowBytes : 0) + 16 * t;

  // The output transposed, dims as M and queries as N: o[u] holds query
  // columns 2t, 2t + 1 of dim rows g (e = 0, 1) and g + 8 (e = 2, 3) of
  // dim tile u, which are head dims dim(2u, g) and dim(2u + 1, g) with
  // dim(j, g) = quarter_dim(g / 2, 2j + g % 2) (the transposed value
  // rows').
  // m, l: the running max and sum of queries 2t + c
  float o[H / 16][4];
#pragma unroll
  for (int u = 0; u < H / 16; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[u][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  [[maybe_unused]] uint32_t sink = 0;  // the copies-alone probe's use

  const int tiles = (n + kTile - 1) / kTile;
  const int nparts = split * kWarps, part = rank * kWarps + warp;
  const int tile_end = (part + 1) * tiles / nparts;
  // Row 0 of the rows being read (dense: the plane's; paged: the current
  // page's): its first byte of this kv head plus the lane's first chunk,
  // and its scales. Paged, `page` is the page they belong to (none yet)
  // and `page_row` that page's first row; dense, the row is the line.
  const uint8_t* kbase = nullptr;
  const uint8_t* vbase = nullptr;
  const float* ksbase = nullptr;
  const float* vsbase = nullptr;
  [[maybe_unused]] int page = -1;
  int page_row = 0;
  auto rows_of = [&](size_t lead) {
    const size_t line = (lead * line_planes + line_plane) * src.rows;
    kbase = kc + line * kStride + at;
    vbase = vc + line * kStride + at;
    if constexpr (kQuant) {
      ksbase = ks + (lead * Nk + kh) * src.rows;
      vsbase = vs + (lead * Nk + kh) * src.rows;
    }
  };
  if constexpr (!kPaged) rows_of(b);
  for (int tile = part * tiles / nparts; tile < tile_end; ++tile) {
    const int r0 = tile * kTile;
    if constexpr (kPaged) {
      const int pg = r0 / src.rows;
      if (pg != page) {
        page = pg;
        page_row = pg * src.rows;
        rows_of((size_t)__ldg(src.table + (size_t)b * src.max_pages + pg) *
                    src.layers +
                src.layer);
      }
    }
    const int j0 = r0 - page_row;  // the tile's first row in those rows
    T x;
#pragma unroll
    for (int kb = 0; kb < kKB; ++kb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * kb + 8 * hf + g;  // the row's place in the tile
        const bool live = r0 + r < n;
        load_quarter(x.k[kb][hf], kbase, j0 + r, kStride, live);
        load_quarter(x.v[kb][hf], vbase, j0 + r, kStride, live);
        if constexpr (kQuant) {
          x.ks[kb][hf] = live ? __ldg(ksbase + j0 + r) * sm_scale : 0.f;
          x.vs[kb][hf] = live ? __ldg(vsbase + j0 + r) : 0.f;
        }
      }
    if constexpr (kCopiesOnly) {
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int i = 0; i < 4 * T::kVec; ++i)
            sink ^= word(x.k[kb][hf], i) ^ word(x.v[kb][hf], i);
          if constexpr (kQuant)
            sink ^= __float_as_uint(x.ks[kb][hf]) ^
                    __float_as_uint(x.vs[kb][hf]);
        }
      continue;
    }

    // scores transposed, keys as M: sc[kb][e] is key r0 + 16 kb + g + 8
    // (e / 2) against query 2t + e % 2
    float sc[kKB][4];
#pragma unroll
    for (int kb = 0; kb < kKB; ++kb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[kb][e] = 0.f;
#pragma unroll
      for (int s = 0; s < H / 16; ++s)
        mma_bf16(sc[kb], pair<kQuant>(x.k[kb][0], 2 * s),
                 pair<kQuant>(x.k[kb][1], 2 * s),
                 pair<kQuant>(x.k[kb][0], 2 * s + 1),
                 pair<kQuant>(x.k[kb][1], 2 * s + 1), qa[2 * s],
                 qa[2 * s + 1]);
    }
    // scale, mask, online softmax: a query's keys lie in the 8 lanes of
    // its column t (three shuffles)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int kb = 0; kb < kKB; ++kb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = r0 + 16 * kb + 8 * (e / 2) + g;
        float v = kNegInf;
        if (j < n) {
          if constexpr (kQuant)
            v = sc[kb][e] * x.ks[kb][e / 2];
          else
            v = sc[kb][e] * sm_scale;
        }
        sc[kb][e] = v;
        mx[e % 2] = fmaxf(mx[e % 2], v);
      }
    float alpha[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int o8 = 4; o8 < 32; o8 <<= 1)
        mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], o8));
      const float m_new = fmaxf(m[c], mx[c]);
      alpha[c] = __expf(m[c] - m_new);
      m[c] = m_new;
      l[c] *= alpha[c];
    }
#pragma unroll
    for (int u = 0; u < H / 16; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[u][e] *= alpha[e % 2];
#pragma unroll
    for (int kb = 0; kb < kKB; ++kb) {
      // p (summed unrounded), then bf16(p * v_scale) or bf16(p): keys g
      // and g + 8 of the block against queries 2t, 2t + 1, transposed into
      // the B fragment of the value product (keys 2t, 2t + 1 and + 8 of
      // query column g)
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = sc[kb][e] > 0.5f * kNegInf ? __expf(sc[kb][e] - m[e % 2])
                                          : 0.f;
        l[e % 2] += p[e];
        if constexpr (kQuant) p[e] *= x.vs[kb][e / 2];
      }
      const uint32_t b0 = transpose8x8(pack_bf16(p[0], p[1]));
      const uint32_t b1 = transpose8x8(pack_bf16(p[2], p[3]));
      // values transposed, dims as M: pair j of a lane's quarter of row r
      // is an element of the 8x8 matrix (row r, elements 2j, 2j + 1 of
      // quarter t); transposed, it holds keys 2t, 2t + 1 of dim row g
#pragma unroll
      for (int u = 0; u < H / 16; ++u)
        mma_bf16(o[u], transpose8x8(pair<kQuant>(x.v[kb][0], 2 * u)),
                 transpose8x8(pair<kQuant>(x.v[kb][0], 2 * u + 1)),
                 transpose8x8(pair<kQuant>(x.v[kb][1], 2 * u)),
                 transpose8x8(pair<kQuant>(x.v[kb][1], 2 * u + 1)), b0, b1);
    }
  }

  if constexpr (kCopiesOnly) {
    if (sink == 0x9e3779b9u) out[0] = __float2bfloat16(1.f);
    return;
  }

  // this warp's partial: l summed over the column's 8 lanes
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int o8 = 4; o8 < 32; o8 <<= 1)
      l[c] += __shfl_xor_sync(0xffffffffu, l[c], o8);
  {
    float* mine = parts + warp * kPart;
#pragma unroll
    for (int u = 0; u < H / 16; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = 2 * t + e % 2;
        const int d =
            quarter_dim<kQuant>(g / 2, 2 * (2 * u + e / 2) + g % 2);
        if (qr < G) mine[qr * H + d] = o[u][e];
      }
    if (g == 0)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (2 * t + c < G) {
          mine[G * H + 2 * t + c] = m[c];
          mine[G * H + G + 2 * t + c] = l[c];
        }
  }
  // the fresh row's score in f32, q . fk over the quad's quarters
  if (stores && warp == 0) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&qa[i]));
      const float2 c = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&fka[i]));
      s += a.x * c.x + a.y * c.y;
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (t == 0 && g < G) fresh_s[g] = s * sm_scale;
  }
  __syncthreads();

  // the block's partial: the warps folded in warp order; element e = g H +
  // d of the G x H outputs, kPer a thread
  float bm[kPer], bl[kPer], ba[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + kSlotThreads * i;
    if (e >= G * H) break;
    const int r = e / H;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mm = fmaxf(mm, parts[w * kPart + G * H + r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = parts + w * kPart;
      const float c = __expf(pw[G * H + r] - mm);
      ll += pw[G * H + G + r] * c;
      aa += pw[e] * c;
    }
    bm[i] = mm;
    bl[i] = ll;
    ba[i] = aa;
  }

  if (!stores) {
    // into slot rank - 1 of rank 0's inbox; the bytes complete rank 0's
    // barrier
    const uint32_t slot = cluster_addr(
        smem_addr(parts + (kWarps + rank - 1) * kPart), 0);
    const uint32_t bar = cluster_addr(inbox_bar, 0);
    cluster_wait();  // rank 0's barrier is set
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kSlotThreads * i;
      if (e >= G * H) break;
      st_async(slot + 4 * e, ba[i], bar);
      if (e % H == 0) {
        st_async(slot + 4 * (G * H + e / H), bm[i], bar);
        st_async(slot + 4 * (G * H + G + e / H), bl[i], bar);
      }
    }
    return;
  }
  if (merge) {
    cluster_wait();
    mbar_wait_cluster(inbox_bar, 0);
  }
  // the ranks in rank order, then the fresh row
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + kSlotThreads * i;
    if (e >= G * H) break;
    const int r = e / H;
    float mm = bm[i], ll = bl[i], aa = ba[i];
    if (merge) {
      for (int k = 1; k < split; ++k)
        mm = fmaxf(mm, parts[(kWarps + k - 1) * kPart + G * H + r]);
      const float c0 = __expf(bm[i] - mm);
      ll *= c0;
      aa *= c0;
      for (int k = 1; k < split; ++k) {
        const float* pk = parts + (kWarps + k - 1) * kPart;
        const float c = __expf(pk[G * H + r] - mm);
        ll += pk[G * H + G + r] * c;
        aa += pk[e] * c;
      }
    }
    const float sf = fresh_s[r];
    const float mf = fmaxf(mm, sf);
    const float c = __expf(mm - mf), pf = __expf(sf - mf);
    out[((size_t)b * Nq + kh * G + r) * H + e % H] =
        __float2bfloat16((aa * c + pf * fvv[i]) / (ll * c + pf));
  }
}

template <int G, int H, bool kQuant, bool kPaged, bool kPair>
int launch(const void* q, const KvRows& src, const void* fk, const void* fv,
           const void* pos, void* out, int B, int Nq, int Nk, int limit,
           float sm_scale, int split, cudaStream_t stream) {
  constexpr int SB = DECODE_SLOTS;
  auto kernel = decode_attention_kernel<G, H, kQuant, kPaged, kPair, SB>;
  const int smem = smem_bytes<G, H>(SB, split);
  if (smem > 48 * 1024) {
    static gabby_smem::SmemLeave leave;
    const cudaError_t err = leave.raise(kernel, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* fkp = static_cast<const __nv_bfloat16*>(fk);
  const __nv_bfloat16* fvp = static_cast<const __nv_bfloat16*>(fv);
  const int* pp = static_cast<const int*>(pos);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  const uint8_t* kp = src.k;
  const uint8_t* vp = src.v;
  const float* ksp = src.ks;
  const float* vsp = src.vs;
  KvRows rows = src;
  void* args[] = {&qp, &kp, &vp, &ksp, &vsp, &rows, &fkp, &fvp, &pp, &op,
                  &Nq, &Nk, &limit, &sm_scale};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, Nk, B / SB);
  cfg.blockDim = dim3(kSlotThreads * SB, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = kPdl ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(kernel), args);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int H, bool kQuant, bool kPaged, bool kPair>
int by_group(const void* q, const KvRows& src, const void* fk,
             const void* fv, const void* pos, void* out, int B, int Nq,
             int Nk, int limit, float sm_scale, int split, cudaStream_t s) {
  switch (Nq / Nk) {
    case 1: return launch<1, H, kQuant, kPaged, kPair>(
        q, src, fk, fv, pos, out, B, Nq, Nk, limit, sm_scale, split, s);
    case 2: return launch<2, H, kQuant, kPaged, kPair>(
        q, src, fk, fv, pos, out, B, Nq, Nk, limit, sm_scale, split, s);
    case 3: return launch<3, H, kQuant, kPaged, kPair>(
        q, src, fk, fv, pos, out, B, Nq, Nk, limit, sm_scale, split, s);
    case 4: return launch<4, H, kQuant, kPaged, kPair>(
        q, src, fk, fv, pos, out, B, Nq, Nk, limit, sm_scale, split, s);
    case 8: return launch<8, H, kQuant, kPaged, kPair>(
        q, src, fk, fv, pos, out, B, Nq, Nk, limit, sm_scale, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The instantiation of the cache's head_dim, element and line layout
template <bool kPaged, bool kPair>
int by_form(const void* q, const KvRows& src, const void* fk, const void* fv,
            const void* pos, void* out, int B, int Nq, int Nk, int H,
            int limit, float sm_scale, int split, cudaStream_t s) {
  const bool quant = src.ks != nullptr;
  if (H == 64)
    return quant ? by_group<64, true, kPaged, kPair>(
                       q, src, fk, fv, pos, out, B, Nq, Nk, limit, sm_scale,
                       split, s)
                 : by_group<64, false, kPaged, kPair>(
                       q, src, fk, fv, pos, out, B, Nq, Nk, limit, sm_scale,
                       split, s);
  if (H == 128)
    return quant ? by_group<128, true, kPaged, kPair>(
                       q, src, fk, fv, pos, out, B, Nq, Nk, limit, sm_scale,
                       split, s)
                 : by_group<128, false, kPaged, kPair>(
                       q, src, fk, fv, pos, out, B, Nq, Nk, limit, sm_scale,
                       split, s);
  return (int)cudaErrorInvalidValue;
}

// Checks what the kernel takes (the plan's slots a block, cluster and tile
// among them; paged: a page the tile divides) and launches
template <bool kPaged>
int dispatch(const void* q, const KvRows& src, const void* fk,
             const void* fv, const void* pos, void* out, int B, int Nq,
             int Nk, int H, int limit, int sb, int split, int tile,
             float sm_scale, void* stream) {
  const bool quant = src.ks != nullptr;
  const int want_tile =
      quant ? 16 * tile_blocks<64, true>()
            : 16 * (H == 128 ? tile_blocks<128, false>()
                             : tile_blocks<64, false>());
  const bool aligned =
      reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(src.k) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(src.v) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(fk) % 2 == 0 &&
      reinterpret_cast<uintptr_t>(fv) % 2 == 0;
  if (B < 1 || Nk < 1 || Nq % Nk != 0 || src.rows < 1 || limit < 0 ||
      (src.pair != 0 && src.pair != 1) || (src.pair && Nk % 2 != 0) ||
      sb != DECODE_SLOTS || B % sb != 0 ||
      (split != 1 && split != 2 && split != 4 && split != kMaxSplit) ||
      tile != want_tile || !aligned || (quant && src.vs == nullptr) ||
      (kPaged && (src.table == nullptr || src.rows % tile != 0 ||
                  src.max_pages < 1 || src.layer < 0 ||
                  src.layer >= src.layers)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return src.pair ? by_form<kPaged, true>(q, src, fk, fv, pos, out, B, Nq,
                                          Nk, H, limit, sm_scale, split, s)
                  : by_form<kPaged, false>(q, src, fk, fv, pos, out, B, Nq,
                                           Nk, H, limit, sm_scale, split, s);
}

KvRows kv_rows(const void* k, const void* v, const void* k_scale,
               const void* v_scale, const void* table, int rows,
               int max_pages, int layers, int layer, int pair) {
  KvRows src;
  src.k = static_cast<const uint8_t*>(k);
  src.v = static_cast<const uint8_t*>(v);
  src.ks = static_cast<const float*>(k_scale);
  src.vs = static_cast<const float*>(v_scale);
  src.table = static_cast<const int*>(table);
  src.rows = rows;
  src.max_pages = max_pages;
  src.layers = layers;
  src.layer = layer;
  src.pair = pair;
  return src;
}

}  // namespace

extern "C" {

// K3, K12 and K16. q [B, Nq, H] bf16 (H 64 or 128, Nq / Nk in 1, 2, 3,
// 4, 8); k/v [B, Nk, S, H] int8 (pair = 1: [B, Nk/2, S, 2H]) and
// k/v_scale [B, Nk, S] f32 of one layer (the caller offsets the
// pointers); fresh_k/v [B, Nk, H] bf16; positions [B] int32; out
// [B, Nq, H] bf16. Reads rows j < min(positions[b], limit). (sb, split,
// tile): the wrapper's decode_plan: slots a block (the build's
// DECODE_SLOTS, 1), blocks a cluster (1, 2, 4 or 8) and rows a warp's tile
// (32; 16 over a bf16 cache at H = 128).
int gabby_decode_attention(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const void* fresh_k, const void* fresh_v,
                           const void* positions, void* out, int B, int Nq,
                           int Nk, int S, int H, int limit, int pair, int sb,
                           int split, int tile, float sm_scale,
                           void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch<false>(
      q, kv_rows(k, v, k_scale, v_scale, nullptr, S, 1, 1, 0, pair), fresh_k,
      fresh_v, positions, out, B, Nq, Nk, H, limit, sb, split, tile,
      sm_scale, stream);
}

// K24, K25 and K32: the same over a bf16 cache, k/v [B, Nk, S, H] bf16
// (pair = 1: [B, Nk/2, S, 2H]) of one layer, no scales.
int gabby_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* fresh_k, const void* fresh_v,
                                const void* positions, void* out, int B,
                                int Nq, int Nk, int S, int H, int limit,
                                int pair, int sb, int split, int tile,
                                float sm_scale, void* stream) {
  return dispatch<false>(
      q, kv_rows(k, v, nullptr, nullptr, nullptr, S, 1, 1, 0, pair),
      fresh_k, fresh_v, positions, out, B, Nq, Nk, H, limit, sb, split, tile,
      sm_scale, stream);
}

// K10 and K17: the same through the page table. k/v pools
// [P, L, Nk, page, H] int8 (pair = 1: [P, L, Nk/2, page, 2H]) and scale
// pools [P, L, Nk, page] f32 (whole, not offset); table [B, max_pages]
// int32. Reads rows j < min(positions[b], page * max_pages); the tile must
// divide the page.
int gabby_paged_decode_attention(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* table, const void* fresh_k,
                                 const void* fresh_v, const void* positions,
                                 void* out, int B, int Nq, int Nk, int L,
                                 int layer, int page, int max_pages, int H,
                                 int pair, int sb, int split, int tile,
                                 float sm_scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(
      q, kv_rows(k, v, k_scale, v_scale, table, page, max_pages, L, layer,
                 pair),
      fresh_k, fresh_v, positions, out, B, Nq, Nk, H, page * max_pages, sb,
      split, tile, sm_scale, stream);
}

// K28 and K29: the same over bf16 pools [P, L, Nk, page, H] (pair = 1:
// [P, L, Nk/2, page, 2H]), no scales.
int gabby_paged_decode_attention_bf16(const void* q, const void* k,
                                      const void* v, const void* table,
                                      const void* fresh_k,
                                      const void* fresh_v,
                                      const void* positions, void* out, int B,
                                      int Nq, int Nk, int L, int layer,
                                      int page, int max_pages, int H,
                                      int pair, int sb, int split, int tile,
                                      float sm_scale, void* stream) {
  return dispatch<true>(
      q, kv_rows(k, v, nullptr, nullptr, table, page, max_pages, L, layer,
                 pair),
      fresh_k, fresh_v, positions, out, B, Nq, Nk, H, page * max_pages, sb,
      split, tile, sm_scale, stream);
}

}  // extern "C"
