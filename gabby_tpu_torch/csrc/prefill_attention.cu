// Single-slot flash prefill attention over an int8 KV cache, Hopper
// (sm_90a): K4, and over the paired cache K21. head_dim 64 or 128, any
// group size. (Over a bf16 cache, K22 and K23, the tiles need no
// conversion and go by TMA straight to wgmma: prefill_attention_bf16.cu.)
//
// Replaces gabby_tpu/ops/pallas/prefill_attention.py:_prefill_call (its
// _kernel body, reached from prefill_attention), unpaired and pair=True,
// with scales: the T queries of one slot's prompt chunk (global positions
// offset..offset+T-1) attend that slot's cache rows j < offset of one
// layer, and then the chunk's own unquantized k/v causally (query t sees
// chunk keys t' <= t). The cache holds only earlier chunks while this runs;
// the caller writes the chunk's rows after the layer's attention. In the
// paired cache a row is one line of 2H elements holding kv heads 2p and
// 2p + 1 side by side (scales still per head); the block of head 2p + h
// stages its half of each line, and everything after the staging copy is
// the unpaired kernel's, so the outputs are equal bit for bit on the same
// rows re-laid. (The reference adds a query-group grid axis to fit the
// paired form into the TPU compiler's memory limit; a block here owns one
// kv head either way and needs no such axis.) The fresh block arrives
// head-major in both layouts.
//
// The arithmetic is the reference's: both products in bf16 on the tensor
// cores with f32 sums; bf16 queries unscaled. The key codes are bf16
// (exact) with ks[j] * sm_scale on the f32 scores and p * vs[j] rounded to
// bf16 against the value codes. The fresh block's k/v and p are bf16.
//
// What bounds it on the H100: operations. At T = 512, offset = 512, 32
// query heads and head_dim 64 a layer does 2 * 2 * 32 * 512 * 64 *
// (512 + 256.5) ~ 3.2 GFLOP of score and value products for ~1.1 MB of
// cache, queries and output; against 989 TFLOP/s of bf16 tensor-core rate
// that is ~3.3 us.
//
// Design, FlashAttention-2 on mma.sync m16n8k16 (bf16 in, f32 sums):
//   * The T * G query rows of one kv head (row = t * G + g) are cut into
//     64-row tiles; one block per (row tile, kv head, part of the key
//     range), 4 warps, each owning 16 rows whose query fragments stay in
//     registers for the whole sweep. At H = 64 a thread has at most 168
//     registers, so three blocks share a multiprocessor; at H = 128 the
//     query fragments and the output accumulator double (96 of them) and
//     two blocks share one.
//   * A short chunk over a long past would leave most multiprocessors idle
//     (8 blocks at T = 16), so its key tiles are split into n_split parts
//     (min(8, 2 x SMs / blocks, tiles / 2); gabby_prefill_attention_splits)
//     whose unnormalized outputs, maxima and sums a second kernel merges in
//     part order: deterministic, no atomics. Grid at G = 4, 8 kv heads and
//     132 SMs: 8, 32, 128, 256 blocks for T = 16, 64, 256, 512, times
//     (tiles / 2 up to) 8, 8, 2, 1 parts: 8 for T = 16 and 64 once the
//     past holds 15 tiles (960 rows), at T = 256 two always.
//   * Keys stream in 64-row tiles: the past cache rows j < offset, then the
//     fresh chunk keys up to the tile's last query position (the causal
//     skip). A ring of shared-memory stages (three at H = 64, two at
//     H = 128) is filled by cp.async (zero-filled past offset or T) ahead
//     of the tile computed: int8 codes and their scales for a past tile,
//     bf16 rows straight into the swizzled layout for a fresh tile. A past
//     tile's codes become bf16 once per block (exact) in a swizzled tile,
//     one extra barrier; every bf16 tile is read in place. The queries' staging tile
//     is the codes' conversion tile: the queries are in registers by then.
//   * Scores: per warp 16 x 64, 2H / 4 mma; B fragments by ldmatrix from
//     the swizzled [key][dim] tile (16-byte chunk c of row r at
//     r * 2H + ((c ^ (r & 7)) << 4): conflict-free). Each column takes
//     ks[j] * sm_scale (past) or sm_scale, then the mask.
//   * Online softmax in registers: a row lives in the four lanes of a quad,
//     its max by two shuffles; the running sum stays per lane until the end.
//   * Values: p * vs[j] (past) or p rounded to bf16 in registers is
//     the A fragment of the value product as it stands (the accumulator
//     layout of m16n8k16 is its A layout); the value tile's B fragments come
//     by ldmatrix.trans. H / 2 mma per warp per tile.
//   * One block barrier per fresh tile, two per past tile; the next
//     tiles' copies are in flight meanwhile.
// Times (python3 chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; int8,
// H = 64): 16 launches at T = 512, offset 512 take 0.567 ms replayed from a
// CUDA graph (K21 0.571; the earlier f32 form 4.056), SDPA on dequantized
// rows 0.67-0.93 in the same run, bound 0.052; K21 at T = 64 over 1024 rows
// (8 parts) 0.225.
// What is left: ~10x the bound, because a block's walk of up to 16 tiles
// is a chain of barriers, conversions and dependent mma that a few blocks
// a multiprocessor do not hide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "smem_leave.cuh"

namespace {

constexpr int kRows = 64;    // query rows per block
constexpr int kKeys = 64;    // keys per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// Sizes that follow from head_dim H.
template <int H>
struct Dims {
  static constexpr int kRowB = 2 * H;         // bytes of a bf16 tile row
  static constexpr int kChunks = kRowB / 16;  // its 16-byte chunks
  static constexpr int kCodeChunks = H / 16;  // 16-byte chunks of int8 codes
  static constexpr int kTile = kKeys * kRowB;
  static constexpr int kStages = H == 64 ? 3 : 2;
  static constexpr int kAhead = kStages - 1;  // tiles loading ahead
  static constexpr int kMinBlocks = H == 64 ? 3 : 2;
  // floats per row of a split's partial result: H unnormalized outputs,
  // its max, its sum, padding
  static constexpr int kPart = H + 4;
};

template <int H>
struct Stage {
  uint8_t k[Dims<H>::kTile];  // bf16 rows (swizzled), or int8 codes
  uint8_t v[Dims<H>::kTile];  // (row r at r * H, the first half)
  float ks[kKeys];
  float vs[kKeys];
};

template <int H>
struct Smem {
  Stage<H> st[Dims<H>::kStages];
  // the block's queries (swizzled) until they are in registers; then, over
  // an int8 cache, a past tile's codes as bf16 (swizzled)
  union {
    uint8_t q[kRows * Dims<H>::kRowB];
    struct {
      uint8_t kb[Dims<H>::kTile];
      uint8_t vb[Dims<H>::kTile];
    } cv;
  } u;
};

// 16-byte chunk c of row r of a tile of 2H-byte rows
template <int H>
__device__ __forceinline__ int swz(int r, int c) {
  return r * Dims<H>::kRowB + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory, of which the first `bytes` come from src and
// the rest are zeros
__device__ __forceinline__ void cp16n(uint32_t dst, const void* src,
                                      int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  cp16n(dst, src, valid ? 16 : 0);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// D += A (16x16, row-major) * B (16x8, column-major), bf16 -> f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte i of w (an int8 code) as f32, exactly: 2^23 + (code + 128) - 2^23 - 128
__device__ __forceinline__ float code_f32(uint32_t w_flipped, int i) {
  return __int_as_float(__byte_perm(w_flipped, 0x4B000000u, 0x7440 + i)) -
         8388736.f;
}

// 16 int8 codes -> 16 bf16 (two 16-byte chunks)
__device__ __forceinline__ void codes_to_bf16(uint4 w, uint4& lo, uint4& hi) {
  const uint32_t in[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                          w.z ^ 0x80808080u, w.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = pack_bf16(code_f32(in[i], 0), code_f32(in[i], 1));
    o[2 * i + 1] = pack_bf16(code_f32(in[i], 2), code_f32(in[i], 3));
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

template <int H>
__global__ void __launch_bounds__(kThreads, Dims<H>::kMinBlocks)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const void* __restrict__ kc,
                         const void* __restrict__ vc,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const __nv_bfloat16* __restrict__ fk,
                         const __nv_bfloat16* __restrict__ fv,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ part, int T, int Nq, int Nk,
                         int S, int offset, int pair, float sm_scale) {
  using D = Dims<H>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<H>& sm = *reinterpret_cast<Smem<H>*>(smem_raw);
  const int G = Nq / Nk;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int total_rows = T * G;

  // cache row j of this head: base + j * stride bytes
  const int stride = H << pair;
  const size_t code0 =
      (size_t)(kh >> pair) * S * (H << pair) + (pair ? (kh & 1) * H : 0);
  const uint8_t* kbase = static_cast<const uint8_t*>(kc) + code0;
  const uint8_t* vbase = static_cast<const uint8_t*>(vc) + code0;
  const float* ksb = ks + (size_t)kh * S;
  const float* vsb = vs + (size_t)kh * S;
  const __nv_bfloat16* fkb = fk + (size_t)kh * T * H;
  const __nv_bfloat16* fvb = fv + (size_t)kh * T * H;

  const int t_last = min(T - 1, (row0 + kRows - 1) / G);
  const int n_past = (offset + kKeys - 1) / kKeys;
  const int n_tiles = n_past + t_last / kKeys + 1;
  // split z of the key range walks tiles [lo, hi) (as even as can be)
  const int z = blockIdx.z, n_split = gridDim.z;
  const int lo = z * n_tiles / n_split, hi = (z + 1) * n_tiles / n_split;

  auto load_tile = [&](int tile) {
    Stage<H>& st = sm.st[tile % D::kStages];
    const bool past = tile < n_past;
    const int j0 = (past ? tile : tile - n_past) * kKeys;
    if (past) {
      // 64 rows x H / 16 chunks of codes, K and V
#pragma unroll
      for (int i = 0; i < 2 * kKeys * D::kCodeChunks / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int kv = idx / (kKeys * D::kCodeChunks);
        const int r = (idx / D::kCodeChunks) % kKeys;
        const int c = idx % D::kCodeChunks;
        const bool ok = j0 + r < offset;
        const uint8_t* src =
            (kv ? vbase : kbase) +
            (ok ? (size_t)(j0 + r) * stride + c * 16 : 0);
        cp16(smem_addr((kv ? st.v : st.k) + r * H + c * 16), src, ok);
      }
      if (tid < 32) {  // 16 chunks of scales each, zeros from offset on
        const int kv = tid / 16, c = tid % 16;
        const int n = max(0, min(4, offset - (j0 + c * 4)));
        const float* src = (kv ? vsb : ksb) + (n ? j0 + c * 4 : 0);
        cp16n(smem_addr((kv ? st.vs : st.ks) + c * 4), src, 4 * n);
      }
      return;
    }
    // bf16 rows, K and V, 2H / 16 chunks each, swizzled: the chunk's own
    // (fresh) rows
    const uint8_t* kb = reinterpret_cast<const uint8_t*>(fkb);
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(fvb);
    const size_t rstride = D::kRowB;
    const int n = T;
#pragma unroll
    for (int i = 0; i < 2 * kKeys * D::kChunks / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int kv = idx / (kKeys * D::kChunks);
      const int r = (idx / D::kChunks) % kKeys, c = idx % D::kChunks;
      const bool ok = j0 + r < n;
      const uint8_t* src =
          (kv ? vb : kb) + (ok ? (size_t)(j0 + r) * rstride + c * 16 : 0);
      cp16(smem_addr((kv ? st.v : st.k) + swz<H>(r, c)), src, ok);
    }
  };

  // the block's queries (zero past the last row), with tile lo
#pragma unroll
  for (int i = 0; i < kRows * D::kChunks / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / D::kChunks, c = idx % D::kChunks;
    const int flat = row0 + r;
    const bool ok = flat < total_rows;
    const __nv_bfloat16* src =
        q + (ok ? ((size_t)(flat / G) * Nq + kh * G + flat % G) * H + c * 8
                : 0);
    cp16(smem_addr(sm.u.q + swz<H>(r, c)), src, ok);
  }
#pragma unroll
  for (int s = 0; s < D::kAhead; ++s) {
    if (lo + s < hi) load_tile(lo + s);
    cp_commit();
  }

  // rows g and g + 8 of the warp's 16: their in-chunk query positions
  const int flat0 = row0 + warp * 16 + g;
  const int t_row[2] = {flat0 / G, (flat0 + 8) / G};

  uint32_t qa[H / 16][4];  // query A fragments, one per 16 dims
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[H / 8][4];
#pragma unroll
  for (int dt = 0; dt < H / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  for (int tile = lo; tile < hi; ++tile) {
    cp_wait<D::kAhead - 1>();  // this tile (and the queries) landed
    __syncthreads();           // ... for every thread; the last tile is done
    if (tile + D::kAhead < hi) load_tile(tile + D::kAhead);
    cp_commit();
    const Stage<H>& st = sm.st[tile % D::kStages];
    const bool past = tile < n_past;
    if (tile == lo) {
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk)
        ldsm_x4(qa[kk], smem_addr(sm.u.q + swz<H>(warp * 16 + lane % 16,
                                                  2 * kk + lane / 16)));
      // the codes' conversion below writes over the queries' tile
      if (past) __syncthreads();
    }
    const int j0 = (past ? tile : tile - n_past) * kKeys;
    const uint8_t* kt = st.k;
    const uint8_t* vt = st.v;
    if (past) {
      // codes -> bf16 once per block: K and V, 64 rows x H / 16 chunks each
#pragma unroll
      for (int i = 0; i < 2 * kKeys * D::kCodeChunks / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int kv = idx / (kKeys * D::kCodeChunks);
        const int r = (idx / D::kCodeChunks) % kKeys;
        const int c = idx % D::kCodeChunks;
        const uint4 w = *reinterpret_cast<const uint4*>(
            (kv ? st.v : st.k) + r * H + c * 16);
        uint4 w0, w1;
        codes_to_bf16(w, w0, w1);
        uint8_t* dst = kv ? sm.u.cv.vb : sm.u.cv.kb;
        *reinterpret_cast<uint4*>(dst + swz<H>(r, 2 * c)) = w0;
        *reinterpret_cast<uint4*>(dst + swz<H>(r, 2 * c + 1)) = w1;
      }
      __syncthreads();
      kt = sm.u.cv.kb;
      vt = sm.u.cv.vb;
    }

    // scores: 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, smem_addr(kt + swz<H>(16 * np + 8 * (lane / 16) + lane % 8,
                                         2 * kk + (lane / 8) % 2)));
        mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }

    // scale, mask, online softmax; element e of tile nt: row g + 8 (e / 2),
    // key 8 nt + 2t + e % 2
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * t + (e & 1);
        const int j = j0 + col;
        float v;
        if (past)
          v = j < offset ? s[nt][e] * (st.ks[col] * sm_scale) : kNegInf;
        else
          v = j <= t_row[e >> 1] ? s[nt][e] * sm_scale : kNegInf;
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int dt = 0; dt < H / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];

    // p (summed unrounded), then p * vs (past) in bf16 as A
    // fragments: keys 16 kk .. 16 kk + 15 are score tiles 2 kk and 2 kk + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = s[nt][e] > 0.5f * kNegInf ? __expf(s[nt][e] - m[e >> 1])
                                         : 0.f;
        l[e >> 1] += p[e];
      }
      if (past) {
        const float v0 = st.vs[8 * nt + 2 * t], v1 = st.vs[8 * nt + 2 * t + 1];
        p[0] *= v0;
        p[1] *= v1;
        p[2] *= v0;
        p[3] *= v1;
      }
      pa[nt / 2][(nt % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < H / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_addr(vt + swz<H>(16 * kk + 8 * ((lane / 8) % 2) +
                                               lane % 8,
                                           2 * dp + lane / 16)));
        mma_bf16(o[2 * dp], pa[kk], b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa[kk], b[2], b[3]);
      }
    }
  }
  cp_wait<0>();  // an empty part (T = 256 at offset 0) still copied queries

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int flat = flat0 + 8 * r;
    if (flat >= total_rows) continue;
    if (n_split > 1) {  // the split's share, for the combine pass
      float* dst =
          part + ((size_t)(z * Nk + kh) * total_rows + flat) * D::kPart;
#pragma unroll
      for (int dt = 0; dt < H / 8; ++dt)
        *reinterpret_cast<float2*>(dst + 8 * dt + 2 * t) =
            make_float2(o[dt][2 * r], o[dt][2 * r + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(dst + H) = make_float2(m[r], l[r]);
      continue;
    }
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst =
        out + ((size_t)(flat / G) * Nq + kh * G + flat % G) * H + 2 * t;
#pragma unroll
    for (int dt = 0; dt < H / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * dt) =
          __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
  }
}

// Merges the n_split partial results of each query row in split order
// (deterministic): one warp a (row, kv head), H / 32 dims a lane.
template <int H>
__global__ void __launch_bounds__(128)
prefill_combine_kernel(const float* __restrict__ part,
                       __nv_bfloat16* __restrict__ out, int rows, int Nq,
                       int Nk, int n_split) {
  constexpr int kD = H / 32, kPart = Dims<H>::kPart;
  const int w = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w >= rows * Nk) return;
  const int kh = w / rows, flat = w % rows, G = Nq / Nk;
  const float* p = part + ((size_t)kh * rows + flat) * kPart;
  const size_t zs = (size_t)Nk * rows * kPart;  // one split to the next
  float mx = kNegInf;
  for (int z = 0; z < n_split; ++z) mx = fmaxf(mx, p[z * zs + H]);
  float l = 0.f, o[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) o[d] = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float* pz = p + z * zs;
    const float e = __expf(pz[H] - mx);
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

template <int H>
int run(const void* q, const void* k, const void* v, const void* k_scale,
        const void* v_scale, const void* fresh_k, const void* fresh_v,
        void* out, void* part, int T, int Nq, int Nk, int S, int offset,
        int pair, int n_split, float sm_scale, cudaStream_t st) {
  static gabby_smem::SmemLeave leave;
  constexpr int bytes = (int)sizeof(Smem<H>);
  cudaError_t err = leave.raise(prefill_attention_kernel<H>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = T * (Nq / Nk);
  dim3 grid((rows + kRows - 1) / kRows, Nk, n_split);
  prefill_attention_kernel<H><<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), k, v,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(fresh_k),
      static_cast<const __nv_bfloat16*>(fresh_v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), T, Nq, Nk,
      S, offset, pair, sm_scale);
  if (n_split > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    prefill_combine_kernel<H><<<(rows * Nk + 3) / 4, 128, 0, st>>>(
        static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out),
        rows, Nq, Nk, n_split);
  }
  return (int)cudaGetLastError();
}

int by_head(const void* q, const void* k, const void* v, const void* k_scale,
            const void* v_scale, const void* fresh_k, const void* fresh_v,
            void* out, void* part, int T, int Nq, int Nk, int S, int H,
            int offset, int pair, int n_split, float sm_scale, void* stream) {
  if (Nk < 1 || Nq % Nk != 0 || offset < 0 || offset > S ||
      (pair != 0 && pair != 1) || (pair && Nk % 2) || n_split < 1 ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 64)
    return run<64>(q, k, v, k_scale, v_scale, fresh_k, fresh_v, out, part,
                   T, Nq, Nk, S, offset, pair, n_split, sm_scale, st);
  if (H == 128)
    return run<128>(q, k, v, k_scale, v_scale, fresh_k, fresh_v, out, part,
                    T, Nq, Nk, S, offset, pair, n_split, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// How many parts the key range of one call is split into: enough blocks
// for two a multiprocessor, each part at least two key tiles, at most 8.
int gabby_prefill_attention_splits(int T, int Nq, int Nk, int offset) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || Nk < 1 || Nq % Nk)
    return 1;
  const int blocks = (T * (Nq / Nk) + kRows - 1) / kRows * Nk;
  const int tiles = (offset + kKeys - 1) / kKeys + (T + kKeys - 1) / kKeys;
  return std::max(1,
                  std::min({8, 2 * sms / std::max(blocks, 1), tiles / 2}));
}

// q [T, Nq, H] bf16 (H 64 or 128); k/v [Nk, S, H] int8 (pair = 1:
// [Nk/2, S, 2H]) and k/v_scale [Nk, S] f32 of one (layer, slot) cache row
// (the caller offsets the pointers); fresh_k/v [Nk, T, H] bf16; out
// [T, Nq, H] bf16. Reads cache rows j < offset. S % 4 == 0 (16-byte rows of
// scales). With n_split > 1 (gabby_prefill_attention_splits) `part` holds
// n_split * Nk * T * (Nq / Nk) * (H + 4) floats of partial results.
int gabby_prefill_attention(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* fresh_k, const void* fresh_v,
                            void* out, void* part, int T, int Nq, int Nk,
                            int S, int H, int offset, int pair, int n_split,
                            float sm_scale, void* stream) {
  if (S % 4 || k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return by_head(q, k, v, k_scale, v_scale, fresh_k, fresh_v, out, part, T,
                 Nq, Nk, S, H, offset, pair, n_split, sm_scale, stream);
}

}  // extern "C"
