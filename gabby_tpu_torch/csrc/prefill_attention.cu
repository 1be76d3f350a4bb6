// Single-slot flash prefill attention over the int8 KV cache, Hopper
// (sm_90a): K4, and over the paired cache K21.
//
// Replaces gabby_tpu/ops/pallas/prefill_attention.py:_prefill_call (its
// _kernel body, reached from prefill_attention), unpaired and pair=True: the
// T queries of one slot's prompt chunk (global positions offset..offset+T-1)
// attend that slot's cache rows j < offset of one layer, and then the
// chunk's own unquantized k/v causally (query t sees chunk keys t' <= t).
// The cache holds only earlier chunks while this runs; the caller writes
// the chunk's rows after the layer's attention. In the paired cache a row
// is one 128-byte line holding the codes of kv heads 2p and 2p + 1 side by
// side, scales still per head; the block of head 2p + h stages bytes
// [64 h, 64 h + 64) of each line, and everything after the staging copy is
// the unpaired kernel's, so the outputs are equal bit for bit on the same
// rows re-laid. (The reference adds a query-group grid axis to fit the
// paired form into the TPU compiler's memory limit; a block here owns one
// kv head either way and needs no such axis.) The fresh block arrives
// head-major in both layouts.
//
// The arithmetic is the reference's: both products in bf16 on the tensor
// cores with f32 sums; bf16 queries unscaled; the int8 key codes as bf16
// (exact) and ks[j] * sm_scale on the f32 scores; p * vs[j] rounded to bf16
// against the value codes; the fresh block's k/v and p in bf16.
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
//     registers for the whole sweep; at most 168 registers a thread, so
//     three blocks share a multiprocessor.
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
//     skip). A ring of three shared-memory stages is filled by cp.async
//     (zero-filled past offset or T) two tiles ahead of the one computed:
//     int8 codes and their scales for a past tile, bf16 rows for a fresh
//     one. A past tile's codes become bf16 once per block (exact) in a
//     swizzled tile, one extra barrier; a fresh tile is read in place.
//   * Scores: per warp 16 x 64, 32 mma; B fragments by ldmatrix from the
//     128-byte-swizzled [key][dim] tile (conflict-free). Each column takes
//     ks[j] * sm_scale (past) or sm_scale (fresh), then the mask.
//   * Online softmax in registers: a row lives in the four lanes of a quad,
//     its max by two shuffles; the running sum stays per lane until the end.
//   * Values: p * vs[j] (past) or p (fresh) rounded to bf16 in registers is
//     the A fragment of the value product as it stands (the accumulator
//     layout of m16n8k16 is its A layout); the value tile's B fragments come
//     by ldmatrix.trans. 32 mma per warp per tile.
//   * One block barrier per fresh tile, two per past tile; the next tiles'
//     copies are in flight meanwhile.
// Times (python3 chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 16
// launches at T = 512, offset 512 take 0.567 ms replayed from a CUDA graph
// (K21 0.571; the earlier f32 form 4.056), SDPA on dequantized rows 0.67-0.93
// in the same run, bound 0.052; K21 at T = 64 over 1024 rows (8 parts)
// 0.225.
// What is left: ~10x the bound, because a block's walk of up to 16 tiles
// is a chain of barriers, conversions and dependent mma that three blocks
// a multiprocessor do not hide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kH = 64;       // head_dim
constexpr int kRows = 64;    // query rows per block
constexpr int kKeys = 64;    // keys per tile
constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kAhead = kStages - 1;  // tiles loading ahead of the computed one
constexpr float kNegInf = -1e30f;
constexpr int kPart = 68;  // floats per row of a split's partial result:
                           // 64 unnormalized outputs, its max, its sum

// A tile of 64 rows x 64 bf16 (128 bytes a row), 16-byte chunk c of row r
// at r * 128 + ((c ^ (r & 7)) << 4).
constexpr int kTileBytes = kKeys * 128;

struct Stage {
  uint8_t k[kTileBytes];  // bf16 fresh rows (swizzled), or int8 codes
  uint8_t v[kTileBytes];  // (row r at r * 64, the first 4 KB)
  float ks[kKeys];
  float vs[kKeys];
};

struct Smem {
  Stage st[kStages];
  uint8_t kb[kTileBytes];  // a past tile's codes as bf16 (swizzled)
  uint8_t vb[kTileBytes];
  uint8_t q[kRows * 128];  // the block's queries (swizzled)
};
constexpr size_t kSmemBytes = sizeof(Smem);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
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

__global__ void __launch_bounds__(kThreads, 3)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const int8_t* __restrict__ kc,
                         const int8_t* __restrict__ vc,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const __nv_bfloat16* __restrict__ fk,
                         const __nv_bfloat16* __restrict__ fv,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ part, int T, int Nq, int Nk,
                         int S, int offset, int pair, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int G = Nq / Nk;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int total_rows = T * G;

  // codes of cache row j of this head: base + j * stride
  const int stride = kH << pair;
  const size_t code0 =
      (size_t)(kh >> pair) * S * stride + (pair ? (kh & 1) * kH : 0);
  const int8_t* kbase = kc + code0;
  const int8_t* vbase = vc + code0;
  const float* ksb = ks + (size_t)kh * S;
  const float* vsb = vs + (size_t)kh * S;
  const __nv_bfloat16* fkb = fk + (size_t)kh * T * kH;
  const __nv_bfloat16* fvb = fv + (size_t)kh * T * kH;

  const int t_last = min(T - 1, (row0 + kRows - 1) / G);
  const int n_past = (offset + kKeys - 1) / kKeys;
  const int n_tiles = n_past + t_last / kKeys + 1;
  // split z of the key range walks tiles [lo, hi) (as even as can be)
  const int z = blockIdx.z, n_split = gridDim.z;
  const int lo = z * n_tiles / n_split, hi = (z + 1) * n_tiles / n_split;

  auto load_tile = [&](int tile) {
    Stage& st = sm.st[tile % kStages];
    if (tile < n_past) {
      const int j0 = tile * kKeys;
      // 64 rows x 4 chunks of codes, K and V: 4 copies a thread
#pragma unroll
      for (int i = 0; i < 2 * kKeys * 4 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int kv = idx / (kKeys * 4), r = (idx / 4) % kKeys, c = idx % 4;
        const bool ok = j0 + r < offset;
        const int8_t* src =
            (kv ? vbase : kbase) + (ok ? (size_t)(j0 + r) * stride + c * 16
                                       : 0);
        cp16(smem_addr((kv ? st.v : st.k) + r * 64 + c * 16), src, ok);
      }
      if (tid < 32) {  // 16 chunks of scales each, zeros from offset on
        const int kv = tid / 16, c = tid % 16;
        const int n = max(0, min(4, offset - (j0 + c * 4)));
        const float* src = (kv ? vsb : ksb) + (n ? j0 + c * 4 : 0);
        cp16n(smem_addr((kv ? st.vs : st.ks) + c * 4), src, 4 * n);
      }
    } else {
      const int j0 = (tile - n_past) * kKeys;
      // 64 rows x 8 chunks of bf16, K and V: 8 copies a thread
#pragma unroll
      for (int i = 0; i < 2 * kKeys * 8 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int kv = idx / (kKeys * 8), r = (idx / 8) % kKeys, c = idx % 8;
        const bool ok = j0 + r < T;
        const __nv_bfloat16* src =
            (kv ? fvb : fkb) + (ok ? (size_t)(j0 + r) * kH + c * 8 : 0);
        cp16(smem_addr((kv ? st.v : st.k) + swz(r, c)), src, ok);
      }
    }
  };

  // the block's queries (zero past the last row), with tile 0
#pragma unroll
  for (int i = 0; i < kRows * 8 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / 8, c = idx % 8;
    const int flat = row0 + r;
    const bool ok = flat < total_rows;
    const __nv_bfloat16* src =
        q + (ok ? ((size_t)(flat / G) * Nq + kh * G + flat % G) * kH + c * 8
                : 0);
    cp16(smem_addr(sm.q + swz(r, c)), src, ok);
  }
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (lo + s < hi) load_tile(lo + s);
    cp_commit();
  }

  // rows g and g + 8 of the warp's 16: their in-chunk query positions
  const int flat0 = row0 + warp * 16 + g;
  const int t_row[2] = {flat0 / G, (flat0 + 8) / G};

  uint32_t qa[4][4];  // query A fragments, one per 16 dims
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  for (int tile = lo; tile < hi; ++tile) {
    cp_wait<kAhead - 1>();  // this tile (and the queries) landed
    __syncthreads();        // ... for every thread; the last tile is done
    if (tile + kAhead < hi) load_tile(tile + kAhead);
    cp_commit();
    if (tile == lo) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(qa[kk], smem_addr(sm.q + swz(warp * 16 + lane % 16,
                                             2 * kk + lane / 16)));
    }
    const Stage& st = sm.st[tile % kStages];
    const bool past = tile < n_past;
    const int j0 = (past ? tile : tile - n_past) * kKeys;
    const uint8_t* kt = st.k;
    const uint8_t* vt = st.v;
    if (past) {
      // codes -> bf16 once per block: K and V, 64 rows x 4 chunks each
#pragma unroll
      for (int i = 0; i < 2 * kKeys * 4 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int kv = idx / (kKeys * 4), r = (idx / 4) % kKeys, c = idx % 4;
        const uint4 w =
            *reinterpret_cast<const uint4*>((kv ? st.v : st.k) + r * 64 +
                                            c * 16);
        uint4 w0, w1;
        codes_to_bf16(w, w0, w1);
        uint8_t* dst = kv ? sm.vb : sm.kb;
        *reinterpret_cast<uint4*>(dst + swz(r, 2 * c)) = w0;
        *reinterpret_cast<uint4*>(dst + swz(r, 2 * c + 1)) = w1;
      }
      __syncthreads();
      kt = sm.kb;
      vt = sm.vb;
    }

    // scores: 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, smem_addr(kt + swz(16 * np + 8 * (lane / 16) + lane % 8,
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
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];

    // p (summed unrounded), then p * vs (past) in bf16 as A fragments:
    // keys 16 kk .. 16 kk + 15 are score tiles 2 kk and 2 kk + 1
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
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_addr(vt + swz(16 * kk + 8 * ((lane / 8) % 2) +
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
      float* dst = part + ((size_t)(z * Nk + kh) * total_rows + flat) * kPart;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<float2*>(dst + 8 * dt + 2 * t) =
            make_float2(o[dt][2 * r], o[dt][2 * r + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(dst + 64) = make_float2(m[r], l[r]);
      continue;
    }
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst =
        out + ((size_t)(flat / G) * Nq + kh * G + flat % G) * kH + 2 * t;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * dt) =
          __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
  }
}

// Merges the n_split partial results of each query row in split order
// (deterministic): one warp a (row, kv head), two dims a lane.
__global__ void __launch_bounds__(128)
prefill_combine_kernel(const float* __restrict__ part,
                       __nv_bfloat16* __restrict__ out, int rows, int Nq,
                       int Nk, int n_split) {
  const int w = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w >= rows * Nk) return;
  const int kh = w / rows, flat = w % rows, G = Nq / Nk;
  const float* p = part + ((size_t)kh * rows + flat) * kPart;
  const size_t zs = (size_t)Nk * rows * kPart;  // one split to the next
  float mx = kNegInf;
  for (int z = 0; z < n_split; ++z) mx = fmaxf(mx, p[z * zs + 64]);
  float l = 0.f, o0 = 0.f, o1 = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float* pz = p + z * zs;
    const float e = __expf(pz[64] - mx);
    const float2 oz = *reinterpret_cast<const float2*>(pz + 2 * lane);
    l += pz[65] * e;
    o0 += oz.x * e;
    o1 += oz.y * e;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  *reinterpret_cast<__nv_bfloat162*>(
      out + ((size_t)(flat / G) * Nq + kh * G + flat % G) * kH + 2 * lane) =
      __floats2bfloat162_rn(o0 * inv, o1 * inv);
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

// q [T, Nq, 64] bf16; k/v [Nk, S, 64] int8 (pair = 1: [Nk/2, S, 128]) and
// k/v_scale [Nk, S] f32 of one (layer, slot) cache row (the caller offsets
// the pointers); fresh_k/v [Nk, T, 64] bf16; out [T, Nq, 64] bf16. Reads
// cache rows j < offset. S % 4 == 0 (16-byte rows of scales). With
// n_split > 1 (gabby_prefill_attention_splits) `part` holds
// n_split * Nk * T * (Nq / Nk) * 68 floats of partial results.
int gabby_prefill_attention(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* fresh_k, const void* fresh_v,
                            void* out, void* part, int T, int Nq, int Nk,
                            int S, int H, int offset, int pair, int n_split,
                            float sm_scale, void* stream) {
  if (H != kH || Nq % Nk != 0 || offset > S || S % 4 ||
      (pair != 0 && pair != 1) || (pair && Nk % 2) || n_split < 1 ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  {
    // the leave to take more than 48 KB holds per device; set under a lock,
    // so calls may come from several threads and go to several devices
    static std::mutex mu;
    static bool attr_set[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu);
    if (!attr_set[dev]) {
      err = cudaFuncSetAttribute(prefill_attention_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmemBytes);
      if (err != cudaSuccess) return (int)err;
      attr_set[dev] = true;
    }
  }
  const int rows = T * (Nq / Nk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((rows + kRows - 1) / kRows, Nk, n_split);
  prefill_attention_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(fresh_k),
      static_cast<const __nv_bfloat16*>(fresh_v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), T, Nq, Nk,
      S, offset, pair, sm_scale);
  if (n_split > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    prefill_combine_kernel<<<(rows * Nk + 3) / 4, 128, 0, st>>>(
        static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out),
        rows, Nq, Nk, n_split);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
