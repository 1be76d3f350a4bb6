// Flash attention of a small block of query positions over the KV cache,
// dense or paged, unpaired or paired, int8 codes with scales or bf16 rows,
// head_dim 64 or 128, Hopper (sm_90a). Shared body of verify_attention.cu
// (K9, K13 over int8; K26, K27 over bf16) and paged_attention.cu (K11, K18
// over int8; K30, K31 over bf16): the multi-position (speculative verify)
// forms. The single-position (decode) forms are decode_attention.cu's, on
// the tensor cores with the same row addressing; attention_s8.cu shares
// this file's.
//
// Replaces gabby_tpu/ops/pallas/attention.py:_decode_call and
// _paged_decode_call (their _flash_step body) at tq > 1 in every form but
// use_s8: T query positions x G query heads of one kv head (row = t * G +
// g) attend cache rows j < min(pos[b], limit) of one layer, and then the
// block's own T unquantized k/v rows causally (row (t, g) sees fresh keys
// t' <= t). 2 <= T <= 32; the entries refuse T = 1. In the paged form row
// j of slot b lives at pool[table[b, j / page], layer, kh, j % page]; the
// table is read here, nothing gathers the pool.
//
// The two cache forms are the reference's `quant = k_scale is not None`:
//   int8 (kQuant): codes with per-(token, kv-head) f32 scales, folded into
//     the scores (k) and the probabilities (v);
//   bf16: the rows themselves; the scores take sm_scale alone and p is
//     rounded to bf16 before the value product, as the reference's
//     `pv.astype(bfloat16)` (attention.py:186-193).
// Either way q . k is a sum of exact products of bf16 values in f32 (q
// pre-multiplied by sm_scale in f32), the softmax runs in f32 and the fresh
// block is folded in f32.
//
// The paired layout stores kv heads 2p and 2p + 1 side by side: a cache row
// is one line of 2H elements, head 2p in the first half, scales still per
// head. The TPU kernel pads the queries block-diagonally to fill a 128-deep
// matrix unit and throws half of each output row away; here a block still
// owns ONE kv head and reads its half of each line (whole 32-byte sectors,
// so no byte is fetched in vain; the pair's other block finds the line's
// neighbourhood in L2). The arithmetic and its order are the unpaired
// kernel's, so the outputs are equal bit for bit on the same rows re-laid.
//
// What bounds it on the H100: bytes. A (slot, kv head) streams 2 * n * H
// code bytes and 2 * n * 4 scale bytes (int8), or 2 * n * 2H bytes (bf16),
// for n live rows; the T * G <= 64 query rows add 4 * T * G * H FLOPs per
// cache row, far below the byte rate at the tensor-core peak. This form
// does those products on the CUDA cores in f32.
//
// Design: one block per (slot, kv head, tile of R <= 8 query rows), 4
// warps; the tiles of one (slot, kv head) re-read its cache rows through
// L2. The loop runs to the slot's own position (this replaces the TPU
// kernel's chunk clamp and, paged, its clamped page index: table entries
// past the slot's rows are never read). A warp takes 32 cache rows at a
// time, one per lane: the lane loads its key row and its value row as
// 16-byte vectors in one go (one exposed memory latency per 32 rows; H or
// 2H bytes each), parks the value row in the warp's shared-memory tile,
// scores the R query rows against the key, and the warp updates an online
// softmax in f32. Each lane then accumulates its H / 32 adjacent output
// dims from the tile and the probabilities. Pages hold a multiple of 32
// rows, so a warp's 32 rows never straddle a page. The last warp then
// folds in the fresh block (one fresh key per lane, T <= 32), and the four
// warps' (max, sum, acc) merge in shared memory (over the value tiles,
// which are dead by then). A slot whose position is 0 sees only the fresh
// block; parked lanes are given position 1 by the caller. Shared memory is
// dynamic: 48 KB at bf16, H = 128, R = 8 (the static limit is 48 KB).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_leave.cuh"

namespace gabby_flash {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // cache rows per warp iteration
constexpr int kMaxT = 32;   // fresh rows: one per lane of one warp
constexpr float kNegInf = -1e30f;

// Bytes of one kv head's cache row: int8 codes or bf16 values.
template <int H, bool kQuant>
__host__ __device__ constexpr int row_bytes() {
  return kQuant ? H : 2 * H;
}

// Where the cache rows of one layer live. Dense: k/v/ks/vs point at the
// layer's [B, Nk, rows, H] rows and [B, Nk, rows] scales (layers = 1,
// layer = 0). Paged: they point at the pools [P, L, Nk, rows, H] and
// [P, L, Nk, rows], `rows` is the page size, and table is [B, max_pages].
// pair = 1: the rows are [.., Nk/2, rows, 2H]; the scales keep Nk planes.
// A bf16 cache has no scales (ks = vs = NULL).
struct KvSource {
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* table;
  int rows;
  int max_pages;
  int layers;
  int layer;
  int pair;
};

// Where 32 consecutive cache rows of one kv head start: `code` is the byte
// offset of the first row, `stride` the bytes from one row to the next,
// `scale` the index of the first row's scale.
struct RowAddr {
  size_t code;
  size_t scale;
  int stride;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Address of cache row j0 of (slot b, head kh); rows j0 .. j0 + 31 follow
// it (j0 % 32 == 0, and a page holds a multiple of 32 rows). kRowBytes is
// one head's row.
template <bool kPaged, int kRowBytes>
__device__ __forceinline__ RowAddr chunk_row(const KvSource& src, int b,
                                             int kh, int Nk, int j0) {
  size_t lead = b;  // (slot), or (physical page, layer)
  int j = j0;
  if (kPaged) {
    const int phys = src.table[(size_t)b * src.max_pages + j0 / src.rows];
    lead = (size_t)phys * src.layers + src.layer;
    j = j0 % src.rows;
  }
  RowAddr a;
  a.scale = (lead * Nk + kh) * src.rows + j;
  a.stride = kRowBytes << src.pair;
  a.code = ((lead * (Nk >> src.pair) + (kh >> src.pair)) * src.rows + j) *
               a.stride +
           (src.pair ? (kh & 1) * kRowBytes : 0);
  return a;
}

// The D = H / 32 adjacent dims [D * lane, D * lane + D) of one row (int8
// codes or bf16 values) as f32.
template <int D, bool kQuant>
__device__ __forceinline__ void lane_dims(const uint8_t* row, int lane,
                                          float (&v)[D]) {
  if constexpr (kQuant) {
    if constexpr (D == 2) {
      const char2 c = *reinterpret_cast<const char2*>(row + 2 * lane);
      v[0] = (float)c.x;
      v[1] = (float)c.y;
    } else {
      const char4 c = *reinterpret_cast<const char4*>(row + 4 * lane);
      v[0] = (float)c.x;
      v[1] = (float)c.y;
      v[2] = (float)c.z;
      v[3] = (float)c.w;
    }
  } else {
    const __nv_bfloat162* p =
        reinterpret_cast<const __nv_bfloat162*>(row) + (D / 2) * lane;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// s[r] += q_s[r] . row for 16 bytes of a row starting at dim d0 (16 int8
// codes, or 8 bf16 values).
template <int R, int H, bool kQuant>
__device__ __forceinline__ void score_vec(const float (*q_s)[H], uint4 w,
                                          int d0, float (&s)[R]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  if constexpr (kQuant) {
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        // sign-extend byte bb of the word
        const float kv = (float)((int)(words[q4] << (24 - 8 * bb)) >> 24);
        const int d = d0 + q4 * 4 + bb;
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = fmaf(q_s[r][d], kv, s[r]);
      }
    }
  } else {
#pragma unroll
    for (int q2 = 0; q2 < 4; ++q2) {
      // a bf16 is the high half of an f32
      const float lo = __uint_as_float(words[q2] << 16);
      const float hi = __uint_as_float(words[q2] & 0xffff0000u);
      const int d = d0 + q2 * 2;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = fmaf(q_s[r][d], lo, s[r]);
        s[r] = fmaf(q_s[r][d + 1], hi, s[r]);
      }
    }
  }
}

// One online-softmax step of a warp over its 32 keys: s[r] is this lane's
// score of query row r (used where ok[r]). Leaves in pw[r] the probability
// the value product takes: p * w (w the value row's scale, or 1), or with
// kRound p rounded to bf16.
template <int R, int D, bool kRound>
__device__ __forceinline__ void softmax_step(const float (&s)[R],
                                             const bool (&ok)[R], float w,
                                             float (&m)[R], float (&l)[R],
                                             float (&acc)[R][D],
                                             float (&pw)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float sr = ok[r] ? s[r] : kNegInf;
    const float m_new = fmaxf(m[r], warp_max(sr));
    const float alpha = __expf(m[r] - m_new);
    const float p = ok[r] ? __expf(sr - m_new) : 0.f;
    l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[r][d] *= alpha;
    m[r] = m_new;
    pw[r] = kRound ? round_bf16(p) : p * w;
  }
}

template <int R, int H, bool kQuant>
struct RowsSmem {
  union {
    // each warp's 32 value rows, then (after the loop) its partial outputs
    __align__(16) uint8_t v_s[kWarps][kChunk][row_bytes<H, kQuant>()];
    float acc_s[kWarps][R][H];
  } u;
  __align__(16) float q_s[R][H];
  __align__(16) float p_s[kWarps][R][kChunk];
  __align__(16) __nv_bfloat16 fv_s[kMaxT][H];
  float m_s[kWarps][R], l_s[kWarps][R];
  int t_s[R];  // query position of each row, -1 past the tile's end
};

template <int R, bool kPaged, int H, bool kQuant>
__global__ void __launch_bounds__(kThreads)
flash_rows_kernel(const __nv_bfloat16* __restrict__ q, const KvSource src,
                  const __nv_bfloat16* __restrict__ fk,
                  const __nv_bfloat16* __restrict__ fv,
                  const int* __restrict__ positions,
                  __nv_bfloat16* __restrict__ out, int T, int Nq, int Nk,
                  int limit, float sm_scale) {
  constexpr int kD = H / 32;  // output dims a lane owns
  constexpr int kRowBytes = row_bytes<H, kQuant>();
  constexpr int kVecs = kRowBytes / 16;  // 16-byte vectors of a row
  constexpr int kDimsPerVec = kQuant ? 16 : 8;
  extern __shared__ __align__(16) unsigned char flash_rows_smem[];
  RowsSmem<R, H, kQuant>& sm =
      *reinterpret_cast<RowsSmem<R, H, kQuant>*>(flash_rows_smem);

  const int b = blockIdx.x, kh = blockIdx.y, row0 = blockIdx.z * R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = Nq / Nk, total = T * G;
  const size_t plane = (size_t)b * Nk + kh;

  for (int e = tid; e < R * H; e += kThreads) {
    const int r = e / H, d = e % H, idx = row0 + r;
    float val = 0.f;
    if (idx < total) {
      const int t = idx / G, g = idx % G;
      val = __bfloat162float(
                q[(((size_t)b * T + t) * Nq + kh * G + g) * H + d]) *
            sm_scale;
    }
    sm.q_s[r][d] = val;
  }
  if (tid < R) sm.t_s[tid] = row0 + tid < total ? (row0 + tid) / G : -1;
  for (int e = tid; e < T * H; e += kThreads)
    sm.fv_s[e / H][e % H] = fv[plane * T * H + e];
  __syncthreads();

  const int capacity = kPaged ? src.rows * src.max_pages : src.rows;
  const int n = max(0, min(min(positions[b], limit), capacity));

  float m[R], l[R], acc[R][kD];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[r][d] = 0.f;
  }

  uint4* vdst = reinterpret_cast<uint4*>(&sm.u.v_s[warp][lane][0]);
  for (int j0 = warp * kChunk; j0 < n; j0 += kWarps * kChunk) {
    const bool valid = j0 + lane < n;
    float s[R], pw[R];
    bool ok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = 0.f;
      ok[r] = valid;
    }
    float vscale = 1.f;
    uint4 vrow[kVecs];
#pragma unroll
    for (int v4 = 0; v4 < kVecs; ++v4) vrow[v4] = make_uint4(0, 0, 0, 0);
    if (valid) {
      const RowAddr at = chunk_row<kPaged, kRowBytes>(src, b, kh, Nk, j0);
      const size_t code = at.code + (size_t)lane * at.stride;
      const uint4* kp = reinterpret_cast<const uint4*>(
          static_cast<const uint8_t*>(src.k) + code);
      const uint4* vp = reinterpret_cast<const uint4*>(
          static_cast<const uint8_t*>(src.v) + code);
      uint4 krow[kVecs];
#pragma unroll
      for (int v4 = 0; v4 < kVecs; ++v4) {
        krow[v4] = kp[v4];
        vrow[v4] = vp[v4];
      }
      float kscale = 1.f;
      if constexpr (kQuant) {
        const size_t row = at.scale + lane;
        kscale = src.ks[row];
        vscale = src.vs[row];
      }
#pragma unroll
      for (int v4 = 0; v4 < kVecs; ++v4)
        score_vec<R, H, kQuant>(sm.q_s, krow[v4], v4 * kDimsPerVec, s);
      if constexpr (kQuant) {
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] *= kscale;
      }
    }
    softmax_step<R, kD, !kQuant>(s, ok, vscale, m, l, acc, pw);
#pragma unroll
    for (int v4 = 0; v4 < kVecs; ++v4) vdst[v4] = vrow[v4];
#pragma unroll
    for (int r = 0; r < R; ++r) sm.p_s[warp][r][lane] = pw[r];
    __syncwarp();
#pragma unroll 8
    for (int jj = 0; jj < kChunk; ++jj) {
      float vv[kD];
      lane_dims<kD, kQuant>(&sm.u.v_s[warp][jj][0], lane, vv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pr = sm.p_s[warp][r][jj];
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[r][d] = fmaf(pr, vv[d], acc[r][d]);
      }
    }
    __syncwarp();  // the tile is rewritten by the next iteration
  }

  if (warp == kWarps - 1) {
    // the fresh block: lane j scores fresh key j; row r sees keys j <= t_s[r]
    const bool valid = lane < T;
    float s[R], pw[R];
    bool ok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = 0.f;
      ok[r] = valid && lane <= sm.t_s[r];
    }
    if (valid) {
      const uint4* kp =
          reinterpret_cast<const uint4*>(fk + (plane * T + lane) * H);
#pragma unroll
      for (int v8 = 0; v8 < H / 8; ++v8)
        score_vec<R, H, false>(sm.q_s, kp[v8], v8 * 8, s);
    }
    softmax_step<R, kD, false>(s, ok, 1.f, m, l, acc, pw);
#pragma unroll
    for (int r = 0; r < R; ++r) sm.p_s[warp][r][lane] = pw[r];
    __syncwarp();
    for (int jj = 0; jj < T; ++jj) {
      float vv[kD];
      lane_dims<kD, false>(reinterpret_cast<const uint8_t*>(&sm.fv_s[jj][0]),
                           lane, vv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pr = sm.p_s[warp][r][jj];
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[r][d] = fmaf(pr, vv[d], acc[r][d]);
      }
    }
  }
  __syncthreads();  // every warp is done with its value tile

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      sm.m_s[warp][r] = m[r];
      sm.l_s[warp][r] = l[r];
    }
#pragma unroll
    for (int d = 0; d < kD; ++d)
      sm.u.acc_s[warp][r][kD * lane + d] = acc[r][d];
  }
  __syncthreads();

  for (int e = tid; e < R * H; e += kThreads) {
    const int r = e / H, d = e % H, idx = row0 + r;
    if (idx >= total) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm.m_s[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(sm.m_s[w][r] - mx);
      den += sm.l_s[w][r] * c;
      num += sm.u.acc_s[w][r][d] * c;
    }
    const int t = idx / G, g = idx % G;
    out[(((size_t)b * T + t) * Nq + kh * G + g) * H + d] =
        __float2bfloat16(num / den);
  }
}

template <int R, bool kPaged, int H, bool kQuant>
int launch_rows(const void* q, const KvSource& src, const void* fk,
                const void* fv, const void* pos, void* out, int B, int T,
                int Nq, int Nk, int limit, float sm_scale,
                cudaStream_t stream) {
  static gabby_smem::SmemLeave leave;
  constexpr int bytes = (int)sizeof(RowsSmem<R, H, kQuant>);
  const cudaError_t err =
      leave.raise(flash_rows_kernel<R, kPaged, H, kQuant>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (T * (Nq / Nk) + R - 1) / R;
  flash_rows_kernel<R, kPaged, H, kQuant>
      <<<dim3(B, Nk, tiles), kThreads, bytes, stream>>>(
          static_cast<const __nv_bfloat16*>(q), src,
          static_cast<const __nv_bfloat16*>(fk),
          static_cast<const __nv_bfloat16*>(fv),
          static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), T,
          Nq, Nk, limit, sm_scale);
  return (int)cudaGetLastError();
}

// Picks the row tile: T * G rows when that is 2 or 4 (or 3, in a tile of
// 4), else tiles of 8 (T >= 2, so T * G >= 2).
template <bool kPaged, int H, bool kQuant>
int launch_tiles(const void* q, const KvSource& src, const void* fk,
                 const void* fv, const void* pos, void* out, int B, int T,
                 int Nq, int Nk, int limit, float sm_scale,
                 cudaStream_t stream) {
  const int total = T * (Nq / Nk);
  if (total == 2)
    return launch_rows<2, kPaged, H, kQuant>(q, src, fk, fv, pos, out, B, T,
                                             Nq, Nk, limit, sm_scale, stream);
  if (total <= 4)
    return launch_rows<4, kPaged, H, kQuant>(q, src, fk, fv, pos, out, B, T,
                                             Nq, Nk, limit, sm_scale, stream);
  return launch_rows<8, kPaged, H, kQuant>(q, src, fk, fv, pos, out, B, T,
                                           Nq, Nk, limit, sm_scale, stream);
}

// q [B, T, Nq, H] bf16, 2 <= T <= 32; fresh_k/v [B, Nk, T, H] bf16;
// positions [B] int32; out [B, T, Nq, H] bf16; H 64 or 128; the cache int8
// with scales (kQuant) or bf16 without.
template <bool kPaged, bool kQuant>
int launch_flash_rows(const void* q, const KvSource& src, const void* fk,
                      const void* fv, const void* pos, void* out, int B, int T,
                      int Nq, int Nk, int H, int limit, float sm_scale,
                      cudaStream_t stream) {
  if (Nk < 1 || Nq % Nk != 0 || T < 2 || T > kMaxT || B < 1 ||
      (src.pair != 0 && src.pair != 1) || (src.pair && Nk % 2) ||
      (kQuant != (src.ks != nullptr && src.vs != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (H == 64)
    return launch_tiles<kPaged, 64, kQuant>(q, src, fk, fv, pos, out, B, T,
                                            Nq, Nk, limit, sm_scale, stream);
  if (H == 128)
    return launch_tiles<kPaged, 128, kQuant>(q, src, fk, fv, pos, out, B, T,
                                             Nq, Nk, limit, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gabby_flash
