// Flash attention of a small block of query rows over the int8 KV cache,
// dense or paged, unpaired or paired, Hopper (sm_90a). Shared body of
// verify_attention.cu (K9, K12, K13) and paged_attention.cu (K10, K11,
// K17, K18); attention_s8.cu shares its row addressing.
//
// Replaces the tq > 1 form of gabby_tpu/ops/pallas/attention.py:_decode_call
// and both forms of _paged_decode_call (their _flash_step body), and the
// pair=True forms of both: T query
// positions x G query heads of one kv head (row = t * G + g) attend cache
// rows j < min(pos[b], limit) of one layer, int8 codes with per-(token,
// kv-head) f32 scales folded into scores (k) and probabilities (v), and
// then the block's own T unquantized k/v rows causally (row (t, g) sees
// fresh keys t' <= t). T = 1 is the decode contract: one always-attended
// fresh row. In the paged form row j of slot b lives at
// pool[table[b, j / page], layer, kh, j % page]; the table is read here,
// nothing gathers the pool.
//
// The paired layout stores the codes of kv heads 2p and 2p + 1 side by
// side: a cache row is one 128-byte line, head 2p in bytes [0, 64), head
// 2p + 1 in bytes [64, 128), scales still per head. The TPU kernel pads the
// queries block-diagonally to fill a 128-deep matrix unit and throws half
// of each output row away; here a block still owns ONE kv head and reads
// its half of each line (two 32-byte sectors, so no byte is fetched in
// vain; the pair's other block finds the line's neighbourhood in L2). The
// arithmetic and its order are the unpaired kernel's, so the outputs are
// equal bit for bit on the same rows re-laid.
//
// What bounds it on the H100: bytes, as for the decode kernel. A (slot, kv
// head) streams 2 * n * 64 code bytes and 2 * n * 4 scale bytes for n live
// rows; the T * G <= 64 query rows add 4 * T * G * 64 FLOPs per cache row,
// far below the byte rate at the tensor-core peak. This first form does
// those products on the CUDA cores in f32.
//
// Design: one block per (slot, kv head, tile of R <= 8 query rows), 4
// warps; the tiles of one (slot, kv head) re-read its cache rows through
// L2. The loop runs to the slot's own position (this replaces the TPU
// kernel's chunk clamp and, paged, its clamped page index: table entries
// past the slot's rows are never read). A warp takes 32 cache rows at a
// time, one per lane: the lane loads its 64-byte key row and its 64-byte
// value row as 16-byte vectors in one go (one exposed memory latency per 32
// rows), scores the R query rows against the key, and the warp updates an
// online softmax in f32. Value rows and probabilities are staged in the
// warp's shared-memory tile, from which each lane accumulates its two of
// the 64 output dims. Pages hold a multiple of 32 rows, so a warp's 32
// rows never straddle a page. The last warp then folds in the fresh block
// (one fresh key per lane, T <= 32), and the four warps' (max, sum, acc)
// merge in shared memory. A slot whose position is 0 sees only the fresh
// block; parked lanes are given position 1 by the caller.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gabby_flash {

constexpr int kH = 64;  // head_dim
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // cache rows per warp iteration
constexpr int kMaxT = 32;   // fresh rows: one per lane of one warp
constexpr float kNegInf = -1e30f;

// Where the cache rows of one layer live. Dense: k/v/ks/vs point at the
// layer's [B, Nk, rows, 64] codes and [B, Nk, rows] scales (layers = 1,
// layer = 0). Paged: they point at the pools [P, L, Nk, rows, 64] and
// [P, L, Nk, rows], `rows` is the page size, and table is [B, max_pages].
// pair = 1: the codes are [.., Nk/2, rows, 128]; the scales keep Nk planes.
struct KvSource {
  const int8_t* k;
  const int8_t* v;
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
// offset of the first row's 64 codes, `stride` the bytes from one row's
// codes to the next row's, `scale` the index of the first row's scale.
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

// Address of cache row j0 of (slot b, head kh); rows j0 .. j0 + 31 follow
// it (j0 % 32 == 0, and a page holds a multiple of 32 rows).
template <bool kPaged>
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
  a.stride = kH << src.pair;
  a.code = ((lead * (Nk >> src.pair) + (kh >> src.pair)) * src.rows + j) *
               a.stride +
           (src.pair ? (kh & 1) * kH : 0);
  return a;
}

// One online-softmax step of a warp over its 32 keys: s[r] is this lane's
// score of query row r (used where ok[r]), w the weight folded into the
// stored probability (the value row's scale). Leaves p * w in pw[r].
template <int R>
__device__ __forceinline__ void softmax_step(const float (&s)[R],
                                             const bool (&ok)[R], float w,
                                             float (&m)[R], float (&l)[R],
                                             float (&acc)[R][2],
                                             float (&pw)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float sr = ok[r] ? s[r] : kNegInf;
    const float m_new = fmaxf(m[r], warp_max(sr));
    const float alpha = __expf(m[r] - m_new);
    const float p = ok[r] ? __expf(sr - m_new) : 0.f;
    l[r] = l[r] * alpha + warp_sum(p);
    acc[r][0] *= alpha;
    acc[r][1] *= alpha;
    m[r] = m_new;
    pw[r] = p * w;
  }
}

template <int R, bool kPaged>
__global__ void __launch_bounds__(kThreads)
flash_rows_kernel(const __nv_bfloat16* __restrict__ q, const KvSource src,
                  const __nv_bfloat16* __restrict__ fk,
                  const __nv_bfloat16* __restrict__ fv,
                  const int* __restrict__ positions,
                  __nv_bfloat16* __restrict__ out, int T, int Nq, int Nk,
                  int limit, float sm_scale) {
  __shared__ __align__(16) float q_s[R][kH];
  __shared__ int t_s[R];  // query position of each row, -1 past the tile's end
  __shared__ __align__(16) int8_t v_s[kWarps][kChunk][kH];
  __shared__ __align__(16) float p_s[kWarps][R][kChunk];
  __shared__ __align__(16) __nv_bfloat16 fv_s[kMaxT][kH];
  __shared__ float m_s[kWarps][R], l_s[kWarps][R];
  __shared__ float acc_s[kWarps][R][kH];

  const int b = blockIdx.x, kh = blockIdx.y, row0 = blockIdx.z * R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = Nq / Nk, total = T * G;
  const size_t plane = (size_t)b * Nk + kh;

  for (int e = tid; e < R * kH; e += kThreads) {
    const int r = e / kH, d = e % kH, idx = row0 + r;
    float val = 0.f;
    if (idx < total) {
      const int t = idx / G, g = idx % G;
      val = __bfloat162float(
                q[(((size_t)b * T + t) * Nq + kh * G + g) * kH + d]) *
            sm_scale;
    }
    q_s[r][d] = val;
  }
  if (tid < R) t_s[tid] = row0 + tid < total ? (row0 + tid) / G : -1;
  for (int e = tid; e < T * kH; e += kThreads)
    fv_s[e / kH][e % kH] = fv[plane * T * kH + e];
  __syncthreads();

  const int capacity = kPaged ? src.rows * src.max_pages : src.rows;
  const int n = max(0, min(min(positions[b], limit), capacity));

  float m[R], l[R], acc[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = 0.f;
  }

  for (int j0 = warp * kChunk; j0 < n; j0 += kWarps * kChunk) {
    const bool valid = j0 + lane < n;
    float s[R], pw[R];
    bool ok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = 0.f;
      ok[r] = valid;
    }
    float vscale = 0.f;
    int4 vrow[kH / 16];
#pragma unroll
    for (int v4 = 0; v4 < kH / 16; ++v4) vrow[v4] = make_int4(0, 0, 0, 0);
    if (valid) {
      const RowAddr at = chunk_row<kPaged>(src, b, kh, Nk, j0);
      const size_t code = at.code + (size_t)lane * at.stride;
      const size_t row = at.scale + lane;
      const int4* kp = reinterpret_cast<const int4*>(src.k + code);
      const int4* vp = reinterpret_cast<const int4*>(src.v + code);
      int4 krow[kH / 16];
#pragma unroll
      for (int v4 = 0; v4 < kH / 16; ++v4) {
        krow[v4] = kp[v4];
        vrow[v4] = vp[v4];
      }
      const float kscale = src.ks[row];
      vscale = src.vs[row];
#pragma unroll
      for (int v4 = 0; v4 < kH / 16; ++v4) {
        const uint32_t words[4] = {(uint32_t)krow[v4].x, (uint32_t)krow[v4].y,
                                   (uint32_t)krow[v4].z, (uint32_t)krow[v4].w};
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            // sign-extend byte bb of the word
            const float kv = (float)((int)(words[q4] << (24 - 8 * bb)) >> 24);
            const int d = v4 * 16 + q4 * 4 + bb;
#pragma unroll
            for (int r = 0; r < R; ++r) s[r] = fmaf(q_s[r][d], kv, s[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] *= kscale;
    }
    softmax_step<R>(s, ok, vscale, m, l, acc, pw);
    int4* vdst = reinterpret_cast<int4*>(&v_s[warp][lane][0]);
#pragma unroll
    for (int v4 = 0; v4 < kH / 16; ++v4) vdst[v4] = vrow[v4];
#pragma unroll
    for (int r = 0; r < R; ++r) p_s[warp][r][lane] = pw[r];
    __syncwarp();
#pragma unroll 8
    for (int jj = 0; jj < kChunk; ++jj) {
      const char2 vv =
          *reinterpret_cast<const char2*>(&v_s[warp][jj][2 * lane]);
      const float v0 = (float)vv.x, v1 = (float)vv.y;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pr = p_s[warp][r][jj];
        acc[r][0] = fmaf(pr, v0, acc[r][0]);
        acc[r][1] = fmaf(pr, v1, acc[r][1]);
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
      ok[r] = valid && lane <= t_s[r];
    }
    if (valid) {
      const uint4* kp =
          reinterpret_cast<const uint4*>(fk + (plane * T + lane) * kH);
#pragma unroll
      for (int v8 = 0; v8 < kH / 8; ++v8) {
        const uint4 w = kp[v8];
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int q2 = 0; q2 < 4; ++q2) {
          // a bf16 is the high half of an f32
          const float lo = __uint_as_float(words[q2] << 16);
          const float hi = __uint_as_float(words[q2] & 0xffff0000u);
          const int d = v8 * 8 + q2 * 2;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            s[r] = fmaf(q_s[r][d], lo, s[r]);
            s[r] = fmaf(q_s[r][d + 1], hi, s[r]);
          }
        }
      }
    }
    softmax_step<R>(s, ok, 1.f, m, l, acc, pw);
#pragma unroll
    for (int r = 0; r < R; ++r) p_s[warp][r][lane] = pw[r];
    __syncwarp();
    for (int jj = 0; jj < T; ++jj) {
      const float2 vv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&fv_s[jj][2 * lane]));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pr = p_s[warp][r][jj];
        acc[r][0] = fmaf(pr, vv.x, acc[r][0]);
        acc[r][1] = fmaf(pr, vv.y, acc[r][1]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
    acc_s[warp][r][2 * lane] = acc[r][0];
    acc_s[warp][r][2 * lane + 1] = acc[r][1];
  }
  __syncthreads();

  for (int e = tid; e < R * kH; e += kThreads) {
    const int r = e / kH, d = e % kH, idx = row0 + r;
    if (idx >= total) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(m_s[w][r] - mx);
      den += l_s[w][r] * c;
      num += acc_s[w][r][d] * c;
    }
    const int t = idx / G, g = idx % G;
    out[(((size_t)b * T + t) * Nq + kh * G + g) * kH + d] =
        __float2bfloat16(num / den);
  }
}

template <int R, bool kPaged>
int launch_rows(const void* q, const KvSource& src, const void* fk,
                const void* fv, const void* pos, void* out, int B, int T,
                int Nq, int Nk, int limit, float sm_scale,
                cudaStream_t stream) {
  const int tiles = (T * (Nq / Nk) + R - 1) / R;
  flash_rows_kernel<R, kPaged><<<dim3(B, Nk, tiles), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), src,
      static_cast<const __nv_bfloat16*>(fk),
      static_cast<const __nv_bfloat16*>(fv), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), T, Nq, Nk, limit, sm_scale);
  return (int)cudaGetLastError();
}

// q [B, T, Nq, 64] bf16; fresh_k/v [B, Nk, T, 64] bf16; positions [B]
// int32; out [B, T, Nq, 64] bf16. Picks the row tile: T * G rows when that
// is 1, 2 or 4, else tiles of 8.
template <bool kPaged>
int launch_flash_rows(const void* q, const KvSource& src, const void* fk,
                      const void* fv, const void* pos, void* out, int B, int T,
                      int Nq, int Nk, int H, int limit, float sm_scale,
                      cudaStream_t stream) {
  if (H != kH || Nk < 1 || Nq % Nk != 0 || T < 1 || T > kMaxT || B < 1 ||
      (src.pair != 0 && src.pair != 1) || (src.pair && Nk % 2))
    return (int)cudaErrorInvalidValue;
  const int total = T * (Nq / Nk);
  if (total == 1)
    return launch_rows<1, kPaged>(q, src, fk, fv, pos, out, B, T, Nq, Nk,
                                  limit, sm_scale, stream);
  if (total == 2)
    return launch_rows<2, kPaged>(q, src, fk, fv, pos, out, B, T, Nq, Nk,
                                  limit, sm_scale, stream);
  if (total <= 4)
    return launch_rows<4, kPaged>(q, src, fk, fv, pos, out, B, T, Nq, Nk,
                                  limit, sm_scale, stream);
  return launch_rows<8, kPaged>(q, src, fk, fv, pos, out, B, T, Nq, Nk, limit,
                                sm_scale, stream);
}

}  // namespace gabby_flash
