// Single-slot flash prefill attention over the int8 KV cache, Hopper
// (sm_90a): K4, and over the paired cache K21.
//
// Replaces gabby_tpu/ops/pallas/prefill_attention.py:_prefill_call (its
// _kernel body, reached from prefill_attention), unpaired and pair=True: the
// T queries of one slot's prompt chunk (global positions offset..offset+T-1)
// attend that slot's cache rows j < offset of one layer, with the int8
// k scale folded into the scores and the v scale into the probabilities,
// and then the chunk's own unquantized k/v causally (query t sees chunk
// keys t' <= t). The cache holds only earlier chunks while this runs; the
// caller writes the chunk's rows after the layer's attention. In the
// paired cache a row is one 128-byte line holding the codes of kv heads 2p
// and 2p + 1 side by side, scales still per head; the block of head
// 2p + h stages bytes [64 h, 64 h + 64) of each line, and everything after
// the staging is the unpaired kernel's, so the outputs are equal bit for
// bit on the same rows re-laid. (The reference adds a query-group grid axis
// to fit the paired form into the TPU compiler's memory limit; a block here
// owns one kv head either way and needs no such axis.) The fresh block
// arrives head-major in both layouts.
//
// What bounds it on the H100: operations. At T = 512, offset = 512, 32
// query heads and head_dim 64 a layer does 2 * 2 * 32 * 512 * 64 *
// (512 + 256.5) ~ 3.2 GFLOP of score and value products for ~1.1 MB of
// cache, queries and output; against 989 TFLOP/s of bf16 tensor-core rate
// that is ~3.3 us. This first form runs those products on the CUDA cores in
// f32 (67 TFLOP/s peak) from shared-memory tiles; tensor-core mma/wgmma
// tiles are the later fix.
//
// Design: the T * G query rows of one kv head (row = t * G + g) are cut
// into 64-row tiles; one block per (row tile, kv head), 128 threads, each
// thread owning a 4-row x 8-column register tile of the 64 x 64 score and
// output blocks. Keys stream in 64-row tiles: first the past cache rows
// (dequantized to f32 while staging into shared memory, scale folded in),
// then the fresh chunk keys up to the tile's last query position. An
// online softmax in f32 carries (max, sum, acc) across key tiles; the
// 64 KB of shared tiles needs dynamic shared memory above 48 KB
// (cudaFuncSetAttribute, set once a device).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kH = 64;        // head_dim
constexpr int kRows = 64;     // query rows per block
constexpr int kKeys = 64;     // keys per tile
constexpr int kThreads = 128;
constexpr int kTR = 4;        // rows per thread
constexpr int kTC = 8;        // columns (keys or dims) per thread
constexpr float kNegInf = -1e30f;

struct Tiles {
  float qt[kH][kRows];   // queries, transposed, pre-scaled by sm_scale
  float kt[kH][kKeys];   // keys, transposed, dequantized
  float v[kKeys][kH];    // values, dequantized
  float pt[kKeys][kRows];  // probabilities, transposed
};
constexpr size_t kSmemBytes = sizeof(Tiles);

__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const int8_t* __restrict__ kc,
                         const int8_t* __restrict__ vc,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const __nv_bfloat16* __restrict__ fk,
                         const __nv_bfloat16* __restrict__ fv,
                         __nv_bfloat16* __restrict__ out, int T, int Nq,
                         int Nk, int S, int offset, int pair,
                         float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles& sm = *reinterpret_cast<Tiles*>(smem_raw);
  const int G = Nq / Nk;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int rg = tid / (kKeys / kTC);  // 0..15: rows rg*4 .. rg*4+3
  const int cg = tid % (kKeys / kTC);  // 0..7: columns cg*8 .. cg*8+7
  const int total_rows = T * G;

  for (int e = tid; e < kRows * kH; e += kThreads) {
    const int r = e / kH, d = e % kH;
    const int flat = row0 + r;
    float val = 0.f;
    if (flat < total_rows) {
      const int t = flat / G, g = flat % G;
      val = __bfloat162float(q[((size_t)t * Nq + kh * G + g) * kH + d]) *
            sm_scale;
    }
    sm.qt[d][r] = val;
  }

  int t_row[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) t_row[i] = (row0 + rg * kTR + i) / G;
  const int t_last = min(T - 1, (row0 + kRows - 1) / G);

  float m[kTR], l[kTR], acc[kTR][kTC];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kTC; ++c) acc[i][c] = 0.f;
  }

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

  const int n_past = (offset + kKeys - 1) / kKeys;
  const int n_fresh = t_last / kKeys + 1;
  for (int tile = 0; tile < n_past + n_fresh; ++tile) {
    const bool past = tile < n_past;
    const int j0 = (past ? tile : tile - n_past) * kKeys;
    __syncthreads();  // previous tile's readers are done
    // stage: thread handles key c = e / kH's dims, 16 at a time
    for (int e = tid; e < kKeys * (kH / 16); e += kThreads) {
      const int c = e / (kH / 16), d0 = (e % (kH / 16)) * 16;
      const int j = j0 + c;
      float kv[16], vv[16];
      if (past && j < offset) {
        const int4 kw = *reinterpret_cast<const int4*>(
            kbase + (size_t)j * stride + d0);
        const int4 vw = *reinterpret_cast<const int4*>(
            vbase + (size_t)j * stride + d0);
        const float ksc = ksb[j], vsc = vsb[j];
        const uint32_t kwords[4] = {(uint32_t)kw.x, (uint32_t)kw.y,
                                    (uint32_t)kw.z, (uint32_t)kw.w};
        const uint32_t vwords[4] = {(uint32_t)vw.x, (uint32_t)vw.y,
                                    (uint32_t)vw.z, (uint32_t)vw.w};
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          const int sh = 24 - 8 * (x % 4);
          kv[x] = (float)((int)(kwords[x / 4] << sh) >> 24) * ksc;
          vv[x] = (float)((int)(vwords[x / 4] << sh) >> 24) * vsc;
        }
      } else if (!past && j < T) {
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          kv[x] = __bfloat162float(fkb[(size_t)j * kH + d0 + x]);
          vv[x] = __bfloat162float(fvb[(size_t)j * kH + d0 + x]);
        }
      } else {
#pragma unroll
        for (int x = 0; x < 16; ++x) kv[x] = vv[x] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        sm.kt[d0 + x][c] = kv[x];
        sm.v[c][d0 + x] = vv[x];
      }
    }
    __syncthreads();

    float s[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int c = 0; c < kTC; ++c) s[i][c] = 0.f;
    for (int d = 0; d < kH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&sm.qt[d][rg * kTR]);
      const float4 k0 = *reinterpret_cast<const float4*>(&sm.kt[d][cg * kTC]);
      const float4 k1 =
          *reinterpret_cast<const float4*>(&sm.kt[d][cg * kTC + 4]);
      const float qv[kTR] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[kTC] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int c = 0; c < kTC; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // mask, then the online-softmax update; a row's 64 scores live in the
    // 8 consecutive lanes that share rg
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int j = j0 + cg * kTC + c;
        const bool ok = past ? (j < offset) : (j <= t_row[i]);
        s[i][c] = ok ? s[i][c] : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const float p = s[i][c] > 0.5f * kNegInf ? __expf(s[i][c] - m_new)
                                                 : 0.f;
        sm.pt[cg * kTC + c][rg * kTR + i] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kTC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kKeys; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&sm.pt[c][rg * kTR]);
      const float4 v0 = *reinterpret_cast<const float4*>(&sm.v[c][cg * kTC]);
      const float4 v1 =
          *reinterpret_cast<const float4*>(&sm.v[c][cg * kTC + 4]);
      const float pv[kTR] = {pa.x, pa.y, pa.z, pa.w};
      const float vv[kTC] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int d = 0; d < kTC; ++d) acc[i][d] = fmaf(pv[i], vv[d], acc[i][d]);
    }
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int flat = row0 + rg * kTR + i;
    if (flat >= total_rows) continue;
    const int t = flat / G, g = flat % G;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* o = out + ((size_t)t * Nq + kh * G + g) * kH + cg * kTC;
#pragma unroll
    for (int d = 0; d < kTC; ++d) o[d] = __float2bfloat16(acc[i][d] * inv);
  }
}

}  // namespace

extern "C" {

// q [T, Nq, 64] bf16; k/v [Nk, S, 64] int8 (pair = 1: [Nk/2, S, 128]) and
// k/v_scale [Nk, S] f32 of one (layer, slot) cache row (the caller offsets
// the pointers); fresh_k/v [Nk, T, 64] bf16; out [T, Nq, 64] bf16. Reads
// cache rows j < offset.
int gabby_prefill_attention(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* fresh_k, const void* fresh_v,
                            void* out, int T, int Nq, int Nk, int S, int H,
                            int offset, int pair, float sm_scale,
                            void* stream) {
  if (H != kH || Nq % Nk != 0 || offset > S || (pair != 0 && pair != 1) ||
      (pair && Nk % 2))
    return (int)cudaErrorInvalidValue;
  {
    // the leave to take 64 KB holds per device; set under a lock, so calls
    // may come from several threads and go to several devices
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
  dim3 grid((rows + kRows - 1) / kRows, Nk);
  prefill_attention_kernel<<<grid, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(fresh_k),
      static_cast<const __nv_bfloat16*>(fresh_v),
      static_cast<__nv_bfloat16*>(out), T, Nq, Nk, S, offset, pair,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
