// GQA flash-decode attention over the unpaired dense KV cache, Hopper
// (sm_90a): K3 over an int8 cache, and the slot-batched launch K16 (int8)
// and K32 (bf16).
//
// Replaces gabby_tpu/ops/pallas/attention.py:_decode_call (its
// _flash_step body, reached from decode_attention) in the form the
// serving path uses: unpaired cache, one query position (tq = 1), int8
// codes with per-(token, kv-head) f32 scales, and the current token's
// unquantized k/v folded in last as an always-attended extra row. It reads
// cache rows j < min(pos[b], limit) of one layer; the k scale folds into
// the scores and the v scale into the probabilities, so no dequantized
// plane is ever written.
//
// The slot-batched launch replaces _decode_call_multi of the same file (the
// same function, SB slots per grid step, chosen by GABBY_ATTN_MULTI=1),
// over an int8 cache (K16) and in its k_scale=None form over a bf16 cache
// (K32): there the rows are read as they are, the scores take sm_scale
// alone and p is rounded to bf16 before the value product, as the
// reference's `pv.astype(bfloat16)`.
//
// What bounds it on the H100: bytes. A (slot, kv head) streams 2 * n * H
// code bytes plus 2 * n * 4 scale bytes (int8), or 2 * n * 2H bytes
// (bf16), for n live rows; at 8 slots x 8 kv heads x 1024 rows x H = 64
// that is ~9.4 MB (int8) or ~16.8 MB (bf16) per layer, 2.8 or 5 us at
// 3.35 TB/s. The arithmetic (G query rows x H x 2 FMAs per row) is far
// below the byte rate.
//
// Design: one block per (slot, kv head), 4 warps. The loop runs to the
// slot's own position, not to max_seq (this replaces the TPU kernel's
// chunk clamp). Each warp takes 32 rows at a time, one row per lane: the
// lane reads its key row as 16-byte vectors and scores all G query heads
// of the group against it, then the warp updates an online softmax in f32
// and accumulates p * v, each lane owning H / 32 adjacent output dims. The
// four warps' partial (max, sum, acc) merge in shared memory together with
// the fresh row. A slot whose position is 0 sees only the fresh row;
// parked lanes are given position 1 by the caller. head_dim H is 64 or 128
// and G any of 1, 2, 3, 4, 8 (one instantiation each).
//
// The slot-batched launch: one block of SB * 128 threads takes SB slots of
// a kv head, four warps a slot, each slot's loop ending at its own
// position. The TPU form exists to spread a grid step's fixed cost over
// more slots; here it only makes the blocks larger and fewer, and every
// slot's arithmetic is the single-slot body's, bit for bit. A slot's
// shared state is 10.3 KB at H = 64 and 20.6 KB at H = 128 (G = 8), so a
// block takes at most 4 slots at H = 64 and 2 at H = 128, inside the 48 KB
// static shared-memory limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// slots per block of the slot-batched launch, at most
template <int H>
__host__ __device__ constexpr int max_slots() {
  return H == 64 ? 4 : 2;
}

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

// One slot's shared state: its four warps' partial results.
template <int G, int H>
struct SlotShared {
  float q_s[G][H];
  float m_s[kWarps][G], l_s[kWarps][G];
  float acc_s[kWarps][G][H];
  float fresh_s[G];
};

// Slot b, kv head kh, by the 128 threads tid = 0..127 that own the slot.
// Every thread of the block calls it: its two barriers are block-wide.
// kQuant: int8 codes with scales ks/vs; else bf16 rows and no scales.
template <int G, int H, bool kQuant>
__device__ __forceinline__ void decode_slot(
    SlotShared<G, H>& sh, int b, int kh, int tid,
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kc,
    const void* __restrict__ vc, const float* __restrict__ ks,
    const float* __restrict__ vs, const __nv_bfloat16* __restrict__ fk,
    const __nv_bfloat16* __restrict__ fv, const int* __restrict__ positions,
    __nv_bfloat16* __restrict__ out, int Nq, int Nk, int S, int limit,
    float sm_scale) {
  constexpr int kD = H / 32;                     // output dims a lane owns
  constexpr int kRowBytes = kQuant ? H : 2 * H;  // one cache row
  float (&q_s)[G][H] = sh.q_s;
  float (&m_s)[kWarps][G] = sh.m_s;
  float (&l_s)[kWarps][G] = sh.l_s;
  float (&acc_s)[kWarps][G][H] = sh.acc_s;
  float (&fresh_s)[G] = sh.fresh_s;
  const int warp = tid / 32, lane = tid % 32;
  for (int e = tid; e < G * H; e += kThreads) {
    const int g = e / H, d = e % H;
    q_s[g][d] = __bfloat162float(q[((size_t)b * Nq + kh * G + g) * H + d]) *
                sm_scale;
  }
  __syncthreads();

  const int n = max(0, min(min(positions[b], limit), S));
  const size_t plane = (size_t)b * Nk + kh;
  const uint8_t* kbase =
      static_cast<const uint8_t*>(kc) + plane * S * kRowBytes;
  const uint8_t* vbase =
      static_cast<const uint8_t*>(vc) + plane * S * kRowBytes;

  float m[G], l[G], acc[G][kD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[g][d] = 0.f;
  }

  for (int j0 = warp * 32; j0 < n; j0 += kWarps * 32) {
    const int j = j0 + lane;
    const bool valid = j < n;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    float vscale = 1.f;
    if (valid) {
      const int4* row =
          reinterpret_cast<const int4*>(kbase + (size_t)j * kRowBytes);
#pragma unroll
      for (int v4 = 0; v4 < kRowBytes / 16; ++v4) {
        const int4 w = row[v4];
        const uint32_t words[4] = {(uint32_t)w.x, (uint32_t)w.y, (uint32_t)w.z,
                                   (uint32_t)w.w};
        if constexpr (kQuant) {
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) {
              // sign-extend byte bb of the word
              const float kv =
                  (float)((int)(words[q4] << (24 - 8 * bb)) >> 24);
              const int d = v4 * 16 + q4 * 4 + bb;
#pragma unroll
              for (int g = 0; g < G; ++g) s[g] = fmaf(q_s[g][d], kv, s[g]);
            }
          }
        } else {
#pragma unroll
          for (int q2 = 0; q2 < 4; ++q2) {
            // a bf16 is the high half of an f32
            const float lo = __uint_as_float(words[q2] << 16);
            const float hi = __uint_as_float(words[q2] & 0xffff0000u);
            const int d = v4 * 8 + q2 * 2;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              s[g] = fmaf(q_s[g][d], lo, s[g]);
              s[g] = fmaf(q_s[g][d + 1], hi, s[g]);
            }
          }
        }
      }
      if constexpr (kQuant) {
        const float kscale = ks[plane * S + j];
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] *= kscale;
        vscale = vs[plane * S + j];
      }
    }
    float pv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sg = valid ? s[g] : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(sg));
      const float alpha = __expf(m[g] - m_new);
      const float p = valid ? __expf(sg - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p);
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[g][d] *= alpha;
      m[g] = m_new;
      pv[g] = kQuant ? p * vscale
                     : __bfloat162float(__float2bfloat16(p));
    }
    const int cnt = min(32, n - j0);
    for (int jj = 0; jj < cnt; ++jj) {
      const uint8_t* vrow = vbase + (size_t)(j0 + jj) * kRowBytes;
      float vv[kD];
      if constexpr (kQuant) {
        if constexpr (kD == 2) {
          const char2 c = *reinterpret_cast<const char2*>(vrow + 2 * lane);
          vv[0] = (float)c.x;
          vv[1] = (float)c.y;
        } else {
          const char4 c = *reinterpret_cast<const char4*>(vrow + 4 * lane);
          vv[0] = (float)c.x;
          vv[1] = (float)c.y;
          vv[2] = (float)c.z;
          vv[3] = (float)c.w;
        }
      } else {
        const __nv_bfloat162* p =
            reinterpret_cast<const __nv_bfloat162*>(vrow) + (kD / 2) * lane;
#pragma unroll
        for (int i = 0; i < kD / 2; ++i) {
          const float2 f = __bfloat1622float2(p[i]);
          vv[2 * i] = f.x;
          vv[2 * i + 1] = f.y;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pg = __shfl_sync(0xffffffffu, pv[g], jj);
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[g][d] = fmaf(pg, vv[d], acc[g][d]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int d = 0; d < kD; ++d) acc_s[warp][g][kD * lane + d] = acc[g][d];
  }
  // fresh-row scores: warp w scores query heads g = w, w + 4, ...
  const __nv_bfloat16* fkr = fk + plane * H;
  const __nv_bfloat16* fvr = fv + plane * H;
  for (int g = warp; g < G; g += kWarps) {
    float sdot = q_s[g][lane] * __bfloat162float(fkr[lane]);
#pragma unroll
    for (int i = 1; i < H / 32; ++i)
      sdot += q_s[g][lane + 32 * i] * __bfloat162float(fkr[lane + 32 * i]);
    sdot = warp_sum(sdot);
    if (lane == 0) fresh_s[g] = sdot;
  }
  __syncthreads();

  for (int e = tid; e < G * H; e += kThreads) {
    const int g = e / H, d = e % H;
    const float sf = fresh_s[g];
    float mx = sf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    const float pf = __expf(sf - mx);
    float den = pf;
    float num = pf * __bfloat162float(fvr[d]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(m_s[w][g] - mx);
      den += l_s[w][g] * c;
      num += acc_s[w][g][d] * c;
    }
    out[((size_t)b * Nq + kh * G + g) * H + d] = __float2bfloat16(num / den);
  }
}

template <int G, int H>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const void* __restrict__ kc,
                        const void* __restrict__ vc,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const __nv_bfloat16* __restrict__ fk,
                        const __nv_bfloat16* __restrict__ fv,
                        const int* __restrict__ positions,
                        __nv_bfloat16* __restrict__ out, int Nq, int Nk,
                        int S, int limit, float sm_scale) {
  __shared__ SlotShared<G, H> sh;
  decode_slot<G, H, true>(sh, blockIdx.x, blockIdx.y, threadIdx.x, q, kc, vc,
                          ks, vs, fk, fv, positions, out, Nq, Nk, S, limit,
                          sm_scale);
}

// blockDim.x = sb * 128: thread group i of 128 takes slot blockIdx.x * sb + i
template <int G, int H, bool kQuant>
__global__ void __launch_bounds__(kThreads * max_slots<H>())
decode_attention_multi_kernel(const __nv_bfloat16* __restrict__ q,
                              const void* __restrict__ kc,
                              const void* __restrict__ vc,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const __nv_bfloat16* __restrict__ fk,
                              const __nv_bfloat16* __restrict__ fv,
                              const int* __restrict__ positions,
                              __nv_bfloat16* __restrict__ out, int Nq, int Nk,
                              int S, int limit, float sm_scale) {
  __shared__ SlotShared<G, H> sh[max_slots<H>()];
  const int group = threadIdx.x / kThreads;
  decode_slot<G, H, kQuant>(
      sh[group], blockIdx.x * (blockDim.x / kThreads) + group, blockIdx.y,
      threadIdx.x % kThreads, q, kc, vc, ks, vs, fk, fv, positions, out, Nq,
      Nk, S, limit, sm_scale);
}

template <int G, int H, bool kQuant>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* fk, const void* fv, const void* pos,
           void* out, int B, int Nq, int Nk, int S, int limit, float sm_scale,
           int sb, cudaStream_t stream) {
  if (sb > max_slots<H>()) return (int)cudaErrorInvalidValue;
  const dim3 grid(B / sb, Nk);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const __nv_bfloat16* fkp = static_cast<const __nv_bfloat16*>(fk);
  const __nv_bfloat16* fvp = static_cast<const __nv_bfloat16*>(fv);
  const int* pp = static_cast<const int*>(pos);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if constexpr (kQuant) {
    if (sb == 1) {
      decode_attention_kernel<G, H><<<grid, kThreads, 0, stream>>>(
          qp, k, v, ksp, vsp, fkp, fvp, pp, op, Nq, Nk, S, limit, sm_scale);
      return (int)cudaGetLastError();
    }
  }
  if (sb < 2) return (int)cudaErrorInvalidValue;
  decode_attention_multi_kernel<G, H, kQuant>
      <<<grid, kThreads * sb, 0, stream>>>(qp, k, v, ksp, vsp, fkp, fvp, pp,
                                           op, Nq, Nk, S, limit, sm_scale);
  return (int)cudaGetLastError();
}

template <int H, bool kQuant>
int by_group(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* fk, const void* fv, const void* pos,
             void* out, int B, int Nq, int Nk, int S, int limit,
             float sm_scale, int sb, cudaStream_t s) {
  switch (Nq / Nk) {
    case 1: return launch<1, H, kQuant>(q, k, v, ks, vs, fk, fv, pos, out, B,
                                        Nq, Nk, S, limit, sm_scale, sb, s);
    case 2: return launch<2, H, kQuant>(q, k, v, ks, vs, fk, fv, pos, out, B,
                                        Nq, Nk, S, limit, sm_scale, sb, s);
    case 3: return launch<3, H, kQuant>(q, k, v, ks, vs, fk, fv, pos, out, B,
                                        Nq, Nk, S, limit, sm_scale, sb, s);
    case 4: return launch<4, H, kQuant>(q, k, v, ks, vs, fk, fv, pos, out, B,
                                        Nq, Nk, S, limit, sm_scale, sb, s);
    case 8: return launch<8, H, kQuant>(q, k, v, ks, vs, fk, fv, pos, out, B,
                                        Nq, Nk, S, limit, sm_scale, sb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kQuant>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* fk, const void* fv, const void* pos,
             void* out, int B, int Nq, int Nk, int S, int H, int limit,
             float sm_scale, int sb, cudaStream_t s) {
  if (Nk < 1 || Nq % Nk != 0 || sb < 1 || B % sb != 0 ||
      (kQuant && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (H == 64)
    return by_group<64, kQuant>(q, k, v, ks, vs, fk, fv, pos, out, B, Nq, Nk,
                                S, limit, sm_scale, sb, s);
  if (H == 128)
    return by_group<128, kQuant>(q, k, v, ks, vs, fk, fv, pos, out, B, Nq, Nk,
                                 S, limit, sm_scale, sb, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B, Nq, H] bf16 (H 64 or 128); k/v [B, Nk, S, H] int8 and k/v_scale
// [B, Nk, S] f32 of one layer (the caller offsets the pointers);
// fresh_k/v [B, Nk, H] bf16; positions [B] int32; out [B, Nq, H] bf16.
// Reads rows j < min(positions[b], limit).
int gabby_decode_attention(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const void* fresh_k, const void* fresh_v,
                           const void* positions, void* out, int B, int Nq,
                           int Nk, int S, int H, int limit, float sm_scale,
                           void* stream) {
  return dispatch<true>(q, k, v, k_scale, v_scale, fresh_k, fresh_v,
                        positions, out, B, Nq, Nk, S, H, limit, sm_scale, 1,
                        static_cast<cudaStream_t>(stream));
}

// The same call with `sb` slots of a kv head per block (sb in 2..4 at
// H = 64, 2 at H = 128; B a multiple of sb).
int gabby_decode_attention_multi(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* fresh_k, const void* fresh_v,
                                 const void* positions, void* out, int B,
                                 int Nq, int Nk, int S, int H, int limit,
                                 int sb, float sm_scale, void* stream) {
  if (sb < 2) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, k, v, k_scale, v_scale, fresh_k, fresh_v,
                        positions, out, B, Nq, Nk, S, H, limit, sm_scale, sb,
                        static_cast<cudaStream_t>(stream));
}

// The slot-batched launch over a bf16 cache: k/v [B, Nk, S, H] bf16 of one
// layer, no scales; everything else as gabby_decode_attention_multi.
int gabby_decode_attention_multi_bf16(const void* q, const void* k,
                                      const void* v, const void* fresh_k,
                                      const void* fresh_v,
                                      const void* positions, void* out, int B,
                                      int Nq, int Nk, int S, int H, int limit,
                                      int sb, float sm_scale, void* stream) {
  if (sb < 2) return (int)cudaErrorInvalidValue;
  return dispatch<false>(q, k, v, nullptr, nullptr, fresh_k, fresh_v,
                         positions, out, B, Nq, Nk, S, H, limit, sm_scale, sb,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
