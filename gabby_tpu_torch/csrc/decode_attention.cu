// GQA flash-decode attention over the int8 KV cache, Hopper (sm_90a): K3,
// and its slot-batched launch K16.
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
// What bounds it on the H100: bytes. A (slot, kv head) streams 2 * n * 64
// code bytes plus 2 * n * 4 scale bytes for n live rows; at 8 slots x 8 kv
// heads x 1024 rows that is ~9.4 MB per layer, ~2.8 us at 3.35 TB/s. The
// arithmetic (4 query rows x 64 x 2 FMAs per row) is far below the byte
// rate.
//
// Design: one block per (slot, kv head), 4 warps. The loop runs to the
// slot's own position, not to max_seq (this replaces the TPU kernel's
// chunk clamp). Each warp takes 32 rows at a time, one row per lane: the
// lane reads its 64-byte key row as four 16-byte vectors and scores all G
// query heads of the group against it, then the warp updates an online
// softmax in f32 and accumulates p * v_scale * v with each lane owning two
// of the 64 output dims. The four warps' partial (max, sum, acc) merge in
// shared memory together with the fresh row. A slot whose position is 0
// sees only the fresh row; parked lanes are given position 1 by the caller.
//
// The slot-batched launch replaces _decode_call_multi of the same file (the
// same function, SB slots per grid step, chosen by GABBY_ATTN_MULTI=1): one
// block of SB * 128 threads takes SB slots of a kv head, four warps a slot,
// each slot's loop ending at its own position. The TPU form exists to
// spread a grid step's fixed cost over more slots; here it only makes the
// blocks larger and fewer (SB <= 4 keeps a block at 512 threads and 42 KB
// of shared memory), and every slot's arithmetic is K3's, bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 64;  // head_dim
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 4;  // slots per block of the slot-batched launch
constexpr float kNegInf = -1e30f;

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
template <int G>
struct SlotShared {
  float q_s[G][kH];
  float m_s[kWarps][G], l_s[kWarps][G];
  float acc_s[kWarps][G][kH];
  float fresh_s[G];
};

// Slot b, kv head kh, by the 128 threads tid = 0..127 that own the slot.
// Every thread of the block calls it: its two barriers are block-wide.
template <int G>
__device__ __forceinline__ void decode_slot(
    SlotShared<G>& sh, int b, int kh, int tid,
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kc,
    const int8_t* __restrict__ vc, const float* __restrict__ ks,
    const float* __restrict__ vs, const __nv_bfloat16* __restrict__ fk,
    const __nv_bfloat16* __restrict__ fv, const int* __restrict__ positions,
    __nv_bfloat16* __restrict__ out, int Nq, int Nk, int S, int limit,
    float sm_scale) {
  float (&q_s)[G][kH] = sh.q_s;
  float (&m_s)[kWarps][G] = sh.m_s;
  float (&l_s)[kWarps][G] = sh.l_s;
  float (&acc_s)[kWarps][G][kH] = sh.acc_s;
  float (&fresh_s)[G] = sh.fresh_s;
  const int warp = tid / 32, lane = tid % 32;
  for (int e = tid; e < G * kH; e += kThreads) {
    const int g = e / kH, d = e % kH;
    q_s[g][d] = __bfloat162float(q[((size_t)b * Nq + kh * G + g) * kH + d]) *
                sm_scale;
  }
  __syncthreads();

  const int n = max(0, min(min(positions[b], limit), S));
  const size_t plane = (size_t)b * Nk + kh;
  const int8_t* kbase = kc + plane * S * kH;
  const int8_t* vbase = vc + plane * S * kH;
  const float* ksb = ks + plane * S;
  const float* vsb = vs + plane * S;

  float m[G], l[G], acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    acc[g][0] = acc[g][1] = 0.f;
  }

  for (int j0 = warp * 32; j0 < n; j0 += kWarps * 32) {
    const int j = j0 + lane;
    const bool valid = j < n;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    float vscale = 0.f;
    if (valid) {
      const int4* row = reinterpret_cast<const int4*>(kbase + (size_t)j * kH);
#pragma unroll
      for (int v4 = 0; v4 < kH / 16; ++v4) {
        const int4 w = row[v4];
        const uint32_t words[4] = {(uint32_t)w.x, (uint32_t)w.y, (uint32_t)w.z,
                                  (uint32_t)w.w};
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            // sign-extend byte bb of the word
            const float kv = (float)((int)(words[q4] << (24 - 8 * bb)) >> 24);
            const int d = v4 * 16 + q4 * 4 + bb;
#pragma unroll
            for (int g = 0; g < G; ++g) s[g] = fmaf(q_s[g][d], kv, s[g]);
          }
        }
      }
      const float kscale = ksb[j];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] *= kscale;
      vscale = vsb[j];
    }
    float pv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sg = valid ? s[g] : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(sg));
      const float alpha = __expf(m[g] - m_new);
      const float p = valid ? __expf(sg - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p);
      acc[g][0] *= alpha;
      acc[g][1] *= alpha;
      m[g] = m_new;
      pv[g] = p * vscale;
    }
    const int cnt = min(32, n - j0);
    for (int jj = 0; jj < cnt; ++jj) {
      const char2 vv = *reinterpret_cast<const char2*>(
          vbase + (size_t)(j0 + jj) * kH + 2 * lane);
      const float v0 = (float)vv.x, v1 = (float)vv.y;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pg = __shfl_sync(0xffffffffu, pv[g], jj);
        acc[g][0] = fmaf(pg, v0, acc[g][0]);
        acc[g][1] = fmaf(pg, v1, acc[g][1]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
    acc_s[warp][g][2 * lane] = acc[g][0];
    acc_s[warp][g][2 * lane + 1] = acc[g][1];
  }
  // fresh-row scores: warp w scores query heads g = w, w + 4, ...
  const __nv_bfloat16* fkr = fk + plane * kH;
  const __nv_bfloat16* fvr = fv + plane * kH;
  for (int g = warp; g < G; g += kWarps) {
    float sdot = q_s[g][lane] * __bfloat162float(fkr[lane]) +
                 q_s[g][lane + 32] * __bfloat162float(fkr[lane + 32]);
    sdot = warp_sum(sdot);
    if (lane == 0) fresh_s[g] = sdot;
  }
  __syncthreads();

  for (int e = tid; e < G * kH; e += kThreads) {
    const int g = e / kH, d = e % kH;
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
    out[((size_t)b * Nq + kh * G + g) * kH + d] = __float2bfloat16(num / den);
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const int8_t* __restrict__ kc,
                        const int8_t* __restrict__ vc,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const __nv_bfloat16* __restrict__ fk,
                        const __nv_bfloat16* __restrict__ fv,
                        const int* __restrict__ positions,
                        __nv_bfloat16* __restrict__ out, int Nq, int Nk,
                        int S, int limit, float sm_scale) {
  __shared__ SlotShared<G> sh;
  decode_slot<G>(sh, blockIdx.x, blockIdx.y, threadIdx.x, q, kc, vc, ks, vs,
                 fk, fv, positions, out, Nq, Nk, S, limit, sm_scale);
}

// blockDim.x = sb * 128: thread group i of 128 takes slot blockIdx.x * sb + i
template <int G>
__global__ void __launch_bounds__(kThreads * kMaxSlots)
decode_attention_multi_kernel(const __nv_bfloat16* __restrict__ q,
                              const int8_t* __restrict__ kc,
                              const int8_t* __restrict__ vc,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const __nv_bfloat16* __restrict__ fk,
                              const __nv_bfloat16* __restrict__ fv,
                              const int* __restrict__ positions,
                              __nv_bfloat16* __restrict__ out, int Nq, int Nk,
                              int S, int limit, float sm_scale) {
  __shared__ SlotShared<G> sh[kMaxSlots];
  const int group = threadIdx.x / kThreads;
  decode_slot<G>(sh[group], blockIdx.x * (blockDim.x / kThreads) + group,
                 blockIdx.y, threadIdx.x % kThreads, q, kc, vc, ks, vs, fk,
                 fv, positions, out, Nq, Nk, S, limit, sm_scale);
}

template <int G>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* fk, const void* fv, const void* pos,
           void* out, int B, int Nq, int Nk, int S, int limit, float sm_scale,
           int sb, cudaStream_t stream) {
  const dim3 grid(B / sb, Nk);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const int8_t* kp = static_cast<const int8_t*>(k);
  const int8_t* vp = static_cast<const int8_t*>(v);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const __nv_bfloat16* fkp = static_cast<const __nv_bfloat16*>(fk);
  const __nv_bfloat16* fvp = static_cast<const __nv_bfloat16*>(fv);
  const int* pp = static_cast<const int*>(pos);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if (sb == 1)
    decode_attention_kernel<G><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, ksp, vsp, fkp, fvp, pp, op, Nq, Nk, S, limit, sm_scale);
  else
    decode_attention_multi_kernel<G><<<grid, kThreads * sb, 0, stream>>>(
        qp, kp, vp, ksp, vsp, fkp, fvp, pp, op, Nq, Nk, S, limit, sm_scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* fk, const void* fv, const void* pos,
             void* out, int B, int Nq, int Nk, int S, int H, int limit,
             float sm_scale, int sb, cudaStream_t s) {
  if (H != kH || Nq % Nk != 0 || sb < 1 || sb > kMaxSlots || B % sb != 0)
    return (int)cudaErrorInvalidValue;
  switch (Nq / Nk) {
    case 1: return launch<1>(q, k, v, ks, vs, fk, fv, pos, out, B, Nq, Nk, S,
                             limit, sm_scale, sb, s);
    case 2: return launch<2>(q, k, v, ks, vs, fk, fv, pos, out, B, Nq, Nk, S,
                             limit, sm_scale, sb, s);
    case 4: return launch<4>(q, k, v, ks, vs, fk, fv, pos, out, B, Nq, Nk, S,
                             limit, sm_scale, sb, s);
    case 8: return launch<8>(q, k, v, ks, vs, fk, fv, pos, out, B, Nq, Nk, S,
                             limit, sm_scale, sb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, Nq, 64] bf16; k/v [B, Nk, S, 64] int8 and k/v_scale [B, Nk, S] f32
// of one layer (the caller offsets the pointers); fresh_k/v [B, Nk, 64]
// bf16; positions [B] int32; out [B, Nq, 64] bf16. Reads rows
// j < min(positions[b], limit).
int gabby_decode_attention(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const void* fresh_k, const void* fresh_v,
                           const void* positions, void* out, int B, int Nq,
                           int Nk, int S, int H, int limit, float sm_scale,
                           void* stream) {
  return dispatch(q, k, v, k_scale, v_scale, fresh_k, fresh_v, positions, out,
                  B, Nq, Nk, S, H, limit, sm_scale, 1,
                  static_cast<cudaStream_t>(stream));
}

// The same call with `sb` slots of a kv head per block (sb in 2..4, B a
// multiple of sb).
int gabby_decode_attention_multi(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* fresh_k, const void* fresh_v,
                                 const void* positions, void* out, int B,
                                 int Nq, int Nk, int S, int H, int limit,
                                 int sb, float sm_scale, void* stream) {
  if (sb < 2) return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, k_scale, v_scale, fresh_k, fresh_v, positions, out,
                  B, Nq, Nk, S, H, limit, sm_scale, sb,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
