// The decode layer's attention prologue at one position over the dense
// int8 KV cache, Hopper (sm_90a): K42, one launch a layer of
// models/llama.py decode_step in place of the eager chain from the fused
// q|k|v product to the attention call (two apply_rope calls, two
// quantize_kv calls, the paired reshape, four index_put row writes and
// the copies: about 70 host dispatches a layer).
//
// Replaces no TPU kernel: the reference's jnp prologue (gabby_tpu/ops/
// rope.py apply_rope, gabby_tpu/runtime/kv_cache.py quantize_kv, the rows
// gathered for one dynamic_update_slice after the layer scan) is fused by
// XLA. The port runs it eagerly, and on the card the host issuing those
// ops, not the device, set the pace of every decode step.
//
// In one launch, for every slot b of the batch:
//   * q and k heads are rotated as apply_rope does: in f32, f = pos *
//     inv_freq[i], then cos f and sin f, then x cos + rot(x) sin with
//     rot(x) = [-x_hi, x_lo], rounded to bf16. q lands in q [B, 1, Nq, H],
//     the rotated k in fresh_k [B, Nk, H]; v is copied to fresh_v [B, Nk,
//     H]: the fresh rows the decode attention folds in;
//   * the bf16 k and v rows are quantized as quantize_kv does, per head:
//     scale = max(amax|x| * (1/127), 1e-8), code = clamp(rint(x / scale),
//     -127, 127);
//   * the codes land in the cache's row min(pos, S - 1) of one layer
//     (unpaired [B, Nk, S, H], or paired [B, Nk/2, S, 2H] with kv head kh
//     at lanes (kh % 2) H of line kh / 2), the scales in [B, Nk, S].
//
// The bits are the eager chain's on the card: every product and sum is an
// explicit round-to-nearest intrinsic (nvcc would otherwise contract a *
// b + c into one FMA, which rounds once where the eager ops round twice);
// cosf, sinf and rintf are the precise library functions, which PyTorch's
// cos, sin and round kernels call; a division of a tensor by the Python
// scalar 127 is, on the card, a product by the f32 reciprocal (PyTorch's
// div_true_kernel_cuda), and a division by a tensor a true division.
//
// What bounds it on the H100: the launch. A step's layer reads the
// product's (Nq + 2 Nk) H bf16 values a slot and writes as many, plus 2 Nk
// H code bytes and 2 Nk scales: 1.7 MB at 64 slots of Mistral-7B's or
// SmolLM2-1.7B's heads, half a microsecond at 3.35 TB/s. The design keeps
// it one launch and one pass: a warp a (slot, head), each lane holding the
// 2 H / 64 rotation pairs (i, i + H/2) that it rotates together, the
// head's amax by warp shuffles, no shared memory and no second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // heads a block

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int H>
__global__ void __launch_bounds__(kWarps * 32)
decode_prologue_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const int* __restrict__ positions,
                       const float* __restrict__ inv_freq,
                       __nv_bfloat16* __restrict__ q_out,
                       __nv_bfloat16* __restrict__ k_out,
                       __nv_bfloat16* __restrict__ v_out,
                       int8_t* __restrict__ k_cache,
                       int8_t* __restrict__ v_cache,
                       float* __restrict__ k_scale,
                       float* __restrict__ v_scale, int nq, int nk, int s,
                       int pair) {
  constexpr int kHalf = H / 2;
  constexpr int kPer = kHalf / 32;  // rotation pairs a lane
  const int lane = threadIdx.x & 31;
  const int head = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (head >= nq + 2 * nk) return;

  const __nv_bfloat16* x = qkv + ((size_t)b * (nq + 2 * nk) + head) * H;
  float lo[kPer], hi[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    lo[i] = __bfloat162float(x[lane + 32 * i]);
    hi[i] = __bfloat162float(x[lane + 32 * i + kHalf]);
  }
  const int pos = positions[b];
  if (head < nq + nk) {
    const float p = (float)pos;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float f = __fmul_rn(p, inv_freq[lane + 32 * i]);
      const float c = cosf(f), sn = sinf(f);
      const float a = __fadd_rn(__fmul_rn(lo[i], c), __fmul_rn(-hi[i], sn));
      const float d = __fadd_rn(__fmul_rn(hi[i], c), __fmul_rn(lo[i], sn));
      lo[i] = round_bf16(a);
      hi[i] = round_bf16(d);
    }
  }
  __nv_bfloat16* out;
  int kh;
  if (head < nq) {
    out = q_out + ((size_t)b * nq + head) * H;
    kh = -1;
  } else if (head < nq + nk) {
    kh = head - nq;
    out = k_out + ((size_t)b * nk + kh) * H;
  } else {
    kh = head - nq - nk;
    out = v_out + ((size_t)b * nk + kh) * H;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    out[lane + 32 * i] = __float2bfloat16_rn(lo[i]);
    out[lane + 32 * i + kHalf] = __float2bfloat16_rn(hi[i]);
  }
  if (kh < 0) return;

  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    m = fmaxf(m, fmaxf(fabsf(lo[i]), fabsf(hi[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = fmaxf(__fmul_rn(m, 1.0f / 127.0f), (float)1e-8);
  const int row = min(max(pos, 0), s - 1);
  const bool is_k = head < nq + nk;
  int8_t* line = (is_k ? k_cache : v_cache) +
                 (pair ? ((size_t)b * (nk / 2) + kh / 2) * s * 2 * H +
                             (size_t)row * 2 * H + (kh & 1) * H
                       : ((size_t)b * nk + kh) * s * H + (size_t)row * H);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float c0 = fminf(fmaxf(rintf(__fdiv_rn(lo[i], scale)), -127.f),
                           127.f);
    const float c1 = fminf(fmaxf(rintf(__fdiv_rn(hi[i], scale)), -127.f),
                           127.f);
    line[lane + 32 * i] = (int8_t)(int)c0;
    line[lane + 32 * i + kHalf] = (int8_t)(int)c1;
  }
  if (lane == 0)
    (is_k ? k_scale : v_scale)[((size_t)b * nk + kh) * s + row] = scale;
}

}  // namespace

extern "C" {

// qkv [B, 1, (Nq + 2 Nk) H] bf16 (the fused product: q | k | v); positions
// [B] int32; inv_freq [H / 2] f32; q [B, 1, Nq, H], fresh_k and fresh_v
// [B, Nk, H] bf16 (written); k_cache, v_cache one layer's [B', Nk, S, H]
// int8 (pair 0) or [B', Nk / 2, S, 2H] (pair 1), B' >= B, and k_scale,
// v_scale [B', Nk, S] f32 (rows written). H 64 or 128.
int gabby_decode_prologue(const void* qkv, const void* positions,
                          const void* inv_freq, void* q, void* fresh_k,
                          void* fresh_v, void* k_cache, void* v_cache,
                          void* k_scale, void* v_scale, int B, int nq, int nk,
                          int S, int H, int pair, void* stream) {
  if (B < 1 || nq < 1 || nk < 1 || S < 1 || (pair && nk % 2) ||
      (H != 64 && H != 128))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + 2 * nk + kWarps - 1) / kWarps, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(qkv);
  const auto* pos = static_cast<const int*>(positions);
  const auto* inv = static_cast<const float*>(inv_freq);
  auto* qo = static_cast<__nv_bfloat16*>(q);
  auto* ko = static_cast<__nv_bfloat16*>(fresh_k);
  auto* vo = static_cast<__nv_bfloat16*>(fresh_v);
  auto* kc = static_cast<int8_t*>(k_cache);
  auto* vc = static_cast<int8_t*>(v_cache);
  auto* ks = static_cast<float*>(k_scale);
  auto* vs = static_cast<float*>(v_scale);
  if (H == 64)
    decode_prologue_kernel<64><<<grid, kWarps * 32, 0, st>>>(
        x, pos, inv, qo, ko, vo, kc, vc, ks, vs, nq, nk, S, pair);
  else
    decode_prologue_kernel<128><<<grid, kWarps * 32, 0, st>>>(
        x, pos, inv, qo, ko, vo, kc, vc, ks, vs, nq, nk, S, pair);
  return (int)cudaGetLastError();
}

}  // extern "C"
