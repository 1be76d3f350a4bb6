// Speculative-verify attention over the dense KV cache, Hopper (sm_90a), on
// the shared row body of flash_rows.cuh (head_dim 64 or 128):
//   int8 cache: K9 (unpaired) and K13 (paired);
//   bf16 cache: K26 (unpaired) and K27 (paired).
//
// Replaces gabby_tpu/ops/pallas/attention.py:_decode_call without s8 dots
// at tq > 1 (reached from verify_attention), unpaired, pair=True and in its
// k_scale=None form over a bf16 cache: the T candidate positions of every
// slot attend that slot's cache rows j < min(pos[b], limit) of one layer
// plus the block's own T unquantized k/v rows causally. T = 1, the decode
// contract, is refused: decode_attention.cu serves it. The body, the
// paired addressing, what bounds it and its design are in flash_rows.cuh.

#include "flash_rows.cuh"

namespace {

gabby_flash::KvSource dense_source(const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   int S, int pair) {
  gabby_flash::KvSource src;
  src.k = k;
  src.v = v;
  src.ks = static_cast<const float*>(k_scale);
  src.vs = static_cast<const float*>(v_scale);
  src.table = nullptr;
  src.rows = S;
  src.max_pages = 1;
  src.layers = 1;
  src.layer = 0;
  src.pair = pair;
  return src;
}

}  // namespace

extern "C" {

// q [B, T, Nq, H] bf16, 2 <= T <= 32; k/v [B, Nk, S, H] int8 (pair = 1:
// [B, Nk/2, S, 2H]) and k/v_scale [B, Nk, S] f32 of one layer (the caller
// offsets the pointers); fresh_k/v [B, Nk, T, H] bf16; positions [B]
// int32; out [B, T, Nq, H] bf16; H 64 or 128.
int gabby_verify_attention(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const void* fresh_k, const void* fresh_v,
                           const void* positions, void* out, int B, int T,
                           int Nq, int Nk, int S, int H, int limit, int pair,
                           float sm_scale, void* stream) {
  return gabby_flash::launch_flash_rows<false, true>(
      q, dense_source(k, v, k_scale, v_scale, S, pair), fresh_k, fresh_v,
      positions, out, B, T, Nq, Nk, H, limit, sm_scale,
      static_cast<cudaStream_t>(stream));
}

// The same over a bf16 cache: k/v [B, Nk, S, H] bf16 (pair = 1:
// [B, Nk/2, S, 2H]) of one layer, no scales.
int gabby_verify_attention_bf16(const void* q, const void* k, const void* v,
                                const void* fresh_k, const void* fresh_v,
                                const void* positions, void* out, int B,
                                int T, int Nq, int Nk, int S, int H,
                                int limit, int pair, float sm_scale,
                                void* stream) {
  return gabby_flash::launch_flash_rows<false, false>(
      q, dense_source(k, v, nullptr, nullptr, S, pair), fresh_k, fresh_v,
      positions, out, B, T, Nq, Nk, H, limit, sm_scale,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
