// Speculative-verify attention over the dense int8 KV cache, Hopper
// (sm_90a): K9, and over the paired cache K13 (T > 1) and K12 (T = 1, the
// paired decode in its bf16/f32 form).
//
// Replaces gabby_tpu/ops/pallas/attention.py:_decode_call in its tq > 1
// form (reached from verify_attention) and in its pair=True form without
// s8 dots (tq = 1 from decode_attention, tq > 1 from verify_attention):
// the T candidate positions of every slot attend that slot's cache rows
// j < min(pos[b], limit) of one layer plus the block's own T unquantized
// k/v rows causally. The body, the paired addressing, what bounds it and
// its design are in flash_rows.cuh.

#include "flash_rows.cuh"

extern "C" {

// q [B, T, Nq, 64] bf16; k/v [B, Nk, S, 64] int8 (pair = 1:
// [B, Nk/2, S, 128]) and k/v_scale [B, Nk, S] f32 of one layer (the caller
// offsets the pointers); fresh_k/v [B, Nk, T, 64] bf16; positions [B]
// int32; out [B, T, Nq, 64] bf16.
int gabby_verify_attention(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const void* fresh_k, const void* fresh_v,
                           const void* positions, void* out, int B, int T,
                           int Nq, int Nk, int S, int H, int limit, int pair,
                           float sm_scale, void* stream) {
  gabby_flash::KvSource src;
  src.k = static_cast<const int8_t*>(k);
  src.v = static_cast<const int8_t*>(v);
  src.ks = static_cast<const float*>(k_scale);
  src.vs = static_cast<const float*>(v_scale);
  src.table = nullptr;
  src.rows = S;
  src.max_pages = 1;
  src.layers = 1;
  src.layer = 0;
  src.pair = pair;
  return gabby_flash::launch_flash_rows<false>(
      q, src, fresh_k, fresh_v, positions, out, B, T, Nq, Nk, H, limit,
      sm_scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
