// Speculative-verify attention over the paged KV pool, Hopper (sm_90a), on
// the shared row body of flash_rows.cuh (head_dim 64 or 128):
//   int8 pool: K11 (unpaired) and K18 (paired);
//   bf16 pool: K30 (unpaired) and K31 (paired).
//
// Replaces gabby_tpu/ops/pallas/attention.py:_paged_decode_call at tq > 1
// (reached from paged_verify_attention), unpaired and pair=True, with
// scales and in its k_scale=None form: the dense verify contract, with row
// j of slot b read from pool[table[b, j / page], layer, kh, j % page]. The
// page table is read inside the kernel, so nothing gathers the pool; the
// loop ends at the slot's own position, so table entries past its rows are
// never read. T = 1 (paged_decode_attention) is refused:
// decode_attention.cu serves it. The body, what bounds it and its design
// are in flash_rows.cuh.

#include "flash_rows.cuh"

namespace {

int paged(const void* q, const void* k, const void* v, const void* k_scale,
          const void* v_scale, const void* table, const void* fresh_k,
          const void* fresh_v, const void* positions, void* out, int B, int T,
          int Nq, int Nk, int L, int layer, int page, int max_pages, int H,
          int pair, float sm_scale, void* stream) {
  if (page < 32 || page % 32 != 0 || max_pages < 1 || layer < 0 || layer >= L)
    return (int)cudaErrorInvalidValue;
  gabby_flash::KvSource src;
  src.k = k;
  src.v = v;
  src.ks = static_cast<const float*>(k_scale);
  src.vs = static_cast<const float*>(v_scale);
  src.table = static_cast<const int*>(table);
  src.rows = page;
  src.max_pages = max_pages;
  src.layers = L;
  src.layer = layer;
  src.pair = pair;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_scale != nullptr)
    return gabby_flash::launch_flash_rows<true, true>(
        q, src, fresh_k, fresh_v, positions, out, B, T, Nq, Nk, H,
        page * max_pages, sm_scale, s);
  return gabby_flash::launch_flash_rows<true, false>(
      q, src, fresh_k, fresh_v, positions, out, B, T, Nq, Nk, H,
      page * max_pages, sm_scale, s);
}

}  // namespace

extern "C" {

// q [B, T, Nq, H] bf16, 2 <= T <= 32; k/v pools [P, L, Nk, page, H] int8
// (pair = 1: [P, L, Nk/2, page, 2H]) and scale pools [P, L, Nk, page] f32
// (whole, not offset); table [B, max_pages] int32; fresh_k/v [B, Nk, T, H]
// bf16; positions [B] int32; out [B, T, Nq, H] bf16. page must be a
// multiple of 32; H 64 or 128.
int gabby_paged_attention(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* table, const void* fresh_k,
                          const void* fresh_v, const void* positions,
                          void* out, int B, int T, int Nq, int Nk, int L,
                          int layer, int page, int max_pages, int H,
                          int pair, float sm_scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return paged(q, k, v, k_scale, v_scale, table, fresh_k, fresh_v, positions,
               out, B, T, Nq, Nk, L, layer, page, max_pages, H, pair,
               sm_scale, stream);
}

// The same over bf16 pools [P, L, Nk, page, H] (pair = 1:
// [P, L, Nk/2, page, 2H]), no scales.
int gabby_paged_attention_bf16(const void* q, const void* k, const void* v,
                               const void* table, const void* fresh_k,
                               const void* fresh_v, const void* positions,
                               void* out, int B, int T, int Nq, int Nk, int L,
                               int layer, int page, int max_pages, int H,
                               int pair, float sm_scale, void* stream) {
  return paged(q, k, v, nullptr, nullptr, table, fresh_k, fresh_v, positions,
               out, B, T, Nq, Nk, L, layer, page, max_pages, H, pair,
               sm_scale, stream);
}

}  // extern "C"
