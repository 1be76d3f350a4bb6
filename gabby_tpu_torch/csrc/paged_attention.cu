// Speculative-verify attention over the paged KV pool, Hopper (sm_90a): the
// verify form of decode_attention.cuh's flash-decode kernel through the
// page table (head_dim 64 or 128, any group):
//   int8 pool: K11 (unpaired) and K18 (paired);
//   bf16 pool: K30 (unpaired) and K31 (paired);
// and the no-fresh-row form of its single-position decode through the page
// table (head_dim 64 or 128, groups 1, 2, 3, 4, 8):
//   int8 pool: K38 (unpaired) and K39 (paired);
//   bf16 pool: K40 (unpaired) and K41 (paired).
//
// Replaces gabby_tpu/ops/pallas/attention.py:_paged_decode_call at tq > 1
// (reached from paged_verify_attention), unpaired and pair=True, with
// scales and in its k_scale=None form: the dense verify contract
// (verify_attention.cu, which says what bounds it and how), with row j of
// slot b read from pool[table[b, j / page], layer, kh, j % page]. The page
// table is read inside the kernel, each page's entry once a warp, so
// nothing gathers the pool; the loop ends at the slot's own position, so
// table entries past its rows are never read. On the same rows under the
// same plan a paged form equals its dense form bit for bit (K11 = K9, K18
// = K11, K30 = K26, K31 = K30). T = 1 (paged_decode_attention) is refused
// here: decode_attention.cu serves it with fresh rows.
//
// K38-K41 replace _paged_decode_call at tq = 1 with fresh_k=None (the
// reference's paged_decode_attention without fresh rows; `last_page` on
// the position): the flash-decode kernel of decode_attention.cu without
// its fresh row (kFresh = false; decode_attention.cu says what bounds it
// and how), rows j < min(positions[b] + 1, page x max_pages) read through
// the table. They are built here, beside the verify form, so that
// decode_attention.cu's instantiations do not grow by the 40 of these.

#include "decode_attention.cuh"

extern "C" {

// q [B, T, Nq, H] bf16, 2 <= T <= 32; k/v pools [P, L, Nk, page, H] int8
// (pair = 1: [P, L, Nk/2, page, 2H]) and scale pools [P, L, Nk, page] f32
// (whole, not offset); table [B, max_pages] int32; fresh_k/v [B, Nk, T, H]
// bf16; positions [B] int32; out [B, T, Nq, H] bf16; H 64 or 128. Reads
// rows j < min(positions[b], page x max_pages); (split, tile, nt): the
// wrapper's verify_plan, whose tile divides the page.
int gabby_paged_attention(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* table, const void* fresh_k,
                          const void* fresh_v, const void* positions,
                          void* out, int B, int T, int Nq, int Nk, int L,
                          int layer, int page, int max_pages, int H,
                          int pair, int split, int tile, int nt,
                          float sm_scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch_verify<true>(
      q, kv_rows(k, v, k_scale, v_scale, table, page, max_pages, L, layer,
                 pair),
      fresh_k, fresh_v, positions, out, B, T, Nq, Nk, H, page * max_pages,
      split, tile, nt, sm_scale, stream);
}

// The same over bf16 pools [P, L, Nk, page, H] (pair = 1:
// [P, L, Nk/2, page, 2H]), no scales.
int gabby_paged_attention_bf16(const void* q, const void* k, const void* v,
                               const void* table, const void* fresh_k,
                               const void* fresh_v, const void* positions,
                               void* out, int B, int T, int Nq, int Nk, int L,
                               int layer, int page, int max_pages, int H,
                               int pair, int split, int tile, int nt,
                               float sm_scale, void* stream) {
  return dispatch_verify<true>(
      q, kv_rows(k, v, nullptr, nullptr, table, page, max_pages, L, layer,
                 pair),
      fresh_k, fresh_v, positions, out, B, T, Nq, Nk, H, page * max_pages,
      split, tile, nt, sm_scale, stream);
}

// K38 and K39: q [B, Nq, H] bf16 (H 64 or 128, Nq / Nk in 1, 2, 3, 4,
// 8); k/v pools [P, L, Nk, page, H] int8 (pair = 1: [P, L, Nk/2, page,
// 2H]) and scale pools [P, L, Nk, page] f32 (whole, not offset); table
// [B, max_pages] int32; positions [B] int32; out [B, Nq, H] bf16. The cache
// holds the current token: reads rows j < min(positions[b] + 1, page x
// max_pages). (sb, split, tile): the wrapper's decode_plan for that read
// bound, whose tile divides the page.
int gabby_paged_decode_attention_nofresh(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* positions, void* out,
    int B, int Nq, int Nk, int L, int layer, int page, int max_pages, int H,
    int pair, int sb, int split, int tile, float sm_scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch_decode<true, false>(
      q, kv_rows(k, v, k_scale, v_scale, table, page, max_pages, L, layer,
                 pair),
      nullptr, nullptr, positions, out, B, Nq, Nk, H, page * max_pages, sb,
      split, tile, sm_scale, stream);
}

// K40 and K41: the same over bf16 pools [P, L, Nk, page, H] (pair = 1:
// [P, L, Nk/2, page, 2H]), no scales.
int gabby_paged_decode_attention_nofresh_bf16(
    const void* q, const void* k, const void* v, const void* table,
    const void* positions, void* out, int B, int Nq, int Nk, int L, int layer,
    int page, int max_pages, int H, int pair, int sb, int split, int tile,
    float sm_scale, void* stream) {
  return dispatch_decode<true, false>(
      q, kv_rows(k, v, nullptr, nullptr, table, page, max_pages, L, layer,
                 pair),
      nullptr, nullptr, positions, out, B, Nq, Nk, H, page * max_pages, sb,
      split, tile, sm_scale, stream);
}

}  // extern "C"
