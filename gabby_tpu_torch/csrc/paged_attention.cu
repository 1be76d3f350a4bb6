// Decode and speculative-verify attention over the paged int8 KV pool,
// Hopper (sm_90a): K10 (T = 1) and K11 (T > 1), and over the paired pool
// K17 (T = 1, bf16/f32 form) and K18 (T > 1).
//
// Replaces gabby_tpu/ops/pallas/attention.py:_paged_decode_call (reached
// from paged_decode_attention with tq = 1 and from paged_verify_attention
// with tq > 1), unpaired and pair=True: the decode and verify contracts of the
// dense kernels, with row j of slot b read from
// pool[table[b, j / page], layer, kh, j % page]. The page table is read
// inside the kernel, so nothing gathers the pool; the loop ends at the
// slot's own position, so table entries past its rows are never followed.
// The body, what bounds it and its design are in flash_rows.cuh.

#include "flash_rows.cuh"

extern "C" {

// q [B, T, Nq, 64] bf16; k/v pools [P, L, Nk, page, 64] int8 (pair = 1:
// [P, L, Nk/2, page, 128]) and scale
// pools [P, L, Nk, page] f32 (whole, not offset); table [B, max_pages]
// int32; fresh_k/v [B, Nk, T, 64] bf16; positions [B] int32; out
// [B, T, Nq, 64] bf16. page must be a multiple of 32.
int gabby_paged_attention(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* table, const void* fresh_k,
                          const void* fresh_v, const void* positions,
                          void* out, int B, int T, int Nq, int Nk, int L,
                          int layer, int page, int max_pages, int H,
                          int pair, float sm_scale, void* stream) {
  if (page < 32 || page % 32 != 0 || max_pages < 1 || layer < 0 || layer >= L)
    return (int)cudaErrorInvalidValue;
  gabby_flash::KvSource src;
  src.k = static_cast<const int8_t*>(k);
  src.v = static_cast<const int8_t*>(v);
  src.ks = static_cast<const float*>(k_scale);
  src.vs = static_cast<const float*>(v_scale);
  src.table = static_cast<const int*>(table);
  src.rows = page;
  src.max_pages = max_pages;
  src.layers = L;
  src.layer = layer;
  src.pair = pair;
  return gabby_flash::launch_flash_rows<true>(
      q, src, fresh_k, fresh_v, positions, out, B, T, Nq, Nk, H,
      page * max_pages, sm_scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
