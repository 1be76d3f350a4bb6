// s8 decode attention over the int8 KV cache, dense or paged, unpaired or
// paired, Hopper (sm_90a): K14, K15 (dense) and K19, K20 (paged). The
// kernel is decode_attention.cu's (decode_attention.cuh) in its s8 form;
// this unit builds that form's 80 instantiations (groups 1, 2, 3, 4, 8 x
// head_dim 64, 128 x dense, paged x unpaired, paired x a body for one
// group of chunks and one for more), so that the build stays one nvcc
// process a source.
//
// Replaces the use_s8=True form of
// gabby_tpu/ops/pallas/attention.py:_decode_call and _paged_decode_call
// (the use_s8 branches of their _flash_step body), which is the reference's
// default for single-position decode over a quantized cache with the fresh
// row. Per (slot, kv head) and query row r of the group:
//   qs = max(|q_r|, 1e-9) / 127, q8 = round(q_r / qs);
//   score_j = int32(q8 . k_codes_j) * qs * (k_scale_j * sm_scale), j < n;
//   an online softmax in f32 over chunks of `chunk` cache rows counted
//   from row 0 (a page, in the paged form), l summed over the unquantized
//   p; within a chunk pvf_j = p_j * v_scale_j, pscale = max(max_j pvf_j,
//   1e-30) / 127 PER ROW OVER THE CHUNK, p8 = round(pvf / pscale), and the
//   chunk adds int32(p8 . v_codes) * pscale;
//   the current token's unquantized k/v row is folded in last, in f32.
// Rounding is to nearest even (__float2int_rn), as jnp.round, and every
// operand of a code (q's scale, a score, the running maximum, p, the
// chunk's scale) is the reference's, so the codes are the plain version's
// wherever expf agrees with it (a quotient takes the correctly rounded
// reciprocal once a chunk and one remainder correction, the IEEE
// division's own steps). Both integer products are exact: int8 x int8
// into int32 on the tensor cores (mma.sync m16n8k32), the k rows' loaded
// words as they are, the v rows turned into the A fragment by movmatrix on
// their byte pairs and one byte permute; a warp scales its value sums
// once a chunk.
//
// What bounds it on the H100: bytes, as the bf16/f32 form: 2 n (H + 4)
// bytes per (slot, kv head) for n live rows (8.9 MB a layer at 8 slots x 8
// kv heads x 1024 rows, H = 64: 2.7 us at 3.35 TB/s); the products are far
// below the tensor cores' rate. As there, a call is as short as a launch's
// ramp, and the design is the bf16/f32 form's (decode_attention.cu): a
// cluster of decode_plan's `split` blocks cuts a (slot, kv head)'s live
// rows, one launch a call, programmatic dependent launch, the ranks folded
// in rank order through st.async into rank 0.
//
// What the s8 form adds: pscale needs a row's maximum of p * v_scale over
// the WHOLE chunk before any probability of the chunk is quantized, and p
// needs the running maximum of the scores up to that chunk; the ranks of
// the cluster cut a chunk's rows among them. So a slot's chunks are read
// in groups of whole chunks (as many as split x 4 parts of four tiles
// hold, at most 32): in each group a warp scores its tiles first (parked
// in shared memory with their rows' v_scale), the ranks trade the group's
// chunk score maxima (each pushes its block's to every other rank with
// st.async, which completes one mbarrier phase there, and each folds the
// ranks: the same m_run(c) on every rank, the reference's m_new after
// chunk c), then the warp takes p and the chunk's p * v_scale maxima,
// which the ranks trade the same way (the reference's pscale), then
// quantizes and takes the value product (s8_rows in decode_attention.cuh).
// So the shared memory does not grow with the read bound, only with a
// chunk longer than the parts' tiles (s8_plan raises the split for such
// a chunk). Tiles are aligned to chunks: chunk c's tiles start at row c x
// chunk, so none straddles two chunks (a chunk that is no multiple of 32
// rows ends in a short tile). The layouts only change where a row is
// read, so on the same rows under the same plan K15 = K14, K20 = K19, and
// K19 = K14 where the page is the dense chunk.

#include "decode_attention.cuh"

namespace {

// the body for one group of chunks or for more (s8_sizes)
template <int G, int H, bool kPaged, bool kPair>
int by_groups(const void* q, const KvRows& src, const void* fk,
              const void* fv, const void* pos, void* out, int B, int Nq,
              int Nk, int limit, int chunk, float sm_scale, int split,
              cudaStream_t s) {
  if (s8_sizes<H>(split, limit, chunk).stash > 0)
    return launch<G, H, true, kPaged, kPair, true, true>(
        q, src, fk, fv, pos, out, B, Nq, Nk, limit, sm_scale, split, s,
        chunk);
  return launch<G, H, true, kPaged, kPair, true, false>(
      q, src, fk, fv, pos, out, B, Nq, Nk, limit, sm_scale, split, s, chunk);
}

template <int H, bool kPaged, bool kPair>
int by_group(const void* q, const KvRows& src, const void* fk,
             const void* fv, const void* pos, void* out, int B, int Nq,
             int Nk, int limit, int chunk, float sm_scale, int split,
             cudaStream_t s) {
  switch (Nq / Nk) {
    case 1: return by_groups<1, H, kPaged, kPair>(
        q, src, fk, fv, pos, out, B, Nq, Nk, limit, chunk, sm_scale, split,
        s);
    case 2: return by_groups<2, H, kPaged, kPair>(
        q, src, fk, fv, pos, out, B, Nq, Nk, limit, chunk, sm_scale, split,
        s);
    case 3: return by_groups<3, H, kPaged, kPair>(
        q, src, fk, fv, pos, out, B, Nq, Nk, limit, chunk, sm_scale, split,
        s);
    case 4: return by_groups<4, H, kPaged, kPair>(
        q, src, fk, fv, pos, out, B, Nq, Nk, limit, chunk, sm_scale, split,
        s);
    case 8: return by_groups<8, H, kPaged, kPair>(
        q, src, fk, fv, pos, out, B, Nq, Nk, limit, chunk, sm_scale, split,
        s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kPaged, bool kPair>
int by_head(const void* q, const KvRows& src, const void* fk,
            const void* fv, const void* pos, void* out, int B, int Nq,
            int Nk, int H, int limit, int chunk, float sm_scale, int split,
            cudaStream_t s) {
  if (H == 64)
    return by_group<64, kPaged, kPair>(q, src, fk, fv, pos, out, B, Nq, Nk,
                                       limit, chunk, sm_scale, split, s);
  if (H == 128)
    return by_group<128, kPaged, kPair>(q, src, fk, fv, pos, out, B, Nq,
                                        Nk, limit, chunk, sm_scale, split, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B, Nq, H] bf16 (H 64 or 128, Nq / Nk in 1, 2, 3, 4, 8); fresh_k/v
// [B, Nk, H] bf16; positions [B] int32; out [B, Nq, H] bf16. table ==
// NULL, the dense cache: k/v [B, Nk, rows, H] int8 (pair = 1:
// [B, Nk/2, rows, 2H]) and k/v_scale [B, Nk, rows] f32 of one layer (the
// caller offsets the pointers; layers = 1, layer = 0, max_pages = 1),
// reads rows j < min(positions[b], limit), `chunk` rows a quantization
// chunk. table [B, max_pages] int32, the paged pool: k/v [P, layers, Nk,
// rows, H] (pair = 1: [P, layers, Nk/2, rows, 2H]) and scale pools
// [P, layers, Nk, rows] whole; rows is the page size, a multiple of 32,
// the read bound is rows x max_pages and the chunk a page (limit and
// chunk must say so). (sb, split, tile): the wrapper's s8_plan (1, a
// cluster of 1, 2, 4 or 8 blocks, 32).
int gabby_attention_s8(const void* q, const void* k, const void* v,
                       const void* k_scale, const void* v_scale,
                       const void* table, const void* fresh_k,
                       const void* fresh_v, const void* positions, void* out,
                       int B, int Nq, int Nk, int layers, int layer, int rows,
                       int max_pages, int H, int limit, int chunk, int pair,
                       int sb, int split, int tile, float sm_scale,
                       void* stream) {
  const bool paged = table != nullptr;
  const bool aligned =
      reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(fresh_k) % 2 == 0 &&
      reinterpret_cast<uintptr_t>(fresh_v) % 2 == 0;
  if (B < 1 || Nk < 1 || Nq % Nk != 0 || rows < 1 || max_pages < 1 ||
      layer < 0 || layer >= layers || limit < 0 || chunk < 1 ||
      k_scale == nullptr || v_scale == nullptr || (pair != 0 && pair != 1) ||
      (pair && Nk % 2 != 0) || sb != 1 ||
      (split != 1 && split != 2 && split != 4 && split != kMaxSplit) ||
      tile != kS8Tile || !aligned ||
      (paged ? rows % kS8Tile != 0 || chunk != rows ||
                   limit != rows * max_pages
             : layers != 1 || max_pages != 1 || limit > rows))
    return (int)cudaErrorInvalidValue;
  const KvRows src = kv_rows(k, v, k_scale, v_scale, table, rows, max_pages,
                             layers, layer, pair);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (paged)
    return pair ? by_head<true, true>(q, src, fresh_k, fresh_v, positions,
                                      out, B, Nq, Nk, H, limit, chunk,
                                      sm_scale, split, s)
                : by_head<true, false>(q, src, fresh_k, fresh_v, positions,
                                       out, B, Nq, Nk, H, limit, chunk,
                                       sm_scale, split, s);
  return pair ? by_head<false, true>(q, src, fresh_k, fresh_v, positions, out,
                                     B, Nq, Nk, H, limit, chunk, sm_scale,
                                     split, s)
              : by_head<false, false>(q, src, fresh_k, fresh_v, positions,
                                      out, B, Nq, Nk, H, limit, chunk,
                                      sm_scale, split, s);
}

}  // extern "C"
