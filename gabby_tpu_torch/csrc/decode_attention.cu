// GQA flash-decode attention over the KV cache at one query position,
// Hopper (sm_90a): every single-position form of the bf16/f32 decode.
//   dense int8 cache: K3 (unpaired), K12 (paired) and the slot-batched
//     launch K16;
//   dense bf16 cache: K24 (unpaired), K25 (paired) and the slot-batched
//     launch K32;
//   paged int8 pool: K10 (unpaired) and K17 (paired);
//   paged bf16 pool: K28 (unpaired) and K29 (paired);
//   dense, without fresh rows: K34, K35 (int8) and K36, K37 (bf16),
//     unpaired and paired (paged_attention.cu builds the paged ones).
//
// Replaces gabby_tpu/ops/pallas/attention.py:_decode_call (its
// _flash_step body, reached from decode_attention) and _paged_decode_call
// (reached from paged_decode_attention) at tq = 1, unpaired and pair=True,
// with scales and in their k_scale=None form, and _decode_call_multi of the
// same file (the same function, chosen by GABBY_ATTN_MULTI=1): one query
// position of G query heads per kv head attends cache rows j < min(pos[b],
// limit) of one layer, and then the current token's unquantized k/v,
// folded in last as an always-attended extra row; in the no-fresh-row form
// (_decode_call with fresh_k=None, reached from the reference's public
// cache_attention and cache_attention_quantized) the cache already holds
// the current token, rows j < min(pos[b] + 1, limit) are read and nothing
// is folded in after them. Over the paged pool row
// j of slot b lives at pool[table[b, j / page], layer, kh, j % page]; the
// table is read here, nothing gathers the pool, and entries past a slot's
// rows are never read (the loop ends at the slot's own position). The
// paired layout stores kv heads 2p and 2p + 1 side by side, a line of 2H
// elements, the scales still per head. The kernel itself lives in
// decode_attention.cuh, whose s8 form (K14, K15, K19, K20) attention_s8.cu
// instantiates and whose verify form (the multi-position forms K9, K11,
// K13, K18, K26, K27, K30, K31) verify_attention.cu and paged_attention.cu:
// this unit builds the 120 instantiations of the forms above (80 with
// fresh rows, 40 dense without).
//
// The arithmetic is the reference's: scores are bf16 q times bf16 k (int8
// codes are exact in bf16) summed in f32 on the tensor cores, times
// k_scale[j] * sm_scale (int8) or sm_scale (bf16); p = exp(s - m) in f32,
// summed unrounded; the value product takes bf16(p * v_scale[j]) (int8) or
// bf16(p) (bf16) against bf16 v, summed in f32; the fresh row in f32. The
// four layouts only change where a row is read, so a form equals its
// unpaired dense form bit for bit on the same rows under the same launch
// plan: K12 = K3, K25 = K24 = K32, K17 = K10, K29 = K28, K10 = K3.
//
// What bounds it on the H100: bytes. A (slot, kv head) streams 2 n H code
// bytes and 2 n 4 scale bytes (int8), or 2 n 2H bytes (bf16), for n live
// rows: at 8 slots x 8 kv heads x 1024 rows that is 8.9 MB a layer at
// H = 64 (2.7 us at 3.35 TB/s), 16.8 MB over a bf16 cache or at H = 128
// (5 us). The products (2 x 2 G H flops a row) are far below the tensor
// cores' rate. A call is as short as a launch's ramp, so one launch a call
// and enough blocks in flight count as much as the body.
//
// Design:
//   * Grid (split, Nk, B): one block of 4 warps per (slot, kv head, rank);
//     the `split` ranks of a (slot, kv head) form a thread-block cluster.
//     split comes from the wrapper's decode_plan (1, 2, 4 or 8, from the
//     read bound `limit` and the card's size alone, so a launch can be
//     captured in a CUDA graph; page * max_pages is the paged read bound).
//     The slot's live rows n = min(pos[b], limit, capacity) are cut on the
//     device into tiles of kTile rows (32; 16 over a bf16 cache at H =
//     128), and the tiles into split * 4 parts as even as can be, part p =
//     rank * 4 + warp taking tiles [p T / P, (p + 1) T / P): a short slot
//     spreads over every warp, and a warp with no tile keeps the empty
//     partial (m = -1e30, l = 0).
//   * Rows: a tile's rows follow one another from its first row's line at
//     a stride of one line (H or 2H elements, 2H or 4H paired), the block's
//     kv head at its half of a paired line. Paged, a page holds a multiple
//     of the tile, so a tile never straddles a page: a warp reads the table
//     entry of its first tile's page, and another only when a tile enters
//     the next page (its tiles are contiguous, so each page's entry once).
//   * Everything that does not depend on the position (q, the fresh k and
//     v) is requested with it, and the fresh row's score is taken in
//     registers, so a block waits on device memory twice: for the position,
//     then for its rows (paged, once more between them: for the page
//     entry). With programmatic dependent launch a block's set-up (its
//     barrier, the cluster's arrival) overlaps the kernel before it, and
//     the next kernel's overlaps this one's tail; every read, the page
//     table's too, waits for the kernel before (griddepcontrol.wait).
//   * A warp's tile: its lanes read the key and value rows straight from
//     device memory into registers as 16-byte vectors, a quad of lanes a
//     row (lane t the chunks t, t + 4, ...: 64 contiguous bytes an
//     instruction), all before the products; the bytes in flight come from
//     the 12-16 warps a multiprocessor holds. Both products run transposed
//     on mma.sync m16n8k16 (bf16 in, f32 sums), so that the 16-row side is
//     never padding: scores with keys as M, the key rows as they were read
//     being A and q the B fragment (queries as N, the head dims permuted
//     alike in q and k); values with head dims as M and queries as N, the
//     value rows turned into A by movmatrix.trans (an 8x8 transpose of bf16
//     pairs across the warp) and the probabilities into B the same way.
//     Int8 codes become bf16 in registers (exact). The online softmax runs
//     per query column in registers (a column's keys lie in 8 lanes: three
//     shuffles). No shared memory stages the cache and no block barrier runs
//     in the loop.
//   * Merge in a fixed order, inside the launch: the 4 warps' partials
//     (m, l, acc[G][H], f32) fold in warp order through shared memory; with
//     split > 1 every other rank writes its block's partial into rank 0's
//     shared memory with st.async, whose bytes complete rank 0's mbarrier
//     (one expect_tx at launch, no remote arrivals); rank 0 folds the ranks
//     in rank order, then the fresh row, and stores bf16. No workspace, no
//     atomics, no second kernel: one launch a call, and a repeat gives the
//     same bits.
//   * The no-fresh-row forms (K34-K37 here, K38-K41 in paged_attention.cu)
//     are this kernel with its fresh row taken out at compile time
//     (kFresh = false): no fresh key or value is read, no fresh score is
//     taken, the ranks' merge stores acc / l, and the slot's live rows are
//     n = min(pos[b] + 1, limit, capacity) (at position 0, one row, which
//     the last part takes: every other warp and rank keeps the empty
//     partial, which the merge weighs by exp(-1e30 - m) = 0). The launch
//     plan is the fresh form's for the same limit, so nothing else changes
//     and the fresh forms are the same instantiations as before.
//   * The slot-batched launch (K16, K32) is this kernel with the same plan:
//     a block takes one slot (the plan's sb = 1), since a block here is a
//     (slot, kv head, rank) and there is no per-grid-step cost to spread.
//     K16 equals K3 bit for bit by construction. The kernel is written for
//     SB slots a block (SB groups of 4 warps); the library builds SB =
//     DECODE_SLOTS, 1 unless a timing build sets it.
// head_dim H is 64 or 128, G any of 1, 2, 3, 4, 8 (one instantiation
// each, dense and paged, unpaired and paired). A build flag of
// tools/bench_decode_attention.py --probe (DECODE_PROBE, 0 in the library)
// removes parts of the kernel to split its time: 1 the copies alone, 2 the
// body without the cross-block merge, 3 the whole kernel without
// programmatic dependent launch.

#include "decode_attention.cuh"

extern "C" {

// K3, K12 and K16. q [B, Nq, H] bf16 (H 64 or 128, Nq / Nk in 1, 2, 3,
// 4, 8); k/v [B, Nk, S, H] int8 (pair = 1: [B, Nk/2, S, 2H]) and
// k/v_scale [B, Nk, S] f32 of one layer (the caller offsets the
// pointers); fresh_k/v [B, Nk, H] bf16; positions [B] int32; out
// [B, Nq, H] bf16. Reads rows j < min(positions[b], limit). (sb, split,
// tile): the wrapper's decode_plan: slots a block (the build's
// DECODE_SLOTS, 1), blocks a cluster (1, 2, 4 or 8) and rows a warp's tile
// (32; 16 over a bf16 cache at H = 128).
int gabby_decode_attention(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const void* fresh_k, const void* fresh_v,
                           const void* positions, void* out, int B, int Nq,
                           int Nk, int S, int H, int limit, int pair, int sb,
                           int split, int tile, float sm_scale,
                           void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch_decode<false, true>(
      q, kv_rows(k, v, k_scale, v_scale, nullptr, S, 1, 1, 0, pair), fresh_k,
      fresh_v, positions, out, B, Nq, Nk, H, limit, sb, split, tile,
      sm_scale, stream);
}

// K24, K25 and K32: the same over a bf16 cache, k/v [B, Nk, S, H] bf16
// (pair = 1: [B, Nk/2, S, 2H]) of one layer, no scales.
int gabby_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* fresh_k, const void* fresh_v,
                                const void* positions, void* out, int B,
                                int Nq, int Nk, int S, int H, int limit,
                                int pair, int sb, int split, int tile,
                                float sm_scale, void* stream) {
  return dispatch_decode<false, true>(
      q, kv_rows(k, v, nullptr, nullptr, nullptr, S, 1, 1, 0, pair),
      fresh_k, fresh_v, positions, out, B, Nq, Nk, H, limit, sb, split, tile,
      sm_scale, stream);
}

// K34 and K35: the no-fresh-row form of K3 and K12, the same arguments
// without fresh_k and fresh_v: the cache already holds the current token,
// rows j < min(positions[b] + 1, limit) are read (limit >= 1).
int gabby_decode_attention_nofresh(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* positions,
                                   void* out, int B, int Nq, int Nk, int S,
                                   int H, int limit, int pair, int sb,
                                   int split, int tile, float sm_scale,
                                   void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch_decode<false, false>(
      q, kv_rows(k, v, k_scale, v_scale, nullptr, S, 1, 1, 0, pair), nullptr,
      nullptr, positions, out, B, Nq, Nk, H, limit, sb, split, tile,
      sm_scale, stream);
}

// K36 and K37: the same over a bf16 cache (K24's and K25's no-fresh form)
int gabby_decode_attention_nofresh_bf16(const void* q, const void* k,
                                        const void* v, const void* positions,
                                        void* out, int B, int Nq, int Nk,
                                        int S, int H, int limit, int pair,
                                        int sb, int split, int tile,
                                        float sm_scale, void* stream) {
  return dispatch_decode<false, false>(
      q, kv_rows(k, v, nullptr, nullptr, nullptr, S, 1, 1, 0, pair), nullptr,
      nullptr, positions, out, B, Nq, Nk, H, limit, sb, split, tile,
      sm_scale, stream);
}

// K10 and K17: the same through the page table. k/v pools
// [P, L, Nk, page, H] int8 (pair = 1: [P, L, Nk/2, page, 2H]) and scale
// pools [P, L, Nk, page] f32 (whole, not offset); table [B, max_pages]
// int32. Reads rows j < min(positions[b], page * max_pages); the tile must
// divide the page.
int gabby_paged_decode_attention(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* table, const void* fresh_k,
                                 const void* fresh_v, const void* positions,
                                 void* out, int B, int Nq, int Nk, int L,
                                 int layer, int page, int max_pages, int H,
                                 int pair, int sb, int split, int tile,
                                 float sm_scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch_decode<true, true>(
      q, kv_rows(k, v, k_scale, v_scale, table, page, max_pages, L, layer,
                 pair),
      fresh_k, fresh_v, positions, out, B, Nq, Nk, H, page * max_pages, sb,
      split, tile, sm_scale, stream);
}

// K28 and K29: the same over bf16 pools [P, L, Nk, page, H] (pair = 1:
// [P, L, Nk/2, page, 2H]), no scales.
int gabby_paged_decode_attention_bf16(const void* q, const void* k,
                                      const void* v, const void* table,
                                      const void* fresh_k,
                                      const void* fresh_v,
                                      const void* positions, void* out, int B,
                                      int Nq, int Nk, int L, int layer,
                                      int page, int max_pages, int H,
                                      int pair, int sb, int split, int tile,
                                      float sm_scale, void* stream) {
  return dispatch_decode<true, true>(
      q, kv_rows(k, v, nullptr, nullptr, table, page, max_pages, L, layer,
                 pair),
      fresh_k, fresh_v, positions, out, B, Nq, Nk, H, page * max_pages, sb,
      split, tile, sm_scale, stream);
}

}  // extern "C"
