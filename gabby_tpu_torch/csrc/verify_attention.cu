// Speculative-verify attention over the dense KV cache, Hopper (sm_90a): the
// verify form of decode_attention.cuh's flash-decode kernel (head_dim 64 or
// 128, any group):
//   int8 cache: K9 (unpaired) and K13 (paired);
//   bf16 cache: K26 (unpaired) and K27 (paired).
//
// Replaces gabby_tpu/ops/pallas/attention.py:_decode_call without s8 dots
// at tq > 1 (its _flash_step body, reached from verify_attention),
// unpaired, pair=True and in its k_scale=None form over a bf16 cache: the T
// candidate positions of every slot (2 <= T <= 32) x G query heads of a kv
// head attend that slot's cache rows j < min(pos[b], limit) of one layer
// plus the block's own T unquantized k/v rows causally (column (t, g) sees
// fresh rows t' <= t). T = 1, the decode contract, is refused:
// decode_attention.cu serves it.
//
// The arithmetic is the decode kernel's: q . k of bf16 values (int8 codes
// are exact in bf16) summed in f32 on the tensor cores, times k_scale[j] *
// sm_scale (int8) or sm_scale (bf16); the softmax in f32, p summed
// unrounded; the value product takes bf16(p * v_scale[j]) (int8) or
// bf16(p) (bf16) against bf16 v, summed in f32 (attention.py:186-193); the
// fresh block's scores, softmax and values in f32, folded last. The layouts
// only change where a row is read, so a form equals its unpaired dense form
// bit for bit on the same rows under the same plan (K13 = K9, K27 = K26),
// and a paged form its dense form (paged_attention.cu).
//
// What bounds it on the H100: bytes. A (slot, kv head) streams 2 n H code
// bytes and 2 n 4 scale bytes (int8), or 2 n 2H bytes (bf16), for n live
// rows; the T G <= 64 columns add 4 T G H flops a cache row, 128 a byte
// at the 1B heads with speculate 7 (T G = 32), below the bf16 tensor
// cores' 295 flops a byte, so each row should be read once for all the
// columns.
//
// Design (decode_attention.cuh's verify form):
//   * Grid (split, Nk x groups, B): a cluster of `split` blocks cuts a
//     (slot, kv head)'s live rows into tiles of 32, each rank a run of
//     them. A block's NT warps take an n8 tile of the T G columns each (up
//     to 64 columns a block; past that `groups` blocks of 8 NT, which
//     re-read the rows through L2), so each row is read from device memory
//     once for all of them. (split, tile, NT) come from the wrapper's
//     verify_plan, from the shapes alone, so a launch can be captured in a
//     CUDA graph.
//   * The block stages its tiles in shared memory with cp.async, four in
//     flight; over int8 it turns each tile's codes into bf16 rows once for
//     all its warps (exact). A warp reads its key fragments with ldmatrix
//     and its values' with ldmatrix.trans, and runs both products
//     transposed on mma.sync m16n8k16 as the decode kernel does (keys, then
//     head dims as M; its 8 columns as N), its online softmax per column in
//     registers. A warp holds one tile's output (H / 16 x 4 f32 a lane), so
//     no warp's partial is folded with another's.
//   * Merge in a fixed order, inside the launch: every other rank lays its
//     warps' partials out in shared memory and sends them into rank 0's
//     inbox in one bulk copy, whose bytes complete rank 0's mbarrier; rank
//     0 takes the fresh rows' scores and values in f32 meanwhile, and each
//     lane folds its own elements: the ranks in rank order, then the fresh
//     rows, and stores bf16. No workspace, no atomics, no second kernel:
//     one launch a call, and a repeat gives the same bits.
//   * Programmatic dependent launch, as the decode kernel's.

#include "decode_attention.cuh"

extern "C" {

// q [B, T, Nq, H] bf16, 2 <= T <= 32; k/v [B, Nk, S, H] int8 (pair = 1:
// [B, Nk/2, S, 2H]) and k/v_scale [B, Nk, S] f32 of one layer (the caller
// offsets the pointers); fresh_k/v [B, Nk, T, H] bf16; positions [B]
// int32; out [B, T, Nq, H] bf16; H 64 or 128. (split, tile, nt): the
// wrapper's verify_plan.
int gabby_verify_attention(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const void* fresh_k, const void* fresh_v,
                           const void* positions, void* out, int B, int T,
                           int Nq, int Nk, int S, int H, int limit, int pair,
                           int split, int tile, int nt, float sm_scale,
                           void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch_verify<false>(
      q, kv_rows(k, v, k_scale, v_scale, nullptr, S, 1, 1, 0, pair), fresh_k,
      fresh_v, positions, out, B, T, Nq, Nk, H, limit, split, tile, nt,
      sm_scale, stream);
}

// The same over a bf16 cache: k/v [B, Nk, S, H] bf16 (pair = 1:
// [B, Nk/2, S, 2H]) of one layer, no scales.
int gabby_verify_attention_bf16(const void* q, const void* k, const void* v,
                                const void* fresh_k, const void* fresh_v,
                                const void* positions, void* out, int B,
                                int T, int Nq, int Nk, int S, int H,
                                int limit, int pair, int split, int tile,
                                int nt, float sm_scale, void* stream) {
  return dispatch_verify<false>(
      q, kv_rows(k, v, nullptr, nullptr, nullptr, S, 1, 1, 0, pair),
      fresh_k, fresh_v, positions, out, B, T, Nq, Nk, H, limit, split, tile,
      nt, sm_scale, stream);
}

}  // extern "C"
