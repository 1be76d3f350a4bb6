// K5, the stacked int8-weight matmul for decode-sized M (1..64): x [M, K]
// bf16 @ int8 W[layer], W stacked [L, K, N], per-channel scales [L, N]
// f32 -> [M, N] bf16. The int8 form of quant_matmul_stacked.cuh's kernel
// (which says what bounds it and how): a stage is 64 K rows of codes, each
// converted to bf16 exactly through f32 and multiplied by x on the bf16
// tensor cores; one launch a call, no workspace, atomics or finalize pass,
// the same bits on a repeat.
//
// Replaces gabby_tpu/ops/pallas/quant_matmul.py _qmatmul_int8_stacked ->
// _int8_stacked_kernel.

#include "quant_matmul_stacked.cuh"

extern "C" {

// x [M, K] bf16, 1 <= M <= bt; map: gabby_int4_stacked_map of the stack
// [L, K, N] (given 2 K); scale: the layer's [N] f32 (the caller offsets
// the pointer); out [M, N] bf16; bt (8 or 64) and split (1, 2, 4 or 8,
// dividing K / 64): the wrapper's stacked_plan.
int gabby_int8_matmul_stacked(const void* x, const void* map,
                              const void* scale, void* out, int M, int K,
                              int N, int layer, int bt, int split,
                              void* stream) {
  return entry<Form::kInt8>(x, map, scale, out, nullptr, M, K, N, layer, bt,
                            split, stream);
}

}  // extern "C"
