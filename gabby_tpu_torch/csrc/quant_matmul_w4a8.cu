// K8, the W4A8 stacked matmul for decode-sized M (1..64): x quantized per
// row to int8 codes inside the launch, then s8 x s8 products of x's codes
// and the packed int4 codes on the tensor cores, an exact int32
// accumulator, out = bf16((f32(acc) * xs) * scale). The s8 form of
// quant_matmul_stacked.cuh's kernel (which says what bounds it and how):
// one launch a call, no workspace, atomics or finalize pass, the plain
// version's bits.
//
// Replaces gabby_tpu/ops/pallas/quant_matmul.py _qmatmul_int4_w4a8_stacked
// -> _int4_w4a8_stacked_kernel.

#include "quant_matmul_stacked.cuh"

extern "C" {

// x [M, K] bf16, 1 <= M <= bt; map: gabby_int4_stacked_map of the packed
// stack [L, K/2, N]; scale: the layer's [N] f32 (the caller offsets the
// pointer); out [M, N] bf16; acc: NULL, or [M, N] int32 receiving the
// accumulator before the scales; bt (8 or 64) and split (1, 2, 4 or 8,
// dividing K / 128; at most 4 at bt 64): the wrapper's stacked_plan.
int gabby_w4a8_matmul(const void* x, const void* map, const void* scale,
                      void* out, void* acc, int M, int K, int N, int layer,
                      int bt, int split, void* stream) {
  return entry<Form::kW4A8>(x, map, scale, out, acc, M, K, N, layer, bt,
                            split, stream);
}

}  // extern "C"
