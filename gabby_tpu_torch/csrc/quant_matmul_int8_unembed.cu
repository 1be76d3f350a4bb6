// K6, the int8 unembed with per-channel scales, for decode-sized M
// (1..64), Hopper (sm_90a): the int8 form of quant_matmul_unembed.cuh's
// persistent TMA + wgmma kernel (which says what bounds it and how). Each
// code becomes bf16 exactly through f32 (K5's conversion) and is
// multiplied by x on the bf16 tensor cores; the f32 total of a channel is
// multiplied by its scale once. One launch a call, no workspace, atomics or
// finalize pass, the same bits on a repeat.
//
// Replaces the Pallas TPU kernel
//   K6  gabby_tpu/ops/pallas/quant_matmul.py _qmatmul_int8 -> _int8_kernel:
//       x [M, K] bf16 @ int8 W [K, N] (a 2-D weight, one code a byte) with
//       scales [N] f32 -> [M, N] bf16; the int8 unembed of a loaded
//       checkpoint, whose vocabulary is not padded (128256 = 1002 x 128).

#include "quant_matmul_unembed.cuh"

extern "C" {

// x [M, K] bf16, 1 <= M <= 64; codes [K, N] int8; scale [N] f32; out
// [M, N] bf16. K a multiple of 64 (a stage's rows), N a multiple of 16
// (TMA's 16-byte row stride; a last strip past N is not stored); x and
// codes 16-byte aligned, scale 8-byte aligned.
int gabby_int8_unembed(const void* x, const void* codes, const void* scale,
                       void* out, int M, int K, int N, void* stream) {
  if (M < 1 || M > 64 || K < kBKP || K % kBKP || N < 16 || N % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(codes) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 8)
    return (int)cudaErrorInvalidValue;
  return launch_m<true>(x, codes, scale, out, M, K, N, 0, stream);
}

const char* gabby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
