// K2, the int4 unembed with group scales, for decode-sized M (1..64),
// Hopper (sm_90a): the int4 form of quant_matmul_unembed.cuh's persistent
// TMA + wgmma kernel (which says what bounds it and how).
//
// Replaces the Pallas TPU kernel
//   K2  gabby_tpu/ops/pallas/quant_matmul.py _qmatmul_int4_grouped ->
//       _int4_grouped_kernel: x [M, K] bf16 @ half-split packed int4
//       W [K/2, N] with scales [K/group, N] along K -> [M, N] bf16.

#include "quant_matmul_unembed.cuh"

extern "C" {

// x [M, K] bf16, 1 <= M <= 64; packed [K/2, N] int8; scale [K/group, N]
// f32; out [M, N] bf16. K/2 and group multiples of 64, group dividing K/2,
// N a multiple of 128; x and packed 16-byte aligned.
int gabby_int4_unembed(const void* x, const void* packed, const void* scale,
                       void* out, int M, int K, int N, int group,
                       void* stream) {
  if (M < 1 || M > 64 || K < 128 || K % 128 || N < kBN || N % kBN ||
      group < kBKP || group % kBKP || (K / 2) % group ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 8)
    return (int)cudaErrorInvalidValue;
  return launch_m<false>(x, packed, scale, out, M, K, N, group, stream);
}

}  // extern "C"
