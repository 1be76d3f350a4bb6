// K1 and K33, the stacked int4 matmul for decode-sized M (1..64) and its
// raw-byte-dot form, on the kernel of quant_matmul_stacked.cuh (which
// says what they compute, what bounds them and how), and the stacks'
// tensor maps that every stacked form (K1, K33, K5, K8) takes.
//
// Replaces gabby_tpu/ops/pallas/quant_matmul.py _qmatmul_int4_stacked ->
// _int4_stacked_kernel (K1) and _int4_stacked_rawdot_kernel (K33).

#include "quant_matmul_stacked.cuh"

extern "C" {

// The tensor map of a stack of byte planes [L, K/2, N] int8 (16-byte
// aligned, K a multiple of 128, N of 128), 128 bytes written to `map`:
// encoded once per stack and passed to every call on it. A packed int4
// stack (K1, K33, K8) has K/2 rows; an int8 stack [L, K, N] (K5) is
// mapped by passing 2 K.
int gabby_int4_stacked_map(const void* packed, int L, int K, int N,
                           void* map) {
  if (L < 1 || K < 2 * kBKP || K % (2 * kBKP) || N < kBN || N % kBN ||
      reinterpret_cast<uintptr_t>(packed) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  const cudaError_t err = stack_map(packed, L, K / 2, N, &m);
  if (err != cudaSuccess) return (int)err;
  memcpy(map, &m, sizeof(m));
  return 0;
}

// K1. x [M, K] bf16, 1 <= M <= bt; map: gabby_int4_stacked_map of the
// stack; scale: the layer's [N] f32 (the caller offsets the pointer); out
// [M, N] bf16; bt (8 or 64) the token tile, split the blocks a strip's K
// is split over (1, 2, 4 or 8, dividing K / 128): the wrapper's
// stacked_plan.
int gabby_int4_matmul(const void* x, const void* map, const void* scale,
                      void* out, int M, int K, int N, int layer, int bt,
                      int split, void* stream) {
  return entry<Form::kInt4>(x, map, scale, out, nullptr, M, K, N, layer, bt,
                            split, stream);
}

// K33, the raw-byte-dot form: the arguments of gabby_int4_matmul.
int gabby_int4_matmul_rawdot(const void* x, const void* map,
                             const void* scale, void* out, int M, int K,
                             int N, int layer, int bt, int split,
                             void* stream) {
  return entry<Form::kRaw>(x, map, scale, out, nullptr, M, K, N, layer, bt,
                           split, stream);
}

}  // extern "C"
