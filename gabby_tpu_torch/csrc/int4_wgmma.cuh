// Device and host helpers of the TMA + wgmma kernels (K7 in
// quant_matmul_prefill.cu, K2 and K6 of quant_matmul_unembed.cuh, the
// stacked forms K1, K33, K5 and K8 of quant_matmul_stacked.cuh): mbarriers,
// TMA tile copies, wgmma fences and the m64n8k16 / m64n64k16 products with
// A from registers, the 128-byte-swizzle descriptor, the conversion of int4
// and int8 codes to bf16 pairs and the ldmatrix unpack of a stage, and the
// tensor maps.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of the given parity to complete. A phase that never
// completes (a copy that never lands) traps after about ten seconds, so a
// fault is an error and not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  if (done) return;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap& map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap& map,
                                       int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulators in place around a batch of wgmma, so that no other
// instruction defines them while the batch is in flight (which would make
// ptxas serialize the wgmma)
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows,
// 128-byte swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma m64nNk16, A (the weight) from registers, B (x) by descriptor,
// f32 accumulators in d (scale-d on: d += A B)
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// wgmma m64n8k16, A (the codes) from registers, B (x) by descriptor
__device__ __forceinline__ void wgmma_n8(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// bf16 pairs of the two codes in bytes 0 and 2 of v: v - 136 after
// 0x4300 | u made 128 + u (exact)
__device__ __forceinline__ uint32_t minus136(uint32_t v) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// A fragments of one stage of packed codes ([64 rows][128 channels] as
// TMA's 128-byte swizzle lays it) for both nibble planes, a[half][k16
// step][4], for the warp's 16 channels `chunk` (fragment row g is channel
// 2g, row g + 8 channel 2g + 1), read through ldmatrix: two .x4.trans
// loads give a thread, for each k16 step s, r_a = rows 16s + 2t, 16s + 2t
// + 1 and r_b = rows 16s + 8 + 2t, 16s + 9 + 2t of its channels 2g, 2g + 1
// (bytes: row 2t ch 2g, row 2t ch 2g + 1, row 2t + 1 ch 2g, row 2t + 1 ch
// 2g + 1), so that one channel's two codes sit in bytes 0 and 2 (ch 2g) or
// 1 and 3 (ch 2g + 1). Rows are read through the 128-byte swizzle: 16-byte
// chunk c of row r at r * 128 + ((c ^ (r & 7)) << 4), eight distinct
// chunks a phase, so no bank conflicts. The lo plane gives lo - 8, the hi
// plane the signed high nibble.
__device__ __forceinline__ void unpack_stage_ldm(const uint8_t* w, int chunk,
                                                 int lane,
                                                 uint32_t (&a)[2][4][4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = 32 * q + lane;
    uint32_t m[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(m[0]), "=r"(m[1]), "=r"(m[2]), "=r"(m[3])
        : "r"(smem_addr(w + r * 128 + ((chunk ^ (r & 7)) << 4))));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * q + h;
      const uint32_t ra = m[2 * h], rb = m[2 * h + 1];
      const uint32_t v[4] = {ra, ra >> 8, rb, rb >> 8};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[0][s][j] = minus136((v[j] & 0x000F000Fu) | 0x43004300u);
        a[1][s][j] = minus136(((v[j] >> 4) & 0x000F000Fu) ^ 0x43084308u);
      }
    }
  }
}

// The A fragments (K5, K6) of one stage of int8 codes ([64 K rows][128
// channels]), a[k16 step][4] in unpack_stage_ldm's register order (its two
// ldmatrix.x4.trans loads; fragment row g is channel 2g, row g + 8 channel
// 2g + 1), each register two codes of a channel as exact bf16: with u =
// c + 128 as the low byte of 2^23's f32 bits, that f32 less 2^23 + 128 is
// c, and an integer of at most 8 bits is its f32's high half.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t v) {
  // bytes 0 and 2 of v: codes + 128
  const float f0 =
      __fsub_rn(__int_as_float(__byte_perm(v, 0x4B000000u, 0x7440)),
                8388736.f);
  const float f2 =
      __fsub_rn(__int_as_float(__byte_perm(v, 0x4B000000u, 0x7442)),
                8388736.f);
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
}
__device__ __forceinline__ void unpack_stage_codes8(const uint8_t* w,
                                                    int chunk, int lane,
                                                    uint32_t (&a)[4][4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = 32 * q + lane;
    uint32_t m[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(m[0]), "=r"(m[1]), "=r"(m[2]), "=r"(m[3])
        : "r"(smem_addr(w + r * 128 + ((chunk ^ (r & 7)) << 4))));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t ra = m[2 * h] ^ 0x80808080u;
      const uint32_t rb = m[2 * h + 1] ^ 0x80808080u;
      const uint32_t v[4] = {ra, ra >> 8, rb, rb >> 8};
#pragma unroll
      for (int j = 0; j < 4; ++j) a[2 * q + h][j] = codes_bf16x2(v[j]);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link against
// libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static std::once_flag once;
  static EncodeTiled fn = nullptr;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// x [M, K] bf16 seen as [M][2][K/2] (the two halves of the pairing),
// boxes of 64 columns x bt rows, 128-byte swizzled, zero past the edges
// (rows past M read as 0).
cudaError_t int4_x_map(const void* x, int M, int K, int bt,
                       CUtensorMap* xmap) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dim[3] = {(cuuint64_t)K / 2, 2, (cuuint64_t)M};
  const cuuint64_t stride[2] = {(cuuint64_t)K, (cuuint64_t)K * 2};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)bt}, ones[3] = {1, 1, 1};
  return encode(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(x), dim, stride, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// x [M, K] bf16 as it is (K5: one K row a weight byte), boxes of 64
// columns x bt rows, 128-byte swizzled, zero past the edges.
cudaError_t x_rows_map(const void* x, int M, int K, int bt,
                       CUtensorMap* xmap) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t stride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)bt}, ones[2] = {1, 1};
  return encode(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(x), dim, stride, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// A stack of byte planes [L, rows, N] int8 (K1, K33, K8: packed int4
// codes, rows = K/2; K5: int8 codes, rows = K), boxes of 128 channels x
// 64 rows x 1 layer, 128-byte swizzled: the layer is the copy's third
// coordinate, so one map serves every layer.
cudaError_t stack_map(const void* planes, int layers, int rows, int N,
                      CUtensorMap* wmap) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dim[3] = {(cuuint64_t)N, (cuuint64_t)rows,
                             (cuuint64_t)layers};
  const cuuint64_t stride[2] = {(cuuint64_t)N, (cuuint64_t)N * rows};
  const cuuint32_t box[3] = {128, 64, 1}, ones[3] = {1, 1, 1};
  return encode(wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                const_cast<void*>(planes), dim, stride, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// A byte plane [rows, N] (K7, K2: packed int4 codes, rows = K/2; K6: int8
// codes, rows = K), 2-D, boxes of 128 channels x 64 rows, 128-byte
// swizzled, zero past the edges (channels past N read as 0).
cudaError_t plane_map(const void* plane, int rows, int N, CUtensorMap* wmap) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t wdim[2] = {(cuuint64_t)N, (cuuint64_t)rows};
  const cuuint64_t wstride[1] = {(cuuint64_t)N};
  const cuuint32_t wbox[2] = {128, 64}, ones[2] = {1, 1};
  return encode(wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(plane), wdim, wstride, wbox, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The two tensor maps of a product on one [K/2, N] plane (K7, K2):
// int4_x_map with boxes of bt rows, and the packed plane's plane_map.
cudaError_t int4_tensor_maps(const void* x, const void* packed, int M,
                             int K, int N, int bt, CUtensorMap* xmap,
                             CUtensorMap* wmap) {
  const cudaError_t err = int4_x_map(x, M, K, bt, xmap);
  if (err != cudaSuccess) return err;
  return plane_map(packed, K / 2, N, wmap);
}

cudaError_t multiprocessors(int* dev, int* sms) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= 64) return cudaErrorInvalidDevice;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
}

}  // namespace
