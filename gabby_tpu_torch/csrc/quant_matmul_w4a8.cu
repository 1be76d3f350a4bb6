// W4A8 matmul for decode-sized M (M <= 64), Hopper (sm_90a): int8
// activations against int4 weights with integer dots.
//
// Replaces the Pallas TPU kernel
//   K8  gabby_tpu/ops/pallas/quant_matmul.py _qmatmul_int4_w4a8_stacked ->
//       _int4_w4a8_stacked_kernel: xq [M, K] int8 (per-row scales xs [M],
//       quantized by the caller) @ half-split packed int4 W[layer]
//       [K/2, N], int32 accumulate, out = f32(acc) * xs * scale -> bf16.
// The layer of the stack is a pointer offset made by the caller.
//
// What bounds it on the H100: bytes (the packed weights, 486 MB per
// Llama-3.2-1B decode step, ~145 us at 3.35 TB/s); the integer dots are
// 4 multiply-adds per __dp4a, a quarter of the f32 kernel's instruction
// count per weight byte.
//
// Design: as the f32 decode kernel (quant_matmul.cu), a block owns a
// 128-column strip of N and one slice of the packed rows, and the K sweep
// is split across blocks; the accumulator is int32, so the atomic adds of
// the slices into the workspace are EXACT and the result does not depend
// on their order. A thread owns 4 columns: it reads 4 packed rows x 4
// bytes, transposes the 4 x 4 bytes with byte permutes so that each
// column's four K-consecutive bytes sit in one word, and turns the nibbles
// into int8 lanes holding 16 * w: (b ^ 8) << 4 for the low nibble (the
// stored value is w + 8, and flipping bit 3 gives w's 4-bit two's
// complement), b & 0xF0 for the high one. So no -8 * rowsum(x) correction
// is carried: every product is 16 times too large, each block's partial
// sum is divided by 16 exactly (a shift) before it is added. The bound
// 127 * 128 * K stays below 2^31 up to K = 131072. xq is staged in shared
// memory as words of four K-consecutive int8. A second kernel applies
// xs[m] * scale[n] to the int32 sums and converts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps, each a different group of 4 rows
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 4;
constexpr int kStrip = 32 * kColsPerLane;  // 128 columns
constexpr int kMT = 8;                     // rows of M per tile
constexpr int kChunkRows = 256;            // packed rows staged at once

struct Smem {
  int x_lo[kMT][kChunkRows / 4];  // words of 4 K-consecutive int8
  int x_hi[kMT][kChunkRows / 4];
  int red[kWarps][kMT][kStrip];
};

__global__ void __launch_bounds__(kThreads)
w4a8_matmul_kernel(const int8_t* __restrict__ xq,
                   const int8_t* __restrict__ packed, int* __restrict__ ws,
                   int M, int K, int N, int rows_per_split) {
  __shared__ Smem sm;
  const int kp = K / 2;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kStrip + lane * kColsPerLane;
  const bool col_ok = n0 < N;  // N % 4 == 0: a lane's 4 columns share fate
  const int r_begin = blockIdx.y * rows_per_split;  // multiples of 4
  const int r_end = min(kp, r_begin + rows_per_split);

  for (int m0 = 0; m0 < M; m0 += kMT) {
    const int mt = min(kMT, M - m0);
    int acc[kMT][kColsPerLane];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[i][c] = 0;

    for (int c0 = r_begin; c0 < r_end; c0 += kChunkRows) {
      const int words = min(kChunkRows, r_end - c0) / 4;
      __syncthreads();  // previous chunk's readers are done
      for (int e = tid; e < words * kMT; e += kThreads) {
        const int i = e / words, r4 = e % words;
        int lo = 0, hi = 0;
        if (i < mt) {
          const int8_t* xr = xq + (size_t)(m0 + i) * K + c0 + 4 * r4;
          lo = *reinterpret_cast<const int*>(xr);
          hi = *reinterpret_cast<const int*>(xr + kp);
        }
        sm.x_lo[i][r4] = lo;
        sm.x_hi[i][r4] = hi;
      }
      __syncthreads();
      if (col_ok) {
        for (int r4 = warp; r4 < words; r4 += kWarps) {
          const int8_t* wp = packed + (size_t)(c0 + 4 * r4) * N + n0;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wp);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wp + N);
          const uint32_t w2 =
              *reinterpret_cast<const uint32_t*>(wp + 2 * (size_t)N);
          const uint32_t w3 =
              *reinterpret_cast<const uint32_t*>(wp + 3 * (size_t)N);
          // 4 x 4 byte transpose: col[c] = bytes (w0[c], w1[c], w2[c], w3[c])
          const uint32_t t01l = __byte_perm(w0, w1, 0x5140);
          const uint32_t t01h = __byte_perm(w0, w1, 0x7362);
          const uint32_t t23l = __byte_perm(w2, w3, 0x5140);
          const uint32_t t23h = __byte_perm(w2, w3, 0x7362);
          const uint32_t col[kColsPerLane] = {
              __byte_perm(t01l, t23l, 0x5410), __byte_perm(t01l, t23l, 0x7632),
              __byte_perm(t01h, t23h, 0x5410), __byte_perm(t01h, t23h, 0x7632)};
          int lo16[kColsPerLane], hi16[kColsPerLane];
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            lo16[c] = (int)(((col[c] ^ 0x08080808u) << 4) & 0xF0F0F0F0u);
            hi16[c] = (int)(col[c] & 0xF0F0F0F0u);
          }
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            const int xl = sm.x_lo[i][r4], xh = sm.x_hi[i][r4];
#pragma unroll
            for (int c = 0; c < kColsPerLane; ++c)
              acc[i][c] = __dp4a(xh, hi16[c], __dp4a(xl, lo16[c], acc[i][c]));
          }
        }
      }
    }

    // reduce the warps; each thread finishes kMT * kStrip / kThreads sums
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c)
        sm.red[warp][i][lane * kColsPerLane + c] = acc[i][c];
    __syncthreads();
    for (int e = tid; e < kMT * kStrip; e += kThreads) {
      const int i = e / kStrip, c = e % kStrip;
      const int n = blockIdx.x * kStrip + c;
      if (i >= mt || n >= N) continue;
      int v = 0;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) v += sm.red[wi][i][c];
      // every product carried a factor 16: the shift is exact
      atomicAdd(ws + (size_t)(m0 + i) * N + n, v >> 4);
    }
  }
}

// out = bf16(f32(acc) * xs[m] * scale[n])
__global__ void w4a8_finalize_kernel(const int* __restrict__ ws,
                                     const float* __restrict__ xs,
                                     const float* __restrict__ scale,
                                     __nv_bfloat16* __restrict__ out, int M,
                                     int N) {
  const size_t total = (size_t)M * N;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x)
    out[e] = __float2bfloat16((float)ws[e] * xs[e / N] * scale[e % N]);
}

}  // namespace

extern "C" {

// xq [M, K] int8; packed [K/2, N] int8 (one layer by pointer offset);
// ws [M, N] int32, zeroed: receives the integer accumulator. K/2 must
// split into n_split slices of a multiple of 4 rows.
int gabby_w4a8_matmul(const void* xq, const void* packed, void* ws, int M,
                      int K, int N, int n_split, void* stream) {
  const int rows_per_split = (K / 2 + n_split - 1) / n_split;
  dim3 grid((N + kStrip - 1) / kStrip, n_split);
  w4a8_matmul_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(packed),
      static_cast<int*>(ws), M, K, N, rows_per_split);
  return (int)cudaGetLastError();
}

// ws [M, N] int32; xs [M] f32; scale [N] f32; out [M, N] bf16
int gabby_w4a8_finalize(const void* ws, const void* xs, const void* scale,
                        void* out, int M, int N, void* stream) {
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  w4a8_finalize_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ws), static_cast<const float*>(xs),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M,
      N);
  return (int)cudaGetLastError();
}

}  // extern "C"
