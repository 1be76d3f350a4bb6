// The weight-only int8 matmul of the int8 unembed for decode-sized M
// (M <= 64), Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of gabby_tpu/ops/pallas/quant_matmul.py
//   K6  _qmatmul_int8 -> _int8_kernel: x @ int8 W, a 2-D [K, N] weight
//       with per-output-channel scales.
// The stacked forms have tensor-core kernels of their own, one launch a
// call (quant_matmul_stacked.cuh): K1, K33 (quant_matmul_stacked.cu), K5
// (quant_matmul_int8_stacked.cu) and K8 (quant_matmul_w4a8.cu); the
// grouped int4 unembed (K2) is quant_matmul_unembed.cu.
//
// Int8 is one code per byte: row r of the [K, N] plane pairs with x[:, r]
// (263 MB for Llama-3.2-1B's [2048, 128256] unembed: ~80 us at 3.35
// TB/s).
//
// What bounds it on the H100: bytes. At M = 8 every weight byte feeds 8
// FMAs. This form does its FMAs on the CUDA cores in f32 and splits K
// across blocks through an f32 workspace and a finalize pass when the
// strips of N are too few for 132 SMs (the unembed's 1002 strips are not).
//
// Design: a block owns a 128-column strip of N and one slice of the
// weight's rows. A warp is 8 column lanes x 4 row lanes; each thread reads
// its 16 bytes (16 columns) of a row as one 16-byte vector, and
// accumulates an 8-row tile of M in f32 against x, which is staged in
// shared memory as f32 per slice. Row lanes and warps are reduced through
// shuffles and shared memory; with one K slice the block writes the output
// (scale applied once per channel), with several it adds into an f32
// workspace that a second pass scales and converts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kColLanes = 8;                 // lanes across the strip
constexpr int kRowLanes = 32 / kColLanes;    // lanes along K in a warp
constexpr int kColsPerLane = 16;             // one 16-byte vector
constexpr int kStrip = kColLanes * kColsPerLane;  // 128 columns
constexpr int kMT = 8;                       // rows of M per tile
constexpr int kChunkRows = 256;              // packed rows staged at once

// x slices staged as f32: [kChunkRows][kMT]
struct Smem {
  float x[kChunkRows][kMT];
  float red[kWarps][kMT][kStrip];
};

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ codes,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ ws, int M, int K, int N,
                   int rows_per_split) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int col_lane = lane % kColLanes;
  const int row_lane = warp * kRowLanes + lane / kColLanes;  // 0..15
  const int n0 = blockIdx.x * kStrip + col_lane * kColsPerLane;
  const bool col_ok = n0 < N;  // N % 16 == 0: a lane's 16 columns share fate
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(K, r_begin + rows_per_split);

  for (int m0 = 0; m0 < M; m0 += kMT) {
    const int mt = min(kMT, M - m0);
    float acc[kMT][kColsPerLane];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[i][c] = 0.f;

    for (int c0 = r_begin; c0 < r_end; c0 += kChunkRows) {
      const int rows = min(kChunkRows, r_end - c0);
      __syncthreads();  // previous chunk's readers are done
      for (int e = tid; e < rows * kMT; e += kThreads) {
        const int r = e / kMT, i = e % kMT;
        sm.x[r][i] =
            i < mt ? __bfloat162float(x[(size_t)(m0 + i) * K + c0 + r]) : 0.f;
      }
      __syncthreads();
      if (col_ok) {
        for (int r = row_lane; r < rows; r += kWarps * kRowLanes) {
          const int row = c0 + r;
          const uint4 w = *reinterpret_cast<const uint4*>(
              codes + (size_t)row * N + n0);
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
          float wc[kColsPerLane];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int b = 0; b < 4; ++b)  // one signed code per byte
              wc[q * 4 + b] = (float)(((int)(words[q] << (24 - 8 * b))) >> 24);
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            const float xv = sm.x[r][i];
#pragma unroll
            for (int c = 0; c < kColsPerLane; ++c)
              acc[i][c] = fmaf(xv, wc[c], acc[i][c]);
          }
        }
      }
    }

    // reduce the 4 row lanes of each warp (lanes col_lane + 8 * k)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        float v = acc[i][c];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[i][c] = v;
      }
    if (lane < kColLanes) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          sm.red[warp][i][col_lane * kColsPerLane + c] = acc[i][c];
    }
    __syncthreads();
    // reduce the warps; each thread finishes kMT * kStrip / kThreads outputs
    for (int e = tid; e < kMT * kStrip; e += kThreads) {
      const int i = e / kStrip, c = e % kStrip;
      const int n = blockIdx.x * kStrip + c;
      if (i >= mt || n >= N) continue;
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) v += sm.red[wi][i][c];
      const size_t o = (size_t)(m0 + i) * N + n;
      if (ws != nullptr)
        atomicAdd(ws + o, v);
      else
        out[o] = __float2bfloat16(v * scale[n]);
    }
  }
}

// ws [M, N] f32 -> out bf16, times the per-channel scale
__global__ void finalize_kernel(const float* __restrict__ ws,
                                const float* __restrict__ scale,
                                __nv_bfloat16* __restrict__ out, int M,
                                int N) {
  const size_t total = (size_t)M * N;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    out[e] = __float2bfloat16(ws[e] * scale[e % N]);
  }
}

}  // namespace

extern "C" {

// x [M, K] bf16; codes [K, N] int8; scale [N] f32; out [M, N] bf16; ws
// [M, N] f32 zeroed when n_split > 1, else NULL.
int gabby_int8_matmul(const void* x, const void* codes, const void* scale,
                      void* out, void* ws, int M, int K, int N, int n_split,
                      void* stream) {
  const int rows_per_split = (K + n_split - 1) / n_split;
  dim3 grid((N + kStrip - 1) / kStrip, n_split);
  int8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), M, K, N, rows_per_split);
  return (int)cudaGetLastError();
}

int gabby_matmul_finalize(const void* ws, const void* scale, void* out,
                          int M, int N, void* stream) {
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  finalize_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), M, N);
  return (int)cudaGetLastError();
}

const char* gabby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
