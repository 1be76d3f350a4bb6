// Weight-only quantized matmuls for decode-sized M (M <= 64), Hopper
// (sm_90a): one kernel, templated over the weight format.
//
// Replaces four Pallas TPU kernels of gabby_tpu/ops/pallas/quant_matmul.py:
//   K1  _qmatmul_int4_stacked -> _int4_stacked_kernel: x @ int4 W[layer]
//       with per-output-channel scales, W stacked [L, K/2, N];
//   K2  _qmatmul_int4_grouped -> _int4_grouped_kernel: the int4 unembed,
//       x @ int4 W [K/2, N] with group scales [K/group, N] along K;
//   K5  _qmatmul_int8_stacked -> _int8_stacked_kernel: x @ int8 W[layer],
//       W stacked [L, K, N], per-output-channel scales;
//   K6  _qmatmul_int8 -> _int8_kernel: the same on a 2-D [K, N] weight
//       (the int8 unembed). K5 and K6 are one entry point: the layer of a
//       stack is a pointer offset made by the caller.
//
// Int4 layout (gabby_tpu_torch/ops/quant.pack_int4): byte (r, n) of the
// packed [K/2, N] plane holds W[r, n] + 8 in its low nibble and
// W[r + K/2, n] in its (signed) high nibble, so row r of the plane pairs
// with x[:, r] (lo) and x[:, r + K/2] (hi). Int8 is one code per byte:
// row r of the [K, N] plane pairs with x[:, r] alone, so there is no
// second x slice and no nibble algebra, at twice the bytes per K row (973
// MB per Llama-3.2-1B decode step, 263 MB for the [2048, 128256] unembed:
// ~290 us + ~80 us at 3.35 TB/s).
//
// What bounds it on the H100: at M = 8 every weight byte feeds 16 FMAs, so
// the packed bytes (486 MB per Llama-3.2-1B decode step across wqkv, wo,
// w_gup and w_down; 132 MB for the unembed) would take ~145 us + ~40 us at
// 3.35 TB/s. This first form does its FMAs on the CUDA cores in f32 (no
// tensor cores yet), which at M = 8 is close to that same time, so it is
// bound by both; moving the dot to mma/wgmma is the next step.
//
// Design: a block owns a 128-column strip of N and one slice of the packed
// rows (the wrapper splits K so that even N = 2048 puts >= 256 blocks on
// the 132 SMs). A warp is 8 column lanes x 4 row lanes; each thread reads
// its 16 packed bytes (16 columns) of a row as one 16-byte vector, unpacks
// lo = (b & 15) - 8 and hi = b >> 4 (sign-extended), and accumulates an
// 8-row tile of M in f32 against x, which is staged in shared memory as
// f32 per slice. Row lanes and warps are reduced through shuffles and
// shared memory; with one K slice the block writes the output (scale
// applied once per channel), with several it adds into an f32 workspace
// that a second pass scales and converts. Grouped scales are applied to
// the unpacked weights per group inside the loop. The layer of a stacked
// weight is a pointer offset made by the caller: nothing is copied.

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

// x slices staged as f32: [kChunkRows][kMT] for the lo and hi halves
struct Smem {
  float x_lo[kChunkRows][kMT];
  float x_hi[kChunkRows][kMT];
  float red[kWarps][kMT][kStrip];
};

enum Fmt { kInt4 = 0, kInt4Grouped = 1, kInt8 = 2 };

template <Fmt kFmt>
__global__ void __launch_bounds__(kThreads)
wq_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ packed,
                 const float* __restrict__ scale,
                 __nv_bfloat16* __restrict__ out,
                 float* __restrict__ ws, int M, int K, int N, int group,
                 int rows_per_split) {
  constexpr bool kGrouped = kFmt == kInt4Grouped;
  constexpr bool kNibbles = kFmt != kInt8;  // two x slices per weight row
  __shared__ Smem sm;
  const int kp = kNibbles ? K / 2 : K;  // rows of the weight plane
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int col_lane = lane % kColLanes;
  const int row_lane = warp * kRowLanes + lane / kColLanes;  // 0..15
  const int n0 = blockIdx.x * kStrip + col_lane * kColsPerLane;
  const bool col_ok = n0 < N;  // N % 16 == 0: a lane's 16 columns share fate
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(kp, r_begin + rows_per_split);
  const int gh = kGrouped ? kp / group : 0;  // scale groups per nibble plane

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
        float lo = 0.f, hi = 0.f;
        if (i < mt) {
          const __nv_bfloat16* xr = x + (size_t)(m0 + i) * K;
          lo = __bfloat162float(xr[c0 + r]);
          if (kNibbles) hi = __bfloat162float(xr[kp + c0 + r]);
        }
        sm.x_lo[r][i] = lo;
        if (kNibbles) sm.x_hi[r][i] = hi;
      }
      __syncthreads();
      if (col_ok) {
        int cur_group = -1;
        float s_lo[kColsPerLane], s_hi[kColsPerLane];
        for (int r = row_lane; r < rows; r += kWarps * kRowLanes) {
          const int row = c0 + r;
          const uint4 w = *reinterpret_cast<const uint4*>(
              packed + (size_t)row * N + n0);
          if (kGrouped && row / group != cur_group) {
            cur_group = row / group;
            const float* sl = scale + (size_t)cur_group * N + n0;
            const float* sh = scale + (size_t)(gh + cur_group) * N + n0;
#pragma unroll
            for (int c = 0; c < kColsPerLane; ++c) {
              s_lo[c] = sl[c];
              s_hi[c] = sh[c];
            }
          }
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
          float wl[kColsPerLane], wh[kColsPerLane];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const uint32_t word = words[q];
              const int c = q * 4 + b;
              if (kNibbles) {
                wl[c] = (float)((int)((word >> (8 * b)) & 15u) - 8);
                wh[c] = (float)(((int)(word << (24 - 8 * b))) >> 28);
              } else {  // one signed code per byte
                wl[c] = (float)(((int)(word << (24 - 8 * b))) >> 24);
                wh[c] = 0.f;
              }
              if (kGrouped) {
                wl[c] *= s_lo[c];
                wh[c] *= s_hi[c];
              }
            }
          }
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            const float xl = sm.x_lo[r][i];
            const float xh = kNibbles ? sm.x_hi[r][i] : 0.f;
#pragma unroll
            for (int c = 0; c < kColsPerLane; ++c)
              acc[i][c] = kNibbles
                  ? fmaf(xl, wl[c], fmaf(xh, wh[c], acc[i][c]))
                  : fmaf(xl, wl[c], acc[i][c]);
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
      if (ws != nullptr) {
        atomicAdd(ws + o, v);
      } else {
        if (!kGrouped) v *= scale[n];
        out[o] = __float2bfloat16(v);
      }
    }
  }
}

// ws [M, N] f32 -> out bf16, times the per-channel scale when given
__global__ void finalize_kernel(const float* __restrict__ ws,
                                const float* __restrict__ scale,
                                __nv_bfloat16* __restrict__ out, int M,
                                int N) {
  const size_t total = (size_t)M * N;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = ws[e];
    if (scale != nullptr) v *= scale[e % N];
    out[e] = __float2bfloat16(v);
  }
}

}  // namespace

extern "C" {

// x [M, K] bf16; packed [K/2, N] int8 (one layer: the caller offsets the
// pointer); scale [N] f32 (group == 0) or [K/group, N] f32; out [M, N]
// bf16; ws [M, N] f32 zeroed when n_split > 1, else NULL.
int gabby_int4_matmul(const void* x, const void* packed, const void* scale,
                      void* out, void* ws, int M, int K, int N, int group,
                      int n_split, void* stream) {
  const int kp = K / 2;
  const int rows_per_split = (kp + n_split - 1) / n_split;
  dim3 grid((N + kStrip - 1) / kStrip, n_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* pp = static_cast<const int8_t*>(packed);
  auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* wp = static_cast<float*>(ws);
  if (group > 0)
    wq_matmul_kernel<kInt4Grouped><<<grid, kThreads, 0, s>>>(
        xp, pp, sp, op, wp, M, K, N, group, rows_per_split);
  else
    wq_matmul_kernel<kInt4><<<grid, kThreads, 0, s>>>(
        xp, pp, sp, op, wp, M, K, N, group, rows_per_split);
  return (int)cudaGetLastError();
}

// x [M, K] bf16; codes [K, N] int8 (one layer of a stack by pointer
// offset, or a 2-D weight); scale [N] f32; out [M, N] bf16; ws [M, N] f32
// zeroed when n_split > 1, else NULL.
int gabby_int8_matmul(const void* x, const void* codes, const void* scale,
                      void* out, void* ws, int M, int K, int N, int n_split,
                      void* stream) {
  const int rows_per_split = (K + n_split - 1) / n_split;
  dim3 grid((N + kStrip - 1) / kStrip, n_split);
  wq_matmul_kernel<kInt8>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const int8_t*>(codes),
          static_cast<const float*>(scale),
          static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), M, K, N,
          0, rows_per_split);
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
