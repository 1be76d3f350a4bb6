// Weight-only quantized matmuls for decode-sized M (M <= 64), Hopper
// (sm_90a): one kernel, templated over the weight format.
//
// Replaces three Pallas TPU kernels of gabby_tpu/ops/pallas/quant_matmul.py
// and one form of them:
//   K1  _qmatmul_int4_stacked -> _int4_stacked_kernel: x @ int4 W[layer]
//       with per-output-channel scales, W stacked [L, K/2, N];
//   K33 the same call's raw-byte-dot body, _int4_stacked_rawdot_kernel
//       (GABBY_INT4_RAWDOT=1): x_odd / 16 against the packed byte read as
//       a signed value b = 16 hi + lo8, x_even - x_odd / 16 (one bf16
//       rounding) against lo8 = b & 15;
//   K5  _qmatmul_int8_stacked -> _int8_stacked_kernel: x @ int8 W[layer],
//       W stacked [L, K, N], per-output-channel scales;
//   K6  _qmatmul_int8 -> _int8_kernel: the same on a 2-D [K, N] weight
//       (the int8 unembed). K5 and K6 are one entry point: the layer of a
//       stack is a pointer offset made by the caller.
// The grouped int4 unembed (K2) has its own kernel in
// quant_matmul_unembed.cu.
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
// K33's algebra. The reference computes
//   xo16 . b + xc . lo8 - 8 (rowsum(xc) + rowsum(xo16))
// with xo16 = x_odd / 16 (exact) and xc = bf16(x_even - xo16). Here x is
// staged as those two slices (xc rounded by __float2bfloat16_rn of the f32
// difference, as the reference rounds it) and the unpack gives b - 8
// against xo16 and lo8 - 8 against xc: the same sum, since
//   sum xo16 (b - 8) + xc (lo8 - 8)
//     = sum xo16 b + xc lo8 - 8 sum (xc + xo16),
// with b - 8 and lo8 - 8 exact small integers in f32. On this card the
// form changes one thing per weight: the high plane's code is the byte
// sign-extended and converted, in place of K1's shift and convert. It does
// not change the bytes.
//
// What bounds it on the H100: bytes. At M = 8 every weight byte feeds 16
// FMAs; the packed bytes of one Llama-3.2-1B decode step (486 MB across
// wqkv, wo, w_gup and w_down in 64 launches) take 0.149 ms at 3.35 TB/s
// (the same for K1 and K33). This form does its FMAs on the CUDA cores in
// f32, which at M = 8 is close to that same time, and splits K across
// blocks through an f32 workspace and a finalize pass: the decode
// projections have N = 2048..16384, too few 128-column strips to fill 132
// SMs. K1 and its forms (K33, K5) are rebuilt on the tensor cores, one
// launch a call, in a later change.
//
// Design: a block owns a 128-column strip of N and one slice of the packed
// rows (the wrapper splits K so that even N = 2048 puts >= 256 blocks on
// the 132 SMs). A warp is 8 column lanes x 4 row lanes; each thread reads
// its 16 packed bytes (16 columns) of a row as one 16-byte vector, unpacks
// its two codes per byte, and accumulates an 8-row tile of M in f32
// against x, which is staged in shared memory as f32 per slice. Row lanes
// and warps are reduced through shuffles and shared memory; with one K
// slice the block writes the output (scale applied once per channel), with
// several it adds into an f32 workspace that a second pass scales and
// converts. The layer of a stacked weight is a pointer offset made by the
// caller: nothing is copied.

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
// (K33: xc and xo16)
struct Smem {
  float x_lo[kChunkRows][kMT];
  float x_hi[kChunkRows][kMT];
  float red[kWarps][kMT][kStrip];
};

enum Fmt { kInt4 = 0, kInt4Raw = 1, kInt8 = 2 };

template <Fmt kFmt>
__global__ void __launch_bounds__(kThreads)
wq_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ packed,
                 const float* __restrict__ scale,
                 __nv_bfloat16* __restrict__ out,
                 float* __restrict__ ws, int M, int K, int N,
                 int rows_per_split) {
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
          if (kFmt == kInt4Raw) {  // xo16 = x_odd / 16 (exact) and
            // xc = bf16(x_even - xo16), rounded to nearest even
            hi *= 0.0625f;
            lo = __bfloat162float(__float2bfloat16_rn(lo - hi));
          }
        }
        sm.x_lo[r][i] = lo;
        if (kNibbles) sm.x_hi[r][i] = hi;
      }
      __syncthreads();
      if (col_ok) {
        for (int r = row_lane; r < rows; r += kWarps * kRowLanes) {
          const int row = c0 + r;
          const uint4 w = *reinterpret_cast<const uint4*>(
              packed + (size_t)row * N + n0);
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
          float wl[kColsPerLane], wh[kColsPerLane];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const uint32_t word = words[q];
              const int c = q * 4 + b;
              const int byte = ((int)(word << (24 - 8 * b))) >> 24;
              if (kFmt == kInt4) {
                wl[c] = (float)((int)((word >> (8 * b)) & 15u) - 8);
                wh[c] = (float)(byte >> 4);
              } else if (kFmt == kInt4Raw) {  // lo8 - 8 and b - 8
                wl[c] = (float)((byte & 15) - 8);
                wh[c] = (float)(byte - 8);
              } else {  // one signed code per byte
                wl[c] = (float)byte;
                wh[c] = 0.f;
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

template <Fmt kFmt>
int launch(const void* x, const void* q, const void* scale, void* out,
           void* ws, int M, int K, int N, int n_split, void* stream) {
  const int kp = kFmt == kInt8 ? K : K / 2;  // rows of the weight plane
  const int rows_per_split = (kp + n_split - 1) / n_split;
  dim3 grid((N + kStrip - 1) / kStrip, n_split);
  wq_matmul_kernel<kFmt>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
          static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
          static_cast<float*>(ws), M, K, N, rows_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] bf16; packed [K/2, N] int8 (one layer: the caller offsets the
// pointer); scale [N] f32; out [M, N] bf16; ws [M, N] f32 zeroed when
// n_split > 1, else NULL.
int gabby_int4_matmul(const void* x, const void* packed, const void* scale,
                      void* out, void* ws, int M, int K, int N, int n_split,
                      void* stream) {
  return launch<kInt4>(x, packed, scale, out, ws, M, K, N, n_split, stream);
}

// K33, the raw-byte-dot form: the arguments of gabby_int4_matmul.
int gabby_int4_matmul_rawdot(const void* x, const void* packed,
                             const void* scale, void* out, void* ws, int M,
                             int K, int N, int n_split, void* stream) {
  return launch<kInt4Raw>(x, packed, scale, out, ws, M, K, N, n_split,
                          stream);
}

// x [M, K] bf16; codes [K, N] int8 (one layer of a stack by pointer
// offset, or a 2-D weight); scale [N] f32; out [M, N] bf16; ws [M, N] f32
// zeroed when n_split > 1, else NULL.
int gabby_int8_matmul(const void* x, const void* codes, const void* scale,
                      void* out, void* ws, int M, int K, int N, int n_split,
                      void* stream) {
  return launch<kInt8>(x, codes, scale, out, ws, M, K, N, n_split, stream);
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
