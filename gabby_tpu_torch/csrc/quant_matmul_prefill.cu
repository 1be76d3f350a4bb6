// Int4 weight-only matmul for prefill-sized M (any M >= 1; the engine's
// chunks reach 512), Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   K7  gabby_tpu/ops/pallas/quant_matmul.py _qmatmul_int4 -> _int4_kernel:
//       x [M, K] bf16 @ half-split packed int4 W [K/2, N], f32 accumulate,
//       per-output-channel scale once at the end -> [M, N] bf16.
// A layer of a stacked weight is a pointer offset made by the caller.
//
// What bounds it on the H100: operations. One 512-token chunk of
// Llama-3.2-1B is 2 * 512 * 973 M = 1.0 TFLOP over its 64 launches (~1.0 ms
// at 989 TFLOP/s bf16) against 486 MB of packed weights (~0.15 ms). So
// unlike the decode kernels (quant_matmul.cu), x no longer fits a block: M
// is tiled, and the products run on the tensor cores.
//
// Design: a block owns a 128 x 64 output tile and walks the packed rows 32
// at a time. Each step stages two 32-deep x slabs (columns r.. and
// K/2 + r.., the half-split pairing) and unpacks the 32 x 64 packed bytes
// ONCE into two bf16 planes in shared memory (lo = (b & 15) - 8,
// hi = b >> 4 sign-extended; both exact in bf16), stored n-major so that
// a B fragment is one 32-bit load; the eight warps (4 along M x 2 along N,
// 32 x 32 outputs each) reuse them across the whole M tile through
// mma.sync m16n8k16 (bf16 in, f32 accumulate). Rows are padded to 40 bf16
// so fragment loads hit 32 distinct banks. Global loads of the next step
// are issued before the barrier that retires the previous step's reads;
// there is no deeper pipeline yet (TMA / wgmma are later work). Rows of x
// past M load as zeros and are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kBM = 128;       // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBKP = 32;       // packed rows per step (K depth 64)
constexpr int kLd = kBKP + 8;  // padded row length in bf16 (20 words)

struct Smem {
  __nv_bfloat16 x_lo[kBM][kLd];
  __nv_bfloat16 x_hi[kBM][kLd];
  __nv_bfloat16 w_lo[kBN][kLd];  // n-major: w_lo[n][k]
  __nv_bfloat16 w_hi[kBN][kLd];
};

__device__ __forceinline__ uint32_t pack_bf16(int a, int b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn((float)a, (float)b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A (16x16, row-major) * B (16x8, column-major), bf16 -> f32
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
int4_prefill_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) Smem sm;
  const int kp = K / 2;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int warp_m = warp / 2, warp_n = warp % 2;
  const int m_blk = blockIdx.y * kBM, n_blk = blockIdx.x * kBN;

  // weight unpack: a thread owns 2 packed rows x 4 columns of the tile; a
  // warp reads 32 contiguous bytes of 8 rows
  const int cg = lane % 8 + 8 * (warp % 2);  // column group, 0..15
  const int rp = lane / 8 + 4 * (warp / 2);  // row pair, 0..15
  const int8_t* w_src = packed + (size_t)(2 * rp) * N + n_blk + cg * 4;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int r0 = 0; r0 < kp; r0 += kBKP) {
    // global -> registers (before the barrier: overlaps the other warps'
    // products of the previous step)
    uint4 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;  // 0..1023: plane, row, vector
      const int plane = idx / 512, row = (idx % 512) / 4, v = idx % 4;
      xv[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m_blk + row < M)
        xv[i] = *reinterpret_cast<const uint4*>(
            x + (size_t)(m_blk + row) * K + (plane ? kp : 0) + r0 + v * 8);
    }
    const uint32_t wa =
        *reinterpret_cast<const uint32_t*>(w_src + (size_t)r0 * N);
    const uint32_t wb =
        *reinterpret_cast<const uint32_t*>(w_src + (size_t)(r0 + 1) * N);

    __syncthreads();  // the previous step's fragment loads are done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const int plane = idx / 512, row = (idx % 512) / 4, v = idx % 4;
      __nv_bfloat16* dst = plane ? &sm.x_hi[row][v * 8] : &sm.x_lo[row][v * 8];
      *reinterpret_cast<uint4*>(dst) = xv[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lo_a = (int)((wa >> (8 * j)) & 15u) - 8;
      const int lo_b = (int)((wb >> (8 * j)) & 15u) - 8;
      const int hi_a = ((int)(wa << (24 - 8 * j))) >> 28;
      const int hi_b = ((int)(wb << (24 - 8 * j))) >> 28;
      *reinterpret_cast<uint32_t*>(&sm.w_lo[cg * 4 + j][2 * rp]) =
          pack_bf16(lo_a, lo_b);
      *reinterpret_cast<uint32_t*>(&sm.w_hi[cg * 4 + j][2 * rp]) =
          pack_bf16(hi_a, hi_b);
    }
    __syncthreads();

#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      const __nv_bfloat16(*xs)[kLd] = plane ? sm.x_hi : sm.x_lo;
      const __nv_bfloat16(*wsm)[kLd] = plane ? sm.w_hi : sm.w_lo;
#pragma unroll
      for (int ks = 0; ks < kBKP; ks += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int row = warp_m * 32 + mi * 16 + g;
          a[mi][0] = ld32(&xs[row][ks + t * 2]);
          a[mi][1] = ld32(&xs[row + 8][ks + t * 2]);
          a[mi][2] = ld32(&xs[row][ks + t * 2 + 8]);
          a[mi][3] = ld32(&xs[row + 8][ks + t * 2 + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = warp_n * 32 + ni * 8 + g;
          b[ni][0] = ld32(&wsm[col][ks + t * 2]);
          b[ni][1] = ld32(&wsm[col][ks + t * 2 + 8]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
      }
    }
  }

  // scale once per channel, convert, store two adjacent columns at a time
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int row = m_blk + warp_m * 32 + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n_blk + warp_n * 32 + ni * 8 + t * 2;
      const float s0 = scale[col], s1 = scale[col + 1];
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][0] * s0, acc[mi][ni][1] * s1);
      if (row + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * N +
                                           col) =
            __floats2bfloat162_rn(acc[mi][ni][2] * s0, acc[mi][ni][3] * s1);
    }
  }
}

}  // namespace

extern "C" {

// x [M, K] bf16; packed [K/2, N] int8 (one layer by pointer offset);
// scale [N] f32; out [M, N] bf16. K % 64 == 0 and N % 64 == 0.
int gabby_int4_matmul_prefill(const void* x, const void* packed,
                              const void* scale, void* out, int M, int K,
                              int N, void* stream) {
  dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  int4_prefill_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(packed), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
