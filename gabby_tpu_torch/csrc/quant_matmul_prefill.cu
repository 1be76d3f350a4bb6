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
// at 989 TFLOP/s bf16) against 486 MB of packed weights (~0.15 ms). Only
// warpgroup MMA (wgmma) reaches that rate; the unpack of the int4 codes must
// stay off its critical path.
//
// Design: the product is computed transposed, out^T = W^T x^T, so that the
// weight is wgmma's A operand, taken from registers, and x is its B operand,
// read by the tensor cores from shared memory.
//   * A block owns 128 output channels and BT tokens (128 or 64): two
//     consumer warpgroups of 64 channels each and a producer warpgroup
//     (384 threads, one block a multiprocessor) that gives its registers
//     to them by setmaxnreg (40 against 232 a thread). Where the output
//     tiles cannot fill the card, K is split in two parts whose f32 sums a
//     second kernel adds in part order (deterministic, no atomics); `plan`
//     picks the tile and the split from the sizes. At M = 512 `wqkv` and
//     `w_gup` take 128-token tiles unsplit (96 and 512 blocks), `wo`
//     64-token tiles (128 blocks), `w_down` 128-token tiles in two parts
//     (128 blocks on 132 SMs).
//   * The producer's one thread issues three TMA copies a stage, both
//     halves of the x tile (x seen as [M][2][K/2]) and the packed tile of
//     64 rows (128 of K), 128-byte swizzled and zero past M, K/2 and N,
//     completing on the stage's "full" mbarrier; it reuses a stage once all
//     eight consumer warps have arrived on its "empty" mbarrier. Four
//     stages. No block barrier in the main loop: the two warpgroups run
//     apart.
//   * Each weight byte is read from shared memory by exactly one thread and
//     unpacked once per block straight into the A fragments: thread (warp
//     w, lane g, t) owns channels 2g and 2g + 1 of its warp's 16 (fragment
//     rows g and g + 8) and loads them as one 16-bit word per packed row
//     (conflict-free under the swizzle); __byte_perm pairs two rows, and
//     the codes become bf16 by the magic number trick (0x4300 | u is
//     128 + u; subtract 136), exact for both nibbles: lo = (b & 15) - 8 for
//     x[:, :K/2], hi = b >> 4 (signed) for x[:, K/2:].
//   * Eight wgmma m64nBTk16 a stage per warpgroup (four K16 steps x two
//     halves), one commit group. Stage i + 1 is unpacked into a second
//     register buffer while stage i's group runs; the group is then waited
//     for in full, so no register a running product uses is touched and
//     ptxas need not serialize the wgmma.
//   * Epilogue: the scale once per channel, bf16 stores of two adjacent
//     channels (or the part's f32 sums), tokens past M never stored.
// Times (python3 chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): the 64
// launches of one 512-token chunk take 2.183 ms replayed from a CUDA graph
// (2.297 issued eagerly; the earlier mma.sync form 9.463), against 1.687 for
// cuBLAS on the dequantized weight and a bound of 1.008. By projection, 16
// launches each: wqkv 0.295, wo 0.234, w_gup 1.075 (52% of the bf16 peak),
// w_down 0.588 (47%). What is left: the unpack costs every stage the same
// whatever BT, so `wo`'s 64-token tiles run at 30% of the peak; `wqkv`
// fills 96 of 132 SMs (35%).

#include "int4_wgmma.cuh"

namespace {

constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kBN = 128;                   // output channels per block
constexpr int kBKP = 64;                   // packed rows per stage (K 128)
constexpr int kStages = 4;


template <int BT>
__host__ __device__ constexpr int stage_bytes() {  // x halves, then weight
  return 2 * BT * 128 + kBKP * kBN;
}

template <int BT>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)kStages * stage_bytes<BT>() +
         2 * kStages * sizeof(uint64_t);
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int BT>
__device__ __forceinline__ void wgmma_tile(float (&d)[BT / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (BT == 128)
    wgmma_n128(d, a, desc);
  else
    wgmma_n64(d, a, desc);
}

// A fragments of one stage for both halves: a[half][k16 step][4]. The
// packed tile is [64 rows][128 channels] as TMA's 128-byte swizzle lays
// it: 16-byte chunk c of row r at r * 128 + ((c ^ (r & 7)) << 4), so the
// 16-bit loads of a warp hit 32 distinct banks.
__device__ __forceinline__ void unpack_stage(const uint8_t* w, int chunk,
                                             int g, int t,
                                             uint32_t (&a)[2][4][4]) {
  const uint8_t* even = w + ((chunk ^ (2 * t)) << 4) + 2 * g;
  const uint8_t* odd = w + ((chunk ^ (2 * t + 1)) << 4) + 2 * g;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int r = 16 * s + 2 * t;  // r & 7 == 2t, (r + 1) & 7 == 2t + 1
    const uint32_t x0 = *reinterpret_cast<const uint16_t*>(even + r * 128);
    const uint32_t x1 =
        *reinterpret_cast<const uint16_t*>(odd + (r + 1) * 128);
    const uint32_t x2 =
        *reinterpret_cast<const uint16_t*>(even + (r + 8) * 128);
    const uint32_t x3 =
        *reinterpret_cast<const uint16_t*>(odd + (r + 9) * 128);
    // fragment rows g (channel 2g, byte 0) and g + 8 (channel 2g + 1,
    // byte 1); k pairs (2t, 2t + 1) from x0/x1, (2t + 8, 2t + 9) from x2/x3
    const uint32_t v[4] = {__byte_perm(x0, x1, 0x0400),
                           __byte_perm(x0, x1, 0x0501),
                           __byte_perm(x2, x3, 0x0400),
                           __byte_perm(x2, x3, 0x0501)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[0][s][j] = minus136((v[j] & 0x000F000Fu) | 0x43004300u);
      a[1][s][j] = minus136(((v[j] >> 4) & 0x000F000Fu) ^ 0x43084308u);
    }
  }
}

// xmap, wmap: int4_tensor_maps (int4_wgmma.cuh) of x and the layer's
// packed plane, with boxes of BT tokens.
template <int BT>
__global__ void __launch_bounds__(kThreads, 1)
int4_prefill_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part, int M, int K, int N) {
  constexpr int kStage = stage_bytes<BT>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + kStages * kStage;  // kStages barriers each
  const uint32_t empty = full + kStages * 8;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BT;
  // part z of a split K takes stages [first, first + n_steps)
  const int z = blockIdx.z, k_split = gridDim.z;
  const int n_all = (K / 2 + kBKP - 1) / kBKP;
  const int first = z * n_all / k_split;
  const int n_steps = (z + 1) * n_all / k_split - first;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer: one thread issues every copy
    // and the warpgroup hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * s, (i / kStages - 1) & 1);
        const uint32_t st = base + s * kStage, bar = full + 8 * s;
        mbar_expect_tx(bar, kStage);
        const int r0 = (first + i) * kBKP;
        tma_3d(st, xmap, r0, 0, m0, bar);
        tma_3d(st + BT * 128, xmap, r0, 1, m0, bar);
        tma_2d(st + 2 * BT * 128, wmap, n0, r0, bar);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int chunk = 4 * wg + warp;  // the warp's 16 channels of the 128

  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][2][4][4];  // [buffer][half][k16 step][4], two stages' worth

  if (n_steps > 0) {
    mbar_wait(full, 0);
    unpack_stage(smem + 2 * BT * 128, chunk, g, t, a[0]);
  }
  // Step i: issue stage i's products from the fragments unpacked in step
  // i - 1; while they run, wait for stage i + 1 and unpack it into the
  // other fragment buffer; then wait for the products and hand the stage
  // back to the producer. Two steps an iteration, so each buffer is a
  // fixed set of registers and no register a running product reads or
  // writes is touched. The two warpgroups run apart: no block barrier.
  for (int i0 = 0; i0 < n_steps; i0 += 2) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int i = i0 + b;
      if (i >= n_steps) break;
      const int s = i % kStages;
      const uint32_t xs = base + s * kStage;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_tile<BT>(acc, a[b][h][k],
                         sw128_desc(xs + h * BT * 128 + k * 32));
      wgmma_commit();
      if (i + 1 < n_steps) {
        const int s1 = (i + 1) % kStages;
        mbar_wait(full + 8 * s1, ((i + 1) / kStages) & 1);
        unpack_stage(smem + s1 * kStage + 2 * BT * 128, chunk, g, t,
                     a[b ^ 1]);
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
  }

  // accumulator: d[4j + e] holds fragment row g + 8 (e / 2) (channel
  // 2g + e / 2 of the warp's 16), token 8j + 2t + e % 2
  const int ch = n0 + 64 * wg + 16 * warp + 2 * g;
  if (ch >= N) return;
  if (k_split > 1) {  // this part's sums, unscaled, for the merge
    float* p = part + (size_t)z * M * N + ch;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const int tok = m0 + 8 * j + 2 * t;
      if (tok < M)
        *reinterpret_cast<float2*>(p + (size_t)tok * N) =
            make_float2(acc[4 * j], acc[4 * j + 2]);
      if (tok + 1 < M)
        *reinterpret_cast<float2*>(p + (size_t)(tok + 1) * N) =
            make_float2(acc[4 * j + 1], acc[4 * j + 3]);
    }
    return;
  }
  const float s0 = scale[ch], s1 = scale[ch + 1];
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    const int tok = m0 + 8 * j + 2 * t;
    if (tok < M)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)tok * N + ch) =
          __floats2bfloat162_rn(acc[4 * j] * s0, acc[4 * j + 2] * s1);
    if (tok + 1 < M)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(tok + 1) * N + ch) =
          __floats2bfloat162_rn(acc[4 * j + 1] * s0, acc[4 * j + 3] * s1);
  }
}

// The k_split parts' sums added in part order (deterministic), the scale
// once per channel, bf16 out: two channels a thread.
__global__ void __launch_bounds__(256)
int4_prefill_merge(const float* __restrict__ part,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, int M, int N,
                   int k_split) {
  const size_t total = (size_t)M * N;
  const size_t i = 2 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= total) return;
  float2 sum = *reinterpret_cast<const float2*>(part + i);
  for (int z = 1; z < k_split; ++z) {
    const float2 p = *reinterpret_cast<const float2*>(part + z * total + i);
    sum.x += p.x;
    sum.y += p.y;
  }
  const int ch = (int)(i % N);
  *reinterpret_cast<__nv_bfloat162*>(out + i) =
      __floats2bfloat162_rn(sum.x * scale[ch], sum.y * scale[ch + 1]);
}

template <int BT>
int launch(const void* x, const void* packed, const void* scale, void* out,
           void* part, int M, int K, int N, int k_split, int dev,
           cudaStream_t stream) {
  // The leave to take more than 48 KB of shared memory holds per kernel
  // and device; set under a lock, so calls may come from several threads
  // and go to several devices.
  {
    static std::mutex mu;
    static bool done[64] = {};
    std::lock_guard<std::mutex> lock(mu);
    if (!done[dev]) {
      cudaError_t err = cudaFuncSetAttribute(
          int4_prefill_kernel<BT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<BT>());
      if (err != cudaSuccess) return (int)err;
      done[dev] = true;
    }
  }
  CUtensorMap xmap, wmap;
  const cudaError_t err = int4_tensor_maps(x, packed, M, K, N, BT, &xmap,
                                           &wmap);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kBN - 1) / kBN, (M + BT - 1) / BT, k_split);
  int4_prefill_kernel<BT><<<grid, kThreads, smem_bytes<BT>(), stream>>>(
      xmap, wmap, static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), M, K, N);
  if (k_split > 1) {
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return (int)launched;
    const size_t pairs = (size_t)M * N / 2;
    int4_prefill_merge<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(part), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), M, N, k_split);
  }
  return (int)cudaGetLastError();
}

struct Plan {
  int bt, k_split;
};

// The token tile and the split of K with the least estimated time: waves
// of one block a multiprocessor x stages a block, a 64-token stage taking
// about 0.7 of a 128-token one, a split adding a merge pass worth about
// four stages. At M = 512: `wqkv` and `w_gup` 128 tokens unsplit (96 and
// 512 blocks), `wo` 64 tokens unsplit and `w_down` 128 tokens in two parts
// (128 blocks each).
Plan plan(int M, int K, int N, int sms) {
  const long cols = (N + kBN - 1) / kBN, steps = (K / 2 + kBKP - 1) / kBKP;
  Plan best{64, 1};
  long best_cost = -1;
  for (int bt : {128, 64})
    for (int ks : {1, 2}) {
      if (ks > steps) continue;
      const long blocks = cols * ((M + bt - 1) / bt) * ks;
      const long cost = (bt == 128 ? 10 : 7) * ((blocks + sms - 1) / sms) *
                            ((steps + ks - 1) / ks) +
                        (ks > 1 ? 40 : 0);
      if (best_cost < 0 || cost < best_cost) {
        best = Plan{bt, ks};
        best_cost = cost;
      }
    }
  return best;
}

}  // namespace

extern "C" {

// How many parts K is split into for these sizes (1 or 2); the caller
// gives gabby_int4_matmul_prefill a workspace of that many [M, N] f32
// planes when it is 2.
int gabby_int4_matmul_prefill_splits(int M, int K, int N) {
  int dev = 0, sms = 0;
  if (M < 1 || K % 64 || N % 64 || multiprocessors(&dev, &sms) != cudaSuccess)
    return 1;
  return plan(M, K, N, sms).k_split;
}

// x [M, K] bf16; packed [K/2, N] int8 (one layer by pointer offset);
// scale [N] f32; out [M, N] bf16; part: k_split x [M, N] f32 or NULL.
// K % 64 == 0 and N % 64 == 0; x and packed 16-byte aligned; k_split as
// gabby_int4_matmul_prefill_splits gave it.
int gabby_int4_matmul_prefill(const void* x, const void* packed,
                              const void* scale, void* out, void* part,
                              int M, int K, int N, int k_split,
                              void* stream) {
  if (M < 1 || K % 64 || N % 64 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = multiprocessors(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan(M, K, N, sms);
  if (k_split != p.k_split || (k_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.bt == 128
             ? launch<128>(x, packed, scale, out, part, M, K, N, k_split,
                           dev, s)
             : launch<64>(x, packed, scale, out, part, M, K, N, k_split, dev,
                          s);
}

}  // extern "C"
