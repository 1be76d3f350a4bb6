// s8 decode attention over the int8 KV cache, dense or paged, unpaired or
// paired, Hopper (sm_90a): K14, K15 (dense) and K19, K20 (paged).
//
// Replaces the use_s8=True form of
// gabby_tpu/ops/pallas/attention.py:_decode_call and _paged_decode_call
// (the use_s8 branches of their _flash_step body), which is the reference's
// default for single-position decode over a quantized cache with the fresh
// row. Per (slot, kv head) and query row r of the group:
//   qs = max(|q_r|, 1e-9) / 127, q8 = round(q_r / qs);
//   score_j = int32(q8 . k_codes_j) * qs * (k_scale_j * sm_scale), j < n;
//   an online softmax in f32 over chunks of `chunk` cache rows counted
//   from row 0 (a page, in the paged form), l summed over the unquantized
//   p; within a chunk pvf_j = p_j * v_scale_j, pscale = max(max_j pvf_j,
//   1e-30) / 127 PER ROW OVER THE CHUNK, p8 = round(pvf / pscale), and the
//   chunk adds int32(p8 . v_codes) * pscale;
//   the current token's unquantized k/v row is folded in last, in f32.
// Rounding is to nearest even (__float2int_rn), as jnp.round. Both integer
// products are exact, so the kernel differs from its plain version only in
// exp and in the order of the f32 sums.
//
// What bounds it on the H100: bytes, as the bf16/f32 form: 2 * n * (H + 4)
// bytes per (slot, kv head); the 4 * G * H integer operations per cache
// row are far below the byte rate at the int8 tensor-core peak. This first
// form takes the products with __dp4a on the CUDA cores. head_dim H is 64
// or 128 and the group G any of 1, 2, 3, 4, 8 (one instantiation each).
//
// Design: one block per (slot, kv head), 4 warps, R = G query rows. pscale
// needs a row's maximum over the WHOLE chunk before any probability of the
// chunk is quantized, so a chunk takes three passes with the scores parked
// in dynamic shared memory (R x chunk f32, 16 KB at G = 4 and 1024 rows):
//   A  a lane loads its H-byte key row, takes H / 4 __dp4a per query row
//      against the packed q8 words (shared-memory broadcasts) and stores
//      the scaled score; the block reduces the chunk's maximum;
//   B  p = exp(score - m_new) for every parked score, p * v_scale written
//      back over it; the block reduces sum(p) and max(p * v_scale); then
//      the quantized p8 go to a second shared plane as bytes;
//   C  a warp stages 32 value rows in its shared tile; each lane owns H / 32
//      adjacent output dims, transposes four rows' bytes of each dim into
//      one word (__byte_perm) and takes one __dp4a per query row and dim
//      against the word of four p8.
// The loop ends at the slot's own position, so a slot at position 0 sees
// only the fresh row, and (paged) table entries past its rows are never
// followed. The paired layout is an addressing (flash_rows.cuh): the block
// of head 2p + h reads bytes [H h, H h + H) of each 2H-byte line, so its
// result equals the unpaired one on the same rows re-laid.

#include "flash_rows.cuh"

namespace {

using namespace gabby_flash;

constexpr int kMaxDynamic = 160 * 1024;

// Reduces v[r] over the block (max or sum); every thread gets the result.
template <int R, bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[R],
                                             float (*red)[R], int warp,
                                             int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = kMax ? warp_max(v[r]) : warp_sum(v[r]);
    if (lane == 0) red[warp][r] = v[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float x = red[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      x = kMax ? fmaxf(x, red[w][r]) : x + red[w][r];
    v[r] = x;
  }
  __syncthreads();  // red is written again by the next reduction
}

template <int R, bool kPaged, int H>
__global__ void __launch_bounds__(kThreads)
attention_s8_kernel(const __nv_bfloat16* __restrict__ q, const KvSource src,
                    const __nv_bfloat16* __restrict__ fk,
                    const __nv_bfloat16* __restrict__ fv,
                    const int* __restrict__ positions,
                    __nv_bfloat16* __restrict__ out, int Nq, int Nk,
                    int limit, int chunk, int chunk_pad, float sm_scale) {
  extern __shared__ __align__(16) unsigned char dyn[];
  float* s_s = reinterpret_cast<float*>(dyn);            // [R][chunk_pad]
  int8_t* p8_s = reinterpret_cast<int8_t*>(s_s + (size_t)R * chunk_pad);
  constexpr int kD = H / 32;  // output dims a lane owns
  __shared__ float qf_s[R][H];
  __shared__ __align__(16) int8_t q8_s[R][H];
  __shared__ float qs_s[R];
  __shared__ __align__(16) int8_t v_s[kWarps][kChunk][H];
  __shared__ float red_s[kWarps][R], red2_s[kWarps][R];
  __shared__ float acc_s[kWarps][R][H];
  __shared__ float m_s[R], l_s[R], fresh_s[R];

  const int b = blockIdx.x, kh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qrow = (size_t)b * Nq + (size_t)kh * R;

  for (int e = tid; e < R * H; e += kThreads)
    qf_s[e / H][e % H] = __bfloat162float(q[qrow * H + e]);
  __syncthreads();
  for (int r = warp; r < R; r += kWarps) {
    float qa = 0.f;
#pragma unroll
    for (int i = 0; i < H / 32; ++i)
      qa = fmaxf(qa, fabsf(qf_s[r][lane + 32 * i]));
    qa = warp_max(qa);
    const float qs = fmaxf(qa, 1e-9f) * (1.0f / 127.0f);
#pragma unroll
    for (int i = 0; i < H / 32; ++i)
      q8_s[r][lane + 32 * i] =
          (int8_t)__float2int_rn(qf_s[r][lane + 32 * i] / qs);
    if (lane == 0) qs_s[r] = qs;
  }
  __syncthreads();

  const int capacity = kPaged ? src.rows * src.max_pages : src.rows;
  const int n = max(0, min(min(positions[b], limit), capacity));

  float m[R], l[R], acc[R][kD], qs[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[r][d] = 0.f;
    qs[r] = qs_s[r];
  }

  for (int base = 0; base < n; base += chunk) {
    const int cn = min(chunk, n - base);       // live rows of this chunk
    const int cn_pad = (cn + kChunk - 1) / kChunk * kChunk;

    // A: scores of the chunk, parked in shared memory
    float cmax[R];
#pragma unroll
    for (int r = 0; r < R; ++r) cmax[r] = kNegInf;
    for (int j0 = warp * kChunk; j0 < cn; j0 += kWarps * kChunk) {
      const int j = j0 + lane;
      if (j < cn) {
        const RowAddr at = chunk_row<kPaged, H>(src, b, kh, Nk, base + j0);
        const int4* kp = reinterpret_cast<const int4*>(
            static_cast<const int8_t*>(src.k) + at.code +
            (size_t)lane * at.stride);
        int4 krow[H / 16];
#pragma unroll
        for (int v4 = 0; v4 < H / 16; ++v4) krow[v4] = kp[v4];
        const float kscale = src.ks[at.scale + lane] * sm_scale;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int4* qw = reinterpret_cast<const int4*>(&q8_s[r][0]);
          int dot = 0;
#pragma unroll
          for (int v4 = 0; v4 < H / 16; ++v4) {
            const int4 qv = qw[v4];
            dot = __dp4a(krow[v4].x, qv.x, dot);
            dot = __dp4a(krow[v4].y, qv.y, dot);
            dot = __dp4a(krow[v4].z, qv.z, dot);
            dot = __dp4a(krow[v4].w, qv.w, dot);
          }
          const float sc = ((float)dot * qs[r]) * kscale;
          s_s[(size_t)r * chunk_pad + j] = sc;
          cmax[r] = fmaxf(cmax[r], sc);
        }
      }
    }
    block_reduce<R, true>(cmax, red_s, warp, lane);

    // B: probabilities, the chunk's sum and its largest p * v_scale
    float alpha[R], psum[R], pmax[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_new = fmaxf(m[r], cmax[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      psum[r] = 0.f;
      pmax[r] = 0.f;
    }
    for (int j = tid; j < cn; j += kThreads) {
      const RowAddr at =
          chunk_row<kPaged, H>(src, b, kh, Nk, base + (j & ~(kChunk - 1)));
      const float vscale = src.vs[at.scale + (j & (kChunk - 1))];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = expf(s_s[(size_t)r * chunk_pad + j] - m[r]);
        const float pvf = p * vscale;
        s_s[(size_t)r * chunk_pad + j] = pvf;
        psum[r] += p;
        pmax[r] = fmaxf(pmax[r], pvf);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      psum[r] = warp_sum(psum[r]);
      pmax[r] = warp_max(pmax[r]);
      if (lane == 0) {
        red_s[warp][r] = psum[r];
        red2_s[warp][r] = pmax[r];
      }
    }
    __syncthreads();
    float pscale[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float sum = red_s[0][r], mx = red2_s[0][r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        sum += red_s[w][r];
        mx = fmaxf(mx, red2_s[w][r]);
      }
      l[r] = l[r] * alpha[r] + sum;
      pscale[r] = fmaxf(mx, 1e-30f) * (1.0f / 127.0f);
    }
    // each thread quantizes the entries it wrote; rows past the chunk's
    // live rows up to the next multiple of 32 get p8 = 0
    for (int j = tid; j < cn_pad; j += kThreads) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int code = 0;
        if (j < cn)
          code = __float2int_rn(s_s[(size_t)r * chunk_pad + j] / pscale[r]);
        p8_s[(size_t)r * chunk_pad + j] = (int8_t)code;
      }
    }
    __syncthreads();

    // C: int32(p8 . v_codes) over the chunk, then scaled into the
    // accumulator
    int acc_i[R][kD];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < kD; ++d) acc_i[r][d] = 0;
    for (int j0 = warp * kChunk; j0 < cn; j0 += kWarps * kChunk) {
      int4 vrow[H / 16];
#pragma unroll
      for (int v4 = 0; v4 < H / 16; ++v4) vrow[v4] = make_int4(0, 0, 0, 0);
      if (j0 + lane < cn) {
        const RowAddr at = chunk_row<kPaged, H>(src, b, kh, Nk, base + j0);
        const int4* vp = reinterpret_cast<const int4*>(
            static_cast<const int8_t*>(src.v) + at.code +
            (size_t)lane * at.stride);
#pragma unroll
        for (int v4 = 0; v4 < H / 16; ++v4) vrow[v4] = vp[v4];
      }
      int4* vdst = reinterpret_cast<int4*>(&v_s[warp][lane][0]);
#pragma unroll
      for (int v4 = 0; v4 < H / 16; ++v4) vdst[v4] = vrow[v4];
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < kChunk; jj += 4) {
        // four rows' bytes of this lane's dims, one word per dim
        int w[kD];
        if constexpr (kD == 2) {
          uint32_t a[4];
#pragma unroll
          for (int x = 0; x < 4; ++x)
            a[x] = *reinterpret_cast<const uint16_t*>(
                &v_s[warp][jj + x][2 * lane]);
          const uint32_t t01 = a[0] | (a[1] << 16), t23 = a[2] | (a[3] << 16);
          w[0] = (int)__byte_perm(t01, t23, 0x6420);
          w[1] = (int)__byte_perm(t01, t23, 0x7531);
        } else {
          uint32_t a[4];
#pragma unroll
          for (int x = 0; x < 4; ++x)
            a[x] = *reinterpret_cast<const uint32_t*>(
                &v_s[warp][jj + x][4 * lane]);
          // bytes 0, 1 of rows 0-1 and of rows 2-3, then bytes 2, 3
          const uint32_t lo01 = __byte_perm(a[0], a[1], 0x5140);
          const uint32_t lo23 = __byte_perm(a[2], a[3], 0x5140);
          const uint32_t hi01 = __byte_perm(a[0], a[1], 0x7362);
          const uint32_t hi23 = __byte_perm(a[2], a[3], 0x7362);
          w[0] = (int)__byte_perm(lo01, lo23, 0x5410);
          w[1] = (int)__byte_perm(lo01, lo23, 0x7632);
          w[2] = (int)__byte_perm(hi01, hi23, 0x5410);
          w[3] = (int)__byte_perm(hi01, hi23, 0x7632);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int pw = *reinterpret_cast<const int*>(
              &p8_s[(size_t)r * chunk_pad + j0 + jj]);
#pragma unroll
          for (int d = 0; d < kD; ++d)
            acc_i[r][d] = __dp4a(w[d], pw, acc_i[r][d]);
        }
      }
      __syncwarp();  // the tile is rewritten by the next iteration
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < kD; ++d)
        acc[r][d] = acc[r][d] * alpha[r] + (float)acc_i[r][d] * pscale[r];
    __syncthreads();  // the score planes are rewritten by the next chunk
  }

  // the fresh row, in f32: warp w scores query rows r = w, w + 4, ...
  const size_t plane = (size_t)b * Nk + kh;
  const __nv_bfloat16* fkr = fk + plane * H;
  const __nv_bfloat16* fvr = fv + plane * H;
  for (int r = warp; r < R; r += kWarps) {
    float sdot = qf_s[r][lane] * __bfloat162float(fkr[lane]);
#pragma unroll
    for (int i = 1; i < H / 32; ++i)
      sdot += qf_s[r][lane + 32 * i] * __bfloat162float(fkr[lane + 32 * i]);
    sdot = warp_sum(sdot);
    if (lane == 0) fresh_s[r] = sdot * sm_scale;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int d = 0; d < kD; ++d) acc_s[warp][r][kD * lane + d] = acc[r][d];
    if (tid == 0) {
      m_s[r] = m[r];
      l_s[r] = l[r];
    }
  }
  __syncthreads();

  for (int e = tid; e < R * H; e += kThreads) {
    const int r = e / H, d = e % H;
    const float sf = fresh_s[r];
    const float m_new = fmaxf(m_s[r], sf);
    const float al = expf(m_s[r] - m_new);
    const float pf = expf(sf - m_new);
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) num += acc_s[w][r][d];
    num = num * al + pf * __bfloat162float(fvr[d]);
    out[qrow * H + e] = __float2bfloat16(num / (l_s[r] * al + pf));
  }
}

template <int R, bool kPaged, int H>
int launch(const void* q, const KvSource& src, const void* fk, const void* fv,
           const void* pos, void* out, int B, int Nq, int Nk, int limit,
           int chunk, float sm_scale, cudaStream_t stream) {
  static gabby_smem::SmemLeave leave;
  const int chunk_pad = (chunk + kChunk - 1) / kChunk * kChunk;
  const int bytes = R * chunk_pad * 5;  // f32 scores + int8 codes
  if (bytes > kMaxDynamic) return (int)cudaErrorInvalidValue;
  const cudaError_t err = leave.raise(attention_s8_kernel<R, kPaged, H>,
                                      bytes);
  if (err != cudaSuccess) return (int)err;
  attention_s8_kernel<R, kPaged, H>
      <<<dim3(B, Nk), kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), src,
      static_cast<const __nv_bfloat16*>(fk),
      static_cast<const __nv_bfloat16*>(fv), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), Nq, Nk, limit, chunk, chunk_pad,
      sm_scale);
  return (int)cudaGetLastError();
}

template <bool kPaged, int H>
int by_group(const void* q, const KvSource& src, const void* fk,
             const void* fv, const void* pos, void* out, int B, int Nq,
             int Nk, int limit, int chunk, float sm_scale,
             cudaStream_t stream) {
  switch (Nq / Nk) {
    case 1: return launch<1, kPaged, H>(q, src, fk, fv, pos, out, B, Nq, Nk,
                                        limit, chunk, sm_scale, stream);
    case 2: return launch<2, kPaged, H>(q, src, fk, fv, pos, out, B, Nq, Nk,
                                        limit, chunk, sm_scale, stream);
    case 3: return launch<3, kPaged, H>(q, src, fk, fv, pos, out, B, Nq, Nk,
                                        limit, chunk, sm_scale, stream);
    case 4: return launch<4, kPaged, H>(q, src, fk, fv, pos, out, B, Nq, Nk,
                                        limit, chunk, sm_scale, stream);
    case 8: return launch<8, kPaged, H>(q, src, fk, fv, pos, out, B, Nq, Nk,
                                        limit, chunk, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kPaged>
int dispatch(const void* q, const KvSource& src, const void* fk,
             const void* fv, const void* pos, void* out, int B, int Nq,
             int Nk, int H, int limit, int chunk, float sm_scale,
             cudaStream_t stream) {
  if (Nk < 1 || Nq % Nk != 0 || B < 1 || chunk < 1 ||
      (src.pair != 0 && src.pair != 1) || (src.pair && Nk % 2))
    return (int)cudaErrorInvalidValue;
  if (H == 64)
    return by_group<kPaged, 64>(q, src, fk, fv, pos, out, B, Nq, Nk, limit,
                                chunk, sm_scale, stream);
  if (H == 128)
    return by_group<kPaged, 128>(q, src, fk, fv, pos, out, B, Nq, Nk, limit,
                                 chunk, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B, Nq, H] bf16 (H 64 or 128); fresh_k/v [B, Nk, H] bf16; positions
// [B] int32; out [B, Nq, H] bf16. table == NULL, the dense cache: k/v
// [B, Nk, rows, H] int8 (pair = 1: [B, Nk/2, rows, 2H]) and k/v_scale
// [B, Nk, rows] f32 of
// one layer (the caller offsets the pointers; layers = 1, layer = 0,
// max_pages = 1), reads rows j < min(positions[b], limit), `chunk` rows per
// quantization chunk. table [B, max_pages] int32, the paged pool: k/v
// [P, layers, Nk, rows, H] (pair = 1: [P, layers, Nk/2, rows, 2H]) and
// scale pools [P, layers, Nk, rows] whole; rows is the page size, a
// multiple of 32, and the chunk is a page.
int gabby_attention_s8(const void* q, const void* k, const void* v,
                       const void* k_scale, const void* v_scale,
                       const void* table, const void* fresh_k,
                       const void* fresh_v, const void* positions, void* out,
                       int B, int Nq, int Nk, int layers, int layer, int rows,
                       int max_pages, int H, int limit, int chunk, int pair,
                       float sm_scale, void* stream) {
  if (rows < 1 || max_pages < 1 || layer < 0 || layer >= layers)
    return (int)cudaErrorInvalidValue;
  KvSource src;
  src.k = k;
  src.v = v;
  src.ks = static_cast<const float*>(k_scale);
  src.vs = static_cast<const float*>(v_scale);
  src.table = static_cast<const int*>(table);
  src.rows = rows;
  src.max_pages = max_pages;
  src.layers = layers;
  src.layer = layer;
  src.pair = pair;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table != nullptr) {
    if (rows % 32 != 0) return (int)cudaErrorInvalidValue;
    return dispatch<true>(q, src, fresh_k, fresh_v, positions, out, B, Nq, Nk,
                          H, rows * max_pages, rows, sm_scale, s);
  }
  if (layers != 1 || max_pages != 1) return (int)cudaErrorInvalidValue;
  return dispatch<false>(q, src, fresh_k, fresh_v, positions, out, B, Nq, Nk,
                         H, limit, chunk, sm_scale, s);
}

}  // extern "C"
