// Hopper counterpart of the JAX package's
//   clip_tpu/ops/qmatmul_pallas.py:172 qmatmul_pallas, all three bodies:
//     _kernel_packed4:69  (q4_0 / q4_1),
//     _kernel_packed5:103 (q5_0 / q5_1),
//     _kernel_bytes:151   (q8_0):
// y[M, N] = x[M, K] . dequant(W)[N, K]^T, decoded in-kernel so that device
// memory holds and moves only the packed codes.
//
// Layouts (ops/qtensor.py): for q4 and q5, byte j of a weight row packs
// element 2j in its low nibble and 2j+1 in its high nibble; q5 adds the
// fifth bit as a little-endian bit plane hb [N, K/8] (element e's bit is bit
// e % 8 of byte e / 8: the even element of pair t sits at bit 2 (t % 4) of
// byte t / 4, the odd one at the next bit, as _kernel_packed5 reads it);
// q8_0 stores signed int8 codes [N, K].  d (and m for q4_1 / q5_1) hold one
// f32 per 32-element block.  Decoding follows the TPU bodies in the compute
// dtype: w = bf16((code - zero_point) * bf16(d)), then + bf16(m); the
// products accumulate in f32 and the output is rounded to bf16.
//
// What bounds it on the main path (the CLIP output projection: M = batch,
// N = 512, K = 768): 2 x 64 x 512 x 768 = 50 MFLOP (0.05 us at the bf16
// peak) against 0.2-0.4 MB of packed weights + 0.1 MB of activations,
// ~0.1 us at 3.35 TB/s -- bytes bound it, and at this size launch latency
// dominates either.  So the design is the simplest correct tiling: a block
// computes a 32 x 32 output tile (small, so that M = 64 still spreads over
// 32 blocks), one 32-element quant block of K at a time; it decodes the
// 32 x 32 weight tile into shared memory once and reuses it for 32 rows of
// x, with each thread accumulating a 2 x 2 sub-tile on CUDA cores.  The
// three formats differ only in the decode of a pair of codes.
#include "common.cuh"

namespace {

constexpr int TM = 32, TN = 32, TK = 32;
constexpr int kQmmThreads = 256;

// codes of elements 2p and 2p + 1 of weight row `row` (K elements)
template <int BITS>
__device__ __forceinline__ void code_pair(const uint8_t* __restrict__ q,
                                          const uint8_t* __restrict__ hb, size_t row, int K,
                                          int p, int& c0, int& c1) {
  if constexpr (BITS == 8) {
    const int8_t* q8 = reinterpret_cast<const int8_t*>(q) + row * K + 2 * p;
    c0 = q8[0];
    c1 = q8[1];
  } else {
    const uint8_t byte = q[row * (K / 2) + p];
    c0 = byte & 0x0F;
    c1 = byte >> 4;
    if constexpr (BITS == 5) {
      const uint8_t plane = hb[row * (K / 8) + p / 4];
      const int sh = 2 * (p & 3);
      c0 |= ((plane >> sh) & 1) << 4;
      c1 |= ((plane >> (sh + 1)) & 1) << 4;
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kQmmThreads)
qmatmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
               const uint8_t* __restrict__ hb, const float* __restrict__ d,
               const float* __restrict__ mins, __nv_bfloat16* __restrict__ out, int M, int N,
               int K, int zero_point) {
  __shared__ float Xs[TM][TK + 1];
  __shared__ float Ws[TN][TK + 1];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kb_n = K / TK;
  float acc[2][2] = {};

  for (int kb = 0; kb < kb_n; ++kb) {
    const int k0 = kb * TK;
    for (int e = threadIdx.x; e < TM * TK; e += kQmmThreads) {
      const int r = e / TK, k = e - r * TK;
      Xs[r][k] = (m0 + r < M) ? __bfloat162float(x[(size_t)(m0 + r) * K + k0 + k]) : 0.f;
    }
    for (int e = threadIdx.x; e < TN * (TK / 2); e += kQmmThreads) {
      const int r = e / (TK / 2), jb = e - r * (TK / 2);
      float w_lo = 0.f, w_hi = 0.f;
      if (n0 + r < N) {
        const size_t row = (size_t)(n0 + r);
        int c0, c1;
        code_pair<BITS>(q, hb, row, K, k0 / 2 + jb, c0, c1);
        const float dd = ctt::bf16_round(d[row * kb_n + kb]);
        w_lo = ctt::bf16_round((float)(c0 - zero_point) * dd);
        w_hi = ctt::bf16_round((float)(c1 - zero_point) * dd);
        if (mins != nullptr) {
          const float mm = ctt::bf16_round(mins[row * kb_n + kb]);
          w_lo = ctt::bf16_round(w_lo + mm);
          w_hi = ctt::bf16_round(w_hi + mm);
        }
      }
      Ws[r][2 * jb] = w_lo;
      Ws[r][2 * jb + 1] = w_hi;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      float xv[2], wv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) xv[i] = Xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 2; ++j) wv[j] = Ws[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) out[(size_t)r * N + c] = __float2bfloat16_rn(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

// x bf16 [m, k]; bits 4: q uint8 [n, k/2]; bits 5: q uint8 [n, k/2] and hb
// uint8 [n, k/8]; bits 8: q int8 [n, k].  d f32 [n, k/32]; mins f32
// [n, k/32] or null -> out bf16 [m, n]; k % 32 == 0
int ctt_qmatmul(const void* x, const uint8_t* q, const uint8_t* hb, const float* d,
                const float* mins, void* out, int m, int n, int k, int zero_point, int bits,
                cudaStream_t stream) {
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  switch (bits) {
    case 4:
      qmatmul_kernel<4><<<grid, kQmmThreads, 0, stream>>>(xb, q, hb, d, mins, ob, m, n, k,
                                                          zero_point);
      break;
    case 5:
      qmatmul_kernel<5><<<grid, kQmmThreads, 0, stream>>>(xb, q, hb, d, mins, ob, m, n, k,
                                                          zero_point);
      break;
    case 8:
      qmatmul_kernel<8><<<grid, kQmmThreads, 0, stream>>>(xb, q, hb, d, mins, ob, m, n, k,
                                                          zero_point);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
