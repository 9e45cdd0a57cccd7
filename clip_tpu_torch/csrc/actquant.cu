// Hopper counterpart of the JAX package's
//   clip_tpu/ops/actquant_pallas.py:362 mlp_lnq_pallas (bodies _mlp_half:335,
//   _mlp_body:274),
//   clip_tpu/ops/actquant_pallas.py:71 lnq_pallas (ctt_lnq below),
//   clip_tpu/ops/actquant_pallas.py:172 gemm_gq_pallas (ctt_gemm_i8 with a
//     GELU or f32-bias epilogue, then ctt_requant),
//   clip_tpu/ops/actquant_pallas.py:296 mlp_gq_pallas (gemm_gq, then
//     ctt_gemm_i8 with the PRE epilogue),
// and of the XLA-level w8a8_pre (actquant_pallas.py:658; the PRE epilogue),
//   clip_tpu/ops/actquant_pallas.py:119 actq_pallas (ctt_requant with an
//     activation prologue and a bf16 or f32 input),
//   clip_tpu/ops/actquant_pallas.py:483 mlp_lnq_stream_pallas and the o half
//     of clip_tpu/ops/attention_pallas.py:648 attn_block_stream_pallas
//     (ctt_requant per group of columns, then ctt_gemm_i8 with the grouped
//     epilogue, below),
// with the building blocks they share with the attention block
// (attention.cu): the LN + row-quant prologue, the int8 GEMM with its
// epilogues, and the row requant.
//
// The TPU's gemm_gq and mlp_gq keep the weights resident in VMEM and the
// [rows, 4H] up output in VMEM up to the requant.  Here the requant's row
// amax spans every output tile of the up GEMM, a reduction across blocks,
// so the up GEMM writes f32 to device memory and ctt_requant reads it back
// (rows x 4H x 8 bytes of traffic); the down GEMM then reads the codes.  At
// ViT-H/14 (64 x 264 rows, 1280 x 5120) the two GEMMs are 2 x 16896 x 1280 x
// 5120 x 2 = 443 G int8 operations (0.22 ms at 1,979 TOP/s) against 0.69 GB
// of that f32 round trip plus 0.17 GB of codes (0.26 ms at 3.35 TB/s): bytes
// bound the chain as built.
//
// The TPU kernel keeps both int8 MLP weights resident in VMEM (4.7 MB at
// ViT-B/32) and runs LN -> quant -> up GEMM -> gelu -> requant -> down GEMM
// per row block.  An SM's 227 KB of shared memory holds neither weight, so
// here the block is a chain of four launches driven from Python:
//
//   ctt_lnq       LN (one-pass f32 moments, variance clamped at 0) + row
//                 int8 quant: one block per row.
//   ctt_gemm_i8   C = A[M,K] . B[N,K]^T over int8 with exact int32
//                 accumulation on mma.sync.m16n8k32.s8 tensor cores, and an
//                 epilogue chosen by `mode` (see GemmMode).
//   ctt_requant   row amax over the full f32 row + int8 quant.  The
//                 requant scale spans all 4H columns of the up GEMM, more
//                 than one output tile holds, so the f32 intermediate goes
//                 through device memory (rows x 4H x 4 bytes written and
//                 read back: 39 MB at ViT-B/32 B=64) -- a later change can
//                 remove that round trip.
//   ctt_gemm_i8   down GEMM with the bias + residual epilogue.
//
// What bounds it on an H100 at ViT-B/32 (rows = 64 x 50, H = 768): the two
// GEMMs are 2 x 3200 x 768 x 3072 x 2 = 30.2 G int8 operations (15 us at
// 1,979 TOP/s) against ~12 MB of compulsory traffic (3.6 us at 3.35 TB/s),
// so int8 operations bound it.  The GEMM tiles 128 x 128 outputs per block
// with 64-byte K slices double-buffered through cp.async, so each weight
// byte is read from device memory once per 128 rows.  The epilogue math is
// written with explicitly rounded intrinsics (__fmul_rn, __fadd_rn) so that
// nvcc contracts nothing into an FMA: the outputs then equal the plain
// PyTorch version (ops/actquant.py) bit for bit wherever no transcendental
// is involved.
#include "common.cuh"

namespace {

using ctt::bf16_round;
using ctt::cp_async16;
using ctt::cp_async_commit;
using ctt::cp_async_wait;
using ctt::mma_s8;

constexpr int kLnThreads = 256;
constexpr int kLnMaxPer = 8;  // rows up to 2048 wide stay in registers

__global__ void __launch_bounds__(kLnThreads)
lnq_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ b, int8_t* __restrict__ codes,
           float* __restrict__ scales, int h, float eps) {
  __shared__ float sh[32];
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * h;
  float v[kLnMaxPer];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int t = 0; t < kLnMaxPer; ++t) {
    const int i = threadIdx.x + t * kLnThreads;
    v[t] = 0.f;
    if (i < h) {
      v[t] = __bfloat162float(xr[i]);
      s += v[t];
      ss += v[t] * v[t];
    }
  }
  s = ctt::block_sum(s, sh);
  ss = ctt::block_sum(ss, sh);
  const float mu = s / h;
  const float var = fmaxf(ss / h - mu * mu, 0.f);
  const float rs = rsqrtf(var + eps);
  float amax = 0.f;
#pragma unroll
  for (int t = 0; t < kLnMaxPer; ++t) {
    const int i = threadIdx.x + t * kLnThreads;
    if (i < h) {
      const float y = __fadd_rn(__fmul_rn(__fmul_rn(v[t] - mu, rs), w[i]), b[i]);
      v[t] = y;
      amax = fmaxf(amax, fabsf(y));
    }
  }
  amax = ctt::block_max(amax, sh);
  const float sx = ctt::row_scale(amax);
#pragma unroll
  for (int t = 0; t < kLnMaxPer; ++t) {
    const int i = threadIdx.x + t * kLnThreads;
    if (i < h) codes[row * h + i] = ctt::quant_code(v[t], sx);
  }
  if (threadIdx.x == 0) scales[row] = sx;
}

__device__ __forceinline__ float gelu_quick(float y) {
  return __fmul_rn(y, __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(0.851f, y)))));
}

__device__ __forceinline__ float gelu_tanh(float y) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y), y), y);
  const float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(y, cube)));
  return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.f, t));
}

// activation prologue of ctt_requant (actq_pallas's act)
enum Act : int { kActNone = 0, kActGeluQuick = 1, kActGeluTanh = 2 };

__device__ __forceinline__ float act_fn(float y, int act) {
  return act == kActGeluQuick ? gelu_quick(y) : act == kActGeluTanh ? gelu_tanh(y) : y;
}

// four consecutive inputs as f32 (16-byte f32 or 8-byte bf16 loads)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

constexpr int kRqThreads = 256;

// One block per (row, group of g columns): act(y) in f32, the group's amax,
// then its int8 codes.  The activation is recomputed in the second pass
// (the same instructions, so the same values) rather than staged.  Scales
// are [rows, n / g]; g == n is the full-row requant.
template <typename InT>
__global__ void __launch_bounds__(kRqThreads)
requant_kernel(const InT* __restrict__ y, int8_t* __restrict__ codes,
               float* __restrict__ scales, int n, int g, int act) {
  __shared__ float sh[32];
  const size_t off = (size_t)blockIdx.x * n + (size_t)blockIdx.y * g;
  const InT* yr = y + off;
  const int g4 = g >> 2;
  float amax = 0.f;
  for (int i = threadIdx.x; i < g4; i += kRqThreads) {
    const float4 q = load4(yr + 4 * i);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(act_fn(q.x, act)), fabsf(act_fn(q.y, act))),
                             fmaxf(fabsf(act_fn(q.z, act)), fabsf(act_fn(q.w, act)))));
  }
  amax = ctt::block_max(amax, sh);
  const float sx = ctt::row_scale(amax);
  char4* cr = reinterpret_cast<char4*>(codes + off);
  for (int i = threadIdx.x; i < g4; i += kRqThreads) {
    const float4 q = load4(yr + 4 * i);
    cr[i] = make_char4(ctt::quant_code(act_fn(q.x, act), sx), ctt::quant_code(act_fn(q.y, act), sx),
                       ctt::quant_code(act_fn(q.z, act), sx), ctt::quant_code(act_fn(q.w, act), sx));
  }
  if (threadIdx.x == 0) scales[(size_t)blockIdx.x * gridDim.y + blockIdx.y] = sx;
}

// ---------------------------------------------------------------------------
// int8 GEMM.  Block tile 128 x 128, K slice 64 bytes, 8 warps as 2 (M) x 4 (N),
// each warp 64 x 32 outputs = 4 x 4 mma tiles of 16 x 8.

enum GemmMode : int {
  kAcc = 0,        // int32 accumulator, stored as is (exactness check)
  kBiasBf16 = 1,   // bf16(acc*sx*ws + b)                       (qkv)
  kGeluQuick = 2,  // f32 gelu_quick(acc*sx*ws + b)              (MLP up)
  kGeluTanh = 3,   // f32 gelu_tanh(acc*sx*ws + b)               (MLP up)
  kResidBf16 = 4,  // bf16(x + bf16(bf16(acc*sx*ws) + bf16(b)))   (o, down)
  kPreBf16 = 5,    // bf16(acc*sx*ws)                            (w8a8_pre)
  kBiasF32 = 6,    // f32 acc*sx*ws + b                          (gemm_gq act=none)
  kGrouped = 7,    // K in groups of g, sx [M, K / g]:            (streamed o, down)
                   //   acc = sum over groups, in group order, of
                   //   (f32(acc_g) * sx[r, grp]) * ws; then t = bf16(acc),
                   //   t = bf16(t + bf16(b)) with a bias, bf16(x + t) with x
};

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // 80-byte rows: fragment loads hit 32 distinct banks
constexpr int kGemmThreads = 256;

__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src, int rows_left,
                                          int ld, int k0) {
  // 128 rows x 4 chunks of 16 bytes; two chunks per thread
#pragma unroll
  for (int c = threadIdx.x; c < BM * 4; c += kGemmThreads) {
    const int r = c >> 2, col = (c & 3) * 16;
    const bool ok = r < rows_left;
    const int8_t* g = ok ? src + (size_t)r * ld + k0 + col : src;
    cp_async16(dst + r * LDS + col, g, ok);
  }
}

__device__ __forceinline__ float epi_scale(int acc, float sx, float ws) {
  return __fmul_rn(__fmul_rn((float)acc, sx), ws);
}

// kGrouped (the Grouped instantiation) is the epilogue of the TPU's streamed
// kernels: their o and down GEMMs take one int8 operand quantized per group
// of K columns (a head group, a 4H chunk), each group with its own row
// scale, so the int32 accumulator is flushed into an f32 one at the end of
// each group (g a multiple of BK) and cleared.  With one group (g == K) it
// equals kResidBf16 bit for bit.
template <bool Grouped>
__global__ void __launch_bounds__(kGemmThreads)
gemm_i8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int M, int N, int K,
               const float* __restrict__ sx, const float* __restrict__ ws,
               const float* __restrict__ bias, const __nv_bfloat16* __restrict__ resid,
               void* __restrict__ out, int mode, int group) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;

  const int8_t* Ab = A + (size_t)m0 * K;
  const int8_t* Bb = B + (size_t)n0 * K;
  const int rows_a = M - m0, rows_b = N - n0;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  float facc[4][4][4];  // Grouped: the f32 sum over the groups flushed so far

  const int kt_n = K / BK;
  const int kt_group = group / BK, n_groups = K / max(group, 1);
  load_tile(As[0], Ab, rows_a, K, 0);
  load_tile(Bs[0], Bb, rows_b, K, 0);
  cp_async_commit();

  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kt_n) {
      load_tile(As[st ^ 1], Ab, rows_a, K, (kt + 1) * BK);
      load_tile(Bs[st ^ 1], Bb, rows_b, K, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* as = As[st];
    const int8_t* bs = Bs[st];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + g;
        af[i][0] = *reinterpret_cast<const unsigned*>(as + r * LDS + ks + t * 4);
        af[i][1] = *reinterpret_cast<const unsigned*>(as + (r + 8) * LDS + ks + t * 4);
        af[i][2] = *reinterpret_cast<const unsigned*>(as + r * LDS + ks + 16 + t * 4);
        af[i][3] = *reinterpret_cast<const unsigned*>(as + (r + 8) * LDS + ks + 16 + t * 4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        bfr[j][0] = *reinterpret_cast<const unsigned*>(bs + n * LDS + ks + t * 4);
        bfr[j][1] = *reinterpret_cast<const unsigned*>(bs + n * LDS + ks + 16 + t * 4);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    __syncthreads();
    if constexpr (Grouped) {
      if ((kt + 1) % kt_group == 0) {
        const int grp = kt / kt_group;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = m0 + wm + i * 16 + g + half * 8;
            const float s = r < M ? sx[(size_t)r * n_groups + grp] : 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = n0 + wn + j * 8 + t * 2;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int idx = half * 2 + e;
                const float p = c + e < N ? epi_scale(acc[i][j][idx], s, ws[c + e]) : 0.f;
                facc[i][j][idx] = grp == 0 ? p : __fadd_rn(facc[i][j][idx], p);
                acc[i][j][idx] = 0;
              }
            }
          }
        }
      }
    }
  }

  if constexpr (Grouped) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + i * 16 + g + half * 8;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + wn + j * 8 + t * 2;
          if (c >= N) continue;
          const size_t o = (size_t)r * N + c;
          float t0 = bf16_round(facc[i][j][half * 2]);
          float t1 = bf16_round(facc[i][j][half * 2 + 1]);
          if (bias != nullptr) {
            t0 = bf16_round(t0 + bf16_round(bias[c]));
            t1 = bf16_round(t1 + bf16_round(bias[c + 1]));
          }
          if (resid != nullptr) {
            const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(resid + o);
            t0 = __low2float(xr) + t0;
            t1 = __high2float(xr) + t1;
          }
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(t0, t1);
        }
      }
    }
    return;
  }

  // epilogue: acc[i][j][0..1] -> row r0, cols c, c+1; [2..3] -> row r0 + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + i * 16 + g + half * 8;
      if (r >= M) continue;
      const float s = mode == kAcc ? 0.f : sx[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn + j * 8 + t * 2;
        if (c >= N) continue;
        const int a0 = acc[i][j][half * 2], a1 = acc[i][j][half * 2 + 1];
        const size_t o = (size_t)r * N + c;
        if (mode == kAcc) {
          *reinterpret_cast<int2*>(static_cast<int*>(out) + o) = make_int2(a0, a1);
        } else if (mode == kBiasBf16) {
          const float y0 = __fadd_rn(epi_scale(a0, s, ws[c]), bias[c]);
          const float y1 = __fadd_rn(epi_scale(a1, s, ws[c + 1]), bias[c + 1]);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(y0, y1);
        } else if (mode == kPreBf16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(epi_scale(a0, s, ws[c]), epi_scale(a1, s, ws[c + 1]));
        } else if (mode == kGeluQuick || mode == kGeluTanh || mode == kBiasF32) {
          float y0 = __fadd_rn(epi_scale(a0, s, ws[c]), bias[c]);
          float y1 = __fadd_rn(epi_scale(a1, s, ws[c + 1]), bias[c + 1]);
          if (mode == kGeluQuick) {
            y0 = gelu_quick(y0);
            y1 = gelu_quick(y1);
          } else if (mode == kGeluTanh) {
            y0 = gelu_tanh(y0);
            y1 = gelu_tanh(y1);
          }
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(y0, y1);
        } else {  // kResidBf16
          const float p0 = bf16_round(epi_scale(a0, s, ws[c]));
          const float p1 = bf16_round(epi_scale(a1, s, ws[c + 1]));
          const float t0 = bf16_round(p0 + bf16_round(bias[c]));
          const float t1 = bf16_round(p1 + bf16_round(bias[c + 1]));
          const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(resid + o);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(__low2float(xr) + t0, __high2float(xr) + t1);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x bf16 [rows, h] -> codes int8 [rows, h], scales f32 [rows]; h <= 2048
int ctt_lnq(const void* x, const float* w, const float* b, int8_t* codes, float* scales,
            int rows, int h, float eps, cudaStream_t stream) {
  lnq_kernel<<<rows, kLnThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(x), w, b,
                                              codes, scales, h, eps);
  return (int)cudaGetLastError();
}

// y [rows, n], f32 or (in_bf16) bf16 -> act(y) quantized per group of g
//   columns: codes int8 [rows, n], scales f32 [rows, n / g]; act an Act;
//   n % g == 0, g % 4 == 0
int ctt_requant(const void* y, int8_t* codes, float* scales, int rows, int n, int g, int act,
                int in_bf16, cudaStream_t stream) {
  const dim3 grid(rows, n / g);
  if (in_bf16)
    requant_kernel<<<grid, kRqThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(y), codes,
                                                    scales, n, g, act);
  else
    requant_kernel<<<grid, kRqThreads, 0, stream>>>(static_cast<const float*>(y), codes, scales,
                                                    n, g, act);
  return (int)cudaGetLastError();
}

// a int8 [m, k], b int8 [n, k] -> out [m, n] per GemmMode; k % 64 == 0, n % 8 == 0.
//   kGrouped: sx [m, k / group], group % 64 == 0, k % group == 0; bias and
//   resid may be null.
int ctt_gemm_i8(const int8_t* a, const int8_t* b, int m, int n, int k, const float* sx,
                const float* ws, const float* bias, const void* resid, void* out, int mode,
                int group, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(resid);
  if (mode == kGrouped)
    gemm_i8_kernel<true><<<grid, kGemmThreads, 0, stream>>>(a, b, m, n, k, sx, ws, bias, x, out,
                                                            mode, group);
  else
    gemm_i8_kernel<false><<<grid, kGemmThreads, 0, stream>>>(a, b, m, n, k, sx, ws, bias, x,
                                                             out, mode, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
