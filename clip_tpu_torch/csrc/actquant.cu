// Hopper counterpart of the JAX package's
//   clip_tpu/ops/actquant_pallas.py:362 mlp_lnq_pallas (bodies _mlp_half:335,
//   _mlp_body:274),
// and the building blocks it shares with the attention block
// (attention.cu): the LN + row-quant prologue, the int8 GEMM with its
// epilogues, and the row requant.
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

constexpr int kRqThreads = 256;

__global__ void __launch_bounds__(kRqThreads)
requant_kernel(const float* __restrict__ y, int8_t* __restrict__ codes,
               float* __restrict__ scales, int n) {
  __shared__ float sh[32];
  const size_t row = blockIdx.x;
  const float4* yr = reinterpret_cast<const float4*>(y + row * n);
  const int n4 = n >> 2;
  float amax = 0.f;
  for (int i = threadIdx.x; i < n4; i += kRqThreads) {
    const float4 q = yr[i];
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(q.x), fabsf(q.y)), fmaxf(fabsf(q.z), fabsf(q.w))));
  }
  amax = ctt::block_max(amax, sh);
  const float sx = ctt::row_scale(amax);
  char4* cr = reinterpret_cast<char4*>(codes + row * n);
  for (int i = threadIdx.x; i < n4; i += kRqThreads) {
    const float4 q = yr[i];
    cr[i] = make_char4(ctt::quant_code(q.x, sx), ctt::quant_code(q.y, sx),
                       ctt::quant_code(q.z, sx), ctt::quant_code(q.w, sx));
  }
  if (threadIdx.x == 0) scales[row] = sx;
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
};

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // 80-byte rows: fragment loads hit 32 distinct banks
constexpr int kGemmThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

__device__ __forceinline__ float gelu_quick(float y) {
  return __fmul_rn(y, __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(0.851f, y)))));
}

__device__ __forceinline__ float gelu_tanh(float y) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y), y), y);
  const float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(y, cube)));
  return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.f, t));
}

__global__ void __launch_bounds__(kGemmThreads)
gemm_i8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int M, int N, int K,
               const float* __restrict__ sx, const float* __restrict__ ws,
               const float* __restrict__ bias, const __nv_bfloat16* __restrict__ resid,
               void* __restrict__ out, int mode) {
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

  const int kt_n = K / BK;
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
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
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
        } else if (mode == kGeluQuick || mode == kGeluTanh) {
          float y0 = __fadd_rn(epi_scale(a0, s, ws[c]), bias[c]);
          float y1 = __fadd_rn(epi_scale(a1, s, ws[c + 1]), bias[c + 1]);
          if (mode == kGeluQuick) {
            y0 = gelu_quick(y0);
            y1 = gelu_quick(y1);
          } else {
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

// y f32 [rows, n] -> codes int8 [rows, n], scales f32 [rows]; n % 4 == 0
int ctt_requant(const float* y, int8_t* codes, float* scales, int rows, int n,
                cudaStream_t stream) {
  requant_kernel<<<rows, kRqThreads, 0, stream>>>(y, codes, scales, n);
  return (int)cudaGetLastError();
}

// a int8 [m, k], b int8 [n, k] -> out [m, n] per GemmMode; k % 64 == 0, n % 8 == 0
int ctt_gemm_i8(const int8_t* a, const int8_t* b, int m, int n, int k, const float* sx,
                const float* ws, const float* bias, const void* resid, void* out, int mode,
                cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_i8_kernel<<<grid, kGemmThreads, 0, stream>>>(
      a, b, m, n, k, sx, ws, bias, static_cast<const __nv_bfloat16*>(resid), out, mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
