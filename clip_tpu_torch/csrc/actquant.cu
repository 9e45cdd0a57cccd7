// Hopper counterpart of the JAX package's
//   clip_tpu/ops/actquant_pallas.py:362 mlp_lnq_pallas (bodies _mlp_half:335,
//   _mlp_body:274),
//   clip_tpu/ops/actquant_pallas.py:71 lnq_pallas (ctt_lnq below),
//   clip_tpu/ops/actquant_pallas.py:172 gemm_gq_pallas (ctt_gemm_gq below:
//     the int8 GEMM, the GELU or f32-bias epilogue and the requant over a
//     group of columns in one kernel),
//   clip_tpu/ops/actquant_pallas.py:296 mlp_gq_pallas (ctt_gemm_gq, then
//     ctt_gemm_i8 with the PRE epilogue),
// and of the XLA-level w8a8_pre (actquant_pallas.py:658; the PRE epilogue),
//   clip_tpu/ops/actquant_pallas.py:119 actq_pallas (ctt_requant with an
//     activation prologue and a bf16 or f32 input),
//   clip_tpu/ops/actquant_pallas.py:483 mlp_lnq_stream_pallas and the o half
//     of clip_tpu/ops/attention_pallas.py:648 attn_block_stream_pallas
//     (ctt_gemm_gq or ctt_requant per group of columns, then ctt_gemm_i8 with
//     the grouped epilogue, below),
// with the building blocks they share with the attention block
// (attention.cu): the LN + row-quant prologue, the int8 GEMM with its
// epilogues, and the row requant.
//
// The TPU kernel keeps both int8 MLP weights resident in VMEM (4.7 MB at
// ViT-B/32) and runs LN -> quant -> up GEMM -> gelu -> requant -> down GEMM
// per row block.  An SM's 227 KB of shared memory holds neither weight, so
// here the block is a chain of three launches driven from Python:
//
//   ctt_lnq       LN (one-pass f32 moments, variance clamped at 0) + row
//                 int8 quant: one block per row.
//   ctt_gemm_gq   up GEMM + bias + act, then the row requant of act(y) over
//                 all 4H columns, on chip: a cluster of blocks along N spans
//                 the row, each keeps its f32 act(y) in shared memory, and
//                 the blocks meet their row maxima through distributed
//                 shared memory.  No f32 row goes to device memory.
//   ctt_gemm_i8   down GEMM with the bias + residual epilogue.
//
// Both GEMMs run on Hopper's warpgroup MMA (wgmma.mma_async m64nNk32 s8,
// exact int32 accumulation), with both operands K-major in shared memory in
// the 128-byte swizzled layout, filled by TMA (cp.async.bulk.tensor) from
// one producer warp into a ring of stages guarded by mbarriers; one or two
// consumer warpgroups issue the wgmmas and run the epilogue from registers.
// The tile is chosen per launch by ops.actquant.gemm_plan (64 or 128 rows x
// 32-128 columns), so that the grid fills the 132 SMs at the shipped shapes.
//
// What bounds it on an H100: at ViT-H/14's MLP (64 x 264 rows, 1280 x 5120)
// the two GEMMs are 2 x 16896 x 1280 x 5120 x 2 = 443 G int8 operations
// (0.22 ms at 1,979 TOP/s) against 0.17 GB of compulsory traffic (0.05 ms
// at 3.35 TB/s): int8 operations bound it, and the design keeps the tensor
// cores fed (TMA instead of thread copies, several stages in flight, the
// epilogue of one tile overlapping the next tile's loads).  The epilogue
// math is written with explicitly rounded intrinsics (__fmul_rn, __fadd_rn)
// so that nvcc contracts nothing into an FMA: the outputs then equal the
// plain PyTorch version (ops/actquant.py) bit for bit wherever no
// transcendental is involved, and ctt_gemm_gq's codes and scales equal the
// two-launch chain ctt_requant(ctt_gemm_i8(...)) bit for bit.
#include "gemm.cuh"

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
// int8 GEMM on wgmma.  C = A[M, K] . B[N, K]^T, both K-major.  A block owns a
// BM x BN output tile (BM = 64 per consumer warpgroup); K goes through a ring
// of stages of 128 bytes of K each (one swizzle row a tile row), four wgmma
// k32 slices a stage.

// the epilogue of columns c, c + 1 of one row (o = r * N + c), every mode
// but kGrouped; w and b are ws and bias at c and c + 1
__device__ __forceinline__ void store_pair(int mode, size_t o, int a0, int a1, float s, float w0,
                                           float w1, float b0, float b1,
                                           const __nv_bfloat16* resid, void* out) {
  if (mode == kAcc) {
    *reinterpret_cast<int2*>(static_cast<int*>(out) + o) = make_int2(a0, a1);
  } else if (mode == kBiasBf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
        __floats2bfloat162_rn(__fadd_rn(epi_scale(a0, s, w0), b0),
                              __fadd_rn(epi_scale(a1, s, w1), b1));
  } else if (mode == kPreBf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
        __floats2bfloat162_rn(epi_scale(a0, s, w0), epi_scale(a1, s, w1));
  } else if (mode == kGeluQuick || mode == kGeluTanh || mode == kBiasF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
        make_float2(act_value(a0, s, w0, b0, mode), act_value(a1, s, w1, b1, mode));
  } else {  // kResidBf16
    const float t0 = bf16_round(bf16_round(epi_scale(a0, s, w0)) + bf16_round(b0));
    const float t1 = bf16_round(bf16_round(epi_scale(a1, s, w1)) + bf16_round(b1));
    const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(resid + o);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
        __floats2bfloat162_rn(__low2float(xr) + t0, __high2float(xr) + t1);
  }
}

// Tiles of ctt_gemm_i8, indexed as ops.actquant.GEMM_TILES: WG consumer
// warpgroups (BM = 64 WG rows) x BN columns.  The stages are sized so that
// two blocks share an SM (three or four for the narrow tiles), and one
// block's epilogue runs while the other's wgmmas do.
template <int WG, int BN>
struct Tile {
  static constexpr int BM = 64 * WG;
  static constexpr int kStageBytes = (BM + BN) * kBK;  // a multiple of 1024
  static constexpr int kStages = WG == 2 ? 3 : 4;
  static constexpr int kThreads = 128 * WG + 32;       // consumers + one producer warp
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};

// kGrouped (the Grouped instantiation) is the epilogue of the TPU's streamed
// kernels: their o and down GEMMs take one int8 operand quantized per group
// of K columns (a head group, a 4H chunk), each group with its own row
// scale, so the int32 accumulator is flushed into an f32 one at the end of
// each group (g a multiple of 64) and the next wgmma overwrites it.  With
// one group (g == K) it equals kResidBf16 bit for bit.
template <int WG, int BN, bool Grouped>
__global__ void __launch_bounds__(Tile<WG, BN>::kThreads, Grouped ? 1 : 2)
gemm_i8_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b, int M, int N, int K,
                     const float* __restrict__ sx, const float* __restrict__ ws,
                     const float* __restrict__ bias, const __nv_bfloat16* __restrict__ resid,
                     void* __restrict__ out, int mode, int group) {
  using T = Tile<WG, BN>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * T::kStageBytes);
  uint64_t* empty = full + S;
  // the warp index, known to the compiler as warp-uniform (so that the
  // wgmmas do not sit on a divergent path)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * BN;
  const int kt_n = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      ctt::mbar_init(&full[s], 1);
      ctt::mbar_init(&empty[s], 4 * WG);  // one arrival per consumer warp
    }
    ctt::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * WG) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % S;
        if (kt >= S) ctt::mbar_wait(&empty[s], ((kt / S) + 1) & 1);
        uint8_t* st = smem + s * T::kStageBytes;
        ctt::mbar_expect_tx(&full[s], T::kStageBytes);
        ctt::tma_load_2d(st, &tma_a, &full[s], kt * kBK, m0);
        ctt::tma_load_2d(st + T::BM * kBK, &tma_b, &full[s], kt * kBK, n0);
      }
    }
    return;
  }

  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
  const int r_base = m0 + wg * 64 + w4 * 16 + g;  // + 8h: the rows of d[4j + 2h + e]
  const unsigned base = ctt::smem_addr(smem);
  const int n_groups = Grouped ? K / group : 1;
  int acc[BN / 2];
  float facc[Grouped ? BN / 2 : 1];
  bool fresh = true;  // the next wgmma overwrites acc
  int grp = 0;
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % S;
    ctt::mbar_wait(&full[s], (kt / S) & 1);
    const unsigned sa = base + s * T::kStageBytes;
    const uint64_t da = ctt::sw128_desc(sa + wg * 64 * kBK), db = ctt::sw128_desc(sa + T::BM * kBK);
    ctt::wgmma_fence();
    // every slice of the stage: past K (K % 128 == 64) TMA filled zeros
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      ctt::wgmma_s8(acc, da + 2 * ks, db + 2 * ks, fresh ? 0 : 1);
      fresh = false;
      if constexpr (Grouped) {
        const int k_end = kt * kBK + (ks + 1) * 32;
        if (k_end <= K && k_end % group == 0) {  // flush group grp
          ctt::wgmma_commit();
          ctt::wgmma_wait<0>();
          ctt::fence_regs(acc);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r_base + 8 * h;
            const float sr = r < M ? sx[(size_t)r * n_groups + grp] : 0.f;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int c = n0 + 8 * j + 2 * t;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * j + 2 * h + e;
                const float p = c + e < N ? epi_scale(acc[i], sr, ws[c + e]) : 0.f;
                facc[i] = grp == 0 ? p : __fadd_rn(facc[i], p);
              }
            }
          }
          ++grp;
          fresh = true;
          ctt::wgmma_fence();
        }
      }
    }
    ctt::wgmma_commit();
    if constexpr (Grouped) {
      ctt::wgmma_wait<0>();
      ctt::fence_regs(acc);
      if (lane == 0) ctt::mbar_arrive(&empty[s]);
    } else {
      // keep this stage's wgmmas in flight; the previous stage's are done
      ctt::wgmma_wait<1>();
      ctt::fence_regs(acc);
      if (kt > 0 && lane == 0) ctt::mbar_arrive(&empty[(kt - 1) % S]);
    }
  }
  ctt::wgmma_wait<0>();
  ctt::fence_regs(acc);

  if constexpr (Grouped) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_base + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c >= N) continue;
        const size_t o = (size_t)r * N + c;
        float t0 = bf16_round(facc[4 * j + 2 * h]);
        float t1 = bf16_round(facc[4 * j + 2 * h + 1]);
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
  } else {
    float sr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) sr[h] = mode == kAcc || r_base + 8 * h >= M ? 0.f : sx[r_base + 8 * h];
    const bool has_ws = mode != kAcc, has_bias = has_ws && mode != kPreBf16;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      if (c >= N) continue;  // N % 8 == 0: c + 1 < N too
      // the column's scale and bias, once for both rows
      const float w0 = has_ws ? ws[c] : 0.f, w1 = has_ws ? ws[c + 1] : 0.f;
      const float b0 = has_bias ? bias[c] : 0.f, b1 = has_bias ? bias[c + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_base + 8 * h;
        if (r < M)
          store_pair(mode, (size_t)r * N + c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], sr[h],
                     w0, w1, b0, b1, resid, out);
      }
    }
  }
}

template <int WG, int BN, bool Grouped>
int launch_gemm(const int8_t* a, const int8_t* b, int m, int n, int k, const float* sx,
                const float* ws, const float* bias, const __nv_bfloat16* resid, void* out,
                int mode, int group, cudaStream_t stream) {
  using T = Tile<WG, BN>;
  CUtensorMap ta, tb;
  int err = tensor_map(&ta, a, m, k, T::BM);
  if (err == 0) err = tensor_map(&tb, b, n, k, BN);
  if (err != 0) return err;
  static bool attr = false;
  if (!attr) {
    err = (int)cudaFuncSetAttribute(gemm_i8_wgmma_kernel<WG, BN, Grouped>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != 0) return err;
    attr = true;
  }
  const dim3 grid((n + BN - 1) / BN, (m + T::BM - 1) / T::BM);
  gemm_i8_wgmma_kernel<WG, BN, Grouped><<<grid, T::kThreads, T::kSmem, stream>>>(
      ta, tb, m, n, k, sx, ws, bias, resid, out, mode, group);
  return (int)cudaGetLastError();
}

template <bool Grouped>
int launch_tile(int tile, const int8_t* a, const int8_t* b, int m, int n, int k, const float* sx,
                const float* ws, const float* bias, const __nv_bfloat16* resid, void* out,
                int mode, int group, cudaStream_t stream) {
  switch (tile) {  // ops.actquant.GEMM_TILES; the grouped epilogue's f32 sums do not fit
                   // two warpgroups' registers beside the accumulators (tile 0)
    case 0:
      if constexpr (!Grouped)
        return launch_gemm<2, 128, false>(a, b, m, n, k, sx, ws, bias, resid, out, mode, group, stream);
      break;
    case 1: return launch_gemm<1, 128, Grouped>(a, b, m, n, k, sx, ws, bias, resid, out, mode, group, stream);
    case 2: return launch_gemm<1, 64, Grouped>(a, b, m, n, k, sx, ws, bias, resid, out, mode, group, stream);
    case 3: return launch_gemm<1, 32, Grouped>(a, b, m, n, k, sx, ws, bias, resid, out, mode, group, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int tile_smem(int tile) {
  switch (tile) {
    case 0: return Tile<2, 128>::kSmem;
    case 1: return Tile<1, 128>::kSmem;
    case 2: return Tile<1, 64>::kSmem;
    case 3: return Tile<1, 32>::kSmem;
  }
  return -1;
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

// a int8 [m, k], b int8 [n, k] -> out [m, n] per GemmMode, on the tile
//   `tile` of ops.actquant.GEMM_TILES; k % 64 == 0, n % 8 == 0, a and b
//   16-byte aligned (TMA).  kGrouped: sx [m, k / group], group % 64 == 0,
//   k % group == 0; bias and resid may be null.
int ctt_gemm_i8(const int8_t* a, const int8_t* b, int m, int n, int k, const float* sx,
                const float* ws, const float* bias, const void* resid, void* out, int mode,
                int group, int tile, cudaStream_t stream) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(resid);
  if (mode == kGrouped)
    return launch_tile<true>(tile, a, b, m, n, k, sx, ws, bias, x, out, mode, group, stream);
  return launch_tile<false>(tile, a, b, m, n, k, sx, ws, bias, x, out, mode, k, stream);
}

// the dynamic shared memory of ctt_gemm_i8's tile `tile`, for the smoke's report
int ctt_gemm_i8_smem(int tile) { return tile_smem(tile); }

}  // extern "C"
