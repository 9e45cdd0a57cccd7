// Hopper counterpart of clip_tpu/ops/actquant_pallas.py:172 gemm_gq_pallas:
// the int8 up GEMM, the rescale, bias and activation, and the int8 requant
// of act(y) over a group of g columns, in one kernel.  g = N is the full
// row of gemm_gq_pallas (and of the MLP blocks' up GEMM,
// mlp_lnq_pallas:362); g = 4H / c is a chunk of mlp_lnq_stream_pallas:483.
//
// The TPU kernel keeps the [rows, 4H] f32 intermediate in VMEM up to the
// requant.  Here the row amax spans more columns than one block holds, so a
// thread-block cluster along N spans the group (ops.actquant.gq_plan: cs
// blocks of CPB columns, up to 16 x 320 = 5120 columns; a cluster of 16 is
// the non-portable size, which H100 allows):
//
//   mainloop  128 rows x CPB columns a block, four warpgroups (two row
//             halves x two column halves) on wgmma m64n(CPB/2)k32 s8 over
//             the same stage, K through a ring of four TMA stages (128-byte
//             swizzle); thread 0 refills a stage once all 16 warps
//             released it.
//   epilogue  act(acc * sx * ws + b) in f32 in the accumulator registers
//             (one loop per activation), each row's |max| over the quad and
//             the two column halves.
//   cluster   every block publishes its 128 row maxima in shared memory,
//             reads the other blocks' through distributed shared memory (a
//             max: exact in any order), and computes the same scales; block
//             0 writes them.
//   codes     from the registers, with one reciprocal a row and two exact
//             correction steps instead of a division an element
//             (quant_code_rcp), staged as int8 in the free ring and written
//             8 bytes a thread.
//
// No f32 row goes to device memory: the bytes are the int8 operands, the
// vectors and the codes.  What bounds it on an H100 at ViT-H/14's up GEMM
// (16896 x 1280 x 5120): 221 G int8 operations, 0.112 ms at 1,979 TOP/s,
// against 0.11 GB of compulsory traffic (0.03 ms).  A 128 x 320 block reads
// 448 bytes of L2 per 82 K operations a byte of K.  The block fills the
// SM's shared memory (four stages, the f32 epilogue has nowhere else to
// live), so its epilogue (tanhf and the quotient once per element) does
// not overlap another block's wgmmas, and the card holds 7 clusters of 16
// at once: 112 of the 132 SMs at ViT-H/14's full row.  The values,
// the amax and the codes equal ctt_gemm_i8's f32 epilogue and ctt_requant's
// bit for bit, so codes and scales equal the two-launch chain.
#include "gemm.cuh"

namespace {

// Phase timestamps of every block (%globaltimer, ns), compiled in only with
// -DCTT_GQ_PHASES (chip_smoke.py --gemm-gq-phases): 0 start, 1 first stage
// arrived, 2 mainloop done, 3 act(y) done, 4 row maxima written, 5 cluster
// met, 6 scales computed, 7 codes written, 8 end.
#ifdef CTT_GQ_PHASES
__device__ unsigned long long* g_phases;
#define GQ_PHASE(i)                                                                    \
  do {                                                                                 \
    if (threadIdx.x == 0) {                                                            \
      unsigned long long t_;                                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                           \
      g_phases[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 9 + (i)] = t_;          \
    }                                                                                  \
  } while (0)
#else
#define GQ_PHASE(i) \
  do {              \
  } while (0)
#endif

constexpr int kGqRows = 128;     // rows a block
constexpr int kGqThreads = 512;  // four consumer warpgroups; thread 0 also issues the loads
constexpr int kGqMaxStages = 4;

// A block is 128 rows x CPB columns: warpgroup wg takes the 64 rows of half
// wg & 1 and the CPB / 2 columns of half wg >> 1, so the four share each
// stage's A and B tiles and hold CPB / 4 accumulators a thread.
template <int CPB>
struct Gq {
  static constexpr int kN = CPB / 2;  // columns of one warpgroup's wgmma (a TMA box of B)
  static constexpr int kStageBytes = (kGqRows + CPB) * kBK;
  static constexpr int kFixed = 1024 + 3 * kGqRows * 4 + 2 * kGqMaxStages * 8;
  static constexpr int kFit = (kSmemLimit - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < kGqMaxStages ? kFit : kGqMaxStages;
  static constexpr int kSmem = kFixed + kStages * kStageBytes;
  static constexpr int kLd8 = CPB + 16;  // row stride of the staged codes
  static_assert(kStages >= 2, "two stages");
  static_assert(2 * kGqRows * 4 + kGqRows * kLd8 <= kStages * kStageBytes,
                "the half-row maxima and the codes fit in the ring");
  static_assert(kN % 16 == 0 && (kN * kBK) % 1024 == 0, "wgmma N, swizzle atoms");
};

// thread 0: stage kt % S <- the A rows and B columns of the block at k = kt * 128
template <int CPB>
__device__ __forceinline__ void gq_load(uint8_t* smem, uint64_t* full, const CUtensorMap* tma_a,
                                        const CUtensorMap* tma_b, int kt, int m0, int col0) {
  using G = Gq<CPB>;
  const int s = kt % G::kStages;
  uint8_t* st = smem + s * G::kStageBytes;
  ctt::mbar_expect_tx(&full[s], G::kStageBytes);
  ctt::tma_load_2d(st, tma_a, &full[s], kt * kBK, m0);
#pragma unroll
  for (int p = 0; p < 2; ++p)
    ctt::tma_load_2d(st + (kGqRows + p * G::kN) * kBK, tma_b, &full[s], kt * kBK,
                     col0 + p * G::kN);
}

// act(acc * sx * ws + b) in place (f32 bits in the accumulators) for the
// rows r0 and r0 + 8 of a thread, and their |max| over its columns; the
// column's scale and bias loaded once for both rows
template <int CPB, int kMode>
__device__ __forceinline__ void gq_act(int (&acc)[CPB / 4], float (&amax)[2],
                                       const float* __restrict__ sx,
                                       const float* __restrict__ ws,
                                       const float* __restrict__ bias, int M, int r0, int c_first,
                                       int col0, int wc, int t, int group) {
  constexpr int kN = CPB / 2;
  float sr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sr[h] = r0 + 8 * h < M ? sx[r0 + 8 * h] : 0.f;
    amax[h] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int lc = wc * kN + 8 * j + 2 * t;
    const bool ok = c_first + lc < group;  // group % 8 == 0: lc + 1 too
    const float w0 = ok ? ws[col0 + lc] : 0.f, w1 = ok ? ws[col0 + lc + 1] : 0.f;
    const float b0 = ok ? bias[col0 + lc] : 0.f, b1 = ok ? bias[col0 + lc + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      const float y0 = ok ? act_value(acc[i], sr[h], w0, b0, kMode) : 0.f;
      const float y1 = ok ? act_value(acc[i + 1], sr[h], w1, b1, kMode) : 0.f;
      acc[i] = __float_as_int(y0);
      acc[i + 1] = __float_as_int(y1);
      amax[h] = fmaxf(amax[h], fmaxf(fabsf(y0), fabsf(y1)));
    }
  }
}

template <int CPB>
__global__ void __launch_bounds__(kGqThreads, 1)
gemm_gq_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
               int M, int N, int K, const float* __restrict__ sx, const float* __restrict__ ws,
               const float* __restrict__ bias, int8_t* __restrict__ codes,
               float* __restrict__ scales, int mode, int group, int cs) {
  using G = Gq<CPB>;
  constexpr int S = G::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  float* rowmax = reinterpret_cast<float*>(smem + S * G::kStageBytes);  // [128]: read by the cluster
  float* rscale = rowmax + kGqRows;                                     // [128]
  float* rrcp = rscale + kGqRows;                                       // [128]: 1 / rscale
  uint64_t* full = reinterpret_cast<uint64_t*>(rrcp + kGqRows);
  uint64_t* empty = full + kGqMaxStages;

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int wr = (warp >> 2) & 1, wc = warp >> 3, w4 = warp & 3, g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % cs, grp = blockIdx.x / cs, n_groups = N / group;
  const int c_first = rank * CPB;          // this block's first column in the group
  const int col0 = grp * group + c_first;  // and in the row
  const int m0 = blockIdx.y * kGqRows;
  const int kt_n = (K + kBK - 1) / kBK;
  GQ_PHASE(0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      ctt::mbar_init(&full[s], 1);
      ctt::mbar_init(&empty[s], kGqThreads / 32);  // every warp
    }
    ctt::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int kt = 0; kt < S && kt < kt_n; ++kt) gq_load<CPB>(smem, full, &tma_a, &tma_b, kt, m0, col0);

  int acc[G::kN / 2];
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % S;
    ctt::mbar_wait(&full[s], (kt / S) & 1);
    if (kt == 0) GQ_PHASE(1);
    const unsigned sa = ctt::smem_addr(smem + s * G::kStageBytes);
    const uint64_t da = ctt::sw128_desc(sa + wr * 64 * kBK);
    const uint64_t db = ctt::sw128_desc(sa + (kGqRows + wc * G::kN) * kBK);
    ctt::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks)  // past K (K % 128 == 64) TMA filled zeros
      ctt::wgmma_s8(acc, da + 2 * ks, db + 2 * ks, (kt | ks) != 0);
    ctt::wgmma_commit();
    ctt::wgmma_wait<1>();
    ctt::fence_regs(acc);
    if (kt > 0) {  // the previous stage's wgmmas are done
      const int sp = (kt - 1) % S;
      if (lane == 0) ctt::mbar_arrive(&empty[sp]);
      if (threadIdx.x == 0 && kt - 1 + S < kt_n) {
        ctt::mbar_wait(&empty[sp], ((kt - 1) / S) & 1);
        gq_load<CPB>(smem, full, &tma_a, &tma_b, kt - 1 + S, m0, col0);
      }
    }
  }
  ctt::wgmma_wait<0>();
  ctt::fence_regs(acc);

  GQ_PHASE(2);
  // act(y) in f32 from the accumulator registers (one copy of the loop per
  // activation, so that no element evaluates another's), and each row's
  // |max| over the quad
  const int lr0 = wr * 64 + w4 * 16 + g;  // + 8h: the rows of acc[4j + 2h + e]
  float amax[2];
  if (mode == kGeluQuick)
    gq_act<CPB, kGeluQuick>(acc, amax, sx, ws, bias, M, m0 + lr0, c_first, col0, wc, t, group);
  else if (mode == kGeluTanh)
    gq_act<CPB, kGeluTanh>(acc, amax, sx, ws, bias, M, m0 + lr0, c_first, col0, wc, t, group);
  else
    gq_act<CPB, kBiasF32>(acc, amax, sx, ws, bias, M, m0 + lr0, c_first, col0, wc, t, group);
  GQ_PHASE(3);
  // the row maxima of the two column halves meet in shared memory (the
  // ring is free once every warp's wgmmas are done)
  __syncthreads();
  float* halfmax = reinterpret_cast<float*>(smem);  // [2][128]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
    amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
    if (t == 0) halfmax[wc * kGqRows + lr0 + 8 * h] = amax[h];
  }
  __syncthreads();
  if (threadIdx.x < kGqRows)
    rowmax[threadIdx.x] = fmaxf(halfmax[threadIdx.x], halfmax[kGqRows + threadIdx.x]);
  GQ_PHASE(4);
  ctt::cluster_sync();  // every block's row maxima are written
  GQ_PHASE(5);
  if (threadIdx.x < kGqRows) {
    float part[16];  // all the cluster's loads in flight at once
#pragma unroll
    for (int q = 0; q < 16; ++q)
      part[q] = q < cs ? ctt::ld_cluster_f32(&rowmax[threadIdx.x], q) : 0.f;
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q) a = fmaxf(a, part[q]);
    const float scl = ctt::row_scale(a);
    rscale[threadIdx.x] = scl;
    rrcp[threadIdx.x] = __frcp_rn(scl);
    const int r = m0 + threadIdx.x;
    if (rank == 0 && r < M) scales[(size_t)r * n_groups + grp] = scl;
  }
  GQ_PHASE(6);
  ctt::cluster_arrive();  // this block has read the others' row maxima
  __syncthreads();        // rscale, rrcp

  // codes from the registers, staged as int8 [128][CPB + 16] in the ring,
  // then 16 bytes a thread to device memory
  int8_t* staged = reinterpret_cast<int8_t*>(smem + 2 * kGqRows * 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lr = lr0 + 8 * h;
    const float scl = rscale[lr], rc = rrcp[lr];
#pragma unroll
    for (int j = 0; j < G::kN / 8; ++j)
      *reinterpret_cast<char2*>(staged + lr * G::kLd8 + wc * G::kN + 8 * j + 2 * t) =
          make_char2(ctt::quant_code_rcp(__int_as_float(acc[4 * j + 2 * h]), scl, rc),
                     ctt::quant_code_rcp(__int_as_float(acc[4 * j + 2 * h + 1]), scl, rc));
  }
  __syncthreads();
  const int n_valid = min(CPB, group - c_first);  // a multiple of 8, or <= 0
  for (int idx = threadIdx.x; idx < kGqRows * (CPB / 8); idx += kGqThreads) {
    const int lr = idx / (CPB / 8), c8 = 8 * (idx % (CPB / 8)), r = m0 + lr;
    if (c8 < n_valid && r < M)
      *reinterpret_cast<uint2*>(codes + (size_t)r * N + col0 + c8) =
          *reinterpret_cast<const uint2*>(staged + lr * G::kLd8 + c8);
  }
  GQ_PHASE(7);
  ctt::cluster_wait();  // no block leaves while another reads its row maxima
  GQ_PHASE(8);
}

template <int CPB>
int gq_attrs() {
  static int err = -1;
  if (err < 0) {
    err = (int)cudaFuncSetAttribute(gemm_gq_kernel<CPB>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, Gq<CPB>::kSmem);
    if (err == 0)
      err = (int)cudaFuncSetAttribute(gemm_gq_kernel<CPB>,
                                      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

template <int CPB>
cudaLaunchConfig_t gq_config(int n, int m, int group, int cs, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n / group) * cs, (m + kGqRows - 1) / kGqRows);
  cfg.blockDim = dim3(kGqThreads);
  cfg.dynamicSmemBytes = Gq<CPB>::kSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int CPB>
int launch_gq(const int8_t* a, const int8_t* b, int m, int n, int k, const float* sx,
              const float* ws, const float* bias, int8_t* codes, float* scales, int mode,
              int group, int cs, cudaStream_t stream) {
  CUtensorMap ta, tb;
  int err = tensor_map(&ta, a, m, k, kGqRows);
  if (err == 0) err = tensor_map(&tb, b, n, k, Gq<CPB>::kN);
  if (err == 0) err = gq_attrs<CPB>();
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gq_config<CPB>(n, m, group, cs, stream, &attr);
  err = (int)cudaLaunchKernelEx(&cfg, gemm_gq_kernel<CPB>, ta, tb, m, n, k, sx, ws, bias, codes,
                                scales, mode, group, cs);
  return err != 0 ? err : (int)cudaGetLastError();
}

template <int CPB>
int gq_info(int cs, int* info) {
  info[0] = Gq<CPB>::kSmem;
  info[1] = Gq<CPB>::kStages;
  int err = gq_attrs<CPB>();
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gq_config<CPB>(64, 64 * kGqRows, 64, cs, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(&info[2], gemm_gq_kernel<CPB>, &cfg);
}

}  // namespace

extern "C" {

// a int8 [m, k] (row scales sx [m]), b int8 [n, k] -> act(a.b^T * sx * ws +
//   bias) requantized per group of `group` columns: codes int8 [m, n],
//   scales f32 [m, n / group]; mode kGeluQuick, kGeluTanh or kBiasF32; a
//   cluster of cs blocks of cpb columns spans a group (ops.actquant.gq_plan);
//   k % 64 == 0, group % 8 == 0, n % group == 0, a and b 16-byte aligned.
int ctt_gemm_gq(const int8_t* a, const int8_t* b, int m, int n, int k, const float* sx,
                const float* ws, const float* bias, int8_t* codes, float* scales, int mode,
                int group, int cs, int cpb, cudaStream_t stream) {
  if (cs < 1 || cs > 16) return (int)cudaErrorInvalidValue;
#define CTT_GQ(C) \
  case C: return launch_gq<C>(a, b, m, n, k, sx, ws, bias, codes, scales, mode, group, cs, stream);
  switch (cpb) {  // ops.actquant.GQ_COLUMNS
    CTT_GQ(128) CTT_GQ(192) CTT_GQ(256) CTT_GQ(320)
  }
#undef CTT_GQ
  return (int)cudaErrorInvalidValue;
}

// For the smoke's report: info[0] the dynamic shared memory of a block of
//   cpb columns, info[1] its ring stages, info[2] how many clusters of cs
//   such blocks the card holds at once (cudaOccupancyMaxActiveClusters).
int ctt_gemm_gq_info(int cs, int cpb, int* info) {
  switch (cpb) {
    case 128: return gq_info<128>(cs, info);
    case 192: return gq_info<192>(cs, info);
    case 256: return gq_info<256>(cs, info);
    case 320: return gq_info<320>(cs, info);
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef CTT_GQ_PHASES
// where the phase timestamps go: [blocks][9] u64
int ctt_gemm_gq_phases_to(unsigned long long* p) {
  return (int)cudaMemcpyToSymbol(g_phases, &p, sizeof(p));
}
#endif

}  // extern "C"
