// Hopper counterpart of the attention core of these TPU kernels of the JAX
// package:
//   clip_tpu/ops/attention_pallas.py:484 attn_block_pallas (body
//     _attn_half:397), whose per-head f32 output feeds the int8 requant;
//   clip_tpu/ops/attention_pallas.py:1014 mha_pallas_qkv (bodies
//     _qkv_kernel_flat:160 and _qkv_kernel:120), whose per-head output is
//     rounded to the compute dtype (o_ref[...] = out.astype(o_ref.dtype)).
//   clip_tpu/ops/attention_pallas.py:1119 mha_pallas (body _mha_kernel:82),
//     attention over separate q, k, v [B, S, H] in bf16 or f32 with the
//     output in the input's dtype: the same kernel with three base pointers
//     and a row stride (the TPU kernel pads S and masks the pad keys; here
//     the keys >= S simply do not exist);
//   the core of clip_tpu/ops/attention_pallas.py:648 attn_block_stream_pallas
//     (f32 out, requantized per head group by ctt_requant).
// All share the softmax _softmax_rows:52.
//
// The TPU attention block keeps both int8 projection weights resident in
// VMEM (1.7 MB for ViT-B/32's qkv alone, more than an SM's shared memory).
// Here that block is a chain driven from ops/attention.py:
//   ctt_lnq -> ctt_gemm_i8 (qkv, bias epilogue, bf16 out)    [actquant.cu]
//   ctt_attention (f32 out)                                  [this file]
//   ctt_requant (full-row amax == max over heads)            [actquant.cu]
//   ctt_gemm_i8 (o projection, bias + residual epilogue)     [actquant.cu]
// and mha_qkv is ctt_attention with the bf16 output.  The TPU's two
// mha_pallas_qkv bodies differ only in layout (images stacked flat with a
// block-diagonal mask, or padded to a 3-D block); per-image attention with
// keys >= valid_len masked is their common function, and one kernel serves
// both.
//
// ctt_attention: one block per (head, image).  The block holds that head's
// K and V in shared memory (rows padded from dh to dh + 2 elements so that
// the lanes reading 32 different K rows hit 32 different banks); each warp
// takes one query row at a time into a small per-warp buffer (q * scale,
// rounded to bf16, as the TPU kernel does), then computes scores in f32
// (one key per lane), exp(clip(s, +-80) + mask) with the additive -1e9 mask
// applied after the clip (masked keys give exactly 0), the row sum by a
// warp reduction, p = e / sum rounded to bf16, then p.V with one pair of
// output columns per lane.  The output is f32, or rounded to bf16.
//
// Shared memory: 2 S (dh + 2) x 2 B for K and V (x 4 B for f32 input) + 4 S
// x 4 B of p rows + 4 dh x 4 B of query rows.  In f32 (mha_pallas on f32
// inputs) q * scale and p stay f32, as the TPU kernel's astype(q.dtype)
// leaves them.  Q is not staged, so every S <= 640 (the TPU's
// single-image bound _FLAT_MAX_S1) fits at dh = 64 and 80: 220.2 KB at
// S = 640, dh = 80, under the 232,448 B a block may have (161.6 KB at
// ViT-L/14-336's S = 577).  The wrapper checks the size before the launch.
//
// ctt_attention_i8 is the counterpart of
//   clip_tpu/ops/attention_pallas.py:278 mha_pallas_qkv_i8 (body
//     _qkv_kernel_flat_i8:215),
// attention over an int8 qkv projection with per-row f32 scales (as
// gemm_gq with act=none writes it).  Same block layout: one block per (head,
// image).  K stays int8 in shared memory (rows of dh / 4 + 1 32-bit words,
// odd, so 32 lanes reading 32 keys hit 32 banks) and each lane forms its
// key's q.k dot with __dp4a, exact in int32 as the TPU's int8 MXU dot; the
// rescale is acc * (sx_q * scale) * sx_k in f32 in that order.  V is
// dequantized once per block to bf16(code * sx) of its own row.  The
// softmax, the bf16 p and the f32 p.V follow the bf16 core.  Shared memory:
// S (dh / 4 + 1) x 4 B of K + S x 4 B of K scales + 4 S x 4 B of p rows +
// 4 dh B of query codes + S (dh + 2) x 2 B of V: 171.8 KB at S = 640,
// dh = 80.  At ViT-B/32 (B = 64, S = 50, 12 heads) bytes bound it: 7.4 MB
// of codes read and 4.9 MB of bf16 written (3.7 us at 3.35 TB/s) against
// 0.25 G int8 and 0.25 G bf16 operations; like the bf16 core it runs on
// CUDA cores, one query row per warp at a time, so latency bounds it in
// practice (see PERF.md).
//
// What bounds it at ViT-B/32 (B = 64, S = 50, 12 heads): 4 x S^2 x 64 x 12 x
// 64 = 0.49 GFLOP (0.5 us at the bf16 tensor-core peak) against 4.9 MB of
// qkv read and 9.8 MB of f32 output written (4.4 us at 3.35 TB/s), so bytes
// bound it.  This version computes with CUDA-core FMAs, not tensor cores;
// at these sizes that costs a few times the bound (see PERF.md).
#include "common.cuh"

namespace {

constexpr int kAttnWarps = 4;

__device__ __forceinline__ void store2(float* row, int d, float x, float y) {
  reinterpret_cast<float2*>(row)[d] = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* row, int d, float x, float y) {
  reinterpret_cast<__nv_bfloat162*>(row)[d] = __floats2bfloat162_rn(x, y);
}

// the d-th pair of a row as f32, and the pair type that copies it
__device__ __forceinline__ float2 load2(const __nv_bfloat16* row, int d) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[d]);
}

__device__ __forceinline__ float2 load2(const float* row, int d) {
  return reinterpret_cast<const float2*>(row)[d];
}

template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Pair<float> { using type = float2; };

// rounding to the input dtype (the TPU kernels' astype(q.dtype))
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return ctt::bf16_round(v);
}

__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// q, k and v rows of head `head` start at q/k/v + row * ld + head * dh, so
// one kernel serves the packed projection (k = q + Hl, v = q + 2 Hl,
// ld = 3 Hl) and separate q, k, v [B*S, H] (ld = H).  The output is
// [B*S, n_head * dh].
template <typename InT, typename OutT>
__global__ void __launch_bounds__(kAttnWarps * 32)
attention_kernel(const InT* __restrict__ qp, const InT* __restrict__ kp,
                 const InT* __restrict__ vp, int ld, OutT* __restrict__ out, int S,
                 int n_head, int dh, float scale, int causal, int valid_len) {
  using P2 = typename Pair<InT>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int head = blockIdx.x, img = blockIdx.y;
  const int hl = n_head * dh;
  const int lds = dh + 2;  // bf16: an odd number of 32-bit words per row
  const int dh2 = dh >> 1;
  InT* Ks = reinterpret_cast<InT*>(smem_raw);
  InT* Vs = Ks + S * lds;
  float* P = reinterpret_cast<float*>(Vs + S * lds);
  float* Qr = P + kAttnWarps * S;

  const size_t row0 = (size_t)img * S;
  for (int idx = threadIdx.x; idx < S * dh2; idx += blockDim.x) {
    const int r = idx / dh2, c2 = idx - r * dh2;
    const size_t o = (row0 + r) * ld + head * dh;
    reinterpret_cast<P2*>(Ks + r * lds)[c2] = reinterpret_cast<const P2*>(kp + o)[c2];
    reinterpret_cast<P2*>(Vs + r * lds)[c2] = reinterpret_cast<const P2*>(vp + o)[c2];
  }
  __syncthreads();

  // q * scale in the input dtype, as the TPU kernels do
  const float sc = round_to(scale, qp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = P + warp * S;
  float* q = Qr + warp * dh;
  for (int i = warp; i < S; i += kAttnWarps) {
    const InT* qsrc = qp + (row0 + i) * ld + head * dh;
    for (int d = lane; d < dh2; d += 32) {
      const float2 qf = load2(qsrc, d);
      q[2 * d] = round_to(qf.x * sc, qp);
      q[2 * d + 1] = round_to(qf.y * sc, qp);
    }
    __syncwarp();
    float lsum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const InT* kr = Ks + j * lds;
      float acc = 0.f;
      for (int d = 0; d < dh2; ++d) {
        const float2 kf = load2(kr, d);
        acc = fmaf(q[2 * d], kf.x, acc);
        acc = fmaf(q[2 * d + 1], kf.y, acc);
      }
      const bool masked = j >= valid_len || (causal && j > i);
      const float e = expf(fminf(fmaxf(acc, -80.f), 80.f) + (masked ? -1e9f : 0.f));
      p[j] = e;
      lsum += e;
    }
    lsum = ctt::warp_sum(lsum);
    __syncwarp();
    for (int j = lane; j < S; j += 32) p[j] = round_to(__fdiv_rn(p[j], lsum), qp);
    __syncwarp();
    OutT* orow = out + (row0 + i) * hl + head * dh;
    for (int d = lane; d < dh2; d += 32) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j < S; ++j) {
        const float pj = p[j];
        const float2 vf = load2(Vs + j * lds, d);
        ax = fmaf(pj, vf.x, ax);
        ay = fmaf(pj, vf.y, ay);
      }
      store2(orow, d, ax, ay);
    }
    __syncwarp();
  }
}

template <typename InT, typename OutT>
int launch(const void* q, const void* k, const void* v, int ld, void* out, int b, int s,
           int n_head, int dh, float scale, int causal, int valid_len, cudaStream_t stream) {
  const size_t smem = (size_t)2 * s * (dh + 2) * sizeof(InT) + (size_t)kAttnWarps * (s + dh) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<InT, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_head, b);
  attention_kernel<InT, OutT><<<grid, kAttnWarps * 32, smem, stream>>>(
      static_cast<const InT*>(q), static_cast<const InT*>(k), static_cast<const InT*>(v), ld,
      static_cast<OutT*>(out), s, n_head, dh, scale, causal, valid_len);
  return (int)cudaGetLastError();
}

constexpr int kI8Warps = kAttnWarps;

template <typename OutT>
__global__ void __launch_bounds__(kI8Warps * 32)
attention_i8_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ sx,
                    OutT* __restrict__ out, int S, int n_head, int dh, float scale, int causal,
                    int valid_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int head = blockIdx.x, img = blockIdx.y;
  const int hl = n_head * dh;
  const int dw = dh >> 2;       // 32-bit words of codes in one head row
  const int ldk = dw + 1;       // odd word stride
  const int ldv = dh + 2;
  const int dh2 = dh >> 1;
  int* Ks = reinterpret_cast<int*>(smem_raw);
  float* Sk = reinterpret_cast<float*>(Ks + S * ldk);
  float* P = Sk + S;
  int* Qr = reinterpret_cast<int*>(P + kI8Warps * S);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(Qr + kI8Warps * dw);

  const size_t row0 = (size_t)img * S;
  for (int r = threadIdx.x; r < S; r += blockDim.x) Sk[r] = sx[row0 + r];
  for (int idx = threadIdx.x; idx < S * dw; idx += blockDim.x) {
    const int r = idx / dw, w = idx - r * dw;
    const int* src = reinterpret_cast<const int*>(qkv + (row0 + r) * 3 * hl + hl + head * dh);
    Ks[r * ldk + w] = src[w];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < S * dh2; idx += blockDim.x) {
    const int r = idx / dh2, c2 = idx - r * dh2;
    const char2 v = reinterpret_cast<const char2*>(qkv + (row0 + r) * 3 * hl + 2 * hl +
                                                   head * dh)[c2];
    const float s = Sk[r];
    reinterpret_cast<__nv_bfloat162*>(Vs + r * ldv)[c2] =
        __floats2bfloat162_rn(__fmul_rn((float)v.x, s), __fmul_rn((float)v.y, s));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = P + warp * S;
  int* q = Qr + warp * dw;
  for (int i = warp; i < S; i += kI8Warps) {
    const int* qsrc = reinterpret_cast<const int*>(qkv + (row0 + i) * 3 * hl + head * dh);
    for (int w = lane; w < dw; w += 32) q[w] = qsrc[w];
    __syncwarp();
    const float sq = __fmul_rn(Sk[i], scale);
    float lsum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const int* kr = Ks + j * ldk;
      int acc = 0;
      for (int w = 0; w < dw; ++w) acc = __dp4a(q[w], kr[w], acc);
      const float sc = __fmul_rn(__fmul_rn((float)acc, sq), Sk[j]);
      const bool masked = j >= valid_len || (causal && j > i);
      const float e = expf(fminf(fmaxf(sc, -80.f), 80.f) + (masked ? -1e9f : 0.f));
      p[j] = e;
      lsum += e;
    }
    lsum = ctt::warp_sum(lsum);
    __syncwarp();
    for (int j = lane; j < S; j += 32) p[j] = ctt::bf16_round(__fdiv_rn(p[j], lsum));
    __syncwarp();
    OutT* orow = out + (row0 + i) * hl + head * dh;
    for (int d = lane; d < dh2; d += 32) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j < S; ++j) {
        const float pj = p[j];
        const float2 vf = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(Vs + j * ldv)[d]);
        ax = fmaf(pj, vf.x, ax);
        ay = fmaf(pj, vf.y, ay);
      }
      store2(orow, d, ax, ay);
    }
    __syncwarp();
  }
}

template <typename OutT>
int launch_i8(const void* qkv, const float* sx, void* out, int b, int s, int n_head, int dh,
              float scale, int causal, int valid_len, cudaStream_t stream) {
  const size_t smem = (size_t)s * (dh / 4 + 1) * 4 + (size_t)s * 4 +
                      (size_t)kI8Warps * (s * 4 + dh) + (size_t)s * (dh + 2) * 2;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_i8_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_head, b);
  attention_i8_kernel<OutT><<<grid, kI8Warps * 32, smem, stream>>>(
      static_cast<const int8_t*>(qkv), sx, static_cast<OutT*>(out), s, n_head, dh, scale,
      causal, valid_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v rows of `ld` elements ([b*s, ...]; head h of a row at h * dh) ->
//   out [b*s, n_head*dh].  io: 0 bf16 in, f32 out; 1 bf16 in, bf16 out;
//   2 f32 in, f32 out.  dh even, ld even.  Keys j >= valid_len are masked,
//   and with `causal` keys j > i.  The packed projection qkv [b*s, 3*Hl] is
//   q = qkv, k = qkv + Hl, v = qkv + 2 Hl, ld = 3 Hl.
int ctt_attention(const void* q, const void* k, const void* v, int ld, void* out, int b, int s,
                  int n_head, int dh, float scale, int causal, int valid_len, int io,
                  cudaStream_t stream) {
  switch (io) {
    case 0:
      return launch<__nv_bfloat16, float>(q, k, v, ld, out, b, s, n_head, dh, scale, causal,
                                          valid_len, stream);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, ld, out, b, s, n_head, dh, scale,
                                                  causal, valid_len, stream);
    case 2:
      return launch<float, float>(q, k, v, ld, out, b, s, n_head, dh, scale, causal, valid_len,
                                  stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// codes int8 [b*s, 3*n_head*dh] (q | k | v, heads contiguous in each third)
//   with row scales f32 [b*s] -> out [b*s, n_head*dh], f32 (out_bf16 == 0) or
//   bf16; dh % 4 == 0.  Masks as ctt_attention.
int ctt_attention_i8(const void* codes, const float* scales, void* out, int b, int s,
                     int n_head, int dh, float scale, int causal, int valid_len, int out_bf16,
                     cudaStream_t stream) {
  return out_bf16 ? launch_i8<__nv_bfloat16>(codes, scales, out, b, s, n_head, dh, scale,
                                             causal, valid_len, stream)
                  : launch_i8<float>(codes, scales, out, b, s, n_head, dh, scale, causal,
                                     valid_len, stream);
}

}  // extern "C"
