// Hopper counterpart of the attention core of two TPU kernels of the JAX
// package:
//   clip_tpu/ops/attention_pallas.py:484 attn_block_pallas (body
//     _attn_half:397), whose per-head f32 output feeds the int8 requant;
//   clip_tpu/ops/attention_pallas.py:1014 mha_pallas_qkv (bodies
//     _qkv_kernel_flat:160 and _qkv_kernel:120), whose per-head output is
//     rounded to the compute dtype (o_ref[...] = out.astype(o_ref.dtype)).
// Both share the softmax _softmax_rows:52.
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
// Shared memory: 2 S (dh + 2) x 2 B for K and V + 4 S x 4 B of p rows +
// 4 dh x 4 B of query rows.  Q is not staged, so every S <= 640 (the TPU's
// single-image bound _FLAT_MAX_S1) fits at dh = 64 and 80: 220.2 KB at
// S = 640, dh = 80, under the 232,448 B a block may have (161.6 KB at
// ViT-L/14-336's S = 577).  The wrapper checks the size before the launch.
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

template <typename OutT>
__global__ void __launch_bounds__(kAttnWarps * 32)
attention_kernel(const __nv_bfloat16* __restrict__ qkv, OutT* __restrict__ out, int S,
                 int n_head, int dh, float scale, int causal, int valid_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int head = blockIdx.x, img = blockIdx.y;
  const int hl = n_head * dh;
  const int ld = dh + 2;  // odd number of 32-bit words per row
  const int dh2 = dh >> 1;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + S * ld;
  float* P = reinterpret_cast<float*>(Vs + S * ld);
  float* Qr = P + kAttnWarps * S;

  const size_t row0 = (size_t)img * S;
  for (int idx = threadIdx.x; idx < S * dh2; idx += blockDim.x) {
    const int r = idx / dh2, c2 = idx - r * dh2;
    const __nv_bfloat162* src =
        reinterpret_cast<const __nv_bfloat162*>(qkv + (row0 + r) * 3 * hl + head * dh) + c2;
    reinterpret_cast<__nv_bfloat162*>(Ks + r * ld)[c2] = src[hl / 2];
    reinterpret_cast<__nv_bfloat162*>(Vs + r * ld)[c2] = src[hl];
  }
  __syncthreads();

  // q * scale in the compute dtype, as the TPU kernel does
  const float sc = ctt::bf16_round(scale);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = P + warp * S;
  float* q = Qr + warp * dh;
  for (int i = warp; i < S; i += kAttnWarps) {
    const __nv_bfloat162* qsrc =
        reinterpret_cast<const __nv_bfloat162*>(qkv + (row0 + i) * 3 * hl + head * dh);
    for (int d = lane; d < dh2; d += 32) {
      const float2 qf = __bfloat1622float2(qsrc[d]);
      q[2 * d] = ctt::bf16_round(qf.x * sc);
      q[2 * d + 1] = ctt::bf16_round(qf.y * sc);
    }
    __syncwarp();
    float lsum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(Ks + j * ld);
      float acc = 0.f;
      for (int d = 0; d < dh2; ++d) {
        const float2 kf = __bfloat1622float2(k2[d]);
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
    for (int j = lane; j < S; j += 32) p[j] = ctt::bf16_round(__fdiv_rn(p[j], lsum));
    __syncwarp();
    OutT* orow = out + (row0 + i) * hl + head * dh;
    for (int d = lane; d < dh2; d += 32) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j < S; ++j) {
        const float pj = p[j];
        const float2 vf = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(Vs + j * ld)[d]);
        ax = fmaf(pj, vf.x, ax);
        ay = fmaf(pj, vf.y, ay);
      }
      store2(orow, d, ax, ay);
    }
    __syncwarp();
  }
}

template <typename OutT>
int launch(const void* qkv, void* out, int b, int s, int n_head, int dh, float scale,
           int causal, int valid_len, cudaStream_t stream) {
  const size_t smem = (size_t)2 * s * (dh + 2) * 2 + (size_t)kAttnWarps * (s + dh) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_head, b);
  attention_kernel<OutT><<<grid, kAttnWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<OutT*>(out), s, n_head, dh, scale,
      causal, valid_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv bf16 [b*s, 3*n_head*dh] (q | k | v, heads contiguous in each third)
//   -> out [b*s, n_head*dh], f32 (out_bf16 == 0) or bf16; dh even.  Keys
//   j >= valid_len are masked, and with `causal` keys j > i.
int ctt_attention(const void* qkv, void* out, int b, int s, int n_head, int dh, float scale,
                  int causal, int valid_len, int out_bf16, cudaStream_t stream) {
  return out_bf16 ? launch<__nv_bfloat16>(qkv, out, b, s, n_head, dh, scale, causal, valid_len,
                                          stream)
                  : launch<float>(qkv, out, b, s, n_head, dh, scale, causal, valid_len, stream);
}

}  // extern "C"
