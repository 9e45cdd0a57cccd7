// Hopper counterpart of the attention core of the JAX package's
//   clip_tpu/ops/attention_pallas.py:484 attn_block_pallas (body
//   _attn_half:397, softmax _softmax_rows:52, requant _quant_heads:64).
//
// The TPU kernel runs the whole attention block per row block with both int8
// projection weights resident in VMEM (1.7 MB for ViT-B/32's qkv alone,
// more than an SM's shared memory).  Here the block is a chain driven from
// ops/attention.py:
//   ctt_lnq -> ctt_gemm_i8 (qkv, bias epilogue, bf16 out)    [actquant.cu]
//   ctt_attention                                            [this file]
//   ctt_requant (full-row amax == max over heads)            [actquant.cu]
//   ctt_gemm_i8 (o projection, bias + residual epilogue)     [actquant.cu]
//
// ctt_attention: one block per (head, image).  CLIP sequences are short
// (S = 50 vision, 80 padded text) and d_head = 64, so one block holds that
// head's Q, K and V in shared memory (3 x 80 x 66 x 2 B = 31 KB; rows padded
// from 64 to 66 elements so that the lanes reading 32 different K rows hit
// 32 different banks).  Each warp takes one query row at a time: scores in
// f32 (one key per lane), exp(clip(s, +-80) + mask) with the additive -1e9
// mask applied after the clip (masked keys give exactly 0), the row sum by
// a warp reduction, p = e / sum rounded to bf16, then p.V with one pair of
// output columns per lane.  The TPU stacks images block-diagonally to fill
// its 128 x 128 matrix unit; attention per image is the same function.
// Numerics follow the TPU kernel: q * scale rounded to bf16, f32 scores,
// p cast to bf16 before p.V, f32 output per head.
//
// What bounds it at ViT-B/32 (B = 64, S = 50, 12 heads): 4 x S^2 x 64 x 12 x
// 64 = 0.49 GFLOP (0.5 us at the bf16 tensor-core peak) against 4.9 MB of
// qkv read and 9.8 MB of f32 output written (4.4 us at 3.35 TB/s), so bytes
// bound it.  This first version computes with CUDA-core FMAs, not tensor
// cores; at these sizes that costs a few times the bound (see PERF.md).
#include "common.cuh"

namespace {

constexpr int kAttnWarps = 4;

__global__ void __launch_bounds__(kAttnWarps * 32)
attention_kernel(const __nv_bfloat16* __restrict__ qkv, float* __restrict__ out, int S,
                 int n_head, int dh, float scale, int causal, int valid_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int head = blockIdx.x, img = blockIdx.y;
  const int hl = n_head * dh;
  const int ld = dh + 2;  // odd number of 32-bit words per row
  const int dh2 = dh >> 1;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + S * ld;
  __nv_bfloat16* Vs = Ks + S * ld;
  float* P = reinterpret_cast<float*>(Vs + S * ld);

  // q * scale in the compute dtype, as the TPU kernel does
  const float sc = ctt::bf16_round(scale);
  const size_t row0 = (size_t)img * S;
  for (int idx = threadIdx.x; idx < S * dh2; idx += blockDim.x) {
    const int r = idx / dh2, c2 = idx - r * dh2;
    const __nv_bfloat162* src =
        reinterpret_cast<const __nv_bfloat162*>(qkv + (row0 + r) * 3 * hl + head * dh) + c2;
    const __nv_bfloat162 q = src[0];
    reinterpret_cast<__nv_bfloat162*>(Qs + r * ld)[c2] =
        __floats2bfloat162_rn(__low2float(q) * sc, __high2float(q) * sc);
    reinterpret_cast<__nv_bfloat162*>(Ks + r * ld)[c2] = src[hl / 2];
    reinterpret_cast<__nv_bfloat162*>(Vs + r * ld)[c2] = src[hl];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = P + warp * S;
  for (int i = warp; i < S; i += kAttnWarps) {
    const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(Qs + i * ld);
    float lsum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(Ks + j * ld);
      float acc = 0.f;
      for (int d = 0; d < dh2; ++d) {
        const float2 qf = __bfloat1622float2(q2[d]);
        const float2 kf = __bfloat1622float2(k2[d]);
        acc = fmaf(qf.x, kf.x, acc);
        acc = fmaf(qf.y, kf.y, acc);
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
    float* orow = out + (row0 + i) * hl + head * dh;
    for (int d = lane; d < dh2; d += 32) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j < S; ++j) {
        const float pj = p[j];
        const float2 vf = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(Vs + j * ld)[d]);
        ax = fmaf(pj, vf.x, ax);
        ay = fmaf(pj, vf.y, ay);
      }
      reinterpret_cast<float2*>(orow)[d] = make_float2(ax, ay);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// qkv bf16 [b*s, 3*n_head*dh] (q | k | v, heads contiguous in each third)
//   -> out f32 [b*s, n_head*dh]; dh even.  Keys j >= valid_len are masked,
//   and with `causal` keys j > i.
int ctt_attention(const void* qkv, float* out, int b, int s, int n_head, int dh, float scale,
                  int causal, int valid_len, cudaStream_t stream) {
  const size_t smem = (size_t)3 * s * (dh + 2) * 2 + (size_t)kAttnWarps * s * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_head, b);
  attention_kernel<<<grid, kAttnWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), out, s, n_head, dh, scale, causal, valid_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
