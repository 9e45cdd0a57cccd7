// Helpers shared by the kernels of clip_tpu_torch: warp and block
// reductions and the row quantizer.  No PyTorch headers: the library is built
// with one plain nvcc call and bound with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ctt {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; blockDim.x a multiple of 32.  `sh` holds 32 floats.
// The leading barrier lets a caller reuse `sh` for consecutive reductions.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) sh[0] = v;
  }
  __syncthreads();
  return sh[0];
}

__device__ __forceinline__ float block_max(float v, float* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0.f;
    v = warp_max(v);
    if (lane == 0) sh[0] = v;
  }
  __syncthreads();
  return sh[0];
}

// amax/127 + 1e-12, as ops.nn.quant_rows
__device__ __forceinline__ float row_scale(float amax) {
  return __fadd_rn(__fdiv_rn(amax, 127.f), 1e-12f);
}

// round half to even, clip to +-127
__device__ __forceinline__ int8_t quant_code(float y, float sx) {
  float q = rintf(__fdiv_rn(y, sx));
  return (int8_t)fminf(fmaxf(q, -127.f), 127.f);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

}  // namespace ctt
