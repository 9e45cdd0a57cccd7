// Helpers shared by the kernels of clip_tpu_torch: warp and block
// reductions, the row quantizer, asynchronous copies and tensor-core
// fragments.  No PyTorch headers: the library is built with plain nvcc
// calls and bound with ctypes.
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

// quant_code with the quotient from a reciprocal rc = __frcp_rn(sx) computed
// once per row instead of a division per element: q = y * rc, then two
// correction steps q += (y - q * sx) * rc, the remainder exact in one FMA.
// With rc the correctly rounded reciprocal and q within an ulp of y / sx
// after the first step, the second gives the correctly rounded quotient
// (Markstein's theorem), the value __fdiv_rn gives, so the code equals
// quant_code's; where the quotient underflows it is far below the 0.5 at
// which rintf could differ.
__device__ __forceinline__ int8_t quant_code_rcp(float y, float sx, float rc) {
  float q = __fmul_rn(y, rc);
  q = __fmaf_rn(__fmaf_rn(-q, sx, y), rc, q);
  q = __fmaf_rn(__fmaf_rn(-q, sx, y), rc, q);
  return (int8_t)fminf(fmaxf(rintf(q), -127.f), 127.f);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// -- asynchronous copies and tensor-core fragments (sm_80 and later) ----------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with pred false the 16 bytes are zero-filled
// (src-size 0) and gmem is not read
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(n));
}

// 4 bytes global -> shared, zero-filled when pred is false
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 matrices of 16-bit elements (8 rows of 16 bytes each); lanes
// 8i..8i+7 give the row addresses of matrix i, and lane l receives row l/4,
// elements 2(l%4) and 2(l%4)+1 of each matrix (with .trans: row 2(l%4) and
// 2(l%4)+1 of column l/4)
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// C[16x8] += A[16x32] . B[32x8] in int8 with exact int32 accumulation
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C[16x8] += A[16x16] . B[16x8] in bf16 with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, x in the low half (the lower column of a fragment)
__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace ctt
