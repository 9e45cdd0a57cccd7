// What the two int8 GEMMs of the port share (ctt_gemm_i8 in actquant.cu,
// ctt_gemm_gq in gemm_gq.cu): the epilogue modes and their arithmetic, the
// activations, and the host-side TMA tensor maps of the int8 operands.
#pragma once

#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using ctt::bf16_round;

// The f32 modes (kGeluQuick, kGeluTanh, kBiasF32) are ctt_gemm_gq's act
// epilogue; in ctt_gemm_i8 they write f32 for the reference chain
// ctt_requant(ctt_gemm_i8(...)) that the tests hold ctt_gemm_gq to.
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

constexpr int kBK = 128;            // K bytes a stage: one 128-byte swizzle row per operand row
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float gelu_quick(float y) {
  return __fmul_rn(y, __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(0.851f, y)))));
}

__device__ __forceinline__ float gelu_tanh(float y) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y), y), y);
  const float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(y, cube)));
  return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.f, t));
}

__device__ __forceinline__ float epi_scale(int acc, float sx, float ws) {
  return __fmul_rn(__fmul_rn((float)acc, sx), ws);
}

// the f32 value of the modes that end in f32: act(acc*sx*ws + b)
__device__ __forceinline__ float act_value(int acc, float sx, float ws, float b, int mode) {
  const float y = __fadd_rn(epi_scale(acc, sx, ws), b);
  return mode == kGeluQuick ? gelu_quick(y) : mode == kGeluTanh ? gelu_tanh(y) : y;
}

// -- host side: tensor maps ------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// A map depends only on (base, rows, cols, box rows), so maps are cached by
// that key: a weight's map is encoded once, and an activation's whenever the
// allocator hands out a new address.  Direct-mapped, 256 entries.
struct MapEntry {
  const void* base;
  int rows, cols, box_rows;
  CUtensorMap map;
};

// the 2-D map of an int8 [rows, cols] row-major tensor, box kBK bytes x
// box_rows rows, 128-byte swizzle, zeros past the edges; 0 or a cudaError
inline int tensor_map(CUtensorMap* out, const void* base, int rows, int cols, int box_rows) {
  static MapEntry maps[256];
  static std::mutex mu;
  const uintptr_t h = (reinterpret_cast<uintptr_t>(base) >> 8) ^ ((uintptr_t)rows * 40503u) ^
                      ((uintptr_t)cols * 9973u) ^ (uintptr_t)box_rows;
  MapEntry& e = maps[(h ^ (h >> 8) ^ (h >> 16)) & 255];
  std::lock_guard<std::mutex> lock(mu);
  if (e.base == base && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
    *out = e.map;
    return 0;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap m;
  if (fn(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  e = MapEntry{base, rows, cols, box_rows, m};
  *out = m;
  return 0;
}

}  // namespace
