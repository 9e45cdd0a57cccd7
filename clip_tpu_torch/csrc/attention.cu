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
//     (f32 out, requantized per head group by ctt_requant);
//   clip_tpu/ops/attention_pallas.py:278 mha_pallas_qkv_i8 (body
//     _qkv_kernel_flat_i8:215): ctt_attention_i8 below.
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
// The function (the TPU kernel's numerics, kept exactly): q * bf16(scale)
// rounded to the input dtype; f32 scores; e = exp(clip(s, +-80) + mask) with
// the additive -1e9 mask applied after the clip, so that a masked key gives
// exactly 0 (keys >= valid_len and, when causal, keys j > i); l = sum e, no
// subtraction of the row max; p = bf16(e / l), normalised before it is
// rounded; out = sum p.v accumulated in f32, written as f32 or bf16.  expf
// and __fdiv_rn, not __expf or a reciprocal; no TF32 anywhere.
//
// What bounds it.  At ViT-L/14-336 [4, 577, 16 heads x 64] the products are
// 4 B S^2 Hl = 5.45 GFLOP (5.5 us at 989 bf16 TFLOP/s) against 14.2 MB of
// qkv in and 4.7 MB of bf16 out (5.6 us at 3.35 TB/s); at ViT-B/32 vision
// [64, 50, 12 x 64] bytes bound it (4.9 MB in, 4.9 MB out: 2.9 us) against
// 0.49 GFLOP.  What the tiled kernels below pay in practice is the exact
// softmax on the CUDA cores: one expf per score in each pass and one
// __fdiv_rn per score, about 30 instructions a score against under 2 of
// tensor-core work, so instruction issue bounds them once four blocks share
// an SM (128 registers a thread at d_head 64).  On an H100 SXM at 700 W
// that is 0.106 ms at ViT-L/14-336, 19 times the bound and 26 times faster
// than the first version (PERF.md); wgmma and TMA would not move it.
//
// ctt_attention (bf16 in) and ctt_attention_i8: tiled tensor-core kernels.
//   * Grid (ceil(S / 64) query tiles, heads, images), four warps a block,
//     16 query rows a warp: 120 blocks at ViT-B/16-384 (S 584) per image,
//     768 at ViT-B/32 vision B = 64.  The first version ran one block per
//     (head, image), under one wave on 132 SMs at S = 584, each warp
//     walking its query rows one at a time with dependent FMA chains.
//   * Q (q * bf16(scale), rounded to bf16; or the int8 codes) is loaded
//     once per warp into mma.sync A fragments.
//   * K and V stream through shared memory in tiles of 64 keys with a
//     cp.async double buffer, rows past S zero-filled (a garbage V row
//     times p = 0 could give NaN); row strides padded by 16 bytes so that
//     ldmatrix reads 8 rows from 8 distinct bank groups.  Shared memory no
//     longer grows with S: 512 (dh + 8) B for bf16 and 17 KB of row-sum
//     scratch (62 KB at dh 80), so several blocks share an SM and any S
//     runs.
//   * Two passes over the key tiles keep the TPU's order of rounding (p is
//     normalised before it is rounded to bf16, so the row sum must be
//     complete first).  Pass 1: S = Q K^T on the tensor cores (bf16
//     mma.sync.m16n8k16 with f32 accumulate; int8 m16n8k32 with exact
//     int32 accumulate), then e and the row sums, in warp order (see
//     add_rows: the plain version's rounding of p at S <= 128).  Pass 2
//     recomputes the same scores with the same instruction sequence (bit
//     for bit the same e), forms p = bf16(__fdiv_rn(e, l)) in registers --
//     the C fragment of a score tile is the A fragment of P, so nothing
//     goes through shared memory -- and accumulates O += P V with mma.sync,
//     V fragments by ldmatrix.trans.  The second Q K^T costs half again the
//     products, cheap next to the softmax's own work.
//   * Key tiles that hold only masked keys (all >= valid_len, or, when
//     causal, all after the block's last query row) add exact zeros to l
//     and to O and are skipped; the mask arithmetic runs only on tiles
//     that hold a masked key.
//   * d_head a multiple of 16 up to 128 (a template parameter: the Q and O
//     fragments live in registers); f32 or bf16 out by a runtime flag, so
//     one instantiation serves both.
// ctt_attention_i8 differs in Q K^T: the codes' int32 dot is exact (as the
// TPU's int8 MXU dot and __dp4a), then acc * (sx_q * scale) * sx_k in f32
// in that order, the K-side row scales of each tile in shared memory, and
// d_head padded to a multiple of 32 with zero codes inside the block (80 ->
// 96: exact zeros).  Each V tile of codes is dequantized once into a bf16
// tile, bf16(code * sx) of its own row, and P V is the bf16 path above.
//
// The f32 form (io = 2, mha_pallas on f32 inputs; no route reaches it) must
// stay exact f32, which the bf16 tensor cores are not, and keeps the first
// design on the CUDA cores: one block per (head, image) holding the head's
// K and V in shared memory (rows of dh + 2 floats), each warp one query row
// at a time, scores one key per lane, p.V one pair of output columns per
// lane.  Shared memory 2 S (dh + 2) x 4 B + 4 (S + dh) x 4 B: S <= 344 at
// dh 80 (425 at dh 64) fits in the 232,448 B a block may have; the wrapper
// checks.
#include <type_traits>

#include "common.cuh"

namespace {

using ctt::cp_async16;
using ctt::cp_async4;
using ctt::cp_async_commit;
using ctt::cp_async_wait;
using ctt::ldmatrix_x4;
using ctt::ldmatrix_x4_trans;
using ctt::mma_bf16;
using ctt::mma_s8;
using ctt::pack_bf16;

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---------------------------------------------------------------------------
// Tiled tensor-core attention (bf16 and int8 inputs)

constexpr int kBQ = 64;  // query rows a block: 4 warps x 16
constexpr int kBK = 64;  // keys a shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDh = 128;

// Rows [0, 64) of a tile: `ROW` bytes of each row from `src` (row stride
// `ld` bytes) into shared rows of `LDS` bytes; rows >= `rows` zero-filled.
template <int ROW, int LDS>
__device__ __forceinline__ void load_tile(void* dst, const void* src, size_t ld, int rows) {
  constexpr int kChunks = ROW / 16;
#pragma unroll
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c - r * kChunks) * 16;
    const bool ok = r < rows;
    const char* g = static_cast<const char*>(src) + (ok ? r * ld + col : 0);
    cp_async16(static_cast<char*>(dst) + r * LDS + col, g, ok);
  }
}

// The softmax numerators of a warp's 16 x 64 score tile (C fragments: lane
// (g, t) holds rows g and g + 8, keys 8j + 2t and 8j + 2t + 1 of each 8-key
// n-tile j), in place: e = exp(clip(s, +-80) + mask), the -1e9 mask after
// the clip, so a masked key gives exactly 0.  A tile with no masked key for
// the warp's rows skips the mask arithmetic (adding 0 changes no expf).
__device__ __forceinline__ void exp_scores(float (&s)[8][4], int key0, int row_a, int row_b,
                                           int valid_len, bool causal) {
  const int t = threadIdx.x & 3;
  const int row0 = row_a - (threadIdx.x & 31) / 4;  // the warp's first row
  if (key0 + kBK <= valid_len && !(causal && key0 + kBK - 1 > row0)) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(fminf(fmaxf(s[j][e], -80.f), 80.f));
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + 2 * t + (e & 1);
      const int row = e < 2 ? row_a : row_b;
      const bool masked = key >= valid_len || (causal && key > row);
      s[j][e] = expf(fminf(fmaxf(s[j][e], -80.f), 80.f) + (masked ? -1e9f : 0.f));
    }
}

// The row sums l in warp order: lane L adds keys L, L + 32, L + 64, ... of
// each of the warp's 16 rows in key order (`part`), and an xor butterfly
// over the 32 lanes ends it.  That is the first version's order and the
// order of PyTorch's own row sum at S <= 128 (measured: the first version's
// outputs equalled the plain version's bit for bit at S = 50 and 80), so
// that p = bf16(e / l) rounds as the plain version's does there; another
// order moves l by an ulp in about half the rows, and a p next to a bf16
// rounding boundary then moves by one bf16 ulp.  The C fragments go through
// a per-warp scratch `es` of 16 rows of kEsLd floats to reach that layout.
constexpr int kEsLd = kBK + 4;
constexpr int kEsBytes = kWarps * 16 * kEsLd * 4;

__device__ __forceinline__ void add_rows(const float (&e)[8][4], float (&part)[16], float* es) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(es + g * kEsLd + j * 8 + 2 * t) = make_float2(e[j][0], e[j][1]);
    *reinterpret_cast<float2*>(es + (g + 8) * kEsLd + j * 8 + 2 * t) =
        make_float2(e[j][2], e[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    part[r] += es[r * kEsLd + lane];
    part[r] += es[r * kEsLd + lane + 32];
  }
  __syncwarp();
}

// the butterfly, and the sums of the lane's rows g and g + 8
__device__ __forceinline__ void row_sums(float (&part)[16], float& la, float& lb) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    part[r] = ctt::warp_sum(part[r]);
    if (r == g) la = part[r];
    if (r == g + 8) lb = part[r];
  }
}

// O[16 x DH] += bf16(e / l) . V[64 x DH] for one key tile.  The C fragments
// of n-tiles 2kk and 2kk + 1 are the A fragment of P's k-step kk (keys 16kk
// .. 16kk + 15); V (bf16 rows of DH + 8) gives its B fragments by
// ldmatrix.trans, two 8-column n-tiles of O per x4 load.
template <int DH>
__device__ __forceinline__ void pv_tile(float (&o)[DH / 8][4], const float (&e)[8][4], float la,
                                        float lb, const __nv_bfloat16* vs) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  // lanes 8i..8i+7 address matrix i: keys +8 (mat & 1), columns +8 (mat >> 1)
  const __nv_bfloat16* vrow = vs + ((mat & 1) * 8 + (lane & 7)) * LD + (mat >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned pa[4];
    pa[0] = pack_bf16(__fdiv_rn(e[2 * kk][0], la), __fdiv_rn(e[2 * kk][1], la));
    pa[1] = pack_bf16(__fdiv_rn(e[2 * kk][2], lb), __fdiv_rn(e[2 * kk][3], lb));
    pa[2] = pack_bf16(__fdiv_rn(e[2 * kk + 1][0], la), __fdiv_rn(e[2 * kk + 1][1], la));
    pa[3] = pack_bf16(__fdiv_rn(e[2 * kk + 1][2], lb), __fdiv_rn(e[2 * kk + 1][3], lb));
#pragma unroll
    for (int dn = 0; dn < DH / 16; ++dn) {
      unsigned b[4];
      ldmatrix_x4_trans(b, vrow + kk * 16 * LD + dn * 16);
      mma_bf16(o[2 * dn], pa, b[0], b[1]);
      mma_bf16(o[2 * dn + 1], pa, b[2], b[3]);
    }
  }
}

// S[16 x 64] = Q . K^T for one key tile: bf16 A fragments of Q (k-steps of
// 16) against K rows of DH + 8 bf16; each x4 load gives two 8-key n-tiles.
template <int DH>
__device__ __forceinline__ void qk_bf16(float (&s)[8][4], const unsigned (&qa)[DH / 16][4],
                                        const __nv_bfloat16* ks) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  // matrix i: keys +8 (i >> 1), columns +8 (i & 1)
  const __nv_bfloat16* krow = ks + ((mat >> 1) * 8 + (lane & 7)) * LD + (mat & 1) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      unsigned b[4];
      ldmatrix_x4(b, krow + nj * 16 * LD + kk * 16);
      mma_bf16(s[2 * nj], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * nj + 1], qa[kk], b[2], b[3]);
    }
}

// the same with int8 codes: k-steps of 32 bytes, K rows of DHP + 16 bytes
template <int DHP>
__device__ __forceinline__ void qk_i8(int (&acc)[8][4], const unsigned (&qa)[DHP / 32][4],
                                      const int8_t* ks) {
  constexpr int LD = DHP + 16;
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  const int8_t* krow = ks + ((mat >> 1) * 8 + (lane & 7)) * LD + (mat & 1) * 16;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll
  for (int kk = 0; kk < DHP / 32; ++kk)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      unsigned b[4];
      ldmatrix_x4(b, krow + nj * 16 * LD + kk * 32);
      mma_s8(acc[2 * nj], qa[kk], b[0], b[1]);
      mma_s8(acc[2 * nj + 1], qa[kk], b[2], b[3]);
    }
}

// O's C fragments -> rows row_a, row_b (< S) of the head's output columns
template <int DH, typename OutT>
__device__ __forceinline__ void store_rows(const float (&o)[DH / 8][4], OutT* out, int hl,
                                           int row_a, int row_b, int S) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (row_a < S) store2(out + (size_t)row_a * hl + c, o[nt][0], o[nt][1]);
    if (row_b < S) store2(out + (size_t)row_b * hl + c, o[nt][2], o[nt][3]);
  }
}

// the same, in bf16 or f32 by a runtime flag (one instantiation a d_head)
template <int DH>
__device__ __forceinline__ void store_rows(const float (&o)[DH / 8][4], void* out, int out_bf16,
                                           size_t off, int hl, int row_a, int row_b, int S) {
  if (out_bf16)
    store_rows<DH>(o, static_cast<__nv_bfloat16*>(out) + off, hl, row_a, row_b, S);
  else
    store_rows<DH>(o, static_cast<float*>(out) + off, hl, row_a, row_b, S);
}

// The double-buffered walk over the key tiles: stage kt < nkt holds K tile
// kt (pass 1), stage nkt + kt K and V tile kt (pass 2); `issue(st)` starts
// a stage's copies into buffer st & 1 and commits them, and each stage's
// compute overlaps the next stage's copies.  `between` runs once between
// the passes.  Two loops, so that the pass-1 row-sum partials and the
// pass-2 O accumulators are never live together.
template <typename Issue, typename Pass1, typename Between, typename Pass2>
__device__ __forceinline__ void walk(int nkt, Issue&& issue, Pass1&& pass1, Between&& between,
                                     Pass2&& pass2) {
  issue(0);
  for (int kt = 0; kt < nkt; ++kt) {
    issue(kt + 1);
    cp_async_wait<1>();
    __syncthreads();
    pass1(kt, kt & 1);
    __syncthreads();
  }
  between();
  for (int kt = 0; kt < nkt; ++kt) {
    const int st = nkt + kt;
    if (st + 1 < 2 * nkt) {
      issue(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    pass2(kt, st & 1);
    __syncthreads();
  }
}

// the key tiles a query tile needs: keys >= valid_len and, when causal,
// keys after the tile's last row hold exact zeros
__device__ __forceinline__ int key_tiles(int q0, int valid_len, bool causal) {
  const int kend = causal ? min(valid_len, q0 + kBQ) : valid_len;
  return (kend + kBK - 1) / kBK;
}

// one query row pair's two bf16 values * sc, rounded to bf16 (0 past S)
__device__ __forceinline__ unsigned q_pair(const __nv_bfloat16* q, size_t ld, int row, int S,
                                           int c, float sc) {
  if (row >= S) return 0u;
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + row * ld + c));
  return pack_bf16(f.x * sc, f.y * sc);
}

__host__ __device__ constexpr int tc_smem(int dh) {
  return 2 * 2 * kBK * (dh + 8) * 2 + kEsBytes;
}

// q, k and v rows of head `head` start at q/k/v + row * ld + head * DH, so
// one kernel serves the packed projection (k = q + Hl, v = q + 2 Hl,
// ld = 3 Hl) and separate q, k, v [B*S, H] (ld = H).  The output is
// [B*S, n_head * DH].
template <int DH>
__global__ void __launch_bounds__(kThreads)
attention_tc_kernel(const __nv_bfloat16* __restrict__ qp, const __nv_bfloat16* __restrict__ kp,
                    const __nv_bfloat16* __restrict__ vp, int ld, void* __restrict__ out,
                    int out_bf16, int S, int n_head, float scale, int causal, int valid_len) {
  constexpr int LD = DH + 8;
  constexpr int kTile = kBK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kTile]
  __nv_bfloat16* Vs = Ks + 2 * kTile;                                // [2][kTile]
  float* es = reinterpret_cast<float*>(Vs + 2 * kTile) + (threadIdx.x >> 5) * 16 * kEsLd;

  const int q0 = blockIdx.x * kBQ, head = blockIdx.y, img = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row_a = q0 + warp * 16 + (lane >> 2), row_b = row_a + 8;
  const size_t base = (size_t)img * S * ld + (size_t)head * DH;

  // Q * bf16(scale) in bf16, as the TPU kernels do, as A fragments
  const float sc = ctt::bf16_round(scale);
  unsigned qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = q_pair(qp + base, ld, row_a, S, c, sc);
    qa[kk][1] = q_pair(qp + base, ld, row_b, S, c, sc);
    qa[kk][2] = q_pair(qp + base, ld, row_a, S, c + 8, sc);
    qa[kk][3] = q_pair(qp + base, ld, row_b, S, c + 8, sc);
  }

  const int nkt = key_tiles(q0, valid_len, causal);
  auto issue = [&](int st) {
    const int kt = st < nkt ? st : st - nkt;
    const size_t off = base + (size_t)kt * kBK * ld;
    const int rows = S - kt * kBK;
    load_tile<DH * 2, LD * 2>(Ks + (st & 1) * kTile, kp + off, (size_t)ld * 2, rows);
    if (st >= nkt) load_tile<DH * 2, LD * 2>(Vs + (st & 1) * kTile, vp + off, (size_t)ld * 2, rows);
    cp_async_commit();
  };
  auto scores = [&](float (&s)[8][4], int kt, int buf) {
    qk_bf16<DH>(s, qa, Ks + buf * kTile);
    exp_scores(s, kt * kBK, row_a, row_b, valid_len, causal);
  };

  float part[16], la = 0.f, lb = 0.f;
#pragma unroll
  for (int r = 0; r < 16; ++r) part[r] = 0.f;
  float o[DH / 8][4];
  walk(
      nkt, issue,
      [&](int kt, int buf) {
        float s[8][4];
        scores(s, kt, buf);
        add_rows(s, part, es);
      },
      [&] {
        row_sums(part, la, lb);
#pragma unroll
        for (int i = 0; i < DH / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
      },
      [&](int kt, int buf) {
        float s[8][4];
        scores(s, kt, buf);
        pv_tile<DH>(o, s, la, lb, Vs + buf * kTile);
      });
  store_rows<DH>(o, out, out_bf16, (size_t)img * S * n_head * DH + head * DH, n_head * DH, row_a,
                 row_b, S);
}

__host__ __device__ constexpr int i8_pad(int dh) { return (dh + 31) / 32 * 32; }

__host__ __device__ constexpr int i8_smem(int dh) {
  // bf16 V tile, two buffers of K codes (rows of dh padded to 32, + 16 B),
  // two of V codes, two of the K rows' scales, the row-sum scratch
  return kBK * (dh + 8) * 2 + 2 * kBK * (i8_pad(dh) + 16) + 2 * kBK * dh + 2 * kBK * 4 +
         kEsBytes;
}

// codes int8 [B*S, 3 Hl] (q | k | v), row scales sx [B*S]
template <int DH>
__global__ void __launch_bounds__(kThreads)
attention_i8_tc_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ sx,
                       void* __restrict__ out, int out_bf16, int S, int n_head, float scale,
                       int causal, int valid_len) {
  constexpr int DHP = i8_pad(DH);
  constexpr int LDK = DHP + 16;  // bytes a K row
  constexpr int LDV = DH + 8;    // bf16 a dequantized V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Vt = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBK * LDV]
  int8_t* Kc = reinterpret_cast<int8_t*>(Vt + kBK * LDV);           // [2][kBK * LDK]
  int8_t* Vc = Kc + 2 * kBK * LDK;                                   // [2][kBK * DH]
  float* Sk = reinterpret_cast<float*>(Vc + 2 * kBK * DH);           // [2][kBK]
  float* es = Sk + 2 * kBK + (threadIdx.x >> 5) * 16 * kEsLd;

  const int q0 = blockIdx.x * kBQ, head = blockIdx.y, img = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row_a = q0 + warp * 16 + (lane >> 2), row_b = row_a + 8;
  const int hl = n_head * DH;
  const size_t ld = 3 * (size_t)hl;
  const size_t row0 = (size_t)img * S;
  const int8_t* qb = qkv + row0 * ld + head * DH;
  const float* sxb = sx + row0;

  // the pad columns [DH, DHP) of both K buffers stay zero (cp.async never
  // writes them); DHP - DH is 0 or 16
  if constexpr (DHP > DH) {
    for (int r = threadIdx.x; r < 2 * kBK; r += kThreads)
      *reinterpret_cast<uint4*>(Kc + r * LDK + DH) = make_uint4(0, 0, 0, 0);
  }

  // Q codes as A fragments (columns >= DH zero) and each row's sx * scale
  unsigned qa[DHP / 32][4];
#pragma unroll
  for (int kk = 0; kk < DHP / 32; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = f & 1 ? row_b : row_a;
      const int c = kk * 32 + (f >> 1) * 16 + 4 * t;
      qa[kk][f] = row < S && c < DH ? *reinterpret_cast<const unsigned*>(qb + row * ld + c) : 0u;
    }
  const float sqa = row_a < S ? __fmul_rn(sxb[row_a], scale) : 0.f;
  const float sqb = row_b < S ? __fmul_rn(sxb[row_b], scale) : 0.f;

  const int nkt = key_tiles(q0, valid_len, causal);
  auto issue = [&](int st) {
    const int kt = st < nkt ? st : st - nkt, buf = st & 1;
    const size_t off = (size_t)kt * kBK * ld;
    const int rows = S - kt * kBK;
    load_tile<DH, LDK>(Kc + buf * kBK * LDK, qb + hl + off, ld, rows);
    for (int r = threadIdx.x; r < kBK; r += kThreads)
      cp_async4(Sk + buf * kBK + r, sxb + (r < rows ? kt * kBK + r : 0), r < rows);
    if (st >= nkt) load_tile<DH, DH>(Vc + buf * kBK * DH, qb + 2 * hl + off, ld, rows);
    cp_async_commit();
  };
  auto scores = [&](float (&s)[8][4], int kt, int buf) {
    const float* sk = Sk + buf * kBK;
    int acc[8][4];
    qk_i8<DHP>(acc, qa, Kc + buf * kBK * LDK);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = __fmul_rn(__fmul_rn((float)acc[j][e], e < 2 ? sqa : sqb),
                            sk[j * 8 + 2 * t + (e & 1)]);
    exp_scores(s, kt * kBK, row_a, row_b, valid_len, causal);
  };

  float part[16], la = 0.f, lb = 0.f;
#pragma unroll
  for (int r = 0; r < 16; ++r) part[r] = 0.f;
  float o[DH / 8][4];
  walk(
      nkt, issue,
      [&](int kt, int buf) {
        float s[8][4];
        scores(s, kt, buf);
        add_rows(s, part, es);
      },
      [&] {
        row_sums(part, la, lb);
#pragma unroll
        for (int i = 0; i < DH / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
      },
      [&](int kt, int buf) {
        // V = bf16(code * sx) of its own row, once per tile
        const int8_t* vc = Vc + buf * kBK * DH;
        const float* sk = Sk + buf * kBK;
        for (int i = threadIdx.x; i < kBK * DH / 4; i += kThreads) {
          const int r = i / (DH / 4), c = (i - r * (DH / 4)) * 4;
          const char4 v = *reinterpret_cast<const char4*>(vc + r * DH + c);
          const float sv = sk[r];
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(Vt + r * LDV + c);
          dst[0] = __floats2bfloat162_rn(__fmul_rn((float)v.x, sv), __fmul_rn((float)v.y, sv));
          dst[1] = __floats2bfloat162_rn(__fmul_rn((float)v.z, sv), __fmul_rn((float)v.w, sv));
        }
        __syncthreads();
        float s[8][4];
        scores(s, kt, buf);
        pv_tile<DH>(o, s, la, lb, Vt);
      });
  store_rows<DH>(o, out, out_bf16, row0 * hl + head * DH, hl, row_a, row_b, S);
}

// f(std::integral_constant<int, dh>) for dh a multiple of 16 up to kMaxDh
template <int DH = 16, typename F>
int with_dh(int dh, F&& f) {
  if constexpr (DH > kMaxDh) {
    return (int)cudaErrorInvalidValue;
  } else {
    return dh == DH ? f(std::integral_constant<int, DH>{}) : with_dh<DH + 16>(dh, f);
  }
}

template <typename K>
int set_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

int launch_tc(const void* q, const void* k, const void* v, int ld, void* out, int out_bf16, int b,
              int s, int n_head, int dh, float scale, int causal, int valid_len,
              cudaStream_t stream) {
  return with_dh(dh, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    const auto kernel = attention_tc_kernel<DH>;
    if (const int e = set_smem(kernel, tc_smem(DH))) return e;
    const dim3 grid((s + kBQ - 1) / kBQ, n_head, b);
    kernel<<<grid, kThreads, tc_smem(DH), stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), ld, out, out_bf16, s, n_head, scale, causal,
        valid_len);
    return (int)cudaGetLastError();
  });
}

int launch_i8(const void* qkv, const float* sx, void* out, int out_bf16, int b, int s, int n_head,
              int dh, float scale, int causal, int valid_len, cudaStream_t stream) {
  return with_dh(dh, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    const auto kernel = attention_i8_tc_kernel<DH>;
    if (const int e = set_smem(kernel, i8_smem(DH))) return e;
    const dim3 grid((s + kBQ - 1) / kBQ, n_head, b);
    kernel<<<grid, kThreads, i8_smem(DH), stream>>>(static_cast<const int8_t*>(qkv), sx, out,
                                                    out_bf16, s, n_head, scale, causal,
                                                    valid_len);
    return (int)cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// f32 attention on the CUDA cores (io = 2)

constexpr int kF32Warps = 4;

__global__ void __launch_bounds__(kF32Warps * 32)
attention_f32_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                     const float* __restrict__ vp, int ld, float* __restrict__ out, int S,
                     int n_head, int dh, float scale, int causal, int valid_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int head = blockIdx.x, img = blockIdx.y;
  const int hl = n_head * dh;
  const int lds = dh + 2;
  const int dh2 = dh >> 1;
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + S * lds;
  float* P = Vs + S * lds;
  float* Qr = P + kF32Warps * S;

  const size_t row0 = (size_t)img * S;
  for (int idx = threadIdx.x; idx < S * dh2; idx += blockDim.x) {
    const int r = idx / dh2, c2 = idx - r * dh2;
    const size_t o = (row0 + r) * ld + head * dh;
    reinterpret_cast<float2*>(Ks + r * lds)[c2] = reinterpret_cast<const float2*>(kp + o)[c2];
    reinterpret_cast<float2*>(Vs + r * lds)[c2] = reinterpret_cast<const float2*>(vp + o)[c2];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = P + warp * S;
  float* q = Qr + warp * dh;
  for (int i = warp; i < S; i += kF32Warps) {
    const float* qsrc = qp + (row0 + i) * ld + head * dh;
    for (int d = lane; d < dh2; d += 32) {
      const float2 qf = reinterpret_cast<const float2*>(qsrc)[d];
      q[2 * d] = qf.x * scale;
      q[2 * d + 1] = qf.y * scale;
    }
    __syncwarp();
    float lsum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float* kr = Ks + j * lds;
      float acc = 0.f;
      for (int d = 0; d < dh2; ++d) {
        const float2 kf = reinterpret_cast<const float2*>(kr)[d];
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
    for (int j = lane; j < S; j += 32) p[j] = __fdiv_rn(p[j], lsum);
    __syncwarp();
    float* orow = out + (row0 + i) * hl + head * dh;
    for (int d = lane; d < dh2; d += 32) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j < S; ++j) {
        const float pj = p[j];
        const float2 vf = reinterpret_cast<const float2*>(Vs + j * lds)[d];
        ax = fmaf(pj, vf.x, ax);
        ay = fmaf(pj, vf.y, ay);
      }
      store2(orow + 2 * d, ax, ay);
    }
    __syncwarp();
  }
}

int launch_f32(const void* q, const void* k, const void* v, int ld, void* out, int b, int s,
               int n_head, int dh, float scale, int causal, int valid_len, cudaStream_t stream) {
  const int smem = (2 * s * (dh + 2) + kF32Warps * (s + dh)) * 4;
  if (const int e = set_smem(attention_f32_kernel, smem)) return e;
  attention_f32_kernel<<<dim3(n_head, b), kF32Warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      ld, static_cast<float*>(out), s, n_head, dh, scale, causal, valid_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v rows of `ld` elements ([b*s, ...]; head h of a row at h * dh) ->
//   out [b*s, n_head*dh].  io: 0 bf16 in, f32 out; 1 bf16 in, bf16 out (both
//   on the tensor cores: dh a multiple of 16 up to 128, ld a multiple of 8,
//   q, k, v 16-byte aligned); 2 f32 in, f32 out (dh and ld even).  Keys
//   j >= valid_len are masked, and with `causal` keys j > i.  The packed
//   projection qkv [b*s, 3*Hl] is q = qkv, k = qkv + Hl, v = qkv + 2 Hl,
//   ld = 3 Hl.
int ctt_attention(const void* q, const void* k, const void* v, int ld, void* out, int b, int s,
                  int n_head, int dh, float scale, int causal, int valid_len, int io,
                  cudaStream_t stream) {
  switch (io) {
    case 0:
    case 1:
      return launch_tc(q, k, v, ld, out, io, b, s, n_head, dh, scale, causal, valid_len, stream);
    case 2:
      return launch_f32(q, k, v, ld, out, b, s, n_head, dh, scale, causal, valid_len, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// codes int8 [b*s, 3*n_head*dh] (q | k | v, heads contiguous in each third)
//   with row scales f32 [b*s] -> out [b*s, n_head*dh], f32 (out_bf16 == 0) or
//   bf16; dh a multiple of 16 up to 128, codes 16-byte aligned.  Masks as
//   ctt_attention.
int ctt_attention_i8(const void* codes, const float* scales, void* out, int b, int s,
                     int n_head, int dh, float scale, int causal, int valid_len, int out_bf16,
                     cudaStream_t stream) {
  return launch_i8(codes, scales, out, out_bf16 != 0, b, s, n_head, dh, scale, causal, valid_len,
                   stream);
}

}  // extern "C"
