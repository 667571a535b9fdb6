// Tiles, fragment loads and per-score helpers shared by the attention forward
// (attention_fwd.cu) and backward (attention_bwd.cu) kernels on the tensor cores.
//
// A block of WARPS warps works on TILE rows of one head; each warp owns 16 of
// them. Two plans, chosen at compile time by the head dim D:
//   - narrow (the forward at D <= 64, the backward at D <= 32): the warp holds
//     its own rows as split A fragments in registers. The matrix it loops over
//     comes in tiles of TILE rows: staged raw into shared memory by cp.async
//     (`stage`), then split once per block into TF32 operands (`prepare`) that
//     every warp reads as mma.sync m16n8k8 B fragments (`frag_b_rows`,
//     `frag_b_cols`). Prepared rows are padded to D + 4 elements.
//   - wide (larger D): the block's own rows stay raw in shared memory, the
//     matrices it loops over come in tiles of WIDE_ROWS raw rows through a ring
//     of two stages (one where two do not fit, `WidePlan`), and every fragment
//     is read from raw rows and split as it is loaded (`frag_a_raw`,
//     `frag_b_rows_raw`, `frag_b_cols_raw`). The accumulators cover a slice of
//     D's columns, one pass over the loop per slice, so that their registers do
//     not grow with D.
// Raw rows are padded by 16 bytes (D + 4 f32 or D + 8 bf16 values), so the
// wide plan's fragment reads from them are free of bank conflicts for D a
// multiple of 32, as the narrow plan's from prepared rows are. The fragment
// layouts and the C-to-A relabelling are described in mma_tf32.cuh.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "mma_tf32.cuh"

namespace attn {

constexpr int TILE = 64;              // keys or queries per block and per loop step
constexpr int WARPS = 4;              // 16 rows of the block's tile each
constexpr int THREADS = WARPS * 32;
constexpr int WIDE_ROWS = 32;         // rows of a streamed tile in the wide plan
constexpr int MAX_SMEM = 232448;      // dynamic shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 2^x; results below 2^-126 flush to 0 (p that small moves no sum here).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- one tile of 64 rows in shared memory: raw (as staged) and prepared ----
//
// Raw rows: D values of T padded by 16 bytes, filled by cp.async. Prepared rows:
// D + 4 elements of Prep<T>, what the fragment loads read: for f32 the (hi, lo)
// TF32 pair of each value, for bf16 its TF32 bits (exact; lo = 0).

template <typename T>
struct Prep;
template <>
struct Prep<float> {
  using type = uint2;
};
template <>
struct Prep<__nv_bfloat16> {
  using type = uint32_t;
};

template <typename T, int D>
struct Tile {
  using P = typename Prep<T>::type;
  static constexpr int RAW = D + 16 / sizeof(T);  // raw row stride (values)
  static constexpr int ROW = D + 4;               // prepared row stride (elements)
  static constexpr int BYTES = TILE * (RAW * sizeof(T) + ROW * sizeof(P));
};

__device__ __forceinline__ void prep(uint2& e, float x) { tf32::split<true>(x, e.x, e.y); }
__device__ __forceinline__ void prep(uint32_t& e, __nv_bfloat16 x) {
  e = static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
}
__device__ __forceinline__ void unpack(const uint2& e, uint32_t& hi, uint32_t& lo) {
  hi = e.x;
  lo = e.y;
}
__device__ __forceinline__ void unpack(const uint32_t& e, uint32_t& hi, uint32_t& lo) {
  hi = e;
  lo = 0u;
}

// Rows [r0, r0 + ROWS) of a row-major (n, D) matrix into raw rows by cp.async
// (the caller commits); rows >= n are zeros.
template <typename T, int D, int ROWS = TILE>
__device__ __forceinline__ void stage(T* raw, const T* src, int r0, int n) {
  constexpr int E = 16 / sizeof(T);  // values per 16-byte chunk
  constexpr int CH = D / E;          // chunks per row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < n;
    tf32::cp_async16(raw + r * Tile<T, D>::RAW + c * E,
                     src + static_cast<size_t>(in ? r0 + r : 0) * D + c * E, in);
  }
}

// Raw rows -> prepared rows, 16 bytes of raw values per step.
template <typename T, int D>
__device__ __forceinline__ void prepare(typename Tile<T, D>::P* dst, const T* raw) {
  using P = typename Tile<T, D>::P;
  constexpr int E = 16 / sizeof(T);
  constexpr int CH = D / E;
#pragma unroll
  for (int i = threadIdx.x; i < TILE * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const uint4 u = *reinterpret_cast<const uint4*>(raw + r * Tile<T, D>::RAW + c * E);
    const T* x = reinterpret_cast<const T*>(&u);
    __align__(16) P e[E];  // 32 bytes
#pragma unroll
    for (int j = 0; j < E; ++j) prep(e[j], x[j]);
    uint4* d = reinterpret_cast<uint4*>(dst + r * Tile<T, D>::ROW + c * E);
    d[0] = reinterpret_cast<const uint4*>(e)[0];
    d[1] = reinterpret_cast<const uint4*>(e)[1];
  }
}

// B fragment of X^T from prepared rows of X: n = row, k = column.
// b0 = X[n0 + g][k0 + t], b1 = X[n0 + g][k0 + t + 4].
template <int D, typename P>
__device__ __forceinline__ void frag_b_rows(const P* x, int n0, int k0, int g, int t,
                                            uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const P* p = x + (n0 + g) * (D + 4) + k0 + t;
  unpack(p[0], hi[0], lo[0]);
  unpack(p[4], hi[1], lo[1]);
}

// B fragment of X from prepared rows of X, k relabelled (mma_tf32.cuh): k = row,
// n = column; b0 = X[k0 + 2t][n0 + g], b1 = X[k0 + 2t + 1][n0 + g].
template <int D, typename P>
__device__ __forceinline__ void frag_b_cols(const P* x, int k0, int n0, int g, int t,
                                            uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const P* p = x + (k0 + 2 * t) * (D + 4) + n0 + g;
  unpack(p[0], hi[0], lo[0]);
  unpack(p[D + 4], hi[1], lo[1]);
}

// A fragments of rows r0 + g, r0 + g + 8 of a (n, D) matrix in device memory,
// for the D / 8 k-steps of a product over D; rows >= n are zeros.
template <typename T, int D, bool kSplit>
__device__ __forceinline__ void frag_a_global(const T* x, int r0, int n, int g, int t,
                                              uint32_t (&hi)[D / 8][4],
                                              uint32_t (&lo)[D / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + g + (r & 1) * 8;
      const int col = kk * 8 + t + (r >> 1) * 4;
      const float v = row < n ? to_f32(x[static_cast<size_t>(row) * D + col]) : 0.f;
      tf32::split<kSplit>(v, hi[kk][r], lo[kk][r]);
    }
  }
}

// A fragment of one k-step from a C fragment (c0, c1, c2, c3): (c0, c2, c1, c3).
template <bool kSplit>
__device__ __forceinline__ void frag_a_from_c(const float (&c)[4], uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  tf32::split<kSplit>(c[0], hi[0], lo[0]);
  tf32::split<kSplit>(c[2], hi[1], lo[1]);
  tf32::split<kSplit>(c[1], hi[2], lo[2]);
  tf32::split<kSplit>(c[3], hi[3], lo[3]);
}

// ---- the wide plan: fragments from raw rows, split as they are loaded ----

// A fragment of rows r0 + g, r0 + g + 8 and columns k0 + t, k0 + t + 4 of raw rows.
template <typename T, int D, bool kSplit>
__device__ __forceinline__ void frag_a_raw(const T* x, int r0, int k0, int g, int t,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  constexpr int S = Tile<T, D>::RAW;
  const T* p = x + (r0 + g) * S + k0 + t;
  tf32::split<kSplit>(to_f32(p[0]), hi[0], lo[0]);
  tf32::split<kSplit>(to_f32(p[8 * S]), hi[1], lo[1]);
  tf32::split<kSplit>(to_f32(p[4]), hi[2], lo[2]);
  tf32::split<kSplit>(to_f32(p[8 * S + 4]), hi[3], lo[3]);
}

// frag_b_rows from raw rows: b0 = X[n0 + g][k0 + t], b1 = X[n0 + g][k0 + t + 4].
template <typename T, int D, bool kSplit>
__device__ __forceinline__ void frag_b_rows_raw(const T* x, int n0, int k0, int g, int t,
                                                uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const T* p = x + (n0 + g) * Tile<T, D>::RAW + k0 + t;
  tf32::split<kSplit>(to_f32(p[0]), hi[0], lo[0]);
  tf32::split<kSplit>(to_f32(p[4]), hi[1], lo[1]);
}

// frag_b_cols from raw rows: b0 = X[k0 + 2t][n0 + g], b1 = X[k0 + 2t + 1][n0 + g].
template <typename T, int D, bool kSplit>
__device__ __forceinline__ void frag_b_cols_raw(const T* x, int k0, int n0, int g, int t,
                                                uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  constexpr int S = Tile<T, D>::RAW;
  const T* p = x + (k0 + 2 * t) * S + n0 + g;
  tf32::split<kSplit>(to_f32(p[0]), hi[0], lo[0]);
  tf32::split<kSplit>(to_f32(p[S]), hi[1], lo[1]);
}

// Shared memory of a wide-plan block: OWN resident tiles of TILE raw rows, then
// STAGES stages of STREAMS streamed tiles of WIDE_ROWS raw rows and EXTRA bytes
// each; two stages where they fit in MAX_SMEM, else one.
template <typename T, int D, int OWN, int STREAMS, int EXTRA = 0>
struct WidePlan {
  static constexpr int ROW_BYTES = Tile<T, D>::RAW * static_cast<int>(sizeof(T));
  static constexpr int OWN_BYTES = OWN * TILE * ROW_BYTES;
  static constexpr int STAGE_BYTES = STREAMS * WIDE_ROWS * ROW_BYTES + EXTRA;
  static constexpr int STAGES = OWN_BYTES + 2 * STAGE_BYTES <= MAX_SMEM ? 2 : 1;
  static constexpr int BYTES = OWN_BYTES + STAGES * STAGE_BYTES;
  static_assert(BYTES <= MAX_SMEM, "a wide-plan block does not fit in shared memory");
};

// The dropout hash of dropout_hash.cuh with row * M1, col * M2 and bh * M3
// computed by the caller (each is reused across many scores).
__device__ __forceinline__ bool kept(uint32_t row_m1, uint32_t col_m2, uint32_t bh_m3,
                                     uint32_t seed, uint32_t thresh) {
  return dropout_hash::mix32((row_m1 ^ col_m2 ^ bh_m3) + seed) >= thresh;
}

}  // namespace attn
