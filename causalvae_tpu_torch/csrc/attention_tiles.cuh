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
//   - deep (D > 256, a multiple of DEEP_CHUNK; D a runtime argument): a block
//     owns R = DEEP_ROWS(D) rows (32 up to D = 512, 16 above) and keeps their
//     f32 accumulators in shared memory, D columns wide; every operand comes
//     through a ring of slots in chunks of DEEP_CHUNK columns (`stage_chunk`)
//     for each tile of DEEP_TILE keys or queries, so that neither registers
//     nor a pass count grow with D (attention_fwd.cu, attention_bwd.cu).
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

// ---- the wide and deep plans: fragments from raw rows, split as they are loaded ----

// A fragment of rows r0 + g, r0 + g + 8 and columns k0 + t, k0 + t + 4 of raw
// rows S values apart.
template <typename T, bool kSplit>
__device__ __forceinline__ void frag_a_at(const T* x, int S, int r0, int k0, int g, int t,
                                          uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const T* p = x + (r0 + g) * S + k0 + t;
  tf32::split<kSplit>(to_f32(p[0]), hi[0], lo[0]);
  tf32::split<kSplit>(to_f32(p[8 * S]), hi[1], lo[1]);
  tf32::split<kSplit>(to_f32(p[4]), hi[2], lo[2]);
  tf32::split<kSplit>(to_f32(p[8 * S + 4]), hi[3], lo[3]);
}

// frag_b_rows from raw rows S values apart: b0 = X[n0 + g][k0 + t], b1 = X[n0 + g][k0 + t + 4].
template <typename T, bool kSplit>
__device__ __forceinline__ void frag_b_rows_at(const T* x, int S, int n0, int k0, int g,
                                               int t, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const T* p = x + (n0 + g) * S + k0 + t;
  tf32::split<kSplit>(to_f32(p[0]), hi[0], lo[0]);
  tf32::split<kSplit>(to_f32(p[4]), hi[1], lo[1]);
}

// frag_b_cols from raw rows S values apart: b0 = X[k0 + 2t][n0 + g], b1 = X[k0 + 2t + 1][n0 + g].
template <typename T, bool kSplit>
__device__ __forceinline__ void frag_b_cols_at(const T* x, int S, int k0, int n0, int g,
                                               int t, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const T* p = x + (k0 + 2 * t) * S + n0 + g;
  tf32::split<kSplit>(to_f32(p[0]), hi[0], lo[0]);
  tf32::split<kSplit>(to_f32(p[S]), hi[1], lo[1]);
}

// The wide plan's reads: raw rows of a tile at head dim D.
template <typename T, int D, bool kSplit>
__device__ __forceinline__ void frag_a_raw(const T* x, int r0, int k0, int g, int t,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  frag_a_at<T, kSplit>(x, Tile<T, D>::RAW, r0, k0, g, t, hi, lo);
}
template <typename T, int D, bool kSplit>
__device__ __forceinline__ void frag_b_rows_raw(const T* x, int n0, int k0, int g, int t,
                                                uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  frag_b_rows_at<T, kSplit>(x, Tile<T, D>::RAW, n0, k0, g, t, hi, lo);
}
template <typename T, int D, bool kSplit>
__device__ __forceinline__ void frag_b_cols_raw(const T* x, int k0, int n0, int g, int t,
                                                uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  frag_b_cols_at<T, kSplit>(x, Tile<T, D>::RAW, k0, n0, g, t, hi, lo);
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

// ---- the deep plan (D > 256) ----
//
// A block of THREADS threads owns R rows (R / 16 row groups of 16) and walks
// the other side in tiles of DEEP_TILE rows. Its f32 accumulators live in
// shared memory, R rows of D + 8 floats (the C fragments' float2 read-modify-
// writes are free of bank conflicts at that stride); each operand tile comes
// in chunks of DEEP_CHUNK columns, DEEP_TILE raw rows padded by 16 bytes, into
// a ring of slots (`deep_acquire`). Score tiles (R x DEEP_TILE, f32) are
// written to shared memory at a stride of DEEP_TILE + 8 floats and read back
// as A fragments a column pair at a time (float2, k relabelled as for a C
// fragment: free of bank conflicts at that stride).
constexpr int DEEP_CHUNK = 64;       // columns of D in a streamed chunk
constexpr int DEEP_TILE = 32;        // rows of the other side a loop step
constexpr int DEEP_WIDE_MAX_D = 512; // R = 32 up to this D, 16 above
constexpr int DEEP_ST = DEEP_TILE + 8;  // score tile stride (floats)

// The largest head dim of the deep plan: the largest multiple of DEEP_CHUNK
// whose dk/dv block (attention_bwd.cu, the largest) fits in MAX_SMEM in f32.
constexpr int DEEP_MAX_D = 1344;

__host__ __device__ constexpr int deep_rows(int d) { return d <= DEEP_WIDE_MAX_D ? 32 : 16; }

template <typename T>
struct DeepChunk {
  static constexpr int RAW = DEEP_CHUNK + 16 / static_cast<int>(sizeof(T));  // row stride
  static constexpr int BYTES = DEEP_TILE * RAW * static_cast<int>(sizeof(T));
};

// Rows [r0, r0 + rows) and columns [c0, c0 + cols) of a row-major (n, d)
// matrix into raw rows `stride` values apart by cp.async (the caller
// commits); rows >= n are zeros.
template <typename T>
__device__ __forceinline__ void stage_cols(T* dst, int stride, const T* src, int d, int r0,
                                           int rows, int c0, int cols, int n) {
  constexpr int E = 16 / sizeof(T);
  const int ch = cols / E;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < rows * ch; i += THREADS) {
    const int r = i / ch, c = i - r * ch;
    const bool in = r0 + r < n;
    tf32::cp_async16(dst + r * stride + c * E,
                     src + static_cast<size_t>(in ? r0 + r : 0) * d + c0 + c * E, in);
  }
}

// One chunk: rows [r0, r0 + rows), columns [c0, c0 + DEEP_CHUNK).
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* src, int d, int r0, int rows,
                                            int c0, int n) {
  stage_cols<T>(dst, DeepChunk<T>::RAW, src, d, r0, rows, c0, DEEP_CHUNK, n);
}

// Consume slot u of a ring of NS slots whose loads run in order, u = 0, 1, ...
// (`load(s)` stages item s into slot s % NS; the caller staged and committed
// items 0 .. NS - 2 beforehand, one group each): waits until item u has
// landed for every thread, which also means every thread is done with item
// u - 1, then stages item u + NS - 1 into that item's slot. One commit group a
// call, empty past `total`.
template <int NS, typename Load>
__device__ __forceinline__ void deep_acquire(int u, int total, Load&& load) {
  tf32::cp_async_wait<NS - 2>();
  __syncthreads();
  if (u + NS - 1 < total) load(u + NS - 1);
  tf32::cp_async_commit();
}

// acc[j] += A B^T over DEEP_CHUNK columns: A rows r0 .. r0 + 15 of raw rows
// sa values apart, B rows n0 + 8 j .. of raw rows sb apart (a score tile's
// C fragments: row g (+ 8), column 2t (+ 1) of each 16 x 8 block).
// The chunk's first and second 32 columns go to two accumulators (two
// independent mma chains), added into acc at the end.
template <typename T, bool kSplit, int NT>
__device__ __forceinline__ void deep_scores(float (&acc)[NT][4], const T* a, int sa,
                                            const T* b, int sb, int r0, int n0, int g,
                                            int t) {
  float part[2][NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) part[h][j][r] = 0.f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < DEEP_CHUNK / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k0 = h * (DEEP_CHUNK / 2) + kk * 8;
      uint32_t ah[4], al[4];
      frag_a_at<T, kSplit>(a, sa, r0, k0, g, t, ah, al);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_rows_at<T, kSplit>(b, sb, n0 + j * 8, k0, g, t, bh, bl);
        tf32::mma3<kSplit>(part[h][j], ah, al, bh, bl);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] += part[0][j][r] + part[1][j][r];
  }
}

// A fragment of rows r0 + g, r0 + g + 8 of an f32 tile (S floats apart) with k
// relabelled as for a C fragment (mma_tf32.cuh): slot t holds column k0 + 2t,
// slot t + 4 column k0 + 2t + 1, each row's pair one float2.
template <bool kSplit>
__device__ __forceinline__ void frag_a_pairs(const float* x, int S, int r0, int k0, int g,
                                             int t, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 a = *reinterpret_cast<const float2*>(x + (r0 + g) * S + k0 + 2 * t);
  const float2 b = *reinterpret_cast<const float2*>(x + (r0 + g + 8) * S + k0 + 2 * t);
  tf32::split<kSplit>(a.x, hi[0], lo[0]);
  tf32::split<kSplit>(b.x, hi[1], lo[1]);
  tf32::split<kSplit>(a.y, hi[2], lo[2]);
  tf32::split<kSplit>(b.y, hi[3], lo[3]);
}

// acc[j] = A B over DEEP_TILE rows of B: A rows r0 .. r0 + 15 of an f32 score
// tile (DEEP_ST floats apart, `frag_a_pairs`), B a chunk's columns c0 + 8 j ..
// (its rows in the same relabelled order, `frag_b_cols_at`). acc starts at 0.
template <typename T, bool kSplit, int NC>
__device__ __forceinline__ void deep_tile_product(float (&acc)[NC][4], const float* tile,
                                                  const T* b, int r0, int c0, int g, int t) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < DEEP_TILE / 8; ++kk) {
    uint32_t ah[4], al[4];
    frag_a_pairs<kSplit>(tile, DEEP_ST, r0, kk * 8, g, t, ah, al);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      uint32_t bh[2], bl[2];
      frag_b_cols_at<T, kSplit>(b, DeepChunk<T>::RAW, kk * 8, c0 + j * 8, g, t, bh, bl);
      tf32::mma3<kSplit>(acc[j], ah, al, bh, bl);
    }
  }
}

// f32 accumulator rows (R x d, stride d + 8) += alpha_row * acc + c: the C
// fragments c[j] of 16 rows from r0 and 8 columns each from c0 + 8 j.
template <int NC>
__device__ __forceinline__ void deep_accumulate(float* acc, int stride, int r0, int c0,
                                                const float (&c)[NC][4], int g, int t,
                                                const float* alpha = nullptr) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + half * 8;
    const float a = alpha ? alpha[row] : 1.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      float2* p = reinterpret_cast<float2*>(acc + row * stride + c0 + j * 8 + 2 * t);
      float2 x = *p;
      x.x = x.x * a + c[j][2 * half];
      x.y = x.y * a + c[j][2 * half + 1];
      *p = x;
    }
  }
}

// out rows [r0, r0 + R) of a row-major (n, d) matrix = acc * mult (mult per
// row when `row_mult`), converted to T; rows >= n are not written.
template <typename T, int R>
__device__ __forceinline__ void deep_store(T* out, const float* acc, int stride, int d,
                                           int r0, int n, float mult,
                                           const float* row_mult = nullptr) {
  const int pairs = d / 2;
  for (int i = threadIdx.x; i < R * pairs; i += THREADS) {
    const int r = i / pairs, c = 2 * (i - r * pairs);
    if (r0 + r >= n) continue;
    const float m = row_mult ? row_mult[r] : mult;
    const float2 x = *reinterpret_cast<const float2*>(acc + r * stride + c);
    store2(out + static_cast<size_t>(r0 + r) * d + c, x.x * m, x.y * m);
  }
}

// The dropout hash of dropout_hash.cuh with row * M1, col * M2 and bh * M3
// computed by the caller (each is reused across many scores).
__device__ __forceinline__ bool kept(uint32_t row_m1, uint32_t col_m2, uint32_t bh_m3,
                                     uint32_t seed, uint32_t thresh) {
  return dropout_hash::mix32((row_m1 ^ col_m2 ^ bh_m3) + seed) >= thresh;
}

}  // namespace attn
