// Multi-head attention backward for Hopper (sm_90a): dq, dk, dv of
// o = dropout(softmax(q k^T * scale)) v, for q, k, v, o, do of shape (BH, N, D),
// contiguous, f32 or bf16, and the forward's row logsumexp lse (BH, N) in f32.
//
// Replaces the Pallas TPU kernel _bwd_fused_kernel (causalvae_tpu/ops/kernels/
// attention.py). Same math, per (query i, key j):
//   p = exp(s - lse_i) with s = scale * q_i . k_j   (recomputed; no (N, N) in memory)
//   dp = do_i . v_j, masked by the dropout hash and scaled by 1 / (1 - rate)
//   pd = p masked and scaled the same way (what the forward multiplied v by)
//   delta_i = sum_d do_i * o_i
//   ds = p * (dp - delta_i)
//   dv_j += pd * do_i,  dk_j += scale * ds * q_i,  dq_i += scale * ds * k_j
//
// What bounds it on this card: operations. 10 * N * N * D flops per head against
// 9 * N * D elements in and out. Every product runs on the tensor cores as
// mma.sync m16n8k8 TF32 (mma_tf32.cuh): for f32 inputs split into 3xTF32, which
// keeps f32 accuracy; at (BH, N, D) = (64, 961, 32) that is 57 GFLOP of TF32
// work, ~0.11 ms at the card's 495 TFLOP/s. For bf16 inputs q, k, v and do are
// exact in TF32 and every product is one mma; p and ds are rounded to TF32
// (11 bits; the JAX kernel rounds them to bf16) before their products.
//
// The TPU kernel held a head's whole K and V and a (512, N) band of the score
// plane in VMEM and accumulated partial dk/dv into revisited output blocks across
// a sequential grid. Blocks on this card run in no order, so the work is split
// in three launches, with no atomics, each output owned by one warp and every sum
// in a fixed order (the same bits from launch to launch):
//   1. delta_kernel: delta_i, one thread per query row, written as f32 into the
//      first 4 bytes of dq's row i (the dq buffer is scratch until launch 3);
//   2. dkdv_kernel: one block per (head, tile of 64 keys), 4 warps of 16 keys.
//      Each warp holds its keys' k and v as mma A fragments (split once) and its
//      dk, dv accumulators as C fragments. A loop over tiles of 64 queries brings
//      q, do, lse and delta into shared memory by cp.async (the next tile lands
//      while this one is used); each tile is split once into TF32 (hi, lo) pairs
//      that all four warps read (`prepare`). Per 8 queries: S^T = K Q^T and
//      dP^T = V dO^T, then p, the dropout mask and ds in registers (each C
//      element's query and key from the fragment map), then dV += P^T dO and
//      dK += dS^T Q with the C fragments as A operands (k relabelled,
//      mma_tf32.cuh: no shuffle, no shared memory);
//   3. dq_kernel: one block per (head, tile of 64 queries), 4 warps of 16 queries
//      holding q, do (A fragments), lse and delta (read from dq's rows before the
//      warp overwrites them); a loop over tiles of 64 keys (k, v the same way):
//      S = Q K^T, dP = dO V^T, ds, then dQ += dS K.
// p and dp are computed by both launches 2 and 3 (14 instead of 10 N*N*D flops
// per head). Keys and queries >= N are zero-filled in shared memory and their p
// set to 0; nothing is padded by the caller. Prepared rows are padded to D + 4
// elements, so every fragment read is free of bank conflicts.
//
// Launches 2 and 3 hold a warp's two operands as split A fragments (2 D
// registers a thread in f32) and its accumulators (D, or D / 2 for dq): at D =
// 64 that spills. So D = 64, 128 and 256 take a wide plan (attention_tiles.cuh)
// for launches 2 and 3, with the same three launches, the same ownership and
// the same fixed order of every sum:
//   - dkdv_wide_kernel: the block's 64 k and v rows stay raw in shared memory;
//     q, do, lse and delta come in tiles of 32 queries through a ring of two
//     stages (one where two do not fit: f32 at D = 256). Per tile, for each
//     k-step the warp loads its k and v A fragments (split as loaded) once and
//     runs S^T and dP^T for all 32 queries; then p, the mask and ds per 8
//     queries as launch 2, and dV += P^T dO, dK += dS^T Q on DKDV_WIDE_COLS =
//     64 columns of D: one pass over the query tiles per 64 columns, each
//     recomputing S^T and dP^T, so a thread holds 64 accumulator floats at any
//     D. Passes: 1 at D = 64, 2 at 128, 4 at 256 (S^T and dP^T then take 2.5x
//     the products of one pass).
//   - dq_wide_kernel: the block's 64 q and do rows stay raw; k and v in tiles
//     of 32 keys; dQ += dS K on DQ_WIDE_COLS = 128 columns a pass (2 passes
//     at D = 256). lse and delta are read into registers before the first
//     write to the warp's dq rows.
// What bounds them: shared memory, 2 x 64 (D + 4) x 4 bytes resident plus
// 2 x 32 (D + 4) x 4 a stage in f32, 199,936 bytes at D = 256 with one stage
// (one block an SM); in bf16 about half.
//
// Head dims above 256 take the deep plan of attention_bwd_deep.cu.
//
// The largest D of the narrow plan is ATTN_BWD_NARROW_MAX_D (32). A build may
// lower it with -D to run the wide plan at a narrow D: ab_attention_plans.py
// does, to time the two plans against each other at the same shape.
//
// The kernels take D = 8, 16, 32 (narrow) and 64, 128, 256 (wide); the wrapper
// zero-pads any other D up to 256 to the next of them (the padded columns add
// 0 to every product; the scale stays 1 / sqrt(D) of the true D). The block
// index runs over (head, tile) on gridDim.x in all three launches, so BH is not
// bound by gridDim.y's 65535.
//
// C interface: attention_bwd(...) returns cudaGetLastError() after the three
// launches (cudaErrorInvalidValue for a head dim or type it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "dropout_hash.cuh"
#include "mma_tf32.cuh"

#ifndef ATTN_BWD_NARROW_MAX_D
#define ATTN_BWD_NARROW_MAX_D 32
#endif

namespace {

using namespace attn;

// ROWS f32 scalars, the one of row r at src[r * stride], by cp.async; rows >= n are 0.
template <int ROWS = TILE>
__device__ __forceinline__ void stage_scalars(float* dst, const float* src, int stride,
                                              int r0, int n) {
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const bool in = r0 + r < n;
    tf32::cp_async4(dst + r, src + static_cast<size_t>(in ? r0 + r : 0) * stride, in);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
             int n) {
  const int blocks = (n + 255) / 256;  // a head's blocks of 256 rows
  const int bh = blockIdx.x / blocks;
  const int row = (blockIdx.x - bh * blocks) * 256 + threadIdx.x;
  if (row >= n) return;
  const size_t at = (static_cast<size_t>(bh) * n + row) * D;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = fmaf(to_f32(dout[at + d]), to_f32(o[at + d]), acc);
  *reinterpret_cast<float*>(dq + at) = acc;
}

// Dynamic shared memory of dkdv_kernel: two tiles (q, do), then lse and delta of
// two consecutive query tiles.
template <typename T, int D>
constexpr int dkdv_smem() { return 2 * Tile<T, D>::BYTES + 4 * TILE * 4; }

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const T* __restrict__ delta_rows, T* __restrict__ dk, T* __restrict__ dv,
            int n, float scale, const long long* __restrict__ seed_at, uint32_t thresh,
            float inv_keep, uint32_t bh0) {
  using TL = Tile<T, D>;
  using P = typename TL::P;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int KS = D / 8;                              // k-steps over D, n-tiles of D
  constexpr int DSTRIDE = D * static_cast<int>(sizeof(T)) / 4;  // floats per dq row
  extern __shared__ __align__(16) unsigned char smem[];
  P* qp = reinterpret_cast<P*>(smem);                    // prepared q rows
  P* dop = qp + TILE * TL::ROW;                          // prepared do rows
  T* qr = reinterpret_cast<T*>(dop + TILE * TL::ROW);    // raw q rows
  T* dor = qr + TILE * TL::RAW;                          // raw do rows
  float* lses = reinterpret_cast<float*>(dor + TILE * TL::RAW);  // [2][TILE]
  float* deltas = lses + 2 * TILE;                               // [2][TILE]

  const int tiles = (n + TILE - 1) / TILE;
  const int bh = blockIdx.x / tiles;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key0 = (blockIdx.x - bh * tiles) * TILE + (threadIdx.x >> 5) * 16;  // the warp's keys
  const size_t head = static_cast<size_t>(bh) * n * D;
  const float* lse_h = lse + static_cast<size_t>(bh) * n;
  const float* delta_h =
      reinterpret_cast<const float*>(delta_rows + head);  // row i at [i * DSTRIDE]

  uint32_t kh[KS][4], kl[KS][4], vh[KS][4], vl[KS][4];
  frag_a_global<T, D, kSplit>(k + head, key0, n, g, t, kh, kl);
  frag_a_global<T, D, kSplit>(v + head, key0, n, g, t, vh, vl);
  float dk_acc[KS][4], dv_acc[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[i][r] = dv_acc[i][r] = 0.f;
  }
  const uint32_t key_m2[2] = {static_cast<uint32_t>(key0 + g) * dropout_hash::M2,
                              static_cast<uint32_t>(key0 + g + 8) * dropout_hash::M2};
  const uint32_t bh_m3 = (bh0 + static_cast<uint32_t>(bh)) * dropout_hash::M3;
  const uint32_t seed = kDrop ? dropout_hash::load_seed(seed_at) : 0u;
  const float scale_log2 = scale * LOG2E;

  stage<T, D>(qr, q + head, 0, n);
  stage<T, D>(dor, dout + head, 0, n);
  stage_scalars(lses, lse_h, 1, 0, n);
  stage_scalars(deltas, delta_h, DSTRIDE, 0, n);
  tf32::cp_async_commit();

  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, q0 = it * TILE;
    tf32::cp_async_wait<0>();
    __syncthreads();  // the raw tile is here; every warp is done with the prepared one
    prepare<T, D>(qp, qr);
    prepare<T, D>(dop, dor);
    __syncthreads();
    if (it + 1 < tiles) {  // the next raw tile lands while this one is used
      stage<T, D>(qr, q + head, q0 + TILE, n);
      stage<T, D>(dor, dout + head, q0 + TILE, n);
      stage_scalars(lses + (buf ^ 1) * TILE, lse_h, 1, q0 + TILE, n);
      stage_scalars(deltas + (buf ^ 1) * TILE, delta_h, DSTRIDE, q0 + TILE, n);
      tf32::cp_async_commit();
    }
    const float* L = lses + buf * TILE;
    const float* DL = deltas + buf * TILE;

#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {  // 8 queries at a time
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bh_[2], bl_[2];
        frag_b_rows<D>(qp, nt * 8, kk * 8, g, t, bh_, bl_);
        tf32::mma3<kSplit>(s, kh[kk], kl[kk], bh_, bl_);
        frag_b_rows<D>(dop, nt * 8, kk * 8, g, t, bh_, bl_);
        tf32::mma3<kSplit>(dp, vh[kk], vl[kk], bh_, bl_);
      }
      // c0 (key g, query 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
      const int ql = nt * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(L + ql);
      const float2 d2 = *reinterpret_cast<const float2*>(DL + ql);
      float pd[4], ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qg = q0 + ql + (r & 1);
        const float l = (r & 1) ? l2.y : l2.x;
        const float delta = (r & 1) ? d2.y : d2.x;
        float p = exp2_ftz(fmaf(s[r], scale_log2, -l * LOG2E));
        p = qg < n ? p : 0.f;
        float dpv = dp[r], pdv = p;
        if (kDrop) {
          const bool keep = kept(static_cast<uint32_t>(qg) * dropout_hash::M1,
                                 key_m2[r >> 1], bh_m3, seed, thresh);
          pdv = keep ? p * inv_keep : 0.f;
          dpv = keep ? dpv * inv_keep : 0.f;
        }
        pd[r] = pdv;
        ds[r] = p * (dpv - delta);
      }
      uint32_t ph[4], pl[4], sh[4], sl[4];
      frag_a_from_c<kSplit>(pd, ph, pl);
      frag_a_from_c<kSplit>(ds, sh, sl);
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {  // 8 columns of dV and dK at a time
        uint32_t bh_[2], bl_[2];
        frag_b_cols<D>(dop, nt * 8, dt * 8, g, t, bh_, bl_);
        tf32::mma3<kSplit>(dv_acc[dt], ph, pl, bh_, bl_);
        frag_b_cols<D>(qp, nt * 8, dt * 8, g, t, bh_, bl_);
        tf32::mma3<kSplit>(dk_acc[dt], sh, sl, bh_, bl_);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + g + half * 8;
    if (key >= n) continue;
#pragma unroll
    for (int dt = 0; dt < KS; ++dt) {
      const size_t at = head + static_cast<size_t>(key) * D + dt * 8 + 2 * t;
      store2(dk + at, dk_acc[dt][2 * half] * scale, dk_acc[dt][2 * half + 1] * scale);
      store2(dv + at, dv_acc[dt][2 * half], dv_acc[dt][2 * half + 1]);
    }
  }
}

// Dynamic shared memory of dq_kernel: two tiles (k, v).
template <typename T, int D>
constexpr int dq_smem() { return 2 * Tile<T, D>::BYTES; }

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse, T* dq, int n,
          float scale, const long long* __restrict__ seed_at, uint32_t thresh,
          float inv_keep, uint32_t bh0) {
  using TL = Tile<T, D>;
  using P = typename TL::P;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int KS = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  P* kp = reinterpret_cast<P*>(smem);
  P* vp = kp + TILE * TL::ROW;
  T* kr = reinterpret_cast<T*>(vp + TILE * TL::ROW);
  T* vr = kr + TILE * TL::RAW;

  const int tiles = (n + TILE - 1) / TILE;
  const int bh = blockIdx.x / tiles;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x - bh * tiles) * TILE + (threadIdx.x >> 5) * 16;  // the warp's queries
  const size_t head = static_cast<size_t>(bh) * n * D;

  uint32_t qh[KS][4], ql[KS][4], oh[KS][4], ol[KS][4];
  frag_a_global<T, D, kSplit>(q + head, row0, n, g, t, qh, ql);
  frag_a_global<T, D, kSplit>(dout + head, row0, n, g, t, oh, ol);
  float lse2[2], delta[2];
  uint32_t row_m1[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + half * 8;
    const bool in = row < n;
    // delta_kernel left delta_i in dq's row i; this warp overwrites that row last
    lse2[half] = in ? lse[static_cast<size_t>(bh) * n + row] * LOG2E : 0.f;
    delta[half] = in ? *reinterpret_cast<const float*>(dq + head + static_cast<size_t>(row) * D)
                     : 0.f;
    row_m1[half] = static_cast<uint32_t>(row) * dropout_hash::M1;
  }
  float dq_acc[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) dq_acc[i][r] = 0.f;
  }
  const uint32_t bh_m3 = (bh0 + static_cast<uint32_t>(bh)) * dropout_hash::M3;
  const uint32_t seed = kDrop ? dropout_hash::load_seed(seed_at) : 0u;
  const float scale_log2 = scale * LOG2E;

  stage<T, D>(kr, k + head, 0, n);
  stage<T, D>(vr, v + head, 0, n);
  tf32::cp_async_commit();

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * TILE;
    tf32::cp_async_wait<0>();
    __syncthreads();
    prepare<T, D>(kp, kr);
    prepare<T, D>(vp, vr);
    __syncthreads();
    if (it + 1 < tiles) {
      stage<T, D>(kr, k + head, k0 + TILE, n);
      stage<T, D>(vr, v + head, k0 + TILE, n);
      tf32::cp_async_commit();
    }

#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {  // 8 keys at a time
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bh_[2], bl_[2];
        frag_b_rows<D>(kp, nt * 8, kk * 8, g, t, bh_, bl_);
        tf32::mma3<kSplit>(s, qh[kk], ql[kk], bh_, bl_);
        frag_b_rows<D>(vp, nt * 8, kk * 8, g, t, bh_, bl_);
        tf32::mma3<kSplit>(dp, oh[kk], ol[kk], bh_, bl_);
      }
      // c0 (query g, key 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = k0 + nt * 8 + 2 * t + (r & 1);
        float p = exp2_ftz(fmaf(s[r], scale_log2, -lse2[r >> 1]));
        p = key < n ? p : 0.f;
        float dpv = dp[r];
        if (kDrop) {
          const bool keep = kept(row_m1[r >> 1],
                                 static_cast<uint32_t>(key) * dropout_hash::M2, bh_m3,
                                 seed, thresh);
          dpv = keep ? dpv * inv_keep : 0.f;
        }
        ds[r] = p * (dpv - delta[r >> 1]);
      }
      uint32_t sh[4], sl[4];
      frag_a_from_c<kSplit>(ds, sh, sl);
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {  // 8 columns of dQ at a time
        uint32_t bh_[2], bl_[2];
        frag_b_cols<D>(kp, nt * 8, dt * 8, g, t, bh_, bl_);
        tf32::mma3<kSplit>(dq_acc[dt], sh, sl, bh_, bl_);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + half * 8;
    if (row >= n) continue;
#pragma unroll
    for (int dt = 0; dt < KS; ++dt) {
      store2(dq + head + static_cast<size_t>(row) * D + dt * 8 + 2 * t,
             dq_acc[dt][2 * half] * scale, dq_acc[dt][2 * half + 1] * scale);
    }
  }
}

// ---- the wide plan (D = 64, 128, 256) ----

constexpr int DKDV_WIDE_COLS = 64;  // dk and dv columns per pass over the query tiles
constexpr int DQ_WIDE_COLS = 128;   // dq columns per pass over the key tiles

// k and v resident; q, do streamed, with lse and delta of the stage's queries
template <typename T, int D>
using DkdvWide = WidePlan<T, D, 2, 2, 2 * WIDE_ROWS * 4>;
// q and do resident; k and v streamed
template <typename T, int D>
using DqWide = WidePlan<T, D, 2, 2>;

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(THREADS)
dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const T* __restrict__ delta_rows, T* __restrict__ dk, T* __restrict__ dv,
                 int n, float scale, const long long* __restrict__ seed_at, uint32_t thresh,
                 float inv_keep, uint32_t bh0) {
  using PL = DkdvWide<T, D>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int RAW = Tile<T, D>::RAW, ST = WIDE_ROWS, NS = PL::STAGES;
  constexpr int KS = D / 8, NT = ST / 8;
  constexpr int DC = D < DKDV_WIDE_COLS ? D : DKDV_WIDE_COLS, CT = DC / 8;
  static_assert(D % DC == 0, "passes must cover D");
  constexpr int DSTRIDE = D * static_cast<int>(sizeof(T)) / 4;  // floats per dq row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // the block's 64 k rows
  T* vs = ks + TILE * RAW;             // and its 64 v rows
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + TILE * RAW);
  // stage s at ring + s * STAGE_BYTES: ST q rows, ST do rows, ST lse, ST delta
  auto q_at = [&](int st) { return reinterpret_cast<T*>(ring + st * PL::STAGE_BYTES); };

  const int ktiles = (n + TILE - 1) / TILE;
  const int bh = blockIdx.x / ktiles;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = (blockIdx.x - bh * ktiles) * TILE, r0 = (threadIdx.x >> 5) * 16;
  const int key0 = k0 + r0;  // the warp's keys
  const size_t head = static_cast<size_t>(bh) * n * D;
  const float* lse_h = lse + static_cast<size_t>(bh) * n;
  const float* delta_h = reinterpret_cast<const float*>(delta_rows + head);
  const uint32_t key_m2[2] = {static_cast<uint32_t>(key0 + g) * dropout_hash::M2,
                              static_cast<uint32_t>(key0 + g + 8) * dropout_hash::M2};
  const uint32_t bh_m3 = (bh0 + static_cast<uint32_t>(bh)) * dropout_hash::M3;
  const uint32_t seed = kDrop ? dropout_hash::load_seed(seed_at) : 0u;
  const float scale_log2 = scale * LOG2E;
  const int qtiles = (n + ST - 1) / ST;

  auto stage_tile = [&](int it) {  // query tile it into its stage
    T* qst = q_at(it % NS);
    T* dost = qst + ST * RAW;
    float* L = reinterpret_cast<float*>(dost + ST * RAW);
    stage<T, D, ST>(qst, q + head, it * ST, n);
    stage<T, D, ST>(dost, dout + head, it * ST, n);
    stage_scalars<ST>(L, lse_h, 1, it * ST, n);
    stage_scalars<ST>(L + ST, delta_h, DSTRIDE, it * ST, n);
  };

  stage<T, D>(ks, k + head, k0, n);  // committed with the first query tile
  stage<T, D>(vs, v + head, k0, n);
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += DC) {  // one pass per DC columns of dk and dv
    float dk_acc[CT][4], dv_acc[CT][4];
#pragma unroll
    for (int i = 0; i < CT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) dk_acc[i][r] = dv_acc[i][r] = 0.f;
    }
#pragma unroll
    for (int st = 0; st + 1 < NS; ++st) {  // the ring's prologue
      if (st < qtiles) stage_tile(st);
      tf32::cp_async_commit();
    }
#pragma unroll 1
    for (int it = 0; it < qtiles; ++it) {
      if (it + NS - 1 < qtiles) stage_tile(it + NS - 1);
      tf32::cp_async_commit();
      tf32::cp_async_wait<NS - 1>();
      __syncthreads();  // tile it (and k, v) is here
      const T* qst = q_at(it % NS);
      const T* dost = qst + ST * RAW;
      const float* L = reinterpret_cast<const float*>(dost + ST * RAW);
      const float* DL = L + ST;
      const int q0 = it * ST;

      // S^T = K Q^T and dP^T = V dO^T for the tile's 32 queries, over all of D
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) s[nt][r] = dp[nt][r] = 0.f;
      }
#pragma unroll 2
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4];
        frag_a_raw<T, D, kSplit>(ks, r0, kk * 8, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh_[2], bl_[2];
          frag_b_rows_raw<T, D, kSplit>(qst, nt * 8, kk * 8, g, t, bh_, bl_);
          tf32::mma3<kSplit>(s[nt], ah, al, bh_, bl_);
        }
        frag_a_raw<T, D, kSplit>(vs, r0, kk * 8, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh_[2], bl_[2];
          frag_b_rows_raw<T, D, kSplit>(dost, nt * 8, kk * 8, g, t, bh_, bl_);
          tf32::mma3<kSplit>(dp[nt], ah, al, bh_, bl_);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {  // 8 queries at a time
        // c0 (key g, query 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
        const int ql = nt * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(L + ql);
        const float2 d2 = *reinterpret_cast<const float2*>(DL + ql);
        float pd[4], ds[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int qg = q0 + ql + (r & 1);
          const float l = (r & 1) ? l2.y : l2.x;
          const float delta = (r & 1) ? d2.y : d2.x;
          float p = exp2_ftz(fmaf(s[nt][r], scale_log2, -l * LOG2E));
          p = qg < n ? p : 0.f;
          float dpv = dp[nt][r], pdv = p;
          if (kDrop) {
            const bool keep = kept(static_cast<uint32_t>(qg) * dropout_hash::M1,
                                   key_m2[r >> 1], bh_m3, seed, thresh);
            pdv = keep ? p * inv_keep : 0.f;
            dpv = keep ? dpv * inv_keep : 0.f;
          }
          pd[r] = pdv;
          ds[r] = p * (dpv - delta);
        }
        uint32_t ph[4], pl[4], sh[4], sl[4];
        frag_a_from_c<kSplit>(pd, ph, pl);
        frag_a_from_c<kSplit>(ds, sh, sl);
#pragma unroll
        for (int dt = 0; dt < CT; ++dt) {  // 8 columns of dV and dK at a time
          uint32_t bh_[2], bl_[2];
          frag_b_cols_raw<T, D, kSplit>(dost, nt * 8, c0 + dt * 8, g, t, bh_, bl_);
          tf32::mma3<kSplit>(dv_acc[dt], ph, pl, bh_, bl_);
          frag_b_cols_raw<T, D, kSplit>(qst, nt * 8, c0 + dt * 8, g, t, bh_, bl_);
          tf32::mma3<kSplit>(dk_acc[dt], sh, sl, bh_, bl_);
        }
      }
      __syncthreads();  // every warp is done with this stage before it is staged again
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + g + half * 8;
      if (key >= n) continue;
#pragma unroll
      for (int dt = 0; dt < CT; ++dt) {
        const size_t at = head + static_cast<size_t>(key) * D + c0 + dt * 8 + 2 * t;
        store2(dk + at, dk_acc[dt][2 * half] * scale, dk_acc[dt][2 * half + 1] * scale);
        store2(dv + at, dv_acc[dt][2 * half], dv_acc[dt][2 * half + 1]);
      }
    }
  }
}

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(THREADS)
dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse, T* dq, int n,
               float scale, const long long* __restrict__ seed_at, uint32_t thresh,
               float inv_keep, uint32_t bh0) {
  using PL = DqWide<T, D>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int RAW = Tile<T, D>::RAW, ST = WIDE_ROWS, NS = PL::STAGES;
  constexpr int KS = D / 8, NT = ST / 8;
  constexpr int DC = D < DQ_WIDE_COLS ? D : DQ_WIDE_COLS, CT = DC / 8;
  static_assert(D % DC == 0, "passes must cover D");
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // the block's 64 q rows
  T* os = qs + TILE * RAW;             // and its 64 do rows
  T* ring = os + TILE * RAW;           // stage s: ST k rows, then ST v rows

  const int qtiles = (n + TILE - 1) / TILE;
  const int bh = blockIdx.x / qtiles;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = (blockIdx.x - bh * qtiles) * TILE, r0 = (threadIdx.x >> 5) * 16;
  const int row0 = q0 + r0;  // the warp's queries
  const size_t head = static_cast<size_t>(bh) * n * D;

  float lse2[2], delta[2];
  uint32_t row_m1[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + half * 8;
    const bool in = row < n;
    // delta_kernel left delta_i in dq's row i; this warp overwrites that row later
    lse2[half] = in ? lse[static_cast<size_t>(bh) * n + row] * LOG2E : 0.f;
    delta[half] = in ? *reinterpret_cast<const float*>(dq + head + static_cast<size_t>(row) * D)
                     : 0.f;
    row_m1[half] = static_cast<uint32_t>(row) * dropout_hash::M1;
  }
  const uint32_t bh_m3 = (bh0 + static_cast<uint32_t>(bh)) * dropout_hash::M3;
  const uint32_t seed = kDrop ? dropout_hash::load_seed(seed_at) : 0u;
  const float scale_log2 = scale * LOG2E;
  const int ktiles = (n + ST - 1) / ST;

  auto stage_tile = [&](int it) {  // key tile it into its stage
    T* kst = ring + (it % NS) * 2 * ST * RAW;
    stage<T, D, ST>(kst, k + head, it * ST, n);
    stage<T, D, ST>(kst + ST * RAW, v + head, it * ST, n);
  };

  stage<T, D>(qs, q + head, q0, n);  // committed with the first key tile
  stage<T, D>(os, dout + head, q0, n);
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += DC) {  // one pass per DC columns of dq
    float dq_acc[CT][4];
#pragma unroll
    for (int i = 0; i < CT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) dq_acc[i][r] = 0.f;
    }
#pragma unroll
    for (int st = 0; st + 1 < NS; ++st) {  // the ring's prologue
      if (st < ktiles) stage_tile(st);
      tf32::cp_async_commit();
    }
#pragma unroll 1
    for (int it = 0; it < ktiles; ++it) {
      if (it + NS - 1 < ktiles) stage_tile(it + NS - 1);
      tf32::cp_async_commit();
      tf32::cp_async_wait<NS - 1>();
      __syncthreads();  // tile it (and q, do) is here
      const T* kst = ring + (it % NS) * 2 * ST * RAW;
      const T* vst = kst + ST * RAW;
      const int k0 = it * ST;

      // S = Q K^T and dP = dO V^T for the tile's 32 keys, over all of D
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) s[nt][r] = dp[nt][r] = 0.f;
      }
#pragma unroll 2
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4];
        frag_a_raw<T, D, kSplit>(qs, r0, kk * 8, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh_[2], bl_[2];
          frag_b_rows_raw<T, D, kSplit>(kst, nt * 8, kk * 8, g, t, bh_, bl_);
          tf32::mma3<kSplit>(s[nt], ah, al, bh_, bl_);
        }
        frag_a_raw<T, D, kSplit>(os, r0, kk * 8, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh_[2], bl_[2];
          frag_b_rows_raw<T, D, kSplit>(vst, nt * 8, kk * 8, g, t, bh_, bl_);
          tf32::mma3<kSplit>(dp[nt], ah, al, bh_, bl_);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {  // 8 keys at a time
        // c0 (query g, key 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
        float ds[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = k0 + nt * 8 + 2 * t + (r & 1);
          float p = exp2_ftz(fmaf(s[nt][r], scale_log2, -lse2[r >> 1]));
          p = key < n ? p : 0.f;
          float dpv = dp[nt][r];
          if (kDrop) {
            const bool keep = kept(row_m1[r >> 1],
                                   static_cast<uint32_t>(key) * dropout_hash::M2, bh_m3,
                                   seed, thresh);
            dpv = keep ? dpv * inv_keep : 0.f;
          }
          ds[r] = p * (dpv - delta[r >> 1]);
        }
        uint32_t sh[4], sl[4];
        frag_a_from_c<kSplit>(ds, sh, sl);
#pragma unroll
        for (int dt = 0; dt < CT; ++dt) {  // 8 columns of dQ at a time
          uint32_t bh_[2], bl_[2];
          frag_b_cols_raw<T, D, kSplit>(kst, nt * 8, c0 + dt * 8, g, t, bh_, bl_);
          tf32::mma3<kSplit>(dq_acc[dt], sh, sl, bh_, bl_);
        }
      }
      __syncthreads();  // every warp is done with this stage before it is staged again
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + half * 8;
      if (row >= n) continue;
#pragma unroll
      for (int dt = 0; dt < CT; ++dt) {
        store2(dq + head + static_cast<size_t>(row) * D + c0 + dt * 8 + 2 * t,
               dq_acc[dt][2 * half] * scale, dq_acc[dt][2 * half + 1] * scale);
      }
    }
  }
}

template <typename T, int D, bool kDrop>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv,
                   int bh, int n, float scale, const long long* seed, uint32_t thresh,
                   float inv_keep, uint32_t bh0, cudaStream_t stream) {
  void (*dkdv)(const T*, const T*, const T*, const T*, const float*, const T*, T*, T*, int,
               float, const long long*, uint32_t, float, uint32_t);
  void (*dqk)(const T*, const T*, const T*, const T*, const float*, T*, int, float,
              const long long*, uint32_t, float, uint32_t);
  int dkdv_bytes, dq_bytes;  // dynamic shared memory of the chosen plan
  if constexpr (D > ATTN_BWD_NARROW_MAX_D) {
    dkdv = dkdv_wide_kernel<T, D, kDrop>;
    dqk = dq_wide_kernel<T, D, kDrop>;
    dkdv_bytes = DkdvWide<T, D>::BYTES;
    dq_bytes = DqWide<T, D>::BYTES;
  } else {
    dkdv = dkdv_kernel<T, D, kDrop>;
    dqk = dq_kernel<T, D, kDrop>;
    dkdv_bytes = dkdv_smem<T, D>();
    dq_bytes = dq_smem<T, D>();
  }
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((n + TILE - 1) / TILE) * bh;
  const long long delta_blocks = static_cast<long long>((n + 255) / 256) * bh;
  if (blocks > 0x7fffffffLL || delta_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks), 256, 0, stream>>>(
      static_cast<const T*>(o), gt, dqt, n);
  dkdv<<<static_cast<unsigned>(blocks), THREADS, dkdv_bytes, stream>>>(
      qt, kt, vt, gt, lse, dqt, static_cast<T*>(dk), static_cast<T*>(dv), n, scale, seed,
      thresh, inv_keep, bh0);
  dqk<<<static_cast<unsigned>(blocks), THREADS, dq_bytes, stream>>>(
      qt, kt, vt, gt, lse, dqt, n, scale, seed, thresh, inv_keep, bh0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, void* dq, void* dk,
                       void* dv, int bh, int n, int d, float scale, int dropout,
                       const long long* seed, uint32_t thresh, float inv_keep, uint32_t bh0,
                       cudaStream_t stream) {
#define ATTN_BWD_D(DIM)                                                               \
  case DIM:                                                                           \
    return dropout ? launch<T, DIM, true>(q, k, v, o, dout, lse, dq, dk, dv, bh, n,   \
                                          scale, seed, thresh, inv_keep, bh0, stream) \
                   : launch<T, DIM, false>(q, k, v, o, dout, lse, dq, dk, dv, bh, n,  \
                                           scale, seed, thresh, inv_keep, bh0, stream);
  switch (d) {
    ATTN_BWD_D(8)
    ATTN_BWD_D(16)
    ATTN_BWD_D(32)
    ATTN_BWD_D(64)
    ATTN_BWD_D(128)
    ATTN_BWD_D(256)
    default: return cudaErrorInvalidValue;
  }
#undef ATTN_BWD_D
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head dim d in {8, 16, 32, 64, 128, 256}
// (narrow plan up to 32, wide above). Shapes (bh, n, d) for
// q, k, v, o, dout, dq, dk, dv and (bh, n) for lse. dropout: 0 = off; else keep
// iff hash >= thresh, kept entries scaled by inv_keep (= 1 / (1 - rate)), the
// hash taken at head bh0 + bh with the seed in the low 32 bits of the int64 at
// `seed` (device memory; may be null with dropout off). Launches on `stream` and
// does not synchronise.
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const float* lse,
                             void* dq, void* dk, void* dv, int bh, int n, int d,
                             int dtype, float scale, int dropout, const long long* seed,
                             unsigned int thresh, float inv_keep, unsigned int bh0,
                             void* stream) {
  if (bh <= 0 || n <= 0 || (dropout && seed == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, dout, lse, dq, dk, dv, bh, n, d,
                                     scale, dropout, seed, thresh, inv_keep, bh0, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, bh,
                                             n, d, scale, dropout, seed, thresh,
                                             inv_keep, bh0, s);
    default: return cudaErrorInvalidValue;
  }
}
