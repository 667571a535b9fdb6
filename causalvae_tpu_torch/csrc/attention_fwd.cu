// Multi-head attention forward for Hopper (sm_90a): o = dropout(softmax(q k^T /
// sqrt(D))) v and the row logsumexp, for q, k, v of shape (BH, N, D), contiguous, f32
// or bf16.
//
// Replaces the Pallas TPU kernel _fwd_kernel (causalvae_tpu/ops/kernels/attention.py).
// Keys at index >= N are masked here, so the caller pads nothing (the TPU kernel
// needed N padded to a multiple of 128). Dropout (training) is applied after the
// softmax, as the JAX kernel and torch apply it: the normaliser l and the logsumexp
// come from the undropped probabilities, only the accumulation into o is masked, and
// o is divided by 1 - rate. The mask is the counter-based hash of dropout_hash.cuh,
// the same bits the backward kernels regenerate.
//
// What bounds it on this card: operations. 4 * N * N * D flops per head against
// 4 * N * D elements in and out. Both products run on the tensor cores as
// mma.sync m16n8k8 TF32 (mma_tf32.cuh): for f32 inputs split into 3xTF32, which
// keeps f32 accuracy; at (BH, N, D) = (64, 961, 32) that is 22.7 GFLOP of TF32
// work, ~0.046 ms at the card's 495 TFLOP/s. For bf16 inputs q, k and v are exact
// in TF32 and each product is one mma; p is rounded to TF32 (the JAX kernel rounds
// it to bf16) before P V. Beside the products, each score takes one exp2 and, with
// dropout, one hash: about as much work again as the products at rate 0.1.
//
// The TPU kernel held a head's whole K and V in VMEM and took the softmax in one
// pass; in f32 that is 240 KB at N = 961, more than a block's 227 KB of shared
// memory. So this kernel runs an online softmax over tiles of keys, in the layout
// of the backward's dq_kernel (attention_tiles.cuh):
//   - one block per (head, tile of 64 queries), 4 warps of 16 queries; each warp
//     holds its q rows as split A fragments and its o accumulator as D / 8 C
//     fragments in registers;
//   - a loop over tiles of 64 keys: K and V are staged raw by cp.async (the next
//     tile lands while this one is used) and split once per block into TF32
//     (hi, lo) rows that all four warps read;
//   - per tile, S = Q K^T for all 64 keys (8 C fragments a warp), scaled into the
//     log2 domain; keys >= N are set to -inf before the row max, so a zero-filled
//     key never becomes the max. A lane holds rows g and g + 8: their maxima are
//     taken over its own values, then across the quad of lanes that share the
//     rows (__shfl_xor_sync over 1 and 2). The running max m and the lane's
//     partial sum l are rescaled by exp2(m_old - m_new), the o fragments with
//     them; p = exp2(s - m_new) is added to l undropped, masked by the hash at
//     each C element's (query, key; the tile's 32 keep bits a lane are hashed
//     before S, so the integer work overlaps the products), and Pa V takes p
//     from the C fragments as A fragments (k relabelled, no shuffle) and V's
//     prepared rows as B. It is summed over the tile in a fresh C fragment and
//     added to o's in f32: the tensor cores' adds round less exactly than f32's,
//     and summed over all 961 keys there, o's f32 error at (64, 961, 32) was
//     4.9e-6 against 9.2e-7 this way (chip_smoke.py, H100 80GB HBM3, 700 W);
//   - after the last tile l is summed across the quad; o = acc / l (/ (1 - rate)
//     with dropout), lse = (m + log2 l) ln 2 in f32 (natural log, as the backward
//     reads it); rows >= N write nothing.
// No atomics and every sum in a fixed order: two launches give the same bits.
//
// That plan holds a warp's q rows (split: D registers a thread in f32) and its o
// accumulator (D / 2) in registers, and a block's K and V tiles raw and prepared
// (1536 (D + 4) bytes in f32): at D = 128 the registers spill, and at D = 256
// the tiles would take 399 KB. So D = 128 and 256 take a wide plan
// (attention_fwd_wide_kernel, attention_tiles.cuh):
//   - the block's 64 q rows stay raw in shared memory and each warp loads its A
//     fragments from them, split as they are loaded, for every k-step;
//   - K and V come in tiles of 32 keys, raw, through a ring of two stages (the
//     next tile lands by cp.async while this one is used); B fragments are read
//     from the raw rows and split as they are loaded;
//   - o's accumulator covers FWD_WIDE_COLS = 128 columns of D: one pass over the
//     key tiles per 128 columns, each recomputing S and the online softmax (the
//     same bits every pass), so a thread holds 64 accumulator floats and 64 for
//     the tile's P V at any D. At D = 256 the second pass repeats Q K^T: 1.5x
//     the products of one pass.
// What bounds it: 64 (D + 4) x 4 + 2 x 2 x 32 (D + 4) x 4 bytes of shared
// memory, 199,680 at D = 256 in f32 (one block an SM), 101,376 at D = 128;
// in bf16 half of that. Scores, masking, dropout and the writes are the
// narrow plan's.
//
// Head dims above 256 take the deep plan of attention_fwd_deep.cu. In bf16,
// D = 128 and 256 run attention_fwd_large.cu instead (bf16 tensor-core products,
// the head dim split over a cluster; faster at every timed shape): this entry
// refuses them, and the wide plan serves f32 (and, in a build with a lowered
// ATTN_FWD_NARROW_MAX_D, bf16 at D 32 and 64).
//
// The largest D of the narrow plan is ATTN_FWD_NARROW_MAX_D (64). A build may
// lower it with -D to run the wide plan at a narrow D: ab_attention_plans.py
// does, to time the two plans against each other at the same shape.
//
// The kernels take D = 8, 16, 32, 64 (narrow) and 128, 256 (wide); the wrapper
// (ops/kernels/attention.py) zero-pads any other D up to 256 to the next of
// them, as the JAX wrapper pads D to a multiple of 8: the padded columns add 0
// to every score and give o columns it drops, and the scale stays 1 / sqrt(D)
// of the true D (an argument). The block index runs over (head, tile of 64
// queries) on gridDim.x, so BH is not bound by gridDim.y's 65535.
//
// C interface: attention_fwd(...) returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head dim or type it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "dropout_hash.cuh"
#include "mma_tf32.cuh"

#ifndef ATTN_FWD_NARROW_MAX_D
#define ATTN_FWD_NARROW_MAX_D 64
#endif

namespace {

using namespace attn;

constexpr float LN2 = 0.6931471805599453f;

// Reductions over the quad of lanes (g, 0..3) that hold the same two rows.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int n, float scale,
                     const long long* __restrict__ seed_at, uint32_t thresh,
                     float keep_prob, uint32_t bh0) {
  using TL = Tile<T, D>;
  using P = typename TL::P;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int KS = D / 8;     // k-steps of Q K^T, n-tiles of O
  constexpr int NT = TILE / 8;  // n-tiles of S, k-steps of P V
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

  uint32_t qh[KS][4], ql[KS][4];
  frag_a_global<T, D, kSplit>(q + head, row0, n, g, t, qh, ql);
  float acc[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
  }
  // per row half (g, g + 8): running max (log2 domain), the lane's partial sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t row_m1[2] = {static_cast<uint32_t>(row0 + g) * dropout_hash::M1,
                              static_cast<uint32_t>(row0 + g + 8) * dropout_hash::M1};
  const uint32_t bh_m3 = (bh0 + static_cast<uint32_t>(bh)) * dropout_hash::M3;
  const uint32_t seed = kDrop ? dropout_hash::load_seed(seed_at) : 0u;
  const float scale_log2 = scale * LOG2E;

  stage<T, D>(kr, k + head, 0, n);
  stage<T, D>(vr, v + head, 0, n);
  tf32::cp_async_commit();

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * TILE;
    tf32::cp_async_wait<0>();
    __syncthreads();  // the raw tile is here; every warp is done with the prepared one
    prepare<T, D>(kp, kr);
    prepare<T, D>(vp, vr);
    __syncthreads();
    if (it + 1 < tiles) {  // the next raw tile lands while this one is used
      stage<T, D>(kr, k + head, k0 + TILE, n);
      stage<T, D>(vr, v + head, k0 + TILE, n);
      tf32::cp_async_commit();
    }

    // The tile's keep bits (bit nt * 4 + r for C element r of n-tile nt), hashed
    // before the products so that the integer work can overlap them.
    uint32_t keep_bits = 0u;
    if (kDrop) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = k0 + nt * 8 + 2 * t + (r & 1);
          keep_bits |= static_cast<uint32_t>(kept(row_m1[r >> 1],
              static_cast<uint32_t>(key) * dropout_hash::M2, bh_m3, seed, thresh))
              << (nt * 4 + r);
        }
      }
    }
    // S = Q K^T; c0 (query g, key 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bh_[2], bl_[2];
        frag_b_rows<D>(kp, nt * 8, kk * 8, g, t, bh_, bl_);
        tf32::mma3<kSplit>(s[nt], qh[kk], ql[kk], bh_, bl_);
      }
    }
    // log2 domain; keys >= n (zero-filled, raw score 0) to -inf before the max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = k0 + nt * 8 + 2 * t + (r & 1);
        s[nt][r] = key < n ? s[nt][r] * scale_log2 : -INFINITY;
        mx[r >> 1] = fmaxf(mx[r >> 1], s[nt][r]);
      }
    }
    // Every tile holds a key < n, so the new max is finite; on the first tile
    // m = -inf and alpha = 0.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m_new = quad_max(mx[half]);
      const float alpha = exp2_ftz(m[half] - m_new);
      m[half] = m_new;
      l[half] *= alpha;
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        acc[dt][2 * half] *= alpha;
        acc[dt][2 * half + 1] *= alpha;
      }
    }

    // PV = Pa V for this tile, 8 keys (one k-step) at a time, then O += PV in f32
    float pv[KS][4];
#pragma unroll
    for (int i = 0; i < KS; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[i][r] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[r] = exp2_ftz(s[nt][r] - m[r >> 1]);  // 0 for masked keys
        l[r >> 1] += p[r];
        if (kDrop) p[r] = (keep_bits >> (nt * 4 + r)) & 1u ? p[r] : 0.f;
      }
      uint32_t ph[4], pl[4];
      frag_a_from_c<kSplit>(p, ph, pl);
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {  // 8 columns of PV at a time
        uint32_t bh_[2], bl_[2];
        frag_b_cols<D>(vp, nt * 8, dt * 8, g, t, bh_, bl_);
        tf32::mma3<kSplit>(pv[dt], ph, pl, bh_, bl_);
      }
    }
#pragma unroll
    for (int i = 0; i < KS; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][r] += pv[i][r];
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float lsum = quad_sum(l[half]);  // every lane of the quad: the same bits
    const int row = row0 + g + half * 8;
    if (row >= n) continue;
    const float inv = 1.f / (kDrop ? lsum * keep_prob : lsum);
#pragma unroll
    for (int dt = 0; dt < KS; ++dt) {
      store2(o + head + static_cast<size_t>(row) * D + dt * 8 + 2 * t,
             acc[dt][2 * half] * inv, acc[dt][2 * half + 1] * inv);
    }
    if (t == 0) lse[static_cast<size_t>(bh) * n + row] = (m[half] + log2f(lsum)) * LN2;
  }
}

// ---- the wide plan (D = 128, 256) ----

constexpr int FWD_WIDE_COLS = 128;  // o columns per pass over the key tiles

template <typename T, int D>
using FwdWide = WidePlan<T, D, 1, 2>;  // q resident; k and v streamed

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(THREADS)
attention_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse, int n, float scale,
                          const long long* __restrict__ seed_at, uint32_t thresh,
                          float keep_prob, uint32_t bh0) {
  using PL = FwdWide<T, D>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int RAW = Tile<T, D>::RAW, ST = WIDE_ROWS, NS = PL::STAGES;
  constexpr int KS = D / 8;                        // k-steps of Q K^T
  constexpr int NT = ST / 8;                       // n-tiles of S, k-steps of P V
  constexpr int DC = D < FWD_WIDE_COLS ? D : FWD_WIDE_COLS;
  constexpr int CT = DC / 8;                       // n-tiles of a pass's o columns
  static_assert(D % DC == 0, "passes must cover D");
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);              // the block's 64 q rows
  T* ring = qs + TILE * RAW;                       // stage s: ST k rows, then ST v rows

  const int qtiles = (n + TILE - 1) / TILE;
  const int bh = blockIdx.x / qtiles;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = (blockIdx.x - bh * qtiles) * TILE, r0 = (threadIdx.x >> 5) * 16;
  const int row0 = q0 + r0;                        // the warp's queries
  const size_t head = static_cast<size_t>(bh) * n * D;
  const uint32_t row_m1[2] = {static_cast<uint32_t>(row0 + g) * dropout_hash::M1,
                              static_cast<uint32_t>(row0 + g + 8) * dropout_hash::M1};
  const uint32_t bh_m3 = (bh0 + static_cast<uint32_t>(bh)) * dropout_hash::M3;
  const uint32_t seed = kDrop ? dropout_hash::load_seed(seed_at) : 0u;
  const float scale_log2 = scale * LOG2E;
  const int ktiles = (n + ST - 1) / ST;

  stage<T, D>(qs, q + head, q0, n);  // committed with the first key tile
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += DC) {  // one pass per DC columns of o
    float acc[CT][4];
#pragma unroll
    for (int i = 0; i < CT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int s = 0; s + 1 < NS; ++s) {  // the ring's prologue
      if (s < ktiles) {
        T* st = ring + s * 2 * ST * RAW;
        stage<T, D, ST>(st, k + head, s * ST, n);
        stage<T, D, ST>(st + ST * RAW, v + head, s * ST, n);
      }
      tf32::cp_async_commit();
    }
#pragma unroll 1
    for (int it = 0; it < ktiles; ++it) {
      const int nx = it + NS - 1;  // the tile that lands while this one is used
      if (nx < ktiles) {
        T* st = ring + (nx % NS) * 2 * ST * RAW;
        stage<T, D, ST>(st, k + head, nx * ST, n);
        stage<T, D, ST>(st + ST * RAW, v + head, nx * ST, n);
      }
      tf32::cp_async_commit();
      tf32::cp_async_wait<NS - 1>();
      __syncthreads();  // tile it (and q) is here
      const T* ks = ring + (it % NS) * 2 * ST * RAW;
      const T* vs = ks + ST * RAW;
      const int k0 = it * ST;

      // S = Q K^T over all of D; c0 (query g, key 2t) ... as the narrow plan
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
      }
#pragma unroll 4
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4];
        frag_a_raw<T, D, kSplit>(qs, r0, kk * 8, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh_[2], bl_[2];
          frag_b_rows_raw<T, D, kSplit>(ks, nt * 8, kk * 8, g, t, bh_, bl_);
          tf32::mma3<kSplit>(s[nt], ah, al, bh_, bl_);
        }
      }
      // log2 domain; keys >= n to -inf before the max (k0 < n: the max is finite)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = k0 + nt * 8 + 2 * t + (r & 1);
          s[nt][r] = key < n ? s[nt][r] * scale_log2 : -INFINITY;
          mx[r >> 1] = fmaxf(mx[r >> 1], s[nt][r]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float m_new = quad_max(mx[half]);
        const float alpha = exp2_ftz(m[half] - m_new);
        m[half] = m_new;
        l[half] *= alpha;
#pragma unroll
        for (int dt = 0; dt < CT; ++dt) {
          acc[dt][2 * half] *= alpha;
          acc[dt][2 * half + 1] *= alpha;
        }
      }
      // PV = Pa V[:, c0:c0 + DC] for this tile, then O += PV in f32
      float pv[CT][4];
#pragma unroll
      for (int i = 0; i < CT; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) pv[i][r] = 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float p[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          p[r] = exp2_ftz(s[nt][r] - m[r >> 1]);  // 0 for masked keys
          l[r >> 1] += p[r];
          if (kDrop) {
            const int key = k0 + nt * 8 + 2 * t + (r & 1);
            p[r] = kept(row_m1[r >> 1], static_cast<uint32_t>(key) * dropout_hash::M2,
                        bh_m3, seed, thresh) ? p[r] : 0.f;
          }
        }
        uint32_t ph[4], pl[4];
        frag_a_from_c<kSplit>(p, ph, pl);
#pragma unroll
        for (int dt = 0; dt < CT; ++dt) {
          uint32_t bh_[2], bl_[2];
          frag_b_cols_raw<T, D, kSplit>(vs, nt * 8, c0 + dt * 8, g, t, bh_, bl_);
          tf32::mma3<kSplit>(pv[dt], ph, pl, bh_, bl_);
        }
      }
#pragma unroll
      for (int i = 0; i < CT; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][r] += pv[i][r];
      }
      __syncthreads();  // every warp is done with this stage before it is staged again
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float lsum = quad_sum(l[half]);
      const int row = row0 + g + half * 8;
      if (row >= n) continue;
      const float inv = 1.f / (kDrop ? lsum * keep_prob : lsum);
#pragma unroll
      for (int dt = 0; dt < CT; ++dt) {
        store2(o + head + static_cast<size_t>(row) * D + c0 + dt * 8 + 2 * t,
               acc[dt][2 * half] * inv, acc[dt][2 * half + 1] * inv);
      }
      if (t == 0 && c0 == 0)
        lse[static_cast<size_t>(bh) * n + row] = (m[half] + log2f(lsum)) * LN2;
    }
  }
}

template <typename T, int D, bool kDrop>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int bh, int n, float scale, const long long* seed, uint32_t thresh,
                   float keep_prob, uint32_t bh0, cudaStream_t stream) {
  if constexpr (D >= 128 && !std::is_same<T, float>::value) {
    return cudaErrorInvalidValue;  // bf16 from D = 128 on: attention_fwd_large.cu
  } else {
    void (*kernel)(const T*, const T*, const T*, T*, float*, int, float, const long long*,
                   uint32_t, float, uint32_t);
    int bytes;  // dynamic shared memory: the narrow plan's k and v tiles, or the wide plan's
    if constexpr (D > ATTN_FWD_NARROW_MAX_D) {
      kernel = attention_fwd_wide_kernel<T, D, kDrop>;
      bytes = FwdWide<T, D>::BYTES;
    } else {
      kernel = attention_fwd_kernel<T, D, kDrop>;
      bytes = 2 * Tile<T, D>::BYTES;
    }
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const long long blocks = static_cast<long long>((n + TILE - 1) / TILE) * bh;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, n, scale, seed, thresh, keep_prob, bh0);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int n, int d, float scale, int dropout,
                       const long long* seed, uint32_t thresh, float keep_prob, uint32_t bh0,
                       cudaStream_t stream) {
#define ATTN_FWD_D(DIM)                                                             \
  case DIM:                                                                         \
    return dropout ? launch<T, DIM, true>(q, k, v, o, lse, bh, n, scale, seed,      \
                                          thresh, keep_prob, bh0, stream)           \
                   : launch<T, DIM, false>(q, k, v, o, lse, bh, n, scale, seed,     \
                                           thresh, keep_prob, bh0, stream);
  switch (d) {
    ATTN_FWD_D(8)
    ATTN_FWD_D(16)
    ATTN_FWD_D(32)
    ATTN_FWD_D(64)
    ATTN_FWD_D(128)
    ATTN_FWD_D(256)
    default: return cudaErrorInvalidValue;
  }
#undef ATTN_FWD_D
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head dim d in {8, 16, 32, 64, 128, 256}
// (bfloat16 up to 64: attention_fwd_large.cu takes it from 128 on).
// Shapes (bh, n, d) for q, k, v and o, (bh, n) for lse. dropout: 0 = off; else keep iff hash >= thresh, and o /= keep_prob
// (= 1 - rate), the hash taken at head bh0 + bh (bh0: the first head of this
// batch in a larger one) with the seed in the low 32 bits of the int64 at `seed`
// (device memory; may be null with dropout off). Launches on `stream` and does not
// synchronise.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int bh, int n, int d,
                             int dtype, float scale, int dropout, const long long* seed,
                             unsigned int thresh, float keep_prob, unsigned int bh0,
                             void* stream) {
  if (bh <= 0 || n <= 0 || (dropout && seed == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, lse, bh, n, d, scale, dropout, seed,
                                     thresh, keep_prob, bh0, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, n, d, scale,
                                             dropout, seed, thresh, keep_prob, bh0, s);
    default: return cudaErrorInvalidValue;
  }
}
