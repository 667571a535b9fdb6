// Multi-head attention forward for Hopper (sm_90a) at padded head dims 128 ...
// 1344: o = dropout(softmax(q k^T * scale)) v and the row logsumexp in natural
// log, for q, k, v of shape (BH, N, D), contiguous, f32 or bf16. The contract of
// attention_fwd.cu's narrow plan: keys >= N masked here; dropout after the softmax
// (l and lse from the undropped p), by the hash of dropout_hash.cuh at head
// bh0 + bh, the seed read from device memory; rows >= N write nothing; no atomics
// and every sum in a fixed order, so two launches give the same bits.
//
// Replaces the Pallas TPU kernel _fwd_kernel (causalvae_tpu/ops/kernels/
// attention.py) at head dims 128 and above, in place of the earlier wide plan
// (D 128, 256: two passes over the keys at D 256, each recomputing S) and deep
// plan (D 320 ... 1344: o's accumulator in shared memory, 32 or 16 queries a
// block, every operand split into TF32 as each warp loaded it).
//
// What bounds it: operations, 4 N^2 D a head against 4 N D elements in and out;
// at (8, 961, 512) 15.1 GFLOP, 0.0153 ms in bf16 at 989 TFLOP/s and 0.0917 ms as
// 3xTF32 at 495 (the bytes take 0.019 ms in f32 at 3.35 TB/s). The design:
//   - The head dim is split over a thread-block cluster. A cluster of
//     C = ceil(D / DC) CTAs (at most 8, the portable size) owns one tile of 64
//     queries; CTA r owns columns [r DC, min((r + 1) DC, D)) of q, k, v and o
//     (the last slice may be narrower, a multiple of 64). DC is 128, or 192 above
//     D = 1024 so that C stays at most 7. A CTA's o slice lives in registers:
//     4 warps of 16 queries, DC / 2 f32 a thread.
//   - Per tile of KT keys each CTA computes its partial S = q k^T over its
//     columns and offers it to the cluster: it writes the partial to its
//     shared memory in fragment order and arrives at a cluster barrier. While
//     the partials cross, it multiplies the previous tile's P by its v
//     (barrier.cluster.arrive and .wait split around that work), then waits
//     and sums the C partials over distributed shared memory in the order
//     0 ... C-1. So every CTA holds the same bits of S, and so the same
//     running max, sum and dropout mask; each then takes the online softmax
//     and keeps P for the next tile's wait. Q K^T and P V each run once (the
//     necessary products), and the grid is C times the number of tiles.
//     Up to C = 2 every CTA gathers every partial (C x KT / 8 16-byte pieces
//     a thread, one barrier a tile; the partial tiles double-buffered, since
//     a CTA writes one again only after every CTA has passed the next tile's
//     barrier, which it reaches after reading it). From C = 3 on the sum is a
//     reduce-scatter and a gather (2 x KT / 8 pieces a thread whatever C is,
//     two barriers a tile, P V split between them; one buffer each, written
//     again only after the barrier that follows their reading): CTA r sums a
//     block of whole warps' pieces, so that the gather reads each warp's
//     pieces from one CTA. Both give the same bits; ab_attention_fwd_large.py
//     times each alone against this choice.
//   - bf16: both products are mma.sync m16n8k16 bf16 with f32 accumulators. q,
//     k and v stay raw in shared memory, rows of DC values whose 16-byte chunks
//     are XOR-swizzled by the row (chunk c of row r at c ^ (r & 7)), filled by
//     cp.async and read by ldmatrix (k as B of Q K^T, v transposed by
//     ldmatrix.trans as B of P V): no per-element conversion, no bank conflict.
//     P is rounded to bf16 before P V, as the JAX kernel does
//     (p.astype(v.dtype)); l sums the f32 p. Two adjacent n8 C fragments of S
//     are one k16 A fragment of P: no shuffle. k and v come through rings of
//     two stages each, v a tile behind k: k of tile it + 1 and v of tile it
//     land while tile it's S and tile it - 1's P V are computed.
//   - f32: 3xTF32 (mma.sync m16n8k8, mma_tf32.cuh), hi/lo pairs prepared once
//     a block: q split once into a shared plane as it is loaded; each k and v
//     tile staged raw by cp.async, then split once into (hi, lo) planes that
//     all four warps read (v transposed, so that a B fragment's two keys are
//     adjacent); the next raw tiles land while this one is multiplied. The k
//     index of both products is relabelled (slot t holds column or key 2t,
//     slot t + 4 column 2t + 1, as mma_tf32.cuh relabels a C fragment), so a
//     fragment's two (hi, lo) pairs are one 16-byte load; rows padded to
//     16 mod 32 words keep those loads free of bank conflicts.
//   - P V is summed a tile at a time, 64 columns at a time, in a fresh C
//     fragment that is then added to o's accumulator in f32 (the tensor cores'
//     adds round less exactly than f32's over 961 keys).
//
// The wrapper (ops/kernels/attention.py) runs this kernel for bf16 and keeps the
// wide and deep plans for f32, where they were faster at the timed shapes (the
// f32 path's split planes hold a CTA alone on an SM, and splitting k and v takes
// a third of its time at D = 128; PERF.md). It zero-pads D to 128, 256 or the
// next multiple of 64 (KERNEL_HEAD_DIMS, DEEP_CHUNK); the scale stays 1 / sqrt(D)
// of the true D. A cluster that cannot be scheduled makes the launch fail with its
// error, which is returned (the wrapper raises): there is no other plan.
//
// C interface: attention_fwd_large(...) takes attention_fwd's arguments and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// dim or type it does not take).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "dropout_hash.cuh"
#include "mma_tf32.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace attn;

constexpr float LN2 = 0.6931471805599453f;
constexpr int BM = 64;          // queries a cluster (16 a warp)
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int LARGE_MIN_D = 128;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- bf16 operands: swizzled raw tiles, ldmatrix, mma m16n8k16 ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// C (16x8, f32) += A (16x16, bf16) B (16x8, bf16). Lane (g, t): a0 = A[g][2t, 2t+1],
// a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9];
// b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]; C as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of rows of `chunks`
// chunks (chunks a multiple of 8).
__device__ __forceinline__ int swz(int r, int c, int chunks) {
  return (r * chunks + (c ^ (r & 7))) * 16;
}

// Rows [r0, r0 + rows) and columns [c0, c0 + w) of a row-major (n, d) bf16 matrix
// into a swizzled tile of DC columns by cp.async (the caller commits); rows >= n
// are zeros.
template <int DC>
__device__ __forceinline__ void stage_swz(unsigned char* dst, const __nv_bfloat16* src,
                                          int d, int r0, int rows, int c0, int w, int n) {
  constexpr int CH = DC / 8;
  const int ch = w / 8;
  for (int i = threadIdx.x; i < rows * ch; i += THREADS) {
    const int r = i / ch, c = i - r * ch;
    const bool in = r0 + r < n;
    tf32::cp_async16(dst + swz(r, c, CH),
                     src + static_cast<size_t>(in ? r0 + r : 0) * d + c0 + c * 8, in);
  }
}

// ---- f32 operands: (hi, lo) TF32 planes prepared once a block ----

__device__ __forceinline__ uint4 split2(float a, float b) {
  uint4 e;
  tf32::split<true>(a, e.x, e.y);
  tf32::split<true>(b, e.z, e.w);
  return e;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void add4(float4& a, const float4& x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

// From this cluster size on, the partial tiles are summed by a reduce-scatter
// and a gather (two barriers, 2 x KT / 8 pieces read a thread); below it every
// CTA gathers every partial (one barrier, C x KT / 8 pieces).
constexpr int SCATTER_MIN_CLUSTER = 3;

// Shared memory of one CTA.
template <typename T, int DC, int KT>
struct LargePlan {
  static constexpr bool F32 = std::is_same<T, float>::value;
  // f32: q plane 64 x (DC + 8) uint2, k plane KT x (DC + 8) uint2, v plane
  // transposed DC x (KT + 8) uint2, one raw tile of k and one of v (rows of
  // DC + 4 f32).
  static constexpr int QROW = DC + 8, VROW = KT + 8, RAW = DC + 4;
  // bf16: swizzled q (64 rows), two ring stages of k and two of v (KT rows each).
  static constexpr int OPS_BYTES =
      F32 ? (BM * QROW + KT * QROW + DC * VROW) * 8 + 2 * KT * RAW * 4
          : (BM + 4 * KT) * DC * 2;
  // two partial S tiles (or a partial tile and the sums), in fragment order
  static constexpr int PART_BYTES = 2 * BM * KT * 4;
  static int bytes(bool cluster) { return OPS_BYTES + (cluster ? PART_BYTES : 0); }
};

template <typename T, int DC, int KT, bool kDrop>
__global__ void __launch_bounds__(THREADS)
attention_fwd_large_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int n, int d, float scale,
                           const long long* __restrict__ seed_at, uint32_t thresh,
                           float keep_prob, uint32_t bh0) {
  using PL = LargePlan<T, DC, KT>;
  constexpr bool F32 = PL::F32;
  constexpr int NT = KT / 8;         // n-tiles of S a warp
  constexpr int NCH = DC / 64;       // 64-column chunks of the slice
  constexpr int CH = DC / 8;         // 16-byte chunks of a bf16 row
  constexpr int PIECES = NT * THREADS;  // float4 pieces of a partial S tile
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const bool scatter = csize >= SCATTER_MIN_CLUSTER;
  // the reduce-scatter's share of a CTA: whole warps' pieces, so that a gather is coalesced
  const int share = ((PIECES + csize - 1) / csize + 31) & ~31;

  const int qtiles = (n + BM - 1) / BM;
  const int tile = blockIdx.x / csize;
  const int bh = tile / qtiles;
  const int q0 = (tile - bh * qtiles) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;  // the warp's rows in the tile
  const int col0 = rank * DC;
  const int width = min(DC, d - col0);  // a multiple of 64
  const int nch = width / 64;
  const size_t head = static_cast<size_t>(bh) * n * d;
  const int ktiles = (n + KT - 1) / KT;

  const uint32_t row_m1[2] = {static_cast<uint32_t>(q0 + r0 + g) * dropout_hash::M1,
                              static_cast<uint32_t>(q0 + r0 + g + 8) * dropout_hash::M1};
  const uint32_t bh_m3 = (bh0 + static_cast<uint32_t>(bh)) * dropout_hash::M3;
  const uint32_t seed = kDrop ? dropout_hash::load_seed(seed_at) : 0u;
  const float scale_log2 = scale * LOG2E;

  // shared memory
  uint2* qp = reinterpret_cast<uint2*>(smem);              // f32 planes
  uint2* kp = qp + BM * PL::QROW;
  uint2* vt = kp + KT * PL::QROW;
  float* rawk = reinterpret_cast<float*>(vt + DC * PL::VROW);
  float* rawv = rawk + KT * PL::RAW;
  unsigned char* qs = smem;                                // bf16 tiles
  unsigned char* kring = smem + BM * DC * 2;               // two stages of k
  unsigned char* vring = kring + 2 * KT * DC * 2;          // two stages of v
  float4* part = reinterpret_cast<float4*>(smem + PL::OPS_BYTES);

  // key tile `it` of k or of v into its raw tile (f32) or ring stage (bf16)
  auto stage_k = [&](int it) {
    if constexpr (F32)
      stage_cols<float>(rawk, PL::RAW, k + head, d, it * KT, KT, col0, width, n);
    else
      stage_swz<DC>(kring + (it & 1) * KT * DC * 2, k + head, d, it * KT, KT, col0, width, n);
  };
  auto stage_v = [&](int it) {
    if constexpr (F32)
      stage_cols<float>(rawv, PL::RAW, v + head, d, it * KT, KT, col0, width, n);
    else
      stage_swz<DC>(vring + (it & 1) * KT * DC * 2, v + head, d, it * KT, KT, col0, width, n);
  };

  // q: f32 split once into its plane; bf16 staged raw (committed with k's tile 0)
  if constexpr (F32) {
    const int c4 = width / 4;
    for (int i = threadIdx.x; i < BM * c4; i += THREADS) {
      const int r = i / c4, c = (i - r * c4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < n)
        x = *reinterpret_cast<const float4*>(q + head + static_cast<size_t>(q0 + r) * d +
                                             col0 + c);
      uint4* dst = reinterpret_cast<uint4*>(qp + r * PL::QROW + c);
      dst[0] = split2(x.x, x.y);
      dst[1] = split2(x.z, x.w);
    }
  } else {
    stage_swz<DC>(qs, q + head, d, q0, BM, col0, width, n);
  }
  // one commit group each for k's and v's tiles, in the order k0, v0, k1, v1, ...
  stage_k(0);
  tf32::cp_async_commit();
  stage_v(0);
  tf32::cp_async_commit();

  float acc[NCH * 8][4];  // o: 8 n-tiles of 8 columns a chunk
#pragma unroll
  for (int i = 0; i < NCH * 8; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // the previous tile's P as A fragments: bf16 one per 16 keys; f32 (hi, lo) per 8
  uint32_t pa[F32 ? NT : NT / 2][4], pl[F32 ? NT : 1][4];

  // o += P V of key tile `it` (its P in pa / pl) for the chunks [lo, hi) of the
  // slice, each summed over the tile in a fresh fragment and added in f32
  auto pv_chunks = [&](int it, int lo, int hi) {
    const unsigned char* vs = vring + (it & 1) * KT * DC * 2;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      if (ch >= lo && ch < hi && ch < nch) {
        float pv[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) pv[j][r] = 0.f;
        }
        if constexpr (F32) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {  // k-steps of 8 keys, k relabelled
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const uint4 b = *reinterpret_cast<const uint4*>(
                  vt + (ch * 64 + j * 8 + g) * PL::VROW + nt * 8 + 2 * t);
              const uint32_t bh_[2] = {b.x, b.z}, bl_[2] = {b.y, b.w};
              tf32::mma3<true>(pv[j], pa[nt], pl[nt], bh_, bl_);
            }
          }
        } else {
#pragma unroll
          for (int kj = 0; kj < NT / 2; ++kj) {  // k-steps of 16 keys
#pragma unroll
            for (int np = 0; np < 4; ++np) {  // two n-tiles of 8 columns a load
              uint32_t b[4];
              ldmatrix_x4_trans(b, smem_addr(vs + swz(kj * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                      ch * 8 + np * 2 + (lane >> 4), CH)));
              mma_bf16(pv[2 * np], pa[kj], b[0], b[1]);
              mma_bf16(pv[2 * np + 1], pa[kj], b[2], b[3]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[ch * 8 + j][r] += pv[j][r];
        }
      }
    }
  };

  // Key tile it: (a) its k lands (f32: split into the plane) and k of it + 1 is
  // staged; (b) the partial S over this CTA's columns, offered to the cluster;
  // (c) while the partials cross the cluster, P V of tile it - 1 (with the
  // reduce-scatter, its first 64 columns here and the rest between the two
  // barriers); (d) the summed S; (e) v of it lands (f32: split into the plane)
  // and v of it + 1 is staged, once tile it - 1's P V is done with v's stage or
  // plane; (f) the online softmax and P of tile it. P V of the last tile
  // follows the loop.
#pragma unroll 1
  for (int it = 0; it < ktiles; ++it) {
    const int k0 = it * KT;
    // (a)
    tf32::cp_async_wait<1>();  // k of it (and v of it - 1) landed; v of it may fly
    __syncthreads();           // ... for every thread; every warp is done with tile it - 1's k
    if constexpr (F32) {
      for (int i = threadIdx.x; i < KT * (width / 4); i += THREADS) {
        const int r = i / (width / 4), c = (i - r * (width / 4)) * 4;
        const float4 x = *reinterpret_cast<const float4*>(rawk + r * PL::RAW + c);
        uint4* dst = reinterpret_cast<uint4*>(kp + r * PL::QROW + c);
        dst[0] = split2(x.x, x.y);
        dst[1] = split2(x.z, x.w);
      }
      __syncthreads();
    }
    if (it + 1 < ktiles) stage_k(it + 1);
    tf32::cp_async_commit();

    // The tile's keep bits (bit nt * 4 + r for C element r of n-tile nt).
    uint32_t keep_bits = 0u;
    if constexpr (kDrop) {
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

    // (b) partial S = Q K^T over this CTA's columns; c0 (query g, key 2t) ...
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
    }
    const unsigned char* ks = kring + (it & 1) * KT * DC * 2;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      if (ch < nch) {
        if constexpr (F32) {
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {  // k-steps of 8 columns, k relabelled
            const int c = ch * 64 + kk * 8 + 2 * t;
            const uint4 a0 = *reinterpret_cast<const uint4*>(qp + (r0 + g) * PL::QROW + c);
            const uint4 a1 = *reinterpret_cast<const uint4*>(qp + (r0 + g + 8) * PL::QROW + c);
            const uint32_t ah[4] = {a0.x, a1.x, a0.z, a1.z}, al[4] = {a0.y, a1.y, a0.w, a1.w};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint4 b = *reinterpret_cast<const uint4*>(kp + (nt * 8 + g) * PL::QROW + c);
              const uint32_t bh_[2] = {b.x, b.z}, bl_[2] = {b.y, b.w};
              tf32::mma3<true>(s[nt], ah, al, bh_, bl_);
            }
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {  // k-steps of 16 columns
            const int c = ch * 8 + kk * 2;  // its first 16-byte chunk
            uint32_t a[4];
            ldmatrix_x4(a, smem_addr(qs + swz(r0 + (lane & 15), c + (lane >> 4), CH)));
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {  // two n-tiles of keys a load
              uint32_t b[4];
              ldmatrix_x4(b, smem_addr(ks + swz(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                                c + ((lane >> 3) & 1), CH)));
              mma_bf16(s[2 * np], a, b[0], b[1]);
              mma_bf16(s[2 * np + 1], a, b[2], b[3]);
            }
          }
        }
      }
    }
    float4* mine = part + (scatter ? 0 : (it & 1) * PIECES);
    if (csize > 1) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mine[nt * THREADS + threadIdx.x] = make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
      cluster_arrive();
    }

    // (c) P V of the previous tile while the partials cross the cluster
    if (it > 0) pv_chunks(it - 1, 0, scatter ? 1 : NCH);

    // (d) the cluster's sum of the partial tiles, in the order 0 ... C-1
    if (csize > 1) {
      cluster_wait();  // every partial is written
      if (scatter) {
        // CTA r sums the pieces [r share, (r + 1) share), then the cluster gathers
        float4* sums = part + PIECES;
        const int hi = min(PIECES, (rank + 1) * share);
        for (int j = rank * share + threadIdx.x; j < hi; j += THREADS) {
          float4 x[MAX_CLUSTER];
#pragma unroll
          for (int r = 0; r < MAX_CLUSTER; ++r)
            if (r < csize) x[r] = cluster.map_shared_rank(mine, r)[j];
#pragma unroll
          for (int r = 1; r < MAX_CLUSTER; ++r)
            if (r < csize) add4(x[0], x[r]);
          sums[j] = x[0];
        }
        cluster_arrive();
        if (it > 0) pv_chunks(it - 1, 1, NCH);
        cluster_wait();  // every sum is written; every partial is read
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = nt * THREADS + threadIdx.x;
          const float4 x = cluster.map_shared_rank(sums, j / share)[j];
          s[nt][0] = x.x;
          s[nt][1] = x.y;
          s[nt][2] = x.z;
          s[nt][3] = x.w;
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = nt * THREADS + threadIdx.x;
          float4 x[MAX_CLUSTER];
#pragma unroll
          for (int r = 0; r < MAX_CLUSTER; ++r)
            if (r < csize) x[r] = cluster.map_shared_rank(mine, r)[j];
#pragma unroll
          for (int r = 1; r < MAX_CLUSTER; ++r)
            if (r < csize) add4(x[0], x[r]);
          s[nt][0] = x[0].x;
          s[nt][1] = x[0].y;
          s[nt][2] = x[0].z;
          s[nt][3] = x[0].w;
        }
      }
    }

    // (e)
    if constexpr (F32) {
      tf32::cp_async_wait<1>();  // v of it landed; k of it + 1 may fly
      __syncthreads();           // ... for every thread; every warp is done with v's plane
      for (int i = threadIdx.x; i < (KT / 2) * width; i += THREADS) {
        const int c = i % width, r = 2 * (i / width);  // keys r, r + 1 of column c
        const float* src = rawv + r * PL::RAW + c;
        *reinterpret_cast<uint4*>(vt + c * PL::VROW + r) = split2(src[0], src[PL::RAW]);
      }
    }
    __syncthreads();  // every warp is done with v of it - 1 (f32: with raw v of it)
    if (it + 1 < ktiles) stage_v(it + 1);
    tf32::cp_async_commit();

    // (f) log2 domain; keys >= n (zero-filled) to -inf before the max (k0 < n:
    // the new max is finite; on the first tile m = -inf and alpha = 0)
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
      for (int i = 0; i < NCH * 8; ++i) {
        acc[i][2 * half] *= alpha;
        acc[i][2 * half + 1] *= alpha;
      }
    }
    // p = 2^(s - m), summed undropped into l, then masked; P as A fragments
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = exp2_ftz(s[nt][r] - m[r >> 1]);  // 0 for masked keys
        l[r >> 1] += p;
        if (kDrop) p = (keep_bits >> (nt * 4 + r)) & 1u ? p : 0.f;
        s[nt][r] = p;
      }
    }
    if constexpr (F32) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) frag_a_from_c<true>(s[nt], pa[nt], pl[nt]);
    } else {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {  // n-tiles 2j and 2j + 1: keys 16j .. 16j + 15
        pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      }
    }
  }
  tf32::cp_async_wait<0>();
  __syncthreads();  // v of the last tile (f32: its plane) is here for every thread
  pv_chunks(ktiles - 1, 0, NCH);
  if (csize > 1) {  // no CTA leaves while another may read its shared memory
    cluster_arrive();
    cluster_wait();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float lsum = quad_sum(l[half]);
    const int row = q0 + r0 + g + half * 8;
    if (row >= n) continue;
    const float inv = 1.f / (kDrop ? lsum * keep_prob : lsum);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      if (ch < nch) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          store2(o + head + static_cast<size_t>(row) * d + col0 + ch * 64 + j * 8 + 2 * t,
                 acc[ch * 8 + j][2 * half] * inv, acc[ch * 8 + j][2 * half + 1] * inv);
        }
      }
    }
    if (t == 0 && rank == 0)
      lse[static_cast<size_t>(bh) * n + row] = (m[half] + log2f(lsum)) * LN2;
  }
}

template <typename T, int DC, int KT, bool kDrop>
cudaError_t launch_large(const void* q, const void* k, const void* v, void* o, float* lse,
                         int bh, int n, int d, float scale, const long long* seed,
                         uint32_t thresh, float keep_prob, uint32_t bh0, cudaStream_t stream) {
  static_assert(LargePlan<T, DC, KT>::OPS_BYTES + LargePlan<T, DC, KT>::PART_BYTES <= MAX_SMEM,
                "a CTA of the large forward must fit in shared memory");
  auto kernel = attention_fwd_large_kernel<T, DC, KT, kDrop>;
  const int clusters = (d + DC - 1) / DC;
  if (clusters > MAX_CLUSTER) return cudaErrorInvalidValue;
  const int bytes = LargePlan<T, DC, KT>::bytes(clusters > 1);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((n + BM - 1) / BM) * bh * clusters;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), static_cast<T*>(o), lse, n, d, scale,
                           seed, thresh, keep_prob, bh0);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// DC = 128 up to D = 1024 (C <= 8), 192 above (C <= 7); the key tile is as long
// as shared memory allows: bf16 64 / 32, f32 32 / 16.
template <typename T, bool kDrop>
cudaError_t dispatch_large(const void* q, const void* k, const void* v, void* o, float* lse,
                           int bh, int n, int d, float scale, const long long* seed,
                           uint32_t thresh, float keep_prob, uint32_t bh0,
                           cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  if (d < LARGE_MIN_D || d > DEEP_MAX_D || d % 64) return cudaErrorInvalidValue;
  if (d <= 1024)
    return launch_large<T, 128, F32 ? 32 : 64, kDrop>(q, k, v, o, lse, bh, n, d, scale, seed,
                                                      thresh, keep_prob, bh0, stream);
  return launch_large<T, 192, F32 ? 16 : 32, kDrop>(q, k, v, o, lse, bh, n, d, scale, seed,
                                                    thresh, keep_prob, bh0, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head dim d a multiple of 64 in 128 ..
// DEEP_MAX_D (1344); the other arguments as attention_fwd's (attention_fwd.cu).
extern "C" int attention_fwd_large(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int bh, int n, int d,
                                   int dtype, float scale, int dropout, const long long* seed,
                                   unsigned int thresh, float keep_prob, unsigned int bh0,
                                   void* stream) {
  if (bh <= 0 || n <= 0 || (dropout && seed == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ATTN_FWD_LARGE(T)                                                                \
  return dropout ? dispatch_large<T, true>(q, k, v, o, lse, bh, n, d, scale, seed, thresh, \
                                           keep_prob, bh0, s)                              \
                 : dispatch_large<T, false>(q, k, v, o, lse, bh, n, d, scale, seed, thresh, \
                                            keep_prob, bh0, s);
  switch (dtype) {
    case 0: ATTN_FWD_LARGE(float)
    case 1: ATTN_FWD_LARGE(__nv_bfloat16)
    default: return cudaErrorInvalidValue;
  }
#undef ATTN_FWD_LARGE
}
