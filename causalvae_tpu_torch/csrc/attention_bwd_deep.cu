// Multi-head attention backward for Hopper (sm_90a) at head dims above 256:
// the deep plan beside attention_bwd.cu's narrow and wide plans, with the same
// contract (dq, dk, dv from q, k, v, o, do of shape (BH, N, D), contiguous,
// f32 or bf16, and the forward's lse (BH, N) in f32; the same math, dropout
// hash and tensor-core products; delta, then dk/dv, then dq in three
// launches, each output owned by one block, no atomics, every sum in a fixed
// order, so two launches give the same bits).
//
// Replaces the Pallas TPU kernel _bwd_fused_kernel (causalvae_tpu/ops/
// kernels/attention.py) at D above 256. It is a source of its own so that
// nvcc builds it in parallel with attention_bwd.cu.
//
// Past D = 256 the wide plan's resident rows would not fit, and its passes
// would take 4.5x the necessary S^T and dP^T at D = 512. So D = 320 ... 1344
// (a multiple of 64, at run time) takes a deep plan, with the same three
// launches, ownership and fixed order of every sum (delta_kernel as it is,
// compiled at each deep D):
//   - dkdv_deep_kernel: a block owns R = 32 keys (16 above D = 512) and their
//     f32 dk and dv accumulators (2 x R x (D + 8)) in shared memory; per tile
//     of 32 queries, (k_c, q_c) and (v_c, do_c) come in chunks of 64 columns
//     through a ring of slots of two chunks (DKDV_DEEP_STAGES), S^T and dP^T are
//     summed over the chunks in C fragments; p, the mask and ds go to shared
//     P and dS tiles; then (do_c, q_c) for each chunk add P^T dO and dS^T Q
//     into the shared accumulators;
//   - dq_deep_kernel: a block owns R queries and their dq accumulator; per
//     tile of 32 keys, (q_c, k_c) and (do_c, v_c) give S and dP, dS goes to a
//     shared tile, then k_c for each chunk adds dS K.
// The products are the narrow plan's (S and dP in both launches, 14 N^2 D a
// head). What bounds the block: shared memory, 195,584 bytes for dk/dv at
// D = 512 f32 (R = 32) and 230,400 at 1344 (R = 16): the next multiple of 64
// would pass the 227 KB a block may have, so 1344 is the limit (DEEP_MAX_D).
// What bounds the launches at (8, 961, 512): operations. 10 x 8 x 961^2 x 512
// = 37.8 GFLOP: 0.229 ms as 3xTF32 at 495 TFLOP/s, 0.0382 ms in bf16 at 989.
//
// The wrapper zero-pads D = 257 ... 1344 to the next multiple of 64; the
// scale stays 1 / sqrt(D) of the true D.
//
// C interface: attention_bwd_deep(...) takes attention_bwd's arguments and
// returns cudaGetLastError() after the three launches (cudaErrorInvalidValue
// for a head dim or type it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "dropout_hash.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace attn;

// ring slots of two chunks each: as many as fit at DEEP_MAX_D in f32
constexpr int DKDV_DEEP_STAGES = 3;
constexpr int DQ_DEEP_STAGES = 6;
constexpr int DEEP_SLOT = 2 * DEEP_TILE;  // rows of a slot: two chunks

template <typename T, int NS>
constexpr int deep_ring_bytes() { return NS * 2 * DeepChunk<T>::BYTES; }

// Dynamic shared memory at head dim d: dk and dv's accumulators, the ring and
// the P and dS tiles (dkdv_deep_kernel); dq's accumulator, the ring and the dS
// tile (dq_deep_kernel).
template <typename T>
constexpr int dkdv_deep_bytes(int d) {
  const int r = deep_rows(d);
  return 2 * r * (d + 8) * 4 + deep_ring_bytes<T, DKDV_DEEP_STAGES>() + 2 * r * DEEP_ST * 4;
}
template <typename T>
constexpr int dq_deep_bytes(int d) {
  const int r = deep_rows(d);
  return r * (d + 8) * 4 + deep_ring_bytes<T, DQ_DEEP_STAGES>() + r * DEEP_ST * 4;
}

static_assert(dkdv_deep_bytes<float>(DEEP_MAX_D) <= MAX_SMEM &&
              dkdv_deep_bytes<float>(DEEP_MAX_D + DEEP_CHUNK) > MAX_SMEM,
              "DEEP_MAX_D is the largest head dim whose dk/dv block fits");
static_assert(dq_deep_bytes<float>(DEEP_MAX_D) <= MAX_SMEM, "the deep dq block must fit");

// dkdv_deep_kernel: one block per (head, R keys), the loop over tiles of
// DEEP_TILE queries. Per tile, 3C ring items of two chunks (C = d / 64):
// (k_c, q_c) and (v_c, do_c) for c = 0 .. C - 1, in turn, sum S^T = K Q^T and
// dP^T = V dO^T into the warps' C fragments; p, the mask and ds then go to
// the shared P and dS tiles; then (do_c, q_c) for each c add P^T dO and
// dS^T Q into the shared dv and dk, a chunk of columns at a time.
template <typename T, int R, bool kDrop>
__global__ void __launch_bounds__(THREADS)
dkdv_deep_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const T* __restrict__ delta_rows, T* __restrict__ dk, T* __restrict__ dv,
                 int n, int d, float scale, const long long* __restrict__ seed_at,
                 uint32_t thresh, float inv_keep, uint32_t bh0) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int NS = DKDV_DEEP_STAGES, CR = DeepChunk<T>::RAW;
  constexpr int RG = R / 16, NTW = RG, NCW = 2 * RG;  // as the deep forward's
  const int AS = d + 8, C = d / DEEP_CHUNK;
  const int dstride = d * static_cast<int>(sizeof(T)) / 4;  // floats per dq row
  extern __shared__ __align__(16) unsigned char smem[];
  float* acck = reinterpret_cast<float*>(smem);  // dk, R x d
  float* accv = acck + R * AS;                   // dv
  T* ring = reinterpret_cast<T*>(accv + R * AS);
  float* pds = reinterpret_cast<float*>(ring + NS * DEEP_SLOT * CR);  // P (masked, scaled)
  float* dss = pds + R * DEEP_ST;                                      // dS

  const int ktiles = (n + R - 1) / R;
  const int bh = blockIdx.x / ktiles;
  const int k0 = (blockIdx.x - bh * ktiles) * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp % RG) * 16;            // the warp's keys
  const int q_off = (warp / RG) * NTW * 8;    // its queries of a tile in S^T
  const int col_off = (warp / RG) * NCW * 8;  // its columns of a chunk
  const size_t head = static_cast<size_t>(bh) * n * d;
  const float* lse_h = lse + static_cast<size_t>(bh) * n;
  const float* delta_h = reinterpret_cast<const float*>(delta_rows + head);
  const int per = 3 * C, total = (n + DEEP_TILE - 1) / DEEP_TILE * per;
  const uint32_t key_m2[2] = {static_cast<uint32_t>(k0 + r0 + g) * dropout_hash::M2,
                              static_cast<uint32_t>(k0 + r0 + g + 8) * dropout_hash::M2};
  const uint32_t bh_m3 = (bh0 + static_cast<uint32_t>(bh)) * dropout_hash::M3;
  const uint32_t seed = kDrop ? dropout_hash::load_seed(seed_at) : 0u;
  const float scale_log2 = scale * LOG2E;

  auto load = [&](int s) {
    const int it = s / per, j = s - it * per, qr = it * DEEP_TILE;
    T* a = ring + (s % NS) * DEEP_SLOT * CR;
    T* b = a + DEEP_TILE * CR;
    if (j < 2 * C) {  // (k_c, q_c) or (v_c, do_c)
      const int c0 = (j >> 1) * DEEP_CHUNK;
      stage_chunk<T>(a, ((j & 1) ? v : k) + head, d, k0, R, c0, n);
      stage_chunk<T>(b, ((j & 1) ? dout : q) + head, d, qr, DEEP_TILE, c0, n);
    } else {  // (do_c, q_c)
      const int c0 = (j - 2 * C) * DEEP_CHUNK;
      stage_chunk<T>(a, dout + head, d, qr, DEEP_TILE, c0, n);
      stage_chunk<T>(b, q + head, d, qr, DEEP_TILE, c0, n);
    }
  };
  for (int i = threadIdx.x; i < 2 * R * AS; i += THREADS) acck[i] = 0.f;
#pragma unroll
  for (int s = 0; s + 1 < NS; ++s) {
    if (s < total) load(s);
    tf32::cp_async_commit();
  }

  int u = 0;
#pragma unroll 1
  for (int q0 = 0; q0 < n; q0 += DEEP_TILE) {
    float sc[NTW][4], dp[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[j][r] = dp[j][r] = 0.f;
    }
#pragma unroll 1
    for (int c = 0; c < C; ++c) {  // S^T from (k_c, q_c), dP^T from (v_c, do_c)
      deep_acquire<NS>(u, total, load);
      const T* a = ring + (u++ % NS) * DEEP_SLOT * CR;
      deep_scores<T, kSplit>(sc, a, CR, a + DEEP_TILE * CR, CR, r0, q_off, g, t);
      deep_acquire<NS>(u, total, load);
      a = ring + (u++ % NS) * DEEP_SLOT * CR;
      deep_scores<T, kSplit>(dp, a, CR, a + DEEP_TILE * CR, CR, r0, q_off, g, t);
    }
    // c0 (key g, query 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ql = q_off + j * 8 + 2 * t + (r & 1), qg = q0 + ql;
        const bool in = qg < n;
        const float lq = in ? lse_h[qg] : 0.f;
        const float delta = in ? delta_h[static_cast<size_t>(qg) * dstride] : 0.f;
        float p = exp2_ftz(fmaf(sc[j][r], scale_log2, -lq * LOG2E));
        p = in ? p : 0.f;
        float dpv = dp[j][r], pdv = p;
        if (kDrop) {
          const bool keep = kept(static_cast<uint32_t>(qg) * dropout_hash::M1, key_m2[r >> 1],
                                 bh_m3, seed, thresh);
          pdv = keep ? p * inv_keep : 0.f;
          dpv = keep ? dpv * inv_keep : 0.f;
        }
        const int at = (r0 + g + 8 * (r >> 1)) * DEEP_ST + ql;
        pds[at] = pdv;
        dss[at] = p * (dpv - delta);
      }
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q on chunk c of d's columns
#pragma unroll 1
    for (int c = 0; c < C; ++c, ++u) {
      deep_acquire<NS>(u, total, load);
      const T* dos = ring + (u % NS) * DEEP_SLOT * CR;
      float fv[NCW][4], fk[NCW][4];
      deep_tile_product<T, kSplit>(fv, pds, dos, r0, col_off, g, t);
      deep_tile_product<T, kSplit>(fk, dss, dos + DEEP_TILE * CR, r0, col_off, g, t);
      deep_accumulate<NCW>(accv, AS, r0, c * DEEP_CHUNK + col_off, fv, g, t);
      deep_accumulate<NCW>(acck, AS, r0, c * DEEP_CHUNK + col_off, fk, g, t);
    }
  }
  __syncthreads();
  deep_store<T, R>(dk + head, acck, AS, d, k0, n, scale);
  deep_store<T, R>(dv + head, accv, AS, d, k0, n, 1.f);
}

// dq_deep_kernel: one block per (head, R queries), the loop over tiles of
// DEEP_TILE keys. Per tile, (q_c, k_c) and (do_c, v_c) for each c sum S = Q K^T
// and dP = dO V^T; ds goes to the shared dS tile; then k_c for each c adds
// dS K into the shared dq. lse and delta of the warp's rows are read into
// registers first (delta from dq's rows, which the block writes last).
template <typename T, int R, bool kDrop>
__global__ void __launch_bounds__(THREADS)
dq_deep_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse, T* dq, int n, int d,
               float scale, const long long* __restrict__ seed_at, uint32_t thresh,
               float inv_keep, uint32_t bh0) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int NS = DQ_DEEP_STAGES, CR = DeepChunk<T>::RAW;
  constexpr int RG = R / 16, NTW = RG, NCW = 2 * RG;
  const int AS = d + 8, C = d / DEEP_CHUNK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // dq, R x d
  T* ring = reinterpret_cast<T*>(acc + R * AS);
  float* dss = reinterpret_cast<float*>(ring + NS * DEEP_SLOT * CR);

  const int qtiles = (n + R - 1) / R;
  const int bh = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x - bh * qtiles) * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp % RG) * 16;            // the warp's queries
  const int key_off = (warp / RG) * NTW * 8;  // its keys of a tile in S
  const int col_off = (warp / RG) * NCW * 8;  // its columns of a chunk
  const size_t head = static_cast<size_t>(bh) * n * d;
  const int per = 3 * C, total = (n + DEEP_TILE - 1) / DEEP_TILE * per;

  float lse2[2], delta[2];
  uint32_t row_m1[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + half * 8;
    const bool in = row < n;
    // delta_kernel left delta_i in dq's row i; this block overwrites that row last
    lse2[half] = in ? lse[static_cast<size_t>(bh) * n + row] * LOG2E : 0.f;
    delta[half] = in ? *reinterpret_cast<const float*>(dq + head + static_cast<size_t>(row) * d)
                     : 0.f;
    row_m1[half] = static_cast<uint32_t>(row) * dropout_hash::M1;
  }
  const uint32_t bh_m3 = (bh0 + static_cast<uint32_t>(bh)) * dropout_hash::M3;
  const uint32_t seed = kDrop ? dropout_hash::load_seed(seed_at) : 0u;
  const float scale_log2 = scale * LOG2E;

  auto load = [&](int s) {
    const int it = s / per, j = s - it * per, kr = it * DEEP_TILE;
    T* a = ring + (s % NS) * DEEP_SLOT * CR;
    if (j < 2 * C) {  // (q_c, k_c) or (do_c, v_c)
      const int c0 = (j >> 1) * DEEP_CHUNK;
      stage_chunk<T>(a, ((j & 1) ? dout : q) + head, d, q0, R, c0, n);
      stage_chunk<T>(a + DEEP_TILE * CR, ((j & 1) ? v : k) + head, d, kr, DEEP_TILE, c0, n);
    } else {  // k_c
      stage_chunk<T>(a, k + head, d, kr, DEEP_TILE, (j - 2 * C) * DEEP_CHUNK, n);
    }
  };
  for (int i = threadIdx.x; i < R * AS; i += THREADS) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s + 1 < NS; ++s) {
    if (s < total) load(s);
    tf32::cp_async_commit();
  }

  int u = 0;
#pragma unroll 1
  for (int k0 = 0; k0 < n; k0 += DEEP_TILE) {
    float sc[NTW][4], dp[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[j][r] = dp[j][r] = 0.f;
    }
#pragma unroll 1
    for (int c = 0; c < C; ++c) {  // S from (q_c, k_c), dP from (do_c, v_c)
      deep_acquire<NS>(u, total, load);
      const T* a = ring + (u++ % NS) * DEEP_SLOT * CR;
      deep_scores<T, kSplit>(sc, a, CR, a + DEEP_TILE * CR, CR, r0, key_off, g, t);
      deep_acquire<NS>(u, total, load);
      a = ring + (u++ % NS) * DEEP_SLOT * CR;
      deep_scores<T, kSplit>(dp, a, CR, a + DEEP_TILE * CR, CR, r0, key_off, g, t);
    }
    // c0 (query g, key 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kl = key_off + j * 8 + 2 * t + (r & 1), key = k0 + kl;
        float p = exp2_ftz(fmaf(sc[j][r], scale_log2, -lse2[r >> 1]));
        p = key < n ? p : 0.f;
        float dpv = dp[j][r];
        if (kDrop) {
          const bool keep = kept(row_m1[r >> 1], static_cast<uint32_t>(key) * dropout_hash::M2,
                                 bh_m3, seed, thresh);
          dpv = keep ? dpv * inv_keep : 0.f;
        }
        dss[(r0 + g + 8 * (r >> 1)) * DEEP_ST + kl] = p * (dpv - delta[r >> 1]);
      }
    }
    __syncthreads();
    // dQ += dS K on chunk c of d's columns
#pragma unroll 1
    for (int c = 0; c < C; ++c, ++u) {
      deep_acquire<NS>(u, total, load);
      float f[NCW][4];
      deep_tile_product<T, kSplit>(f, dss, ring + (u % NS) * DEEP_SLOT * CR, r0, col_off, g, t);
      deep_accumulate<NCW>(acc, AS, r0, c * DEEP_CHUNK + col_off, f, g, t);
    }
  }
  __syncthreads();
  deep_store<T, R>(dq + head, acc, AS, d, q0, n, scale);
}

template <typename T, int R, bool kDrop>
cudaError_t launch_deep(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, void* dq, void* dk, void* dv, int bh, int n, int d,
                        float scale, const long long* seed, uint32_t thresh, float inv_keep,
                        uint32_t bh0, cudaStream_t stream) {
  auto dkdv = dkdv_deep_kernel<T, R, kDrop>;
  auto dqk = dq_deep_kernel<T, R, kDrop>;
  const int dkdv_bytes = dkdv_deep_bytes<T>(d), dq_bytes = dq_deep_bytes<T>(d);
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((n + R - 1) / R) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  dkdv<<<static_cast<unsigned>(blocks), THREADS, dkdv_bytes, stream>>>(
      qt, kt, vt, gt, lse, dqt, static_cast<T*>(dk), static_cast<T*>(dv), n, d, scale, seed,
      thresh, inv_keep, bh0);
  dqk<<<static_cast<unsigned>(blocks), THREADS, dq_bytes, stream>>>(
      qt, kt, vt, gt, lse, dqt, n, d, scale, seed, thresh, inv_keep, bh0);
  return cudaGetLastError();
}

// delta_i at a deep head dim, d at run time: delta_kernel's sum in its order
// (unrolling it at every deep D would take minutes of nvcc).
template <typename T>
__global__ void __launch_bounds__(256)
delta_deep_kernel(const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
                  int n, int d) {
  const int blocks = (n + 255) / 256;
  const int bh = blockIdx.x / blocks;
  const int row = (blockIdx.x - bh * blocks) * 256 + threadIdx.x;
  if (row >= n) return;
  const size_t at = (static_cast<size_t>(bh) * n + row) * d;
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < d; ++i) acc = fmaf(to_f32(dout[at + i]), to_f32(o[at + i]), acc);
  *reinterpret_cast<float*>(dq + at) = acc;
}

template <typename T, bool kDrop>
cudaError_t dispatch_deep(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, void* dq, void* dk, void* dv,
                          int bh, int n, int d, float scale, const long long* seed,
                          uint32_t thresh, float inv_keep, uint32_t bh0, cudaStream_t stream) {
  if (d <= 256 || d > DEEP_MAX_D || d % DEEP_CHUNK) return cudaErrorInvalidValue;
  const long long delta_blocks = static_cast<long long>((n + 255) / 256) * bh;
  if (delta_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  delta_deep_kernel<T><<<static_cast<unsigned>(delta_blocks), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<T*>(dq), n, d);
  return deep_rows(d) == 32
             ? launch_deep<T, 32, kDrop>(q, k, v, dout, lse, dq, dk, dv, bh, n, d, scale,
                                         seed, thresh, inv_keep, bh0, stream)
             : launch_deep<T, 16, kDrop>(q, k, v, dout, lse, dq, dk, dv, bh, n, d, scale,
                                         seed, thresh, inv_keep, bh0, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head dim d a multiple of 64 in 320 ..
// DEEP_MAX_D (1344); the other arguments as attention_bwd's (attention_bwd.cu).
extern "C" int attention_bwd_deep(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, const float* lse,
                                  void* dq, void* dk, void* dv, int bh, int n, int d,
                                  int dtype, float scale, int dropout, const long long* seed,
                                  unsigned int thresh, float inv_keep, unsigned int bh0,
                                  void* stream) {
  if (bh <= 0 || n <= 0 || (dropout && seed == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ATTN_BWD_DEEP(T)                                                                 \
  return dropout ? dispatch_deep<T, true>(q, k, v, o, dout, lse, dq, dk, dv, bh, n, d, scale, \
                                          seed, thresh, inv_keep, bh0, s)                  \
                 : dispatch_deep<T, false>(q, k, v, o, dout, lse, dq, dk, dv, bh, n, d,    \
                                           scale, seed, thresh, inv_keep, bh0, s);
  switch (dtype) {
    case 0: ATTN_BWD_DEEP(float)
    case 1: ATTN_BWD_DEEP(__nv_bfloat16)
    default: return cudaErrorInvalidValue;
  }
#undef ATTN_BWD_DEEP
}
