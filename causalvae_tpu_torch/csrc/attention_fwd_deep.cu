// Multi-head attention forward for Hopper (sm_90a) at head dims above 256: the
// deep plan beside attention_fwd.cu's narrow and wide plans, with the same
// contract (o = dropout(softmax(q k^T * scale)) v and the row logsumexp in
// natural log, for q, k, v of shape (BH, N, D), contiguous, f32; keys
// >= N masked here; the dropout hash of dropout_hash.cuh; tensor-core
// products as mma.sync m16n8k8 3xTF32; no atomics and every sum
// in a fixed order, so two launches give the same bits).
//
// Replaces the Pallas TPU kernel _fwd_kernel (causalvae_tpu/ops/kernels/
// attention.py) at head dims above 256, which the JAX wrapper hands it whole, in
// f32. bf16 runs attention_fwd_large.cu there (faster at every timed shape), so
// this entry takes f32 only.
// It is a source of its own so that nvcc builds it in parallel with
// attention_fwd.cu.
//
// Past D = 256 the wide plan would need two blocks' shared memory, and its
// passes would repeat Q K^T per 128 columns (2.5x the products at D = 512). So
// D = 320 ... 1344 (a multiple of 64, at run time) takes a deep plan
// (attention_fwd_deep_kernel):
//   - a block owns R = 32 queries (16 above D = 512): their raw q rows and
//     their f32 o accumulator (R x (D + 8)) stay in shared memory;
//   - per tile of 32 keys, k comes in chunks of 64 columns through a ring of
//     FWD_DEEP_STAGES slots (cp.async; as many as fit at the limit), and
//     S = Q K^T is summed over the chunks in C fragments, each of the 4 warps
//     16 queries x 8 R / 16 keys; the scaled, masked scores go to a shared
//     tile, where 128 / R threads a row take the online softmax (the row max
//     by shuffles, alpha, p summed undropped into each thread's partial l,
//     then masked by the hash, in place); then v comes in chunks, and each
//     warp adds its 16 x 16 R / 16 part of the tile's P V (a fresh C
//     fragment) to alpha times the shared o, in f32;
//   - Q K^T and P V are computed once each (the necessary products); the
//     block's shared memory is 190,080 bytes at D = 512 f32 and 227,648 at
//     the limit 1344 (R = 16).
// Keeping q resident (not streamed, as k and v are) saves re-reading it from
// L2 for every key tile and still fits up to the backward's limit.
// What bounds it at (8, 961, 512): operations. 4 x 8 x 961^2 x 512 = 15.1
// GFLOP: 0.0917 ms as 3xTF32 at 495 TFLOP/s; the bytes (q, k, v, o, 63 MB)
// take 0.019 ms at 3.35 TB/s.
//
// The wrapper (ops/kernels/attention.py) zero-pads D = 257 ... 1344 to the
// next multiple of 64; the scale stays 1 / sqrt(D) of the true D.
//
// C interface: attention_fwd_deep(...) takes attention_fwd's arguments and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head dim or type it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "dropout_hash.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace attn;

constexpr float LN2 = 0.6931471805599453f;

constexpr int FWD_DEEP_STAGES = 6;  // ring slots, one chunk of k or v each: as many as fit

// Dynamic shared memory of attention_fwd_deep_kernel at head dim d: the q rows,
// o's accumulator, the ring, the score tile and a float a row.
template <typename T>
constexpr int fwd_deep_bytes(int d) {
  const int r = deep_rows(d), e = static_cast<int>(sizeof(T));
  return r * (d + 16 / e) * e + r * (d + 8) * 4 + FWD_DEEP_STAGES * DeepChunk<T>::BYTES +
         r * DEEP_ST * 4 + r * 4;
}

template <typename T, int R, bool kDrop>
__global__ void __launch_bounds__(THREADS)
attention_fwd_deep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse, int n, int d, float scale,
                          const long long* __restrict__ seed_at, uint32_t thresh,
                          float keep_prob, uint32_t bh0) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int NS = FWD_DEEP_STAGES, CR = DeepChunk<T>::RAW;
  constexpr int RG = R / 16;            // row groups of 16; WARPS / RG warps share one
  constexpr int NTW = RG;               // n-tiles of 8 keys a warp computes in S
  constexpr int NCW = 2 * RG;           // n-tiles of 8 columns a warp adds in a chunk of P V
  constexpr int TPR = THREADS / R;      // threads a row in the softmax
  constexpr int KPT = DEEP_TILE / TPR;  // keys a softmax thread
  const int QS = d + 16 / static_cast<int>(sizeof(T)), AS = d + 8, C = d / DEEP_CHUNK;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);                            // the block's R q rows
  float* acc = reinterpret_cast<float*>(qs + R * QS);            // o, R x d
  T* ring = reinterpret_cast<T*>(acc + R * AS);                  // NS chunks of k or v
  float* sp = reinterpret_cast<float*>(ring + NS * DEEP_TILE * CR);  // S, then P
  float* rowv = sp + R * DEEP_ST;  // a row's alpha for this tile; at the end 1 / l

  const int qtiles = (n + R - 1) / R;
  const int bh = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x - bh * qtiles) * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp % RG) * 16;              // the warp's rows
  const int key_off = (warp / RG) * NTW * 8;    // its keys of a tile in S
  const int col_off = (warp / RG) * NCW * 8;    // its columns of a chunk in P V
  const size_t head = static_cast<size_t>(bh) * n * d;
  const int ktiles = (n + DEEP_TILE - 1) / DEEP_TILE, total = ktiles * 2 * C;
  // the softmax: TPR threads a row, KPT keys each
  const int srow = threadIdx.x / TPR, spart = threadIdx.x % TPR;
  const uint32_t row_m1 = static_cast<uint32_t>(q0 + srow) * dropout_hash::M1;
  const uint32_t bh_m3 = (bh0 + static_cast<uint32_t>(bh)) * dropout_hash::M3;
  const uint32_t seed = kDrop ? dropout_hash::load_seed(seed_at) : 0u;
  const float scale_log2 = scale * LOG2E;
  float m = -INFINITY, l = 0.f;  // the row's running max (log2 domain), this thread's sum

  // item s of the ring: key tile s / (2C), then chunk c of k (j = c) or v (j = C + c)
  auto load = [&](int s) {
    const int it = s / (2 * C), j = s - it * 2 * C;
    stage_chunk<T>(ring + (s % NS) * DEEP_TILE * CR, (j < C ? k : v) + head, d,
                   it * DEEP_TILE, DEEP_TILE, (j < C ? j : j - C) * DEEP_CHUNK, n);
  };
  for (int i = threadIdx.x; i < R * AS; i += THREADS) acc[i] = 0.f;
  stage_cols<T>(qs, QS, q + head, d, q0, R, 0, d, n);  // committed with item 0
#pragma unroll
  for (int s = 0; s + 1 < NS; ++s) {
    if (s < total) load(s);
    tf32::cp_async_commit();
  }

  int u = 0;
#pragma unroll 1
  for (int it = 0; it < ktiles; ++it) {
    const int k0 = it * DEEP_TILE;
    // S = Q K^T for the warp's 16 rows and NTW x 8 keys, summed over d's chunks
    float sc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[j][r] = 0.f;
    }
#pragma unroll 1
    for (int c = 0; c < C; ++c, ++u) {
      deep_acquire<NS>(u, total, load);
      deep_scores<T, kSplit>(sc, qs + c * DEEP_CHUNK, QS, ring + (u % NS) * DEEP_TILE * CR, CR,
                             r0, key_off, g, t);
    }
    // log2 domain; keys >= n to -inf before the max (k0 < n: the max is finite)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = key_off + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(sp + (r0 + g + 8 * half) * DEEP_ST + key) = make_float2(
            k0 + key < n ? sc[j][2 * half] * scale_log2 : -INFINITY,
            k0 + key + 1 < n ? sc[j][2 * half + 1] * scale_log2 : -INFINITY);
      }
    }
    __syncthreads();
    // the online softmax of the tile: the row max over its TPR threads, alpha,
    // p = 2^(s - m) summed undropped, then masked by the hash, in place
    {
      float* sr = sp + srow * DEEP_ST + spart * KPT;
      float mx = m;
#pragma unroll
      for (int i = 0; i < KPT; ++i) mx = fmaxf(mx, sr[i]);
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2_ftz(m - mx);  // 0 on the first tile
      m = mx;
      l *= alpha;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        float p = exp2_ftz(sr[i] - mx);  // 0 for masked keys
        l += p;
        if (kDrop) {
          const uint32_t key = static_cast<uint32_t>(k0 + spart * KPT + i);
          p = kept(row_m1, key * dropout_hash::M2, bh_m3, seed, thresh) ? p : 0.f;
        }
        sr[i] = p;
      }
      if (spart == 0) rowv[srow] = alpha;
    }
    __syncthreads();
    // o = alpha o + Pa V, chunk by chunk: the tile's Pa V summed in a fresh C
    // fragment, then added to the shared o in f32
#pragma unroll 1
    for (int c = 0; c < C; ++c, ++u) {
      deep_acquire<NS>(u, total, load);
      float pv[NCW][4];
      deep_tile_product<T, kSplit>(pv, sp, ring + (u % NS) * DEEP_TILE * CR, r0, col_off, g, t);
      deep_accumulate<NCW>(acc, AS, r0, c * DEEP_CHUNK + col_off, pv, g, t, rowv);
    }
  }

  __syncthreads();  // every warp is done with the alphas
  {
    float lsum = l;
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    if (spart == 0) {
      rowv[srow] = 1.f / (kDrop ? lsum * keep_prob : lsum);
      if (q0 + srow < n)
        lse[static_cast<size_t>(bh) * n + q0 + srow] = (m + log2f(lsum)) * LN2;
    }
  }
  __syncthreads();
  deep_store<T, R>(o + head, acc, AS, d, q0, n, 1.f, rowv);
}

static_assert(fwd_deep_bytes<float>(DEEP_MAX_D) <= MAX_SMEM, "the deep forward must fit");

template <typename T, int R, bool kDrop>
cudaError_t launch_deep(const void* q, const void* k, const void* v, void* o, float* lse,
                        int bh, int n, int d, float scale, const long long* seed,
                        uint32_t thresh, float keep_prob, uint32_t bh0, cudaStream_t stream) {
  auto kernel = attention_fwd_deep_kernel<T, R, kDrop>;
  const int bytes = fwd_deep_bytes<T>(d);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((n + R - 1) / R) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, n, d, scale, seed, thresh, keep_prob, bh0);
  return cudaGetLastError();
}

template <typename T, bool kDrop>
cudaError_t dispatch_deep(const void* q, const void* k, const void* v, void* o, float* lse,
                          int bh, int n, int d, float scale, const long long* seed,
                          uint32_t thresh, float keep_prob, uint32_t bh0,
                          cudaStream_t stream) {
  if (d <= 256 || d > DEEP_MAX_D || d % DEEP_CHUNK) return cudaErrorInvalidValue;
  return deep_rows(d) == 32
             ? launch_deep<T, 32, kDrop>(q, k, v, o, lse, bh, n, d, scale, seed, thresh,
                                         keep_prob, bh0, stream)
             : launch_deep<T, 16, kDrop>(q, k, v, o, lse, bh, n, d, scale, seed, thresh,
                                         keep_prob, bh0, stream);
}

}  // namespace

// dtype: 0 = float32 (bfloat16 runs attention_fwd_large.cu); head dim d a
// multiple of 64 in 320 .. DEEP_MAX_D (1344); the other arguments as
// attention_fwd's (attention_fwd.cu).
extern "C" int attention_fwd_deep(const void* q, const void* k, const void* v,
                                  void* o, float* lse, int bh, int n, int d,
                                  int dtype, float scale, int dropout, const long long* seed,
                                  unsigned int thresh, float keep_prob, unsigned int bh0,
                                  void* stream) {
  if (bh <= 0 || n <= 0 || (dropout && seed == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ATTN_FWD_DEEP(T)                                                                \
  return dropout ? dispatch_deep<T, true>(q, k, v, o, lse, bh, n, d, scale, seed, thresh, \
                                          keep_prob, bh0, s)                              \
                 : dispatch_deep<T, false>(q, k, v, o, lse, bh, n, d, scale, seed, thresh, \
                                           keep_prob, bh0, s);
  switch (dtype) {
    case 0: ATTN_FWD_DEEP(float)
    default: return cudaErrorInvalidValue;  // bf16: attention_fwd_large.cu
  }
#undef ATTN_FWD_DEEP
}
