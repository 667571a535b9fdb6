// Per-channel reductions of train-mode BatchNorm for Hopper (sm_90a), over a
// contiguous tensor seen as (N, C, S): NCHW with S = H * W, or (B, C) with S = 1.
//   bn_stats: out[0][c] = sum x,   out[1][c] = sum x^2                       (forward)
//   bn_bwd:   out[0][c] = sum dy,  out[1][c] = sum dy * (x - mean[c]) * inv[c]  (backward)
// Sums are float32 whatever the input type (float32 or bfloat16).
//
// Replaces the Pallas TPU kernels _sum_sq_kernel and _dy_dyxhat_kernel behind
// _lane_reduce (causalvae_tpu/ops/kernels/batchnorm.py). Those viewed an NHWC tensor
// with C dividing 128 as (M, 128) rows, so that every one of the TPU's 128 lanes held
// one channel, and accumulated over a sequential grid; other shapes went to XLA. That
// restriction came from the TPU's lane width. Here every train-mode BatchNorm goes
// through these kernels: the 16 four-dimensional ones of the vessel model and the 2
// adapter ones on (B, C).
//
// What bounds it on this card: bytes. Two flops per element read (four in the
// backward) against 4 bytes (8), far below the ~20 flops per byte at which the f32
// cores balance 3.35 TB/s. The largest train-mode input is the decoder tail,
// (8, 16, 768, 1280) float32: 503 MB, ~0.15 ms for the statistics; ~1.0 GB, ~0.30 ms
// for the backward.
// Design: in NCHW each (n, c) row of S elements is contiguous, so
//   - stage 1: a grid of (C, N * split) blocks of 256 threads; block (c, n * split + j)
//     reads the j-th chunk of 4096 elements of row (n, c), neighbouring threads on
//     neighbouring addresses, keeps both sums in registers, folds them with warp
//     shuffles in a fixed order and writes one partial pair;
//   - stage 2: one block per channel folds its N * split partials in a fixed order.
// No float atomics: the same input gives the same bits from run to run.
//
// Channels-last entries (bn_stats_rows, bn_bwd_rows) take a contiguous (M, C) tensor:
// the NHWC activations of the phase-packed model, M = B*H*W rows of C channels, read in
// place instead of being copied to NCHW. Stage 1 there is a grid of (ceil(C / 32),
// ceil(M / 256)) blocks: 32 neighbouring channels (one 128-byte row segment per warp)
// by 8 row lanes over a chunk of 256 rows, folded over the lanes in a fixed order into
// one partial pair per (chunk, channel); stage 2 folds the chunks of each channel.
//
// C interface: bn_stats(...), bn_bwd(...), bn_stats_rows(...) and bn_bwd_rows(...)
// return cudaGetLastError() after both launches (cudaErrorInvalidValue for a type or a
// shape they do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;                // elements per thread of a chunk
constexpr int CHUNK = THREADS * ITEMS;   // elements of one (n, c) row per block
constexpr int MAX_SLABS = 65535;         // grid.y limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Sum of (a, b) over the block, in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[THREADS / 32], sb[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < THREADS / 32 ? sa[lane] : 0.f;
    b = lane < THREADS / 32 ? sb[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
  }
}

// partials: (2, C, slabs) float32, slabs = gridDim.y = N * split.
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
bn_partials_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ mean, const float* __restrict__ inv,
                   int C, int S, int split, float* __restrict__ partials) {
  const int c = blockIdx.x;
  const int slab = blockIdx.y;
  const int n = slab / split;
  const int s0 = (slab - n * split) * CHUNK;
  const int s1 = min(S, s0 + CHUNK);
  const size_t row = (static_cast<size_t>(n) * C + c) * S;
  float mu = 0.f, iv = 0.f;
  if (BWD) {
    mu = mean[c];
    iv = inv[c];
  }
  float a = 0.f, b = 0.f;
#pragma unroll 4
  for (int s = s0 + threadIdx.x; s < s1; s += THREADS) {
    const float xv = to_f32(x[row + s]);
    if (BWD) {
      const float g = to_f32(dy[row + s]);
      a += g;
      b += g * ((xv - mu) * iv);
    } else {
      a += xv;
      b += xv * xv;
    }
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    const int slabs = gridDim.y;
    partials[static_cast<size_t>(c) * slabs + slab] = a;
    partials[(static_cast<size_t>(C) + c) * slabs + slab] = b;
  }
}

// out: (2, C) float32.
__global__ void __launch_bounds__(THREADS)
bn_fold_kernel(const float* __restrict__ partials, int C, int slabs,
               float* __restrict__ out) {
  const int c = blockIdx.x;
  const float* pa = partials + static_cast<size_t>(c) * slabs;
  const float* pb = partials + (static_cast<size_t>(C) + c) * slabs;
  float a = 0.f, b = 0.f;
  for (int i = threadIdx.x; i < slabs; i += THREADS) {
    a += pa[i];
    b += pb[i];
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    out[c] = a;
    out[C + c] = b;
  }
}

int split_of(int S) { return (S + CHUNK - 1) / CHUNK; }

template <typename T, bool BWD>
cudaError_t launch(const void* x, const void* dy, const float* mean,
                   const float* inv, int N, int C, int S, float* partials,
                   float* out, cudaStream_t stream) {
  const int split = split_of(S);
  const dim3 grid(C, N * split);
  bn_partials_kernel<T, BWD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, C, S, split,
      partials);
  bn_fold_kernel<<<C, THREADS, 0, stream>>>(partials, C, N * split, out);
  return cudaGetLastError();
}

bool bad_shape(int N, int C, int S) {
  return N < 1 || C < 1 || S < 1 ||
         static_cast<long long>(N) * split_of(S) > MAX_SLABS;
}

constexpr int ROWS = 256;  // rows of one chunk in the channels-last entries

// partials: (2, chunks, C) float32, chunks = gridDim.y.
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
bn_rows_partials_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ mean, const float* __restrict__ inv,
                        int M, int C, float* __restrict__ partials) {
  __shared__ float sa[THREADS / 32][32], sb[THREADS / 32][32];
  const int lane = threadIdx.x & 31, rl = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int r0 = blockIdx.y * ROWS, r1 = min(M, r0 + ROWS);
  float a = 0.f, b = 0.f;
  if (c < C) {
    float mu = 0.f, iv = 0.f;
    if (BWD) {
      mu = mean[c];
      iv = inv[c];
    }
    for (int r = r0 + rl; r < r1; r += THREADS / 32) {
      const size_t i = static_cast<size_t>(r) * C + c;
      const float xv = to_f32(x[i]);
      if (BWD) {
        const float g = to_f32(dy[i]);
        a += g;
        b += g * ((xv - mu) * iv);
      } else {
        a += xv;
        b += xv * xv;
      }
    }
  }
  sa[rl][lane] = a;
  sb[rl][lane] = b;
  __syncthreads();
  if (rl == 0 && c < C) {
    a = b = 0.f;
    for (int k = 0; k < THREADS / 32; ++k) {
      a += sa[k][lane];
      b += sb[k][lane];
    }
    partials[static_cast<size_t>(blockIdx.y) * C + c] = a;
    partials[(static_cast<size_t>(gridDim.y) + blockIdx.y) * C + c] = b;
  }
}

// out: (2, C) float32; one thread per channel folds its chunks in order.
__global__ void __launch_bounds__(THREADS)
bn_rows_fold_kernel(const float* __restrict__ partials, int C, int chunks,
                    float* __restrict__ out) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int i = 0; i < chunks; ++i) {
    a += partials[static_cast<size_t>(i) * C + c];
    b += partials[(static_cast<size_t>(chunks) + i) * C + c];
  }
  out[c] = a;
  out[C + c] = b;
}

template <typename T, bool BWD>
cudaError_t launch_rows(const void* x, const void* dy, const float* mean, const float* inv,
                        int M, int C, float* partials, float* out, cudaStream_t stream) {
  const int chunks = (M + ROWS - 1) / ROWS;
  const dim3 grid((C + 31) / 32, chunks);
  bn_rows_partials_kernel<T, BWD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, M, C, partials);
  bn_rows_fold_kernel<<<(C + THREADS - 1) / THREADS, THREADS, 0, stream>>>(partials, C,
                                                                          chunks, out);
  return cudaGetLastError();
}

bool bad_rows(int M, int C) { return M < 1 || C < 1 || (M + ROWS - 1) / ROWS > MAX_SLABS; }

}  // namespace

// Scratch `partials` must hold 2 * C * N * ceil(S / 4096) float32; `out` 2 * C.
// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` and does not synchronise.
extern "C" int bn_stats(const void* x, int N, int C, int S, int dtype,
                        float* partials, float* out, void* stream) {
  if (bad_shape(N, C, S)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, false>(x, nullptr, nullptr, nullptr, N, C, S,
                                        partials, out, s);
    case 1: return launch<__nv_bfloat16, false>(x, nullptr, nullptr, nullptr, N, C,
                                                S, partials, out, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int bn_bwd(const void* dy, const void* x, const float* mean,
                      const float* inv, int N, int C, int S, int dtype,
                      float* partials, float* out, void* stream) {
  if (bad_shape(N, C, S)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, true>(x, dy, mean, inv, N, C, S, partials, out, s);
    case 1: return launch<__nv_bfloat16, true>(x, dy, mean, inv, N, C, S, partials,
                                               out, s);
    default: return cudaErrorInvalidValue;
  }
}

// Channels-last (M, C): scratch `partials` must hold 2 * C * ceil(M / 256) float32.
extern "C" int bn_stats_rows(const void* x, int M, int C, int dtype, float* partials,
                             float* out, void* stream) {
  if (bad_rows(M, C)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_rows<float, false>(x, nullptr, nullptr, nullptr, M, C, partials,
                                             out, s);
    case 1: return launch_rows<__nv_bfloat16, false>(x, nullptr, nullptr, nullptr, M, C,
                                                     partials, out, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int bn_bwd_rows(const void* dy, const void* x, const float* mean,
                           const float* inv, int M, int C, int dtype, float* partials,
                           float* out, void* stream) {
  if (bad_rows(M, C)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_rows<float, true>(x, dy, mean, inv, M, C, partials, out, s);
    case 1: return launch_rows<__nv_bfloat16, true>(x, dy, mean, inv, M, C, partials,
                                                    out, s);
    default: return cudaErrorInvalidValue;
  }
}
