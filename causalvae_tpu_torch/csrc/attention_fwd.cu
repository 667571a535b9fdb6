// Multi-head attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(D)) v
// and the row logsumexp, for q, k, v of shape (BH, N, D), contiguous, f32 or bf16.
//
// Replaces the Pallas TPU kernel _fwd_kernel (causalvae_tpu/ops/kernels/attention.py)
// at dropout rate 0, the serving path. Keys at index >= N are masked here, so the
// caller pads nothing (the TPU kernel needed N padded to a multiple of 128).
//
// What bounds it on this card: operations. At the vessel shape (BH = 8 * batch,
// N = 961, D = 32) the kernel does 4*N*N*D flops per head against 4*N*D elements of
// input and output, about 240 flops per byte in f32, far above the ~20 flops per
// byte at which the f32 CUDA cores (67 TFLOP/s) balance 3.35 TB/s of memory.
// The TPU design held one head's whole K and V in fast memory and took the softmax
// in one pass; in f32 that is 240 KB at N = 961, more than a block's 227 KB of
// shared memory. So this kernel is the simple online-softmax design instead:
//   - one block per (head, tile of BLOCK_M = 64 query rows), one thread per row,
//     holding its q row and its f32 accumulator in registers;
//   - a loop over tiles of BLOCK_N keys: the block stages K and V (as f32) in
//     shared memory, every thread reads them by broadcast, scores the tile into
//     registers, and folds it in with a running max and sum (one expf per score
//     and one per tile for the rescale);
//   - accumulation in f32, outputs o in the input type and lse in f32.
// Tensor cores (mma/wgmma), TMA and double buffering are left for later work.
//
// C interface: attention_fwd(...) returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head dim or type it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK_M = 64;  // query rows per block = threads per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

template <typename T, int D, int BLOCK_N>
__global__ void __launch_bounds__(BLOCK_M)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int n, float scale) {
  __shared__ __align__(16) float ks[BLOCK_N][D];
  __shared__ __align__(16) float vs[BLOCK_N][D];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * BLOCK_M + threadIdx.x;
  const bool active = row < n;
  const size_t head = static_cast<size_t>(bh) * n * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f32(q[head + static_cast<size_t>(row) * D + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;  // running max of the scaled scores
  float l = 0.f;        // running sum of exp(score - m)

  for (int k0 = 0; k0 < n; k0 += BLOCK_N) {
    const int valid = min(BLOCK_N, n - k0);
    const size_t base = head + static_cast<size_t>(k0) * D;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < BLOCK_N * D; i += BLOCK_M) {
      const int j = i / D;
      const bool in = j < valid;
      ks[j][i % D] = in ? to_f32(k[base + i]) : 0.f;
      vs[j][i % D] = in ? to_f32(v[base + i]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float s[BLOCK_N];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      s[j] = j < valid ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // Every tile holds at least one valid key, so m_new is finite; on the
    // first tile m = -inf and alpha = expf(-inf) = 0.
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for masked keys
      l += p;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (active) {
    T* out = o + head + static_cast<size_t>(row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = from_f32<T>(acc[d] / l);
    lse[static_cast<size_t>(bh) * n + row] = m + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int n, float scale, cudaStream_t stream) {
  constexpr int BLOCK_N = D <= 32 ? 64 : 32;  // keep s[] + q + acc in registers
  const dim3 grid((n + BLOCK_M - 1) / BLOCK_M, bh);
  attention_fwd_kernel<T, D, BLOCK_N><<<grid, BLOCK_M, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int n, int d, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(q, k, v, o, lse, bh, n, scale, stream);
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, n, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, n, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, n, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Shapes (bh, n, d) for q, k, v and o, (bh, n)
// for lse. Launches on `stream` and does not synchronise.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int bh, int n, int d,
                             int dtype, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, lse, bh, n, d, scale, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, n, d, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
