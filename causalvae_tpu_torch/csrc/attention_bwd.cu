// Multi-head attention backward for Hopper (sm_90a): dq, dk, dv of
// o = dropout(softmax(q k^T * scale)) v, for q, k, v, o, do of shape (BH, N, D),
// contiguous, f32 or bf16, and the forward's row logsumexp lse (BH, N) in f32.
//
// Replaces the Pallas TPU kernel _bwd_fused_kernel (causalvae_tpu/ops/kernels/
// attention.py). Same math, per (query i, key j):
//   p = exp(s - lse_i) with s = scale * q_i . k_j   (recomputed; no (N, N) in memory)
//   dp = do_i . v_j, masked by the dropout hash and scaled by 1 / (1 - rate)
//   pd = p masked and scaled the same way (what the forward multiplied v by)
//   delta_i = sum_d do_i * o_i                      (computed here, per query row)
//   ds = p * (dp - delta_i)
//   dv_j += pd * do_i,  dk_j += scale * ds * q_i,  dq_i += scale * ds * k_j
// Keys and queries at index >= N are masked by the loop bounds; nothing is padded.
//
// What bounds it on this card: operations. 10 * N * N * D flops per head against
// 9 * N * D elements in and out: at (BH, N, D) = (64, 961, 32) in f32, 18.9 GFLOP,
// ~0.28 ms at the f32 cores' 67 TFLOP/s, against ~0.01 ms for the bytes.
// The TPU kernel held a head's whole K and V and a (512, N) band of the score plane
// in VMEM and accumulated partial dk/dv into revisited output blocks across a
// sequential grid. Blocks on this card run in no order, so this is the simple
// deterministic design, with no atomics:
//   - attention_bwd_dkdv_kernel: one block per (head, tile of 64 keys), one thread
//     per key holding k_j, v_j and its dk_j, dv_j accumulators in registers; a loop
//     over tiles of 64 query rows staged (q, do as f32, lse, delta) in shared memory
//     and read by broadcast;
//   - attention_bwd_dq_kernel: one block per (head, tile of 64 query rows), one
//     thread per row holding q_i, do_i and dq_i; a loop over tiles of 64 keys staged
//     (k, v as f32) in shared memory.
// p and dp are recomputed by both kernels (14 instead of 10 N*N*D flops per head),
// each thread owns its outputs, and every sum runs in a fixed order, so the result is
// the same bits from run to run. Tensor cores, TMA and one-pass fusion are later work.
//
// C interface: attention_bwd(...) returns cudaGetLastError() after both launches
// (cudaErrorInvalidValue for a head dim or type it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dropout_hash.cuh"

namespace {

constexpr int BLOCK = 64;  // rows (or keys) per block = threads per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
__device__ __forceinline__ float dot_smem(const float* a_reg, const float* b_smem) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 b = *reinterpret_cast<const float4*>(b_smem + d);
    acc = fmaf(a_reg[d], b.x, acc);
    acc = fmaf(a_reg[d + 1], b.y, acc);
    acc = fmaf(a_reg[d + 2], b.z, acc);
    acc = fmaf(a_reg[d + 3], b.w, acc);
  }
  return acc;
}

template <int D>
__device__ __forceinline__ void axpy_smem(float a, const float* x_smem, float* y_reg) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(x_smem + d);
    y_reg[d] = fmaf(a, x.x, y_reg[d]);
    y_reg[d + 1] = fmaf(a, x.y, y_reg[d + 1]);
    y_reg[d + 2] = fmaf(a, x.z, y_reg[d + 2]);
    y_reg[d + 3] = fmaf(a, x.w, y_reg[d + 3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BLOCK)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ o,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          T* __restrict__ dk, T* __restrict__ dv, int n, float scale,
                          int dropout, uint32_t seed, uint32_t thresh,
                          float inv_keep) {
  __shared__ __align__(16) float qs[BLOCK][D];
  __shared__ __align__(16) float dos[BLOCK][D];
  __shared__ float lses[BLOCK];
  __shared__ float deltas[BLOCK];

  const int bh = blockIdx.y;
  const int col = blockIdx.x * BLOCK + threadIdx.x;  // this thread's key
  const bool active = col < n;
  const size_t head = static_cast<size_t>(bh) * n * D;

  float kr[D], vr[D], dkr[D], dvr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = active ? to_f32(k[head + static_cast<size_t>(col) * D + d]) : 0.f;
    vr[d] = active ? to_f32(v[head + static_cast<size_t>(col) * D + d]) : 0.f;
    dkr[d] = 0.f;
    dvr[d] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += BLOCK) {
    const int valid = min(BLOCK, n - q0);
    const size_t base = head + static_cast<size_t>(q0) * D;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < BLOCK * D; i += BLOCK) {
      const int r = i / D;
      const bool in = r < valid;
      qs[r][i % D] = in ? to_f32(q[base + i]) : 0.f;
      dos[r][i % D] = in ? to_f32(dout[base + i]) : 0.f;
    }
    __syncthreads();
    if (threadIdx.x < valid) {
      const int r = threadIdx.x;
      const T* orow = o + base + static_cast<size_t>(r) * D;
      float delta = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) delta = fmaf(dos[r][d], to_f32(orow[d]), delta);
      deltas[r] = delta;
      lses[r] = lse[static_cast<size_t>(bh) * n + q0 + r];
    }
    __syncthreads();
    if (!active) continue;

#pragma unroll 2
    for (int i = 0; i < valid; ++i) {
      const float p = expf(dot_smem<D>(kr, qs[i]) * scale - lses[i]);
      float dp = dot_smem<D>(vr, dos[i]);
      float pd = p;
      if (dropout) {
        const bool kept = dropout_hash::keep(seed, bh, q0 + i, col, thresh);
        pd = kept ? p * inv_keep : 0.f;
        dp = kept ? dp * inv_keep : 0.f;
      }
      const float ds = p * (dp - deltas[i]);
      axpy_smem<D>(pd, dos[i], dvr);
      axpy_smem<D>(ds, qs[i], dkr);
    }
  }

  if (active) {
    T* dkrow = dk + head + static_cast<size_t>(col) * D;
    T* dvrow = dv + head + static_cast<size_t>(col) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dkrow[d] = from_f32<T>(dkr[d] * scale);
      dvrow[d] = from_f32<T>(dvr[d]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BLOCK)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        T* __restrict__ dq, int n, float scale, int dropout,
                        uint32_t seed, uint32_t thresh, float inv_keep) {
  __shared__ __align__(16) float ks[BLOCK][D];
  __shared__ __align__(16) float vs[BLOCK][D];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * BLOCK + threadIdx.x;  // this thread's query
  const bool active = row < n;
  const size_t head = static_cast<size_t>(bh) * n * D;

  float qr[D], dor[D], dqr[D];
  float delta = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t at = head + static_cast<size_t>(row) * D + d;
    qr[d] = active ? to_f32(q[at]) : 0.f;
    dor[d] = active ? to_f32(dout[at]) : 0.f;
    delta = fmaf(dor[d], active ? to_f32(o[at]) : 0.f, delta);
    dqr[d] = 0.f;
  }
  const float lse_r = active ? lse[static_cast<size_t>(bh) * n + row] : 0.f;

  for (int k0 = 0; k0 < n; k0 += BLOCK) {
    const int valid = min(BLOCK, n - k0);
    const size_t base = head + static_cast<size_t>(k0) * D;
    __syncthreads();
    for (int i = threadIdx.x; i < BLOCK * D; i += BLOCK) {
      const int j = i / D;
      const bool in = j < valid;
      ks[j][i % D] = in ? to_f32(k[base + i]) : 0.f;
      vs[j][i % D] = in ? to_f32(v[base + i]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;

#pragma unroll 2
    for (int j = 0; j < valid; ++j) {
      const float p = expf(dot_smem<D>(qr, ks[j]) * scale - lse_r);
      float dp = dot_smem<D>(dor, vs[j]);
      if (dropout) {
        dp = dropout_hash::keep(seed, bh, row, k0 + j, thresh) ? dp * inv_keep : 0.f;
      }
      axpy_smem<D>(p * (dp - delta), ks[j], dqr);
    }
  }

  if (active) {
    T* dqrow = dq + head + static_cast<size_t>(row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dqrow[d] = from_f32<T>(dqr[d] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv,
                   int bh, int n, float scale, int dropout, uint32_t seed,
                   uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const dim3 grid((n + BLOCK - 1) / BLOCK, bh);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* gt = static_cast<const T*>(dout);
  attention_bwd_dkdv_kernel<T, D><<<grid, BLOCK, 0, stream>>>(
      qt, kt, vt, ot, gt, lse, static_cast<T*>(dk), static_cast<T*>(dv), n, scale,
      dropout, seed, thresh, inv_keep);
  attention_bwd_dq_kernel<T, D><<<grid, BLOCK, 0, stream>>>(
      qt, kt, vt, ot, gt, lse, static_cast<T*>(dq), n, scale, dropout, seed, thresh,
      inv_keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, void* dq, void* dk,
                       void* dv, int bh, int n, int d, float scale, int dropout,
                       uint32_t seed, uint32_t thresh, float inv_keep,
                       cudaStream_t stream) {
#define ATTN_BWD_D(DIM)                                                            \
  case DIM:                                                                        \
    return launch<T, DIM>(q, k, v, o, dout, lse, dq, dk, dv, bh, n, scale, dropout, \
                          seed, thresh, inv_keep, stream);
  switch (d) {
    ATTN_BWD_D(8)
    ATTN_BWD_D(16)
    ATTN_BWD_D(32)
    default: return cudaErrorInvalidValue;
  }
#undef ATTN_BWD_D
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head dim d in {8, 16, 32} (four (D) register
// arrays per thread; 64 would spill). Shapes (bh, n, d) for q, k, v, o, dout, dq,
// dk, dv and (bh, n) for lse. dropout: 0 = off; else keep iff hash >= thresh, kept
// entries scaled by inv_keep (= 1 / (1 - rate)). Launches on `stream` and does not
// synchronise.
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const float* lse,
                             void* dq, void* dk, void* dv, int bh, int n, int d,
                             int dtype, float scale, int dropout, unsigned int seed,
                             unsigned int thresh, float inv_keep, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, dout, lse, dq, dk, dv, bh, n, d,
                                     scale, dropout, seed, thresh, inv_keep, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, bh,
                                             n, d, scale, dropout, seed, thresh,
                                             inv_keep, s);
    default: return cudaErrorInvalidValue;
  }
}
