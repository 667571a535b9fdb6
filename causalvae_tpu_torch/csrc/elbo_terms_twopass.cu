// The earlier design of the vessel ELBO's two image sums (csrc/elbo_terms.cu before
// its redesign), kept only as chip_smoke.py's yardstick: phase 3 times it beside the
// one-launch kernel on the same card. Nothing in the port launches it. It computes
//   out[0] = sum((r - x)^2 * (1 + (pw - 1) * x)),   out[1] = sum(|r| * (x < 0.1))
// over flat float32 r and x with pw read from device memory, in two launches:
//   - stage 1: a grid of at most 1024 blocks of 256 threads walks the arrays with a
//     grid-stride loop of 4-byte loads; each block writes one partial pair;
//   - stage 2: one block folds the partials in a fixed order.
// Remove it once no table of PERF.md needs its time.
//
// C interface: elbo_terms_twopass(...) returns cudaGetLastError() after both launches.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;

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

__global__ void __launch_bounds__(THREADS)
elbo_partials_kernel(const float* __restrict__ r, const float* __restrict__ x,
                     const float* __restrict__ pw, long long n,
                     float* __restrict__ partials) {
  const float pw_minus_1 = *pw - 1.f;
  float rl = 0.f, sp = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < n; i += stride) {
    const float rv = r[i];
    const float xv = x[i];
    const float d = rv - xv;
    rl += d * d * (1.f + pw_minus_1 * xv);
    sp += fabsf(rv) * (xv < 0.1f ? 1.f : 0.f);
  }
  block_sum2(rl, sp);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = rl;
    partials[gridDim.x + blockIdx.x] = sp;
  }
}

__global__ void __launch_bounds__(THREADS)
elbo_fold_kernel(const float* __restrict__ partials, int blocks,
                 float* __restrict__ out) {
  float rl = 0.f, sp = 0.f;
  for (int i = threadIdx.x; i < blocks; i += THREADS) {
    rl += partials[i];
    sp += partials[blocks + i];
  }
  block_sum2(rl, sp);
  if (threadIdx.x == 0) {
    out[0] = rl;
    out[1] = sp;
  }
}

}  // namespace

// recon, x: n float32 each; pw: one float32; partials: 2 * blocks float32 of scratch;
// out: 2 float32. 1 <= blocks <= 1024. Launches on `stream` and does not synchronise.
extern "C" int elbo_terms_twopass(const float* recon, const float* x, const float* pw,
                                  long long n, float* partials, int blocks,
                                  float* out, void* stream) {
  if (n < 1 || blocks < 1 || blocks > MAX_BLOCKS) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  elbo_partials_kernel<<<blocks, THREADS, 0, s>>>(recon, x, pw, n, partials);
  elbo_fold_kernel<<<1, THREADS, 0, s>>>(partials, blocks, out);
  return cudaGetLastError();
}
