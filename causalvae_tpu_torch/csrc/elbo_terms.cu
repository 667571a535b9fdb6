// The vessel ELBO's image terms for Hopper (sm_90a): one launch forward, one backward.
//
// Forward (elbo_terms), over r (the reconstruction, float32 or bfloat16) and x (the
// target, float32) of n elements:
//   out[0] = sum((r - x)^2 * (1 + (pw - 1) * x))      weighted reconstruction
//   out[1] = sum(|r| * (x < 0.1))                      background sparsity
//   out[2] = pw
// pw is read from device memory where the caller gives it; otherwise it is the batch's
// positive weight, computed in the same pass: clamp((1 - f) / (f + 1e-6), 1, 50) with
// f = sum(x) / (n + 1e-6), rounded as torch rounds pos_weight(x) on the card (the
// division by the host scalar as a product with its float32 reciprocal). Each thread
// keeps S1 = sum d^2, S2 = sum d^2 x, S3 = sum |r| [x < 0.1] and Sx = sum x, and the
// fold gives out[0] = S1 + (pw - 1) S2. All four terms are non-negative on the
// training path (x is a {0, 1} mask, so Sx is exact in any order), so the split
// cancels nothing.
//
// Backward (elbo_terms_bwd), given g (the gradient of out[0] and out[1]) and pw:
//   d r = ((g0 * 2) * d) * w + (g1 * sign(r)) * [x < 0.1],     w = 1 + (pw - 1) * x
//   d x = g0 * (((-2) * d) * w + (d * d) * (pw - 1))           (only when asked)
// with d = r - x, each product and sum rounded once (__fmul_rn / __fadd_rn: nothing is
// contracted into an FMA), sign as torch's (0 at +-0 and NaN) and d r rounded to
// bfloat16 to nearest even for a bfloat16 r: the same bits as the plain backward of
// ops/kernels/elbo.py on the CPU.
//
// Replaces the Pallas TPU kernel _kernel / _pallas_terms
// (causalvae_tpu/ops/kernels/elbo.py), which streamed (512, 128) f32 blocks through
// VMEM and accumulated into one SMEM cell pair across a sequential grid, with
// pos_weight and the custom VJP's backward (_fused_bwd) left to XLA.
//
// What bounds it on this card: bytes. The forward reads 8 bytes per element (6 with a
// bfloat16 r) for ~12 flops, the backward reads 8 (6) and writes 4 (2), far below the
// ~20 flops per byte at which the f32 cores balance 3.35 TB/s. At the vessel batch
// (8, 768, 1280, 1) the forward moves 63 MB (47 MB), ~0.019 ms (0.014); the backward
// 94 MB (63 MB), ~0.028 ms (0.019).
// Design:
//   - 16-byte accesses: a vector is 16 bytes of r (4 float32 or 8 bfloat16, widened
//     in registers) and the matching float32 of x (one or two float4); each thread
//     issues the loads of UNROLL vectors before it uses any of them;
//   - one resident wave: the grid is the SM count times the fewest blocks an SM holds
//     of any kernel here (occupancy API, queried once per device by the caller: 4
//     blocks of 256 threads at the forward's 61 registers, 528 on an H100), at most one
//     block per 256 units of work, walking the vectors with a grid-stride loop;
//   - edges: the elements before r's first 16-byte boundary (the head) and after the
//     last whole vector (the tail) take a scalar path; where x, d r or d x are not
//     16-byte aligned at that boundary (a view with another offset) every element
//     takes it;
//   - the forward's cross-block fold in the same launch: each block writes its four
//     partials, fences, and takes a ticket; the last block to arrive folds all
//     partials in block order (FOLD rows of them loaded at once, so the fold costs
//     one L2 round trip at the vessel batch), writes out and resets the ticket to 0.
//     No float atomics: the same input gives the same bits from run to run on one
//     card.
// The ticket and the partials belong to one device and are used by one launch at a
// time: two streams must not run the forward on one device at once.
//
// C interface: elbo_terms_blocks(...) gives the grid, elbo_terms(...) and
// elbo_terms_bwd(...) launch and return cudaGetLastError() (cudaErrorInvalidValue for
// a shape or type they do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;  // vectors whose loads a thread issues together
constexpr int FOLD = 8;    // partials per sum a thread of the last block loads together

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 16 bytes of r at p (16-byte aligned) as floats; bfloat16 widens exactly.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
template <int N>
__device__ __forceinline__ void load_x(const float* p, float (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 q = reinterpret_cast<const float4*>(p)[k];
    v[4 * k] = q.x; v[4 * k + 1] = q.y; v[4 * k + 2] = q.z; v[4 * k + 3] = q.w;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

struct Sums {
  float s1, s2, s3, sx;  // sum d^2, sum d^2 x, sum |r| [x < 0.1], sum x
};

__device__ __forceinline__ void accumulate(Sums& a, float r, float x) {
  const float d = r - x;
  const float d2 = d * d;
  a.s1 += d2;
  a.s2 += d2 * x;
  a.s3 += fabsf(r) * (x < 0.1f ? 1.f : 0.f);
  a.sx += x;
}

// The four sums over the block, in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ void block_sum(Sums& a) {
  __shared__ Sums part[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a.s1 += __shfl_down_sync(0xffffffffu, a.s1, off);
    a.s2 += __shfl_down_sync(0xffffffffu, a.s2, off);
    a.s3 += __shfl_down_sync(0xffffffffu, a.s3, off);
    a.sx += __shfl_down_sync(0xffffffffu, a.sx, off);
  }
  if (lane == 0) part[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < THREADS / 32 ? part[lane] : Sums{0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a.s1 += __shfl_down_sync(0xffffffffu, a.s1, off);
      a.s2 += __shfl_down_sync(0xffffffffu, a.s2, off);
      a.s3 += __shfl_down_sync(0xffffffffu, a.s3, off);
      a.sx += __shfl_down_sync(0xffffffffu, a.sx, off);
    }
  }
}

// Where the vectors lie: elements [head, head + nvec * VEC) go 16 bytes at a time,
// the head [0, head) and the tail [head + nvec * VEC, n) one element at a time.
struct Split {
  long long n, head, nvec;
  int vec_n;  // elements of a vector (VEC)
  __device__ __forceinline__ long long scalars() const { return n - nvec * vec_n; }
  __device__ __forceinline__ long long scalar_index(long long i) const {
    return i < head ? i : i + nvec * vec_n;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
elbo_fwd_kernel(const T* __restrict__ r, const float* __restrict__ x, Split sp,
                const float* __restrict__ pw_given, float inv_count,
                float* __restrict__ partials, unsigned int* __restrict__ ticket,
                float* __restrict__ out) {
  constexpr int VEC = Vec<T>::N;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const T* rv = r + sp.head;
  const float* xv = x + sp.head;
  Sums acc{0.f, 0.f, 0.f, 0.f};
  long long v = tid;
  for (; v + (UNROLL - 1) * stride < sp.nvec; v += UNROLL * stride) {
    float a[UNROLL][VEC], b[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      load_vec(rv + (v + u * stride) * VEC, a[u]);
      load_x<VEC>(xv + (v + u * stride) * VEC, b[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < VEC; ++k) accumulate(acc, a[u][k], b[u][k]);
  }
  for (; v < sp.nvec; v += stride) {
    float a[VEC], b[VEC];
    load_vec(rv + v * VEC, a);
    load_x<VEC>(xv + v * VEC, b);
#pragma unroll
    for (int k = 0; k < VEC; ++k) accumulate(acc, a[k], b[k]);
  }
  for (long long i = tid; i < sp.scalars(); i += stride) {
    const long long e = sp.scalar_index(i);
    accumulate(acc, to_f32(r[e]), x[e]);
  }
  block_sum(acc);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    const int g = gridDim.x, b = blockIdx.x;
    partials[b] = acc.s1;
    partials[g + b] = acc.s2;
    partials[2 * g + b] = acc.s3;
    partials[3 * g + b] = acc.sx;
    __threadfence();
    last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(g - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: every other block's partials are visible; fold them in block order,
  // FOLD rows of partials loaded before any is added (one L2 round trip, not FOLD)
  Sums tot{0.f, 0.f, 0.f, 0.f};
  const int g = gridDim.x;
  for (int b0 = threadIdx.x; b0 < g; b0 += FOLD * THREADS) {
    float v[FOLD][4];
#pragma unroll
    for (int k = 0; k < FOLD; ++k) {
      const int b = b0 + k * THREADS;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k][j] = b < g ? __ldcg(partials + j * g + b) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < FOLD; ++k) {
      tot.s1 += v[k][0];
      tot.s2 += v[k][1];
      tot.s3 += v[k][2];
      tot.sx += v[k][3];
    }
  }
  block_sum(tot);
  if (threadIdx.x == 0) {
    float pw;
    if (pw_given != nullptr) {
      pw = *pw_given;
    } else {
      const float f = __fmul_rn(tot.sx, inv_count);
      pw = __fdiv_rn(__fsub_rn(1.f, f), __fadd_rn(f, 1e-6f));
      pw = pw < 1.f ? 1.f : (pw > 50.f ? 50.f : pw);  // a NaN stays NaN, as in clamp
    }
    out[0] = __fadd_rn(tot.s1, __fmul_rn(__fsub_rn(pw, 1.f), tot.s2));
    out[1] = tot.s3;
    out[2] = pw;
    *ticket = 0u;
  }
}

struct BwdScalars {
  float g0x2, g0, g1, pm1;  // g0 * 2, g0, g1, pw - 1
};

__device__ __forceinline__ float torch_sign(float r) {
  return __fsub_rn(r > 0.f ? 1.f : 0.f, r < 0.f ? 1.f : 0.f);
}

// d r (and d x) of one element, in the plain backward's order of operations.
__device__ __forceinline__ float grad_r(const BwdScalars& c, float r, float x, float& dx) {
  const float d = __fsub_rn(r, x);
  const float w = __fadd_rn(1.f, __fmul_rn(c.pm1, x));
  dx = __fmul_rn(c.g0, __fadd_rn(__fmul_rn(__fmul_rn(-2.f, d), w),
                                 __fmul_rn(__fmul_rn(d, d), c.pm1)));
  return __fadd_rn(__fmul_rn(__fmul_rn(c.g0x2, d), w),
                   __fmul_rn(__fmul_rn(c.g1, torch_sign(r)), x < 0.1f ? 1.f : 0.f));
}

template <typename T, bool DR, bool DX>
__global__ void __launch_bounds__(THREADS)
elbo_bwd_kernel(const T* __restrict__ r, const float* __restrict__ x, Split sp,
                const float* __restrict__ g, const float* __restrict__ pw,
                T* __restrict__ dr, float* __restrict__ dx) {
  constexpr int VEC = Vec<T>::N;
  BwdScalars c;
  c.g0 = g[0];
  c.g0x2 = __fmul_rn(c.g0, 2.f);
  c.g1 = g[1];
  c.pm1 = __fsub_rn(*pw, 1.f);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const T* rv = r + sp.head;
  const float* xv = x + sp.head;
  long long v = tid;
  for (; v + (UNROLL - 1) * stride < sp.nvec; v += UNROLL * stride) {
    float a[UNROLL][VEC], b[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      load_vec(rv + (v + u * stride) * VEC, a[u]);
      load_x<VEC>(xv + (v + u * stride) * VEC, b[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float gr[VEC], gx[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) gr[k] = grad_r(c, a[u][k], b[u][k], gx[k]);
      const long long e = sp.head + (v + u * stride) * VEC;
      if (DR) store_vec(dr + e, gr);
      if (DX) {
#pragma unroll
        for (int k = 0; k < VEC / 4; ++k)
          reinterpret_cast<float4*>(dx + e)[k] =
              make_float4(gx[4 * k], gx[4 * k + 1], gx[4 * k + 2], gx[4 * k + 3]);
      }
    }
  }
  for (; v < sp.nvec; v += stride) {
    float a[VEC], b[VEC], gr[VEC], gx[VEC];
    load_vec(rv + v * VEC, a);
    load_x<VEC>(xv + v * VEC, b);
#pragma unroll
    for (int k = 0; k < VEC; ++k) gr[k] = grad_r(c, a[k], b[k], gx[k]);
    const long long e = sp.head + v * VEC;
    if (DR) store_vec(dr + e, gr);
    if (DX) {
#pragma unroll
      for (int k = 0; k < VEC / 4; ++k)
        reinterpret_cast<float4*>(dx + e)[k] =
            make_float4(gx[4 * k], gx[4 * k + 1], gx[4 * k + 2], gx[4 * k + 3]);
    }
  }
  for (long long i = tid; i < sp.scalars(); i += stride) {
    const long long e = sp.scalar_index(i);
    float gx;
    const float gr = grad_r(c, to_f32(r[e]), x[e], gx);
    if (DR) store(dr + e, gr);
    if (DX) dx[e] = gx;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The vector split of n elements of r (element size `bytes`): the head up to r's first
// 16-byte boundary, whole vectors after it where every other pointer (x and, in the
// backward, d r and d x; nullptr is skipped) is 16-byte aligned there too, else none.
Split split(const void* r, int bytes, long long n, const void* const* others, int count) {
  const int vec_n = 16 / bytes;
  long long head = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(r) & 15u)) & 15u);
  bool ok = head % bytes == 0;
  head /= bytes;
  for (int k = 0; ok && k < count; ++k) {
    if (others[k] == nullptr) continue;
    const int elt = k == 0 || k == 2 ? 4 : bytes;  // x and d x are float32
    ok = aligned16(static_cast<const char*>(others[k]) + head * elt);
  }
  Split sp;
  sp.n = n;
  sp.vec_n = vec_n;
  sp.head = ok && head < n ? head : 0;
  sp.nvec = ok && head < n ? (n - head) / vec_n : 0;
  return sp;
}

// Blocks for one launch: one resident wave, at most one block per THREADS units of work.
int launch_blocks(const Split& sp, int resident) {
  const long long work = sp.nvec + (sp.n - sp.nvec * sp.vec_n);
  const long long want = (work + THREADS - 1) / THREADS;
  return static_cast<int>(want < 1 ? 1 : (want < resident ? want : resident));
}

template <typename T>
cudaError_t launch_fwd(const void* r, const float* x, long long n, const float* pw,
                       float* partials, int resident, unsigned int* ticket, float* out,
                       cudaStream_t s) {
  const void* others[1] = {x};
  const Split sp = split(r, sizeof(T), n, others, 1);
  // torch on the card divides a tensor by a host scalar as a product with the
  // scalar's float32 reciprocal
  const float inv_count = 1.0f / static_cast<float>(static_cast<double>(n) + 1e-6);
  elbo_fwd_kernel<T><<<launch_blocks(sp, resident), THREADS, 0, s>>>(
      static_cast<const T*>(r), x, sp, pw, inv_count, partials, ticket, out);
  return cudaGetLastError();
}

template <typename T, bool DR, bool DX>
cudaError_t launch_bwd(const void* r, const float* x, long long n, const float* g,
                       const float* pw, void* dr, float* dx, int resident,
                       cudaStream_t s) {
  const void* others[3] = {x, dr, dx};
  const Split sp = split(r, sizeof(T), n, others, 3);
  elbo_bwd_kernel<T, DR, DX><<<launch_blocks(sp, resident), THREADS, 0, s>>>(
      static_cast<const T*>(r), x, sp, g, pw, static_cast<T*>(dr), dx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_outputs(const void* r, const float* x, long long n, const float* g,
                               const float* pw, void* dr, float* dx, int resident,
                               cudaStream_t s) {
  if (dr != nullptr && dx != nullptr)
    return launch_bwd<T, true, true>(r, x, n, g, pw, dr, dx, resident, s);
  if (dr != nullptr) return launch_bwd<T, true, false>(r, x, n, g, pw, dr, dx, resident, s);
  if (dx != nullptr) return launch_bwd<T, false, true>(r, x, n, g, pw, dr, dx, resident, s);
  return cudaErrorInvalidValue;
}

template <typename K>
cudaError_t resident_blocks(K kernel, int dev, int sms, int& blocks) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                        THREADS, 0);
  if (err != cudaSuccess) return err;
  const int b = (per_sm > 0 ? per_sm : 1) * sms;
  blocks = blocks == 0 || b < blocks ? b : blocks;
  return cudaSuccess;
}

}  // namespace

// *blocks = the SM count of the current device times the fewest blocks of any of this
// file's kernels that one SM holds: the largest grid either entry launches, and the
// number of partials (of each of the four sums) that elbo_terms' scratch must hold.
extern "C" int elbo_terms_blocks(int* blocks) {
  int dev = 0, sms = 0, b = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = resident_blocks(elbo_fwd_kernel<float>, dev, sms, b)) != cudaSuccess ||
      (err = resident_blocks(elbo_fwd_kernel<__nv_bfloat16>, dev, sms, b)) != cudaSuccess ||
      (err = resident_blocks(elbo_bwd_kernel<float, true, true>, dev, sms, b)) != cudaSuccess ||
      (err = resident_blocks(elbo_bwd_kernel<__nv_bfloat16, true, true>, dev, sms, b)) !=
          cudaSuccess)
    return err;
  *blocks = b;
  return cudaSuccess;
}

// r: n values of r_dtype (0 = float32, 1 = bfloat16); x: n float32; pw: one float32,
// or nullptr to compute it from x; partials: 4 * blocks float32 of scratch and ticket
// one unsigned int, 0 between launches (both kept per device by the caller); blocks
// from elbo_terms_blocks; out: 3 float32. Launches on `stream`, does not synchronise.
extern "C" int elbo_terms(const void* r, int r_dtype, const float* x, long long n,
                          const float* pw, float* partials, int blocks,
                          unsigned int* ticket, float* out, void* stream) {
  if (n < 1 || blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r_dtype) {
    case 0: return launch_fwd<float>(r, x, n, pw, partials, blocks, ticket, out, s);
    case 1: return launch_fwd<__nv_bfloat16>(r, x, n, pw, partials, blocks, ticket, out, s);
    default: return cudaErrorInvalidValue;
  }
}

// r, x as above; g: the gradients of out[0] and out[1] (2 float32); pw: one float32;
// dr: n values of r_dtype or nullptr; dx: n float32 or nullptr (not both nullptr).
extern "C" int elbo_terms_bwd(const void* r, int r_dtype, const float* x, long long n,
                              const float* g, const float* pw, void* dr, float* dx,
                              int blocks, void* stream) {
  if (n < 1 || blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r_dtype) {
    case 0: return launch_bwd_outputs<float>(r, x, n, g, pw, dr, dx, blocks, s);
    case 1: return launch_bwd_outputs<__nv_bfloat16>(r, x, n, g, pw, dr, dx, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}
