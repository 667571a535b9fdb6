// Stage backward for Hopper (sm_90a): every cotangent of stage_fwd.cu's
//   y = conv_same_KxK(leaky(x * mul + add, slope)) + bias
// from x, dy, mul, add and W:
//   da   = conv_same(dy, W rotated and transposed), pad K-1-pad_lo   (dgrad)
//   dx   = da * leaky'(pre) * mul,  pre = x * mul + add
//   dmul = sum over pixels of da * leaky'(pre) * x,   dadd = sum of da * leaky'(pre)
//   dW[u, v] = sum over pixels p of a[p + (u, v) - pad_lo]^T dy[p]      (wgrad)
//   db   = sum over pixels of dy
// x, dy, W, dx in x's type (float32 or bfloat16); dW, db, dmul, dadd float32. Without a
// prologue, a = x, dx = da and dmul/dadd are left as the caller set them.
//
// Replaces the Pallas TPU kernel _stage_bwd_kernel / _stage_bwd_call
// (causalvae_tpu/ops/kernels/stage.py), which read x and dy once per image and carried
// dW, db, dmul and dadd across a sequential grid over the batch. Blocks here run in no
// order, so the reductions are split and folded instead, without atomics: the same
// inputs give the same bits from run to run.
//
// What bounds it on this card: operations, twice the forward's lifted work (dgrad and
// wgrad each 2 * B*H*W * K*K * Ci * Co flops) in float32 FMA on the CUDA cores.
// Design:
//   1. dgrad: stage_gemm.cuh's implicit GEMM over dy (M = pixels, N = Ci, depth
//      K*K*Co); its epilogue recomputes pre from x, writes dx, and writes per-block
//      column partials of dmul and dadd;
//   2. wgrad: one GEMM per tap, M = Ci, N = Co, depth = pixels, split over pixel
//      ranges (split-K); the A tile recomputes the activation from x as it loads (zero
//      outside the image), the B tile is dy; each split writes its partial dW;
//   3. db: column sums of dy over row chunks;
//   4. folds: each partial set is summed over its splits in a fixed order.
//
// C interface: stage_bwd(...) returns cudaGetLastError() after its launches;
// stage_bwd_scratch_floats(...) gives the float32 scratch it needs.

#include "stage_gemm.cuh"

namespace {

using stage::BK;
using stage::BM;
using stage::THREADS;

constexpr int DB_ROWS = 256;  // rows of dy per column-sum block

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1).
struct FastDiv {
  unsigned d, mult, shift;
  __device__ __forceinline__ int div(int n) const {
    const unsigned t = __umulhi(static_cast<unsigned>(n), mult);
    return static_cast<int>((t + static_cast<unsigned>(n)) >> shift);
  }
};

FastDiv make_fastdiv(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, static_cast<unsigned>(m), s};
}

struct WgradArgs {
  const void* x;
  const void* dy;
  const float* mul;
  const float* add;
  float* partials;  // (splits, K*K, Ci, Co)
  int B, H, W, Ci, Co, K, pad_lo;
  float slope;
  int has_prologue;
  int span;         // pixels per split, a multiple of BK
  FastDiv hw, w;
};

// grid: x = Ci tiles * Co tiles, y = split, z = tap (u * K + v).
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) wgrad_kernel(const WgradArgs p) {
  using namespace stage;
  constexpr int TN = BN / 16;
  constexpr int BLOADS = BN * BK / THREADS;
  __shared__ __align__(16) Tiles<BN> sm;
  const T* X = static_cast<const T*>(p.x);
  const T* DY = static_cast<const T*>(p.dy);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int M = p.B * p.H * p.W;
  const int co_tiles = (p.Co + BN - 1) / BN;
  const int ci0 = (blockIdx.x / co_tiles) * BM;
  const int co0 = (blockIdx.x % co_tiles) * BN;
  const int tap = blockIdx.z;
  const int dh = tap / p.K - p.pad_lo, dw = tap % p.K - p.pad_lo;
  const int p_begin = blockIdx.y * p.span;
  const int p_end = min(M, p_begin + p.span);
  const int KT = p_end > p_begin ? (p_end - p_begin + BK - 1) / BK : 0;

  // A loads: channel ci (fixed for the block's life), pixels t / 128 + 2 i of the step
  const int ci = ci0 + t % BM;
  const bool ci_ok = ci < p.Ci;
  float mu = 1.f, ad = 0.f;
  if (p.has_prologue && ci_ok) {
    mu = p.mul[ci];
    ad = p.add[ci];
  }
  float ra[4], rb[BLOADS];
  auto b_coords = [&](int j, int& kb, int& nb) {
    kb = t / BN + (THREADS / BN) * j;
    nb = t % BN;
  };
  auto load = [&](int kt) {
    const int pbase = p_begin + kt * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pix = pbase + t / BM + 2 * i;
      float v = 0.f;
      if (pix < p_end && ci_ok) {
        const int b = p.hw.div(pix);
        const int rem = pix - b * p.H * p.W;
        const int h = p.w.div(rem);
        const int sh = h + dh, sw = rem - h * p.W + dw;
        if (sh >= 0 && sh < p.H && sw >= 0 && sw < p.W) {
          v = to_f32(X[(static_cast<long long>(b * p.H + sh) * p.W + sw) * p.Ci + ci]);
          if (p.has_prologue) v = round_to<T>(leaky(affine(v, mu, ad), p.slope));
        }
      }
      ra[i] = v;
    }
#pragma unroll
    for (int j = 0; j < BLOADS; ++j) {
      int kb, nb;
      b_coords(j, kb, nb);
      const int pix = pbase + kb, n = co0 + nb;
      rb[j] = (pix < p_end && n < p.Co)
          ? to_f32(DY[static_cast<long long>(pix) * p.Co + n]) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sm.a[buf][t / BM + 2 * i][t % BM] = ra[i];
#pragma unroll
    for (int j = 0; j < BLOADS; ++j) {
      int kb, nb;
      b_coords(j, kb, nb);
      sm.b[buf][kb][nb] = rb[j];
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  if (KT > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
    mma_step<BN>(sm.a[cur], sm.b[cur], ty, tx, acc);
    if (kt + 1 < KT) store(cur ^ 1);
    __syncthreads();
  }
  const long long base =
      (static_cast<long long>(blockIdx.y) * gridDim.z + tap) * p.Ci;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = ci0 + row_of(ty, i);
    if (c >= p.Ci) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = co0 + col_of(tx, j);
      if (n < p.Co) p.partials[(base + c) * p.Co + n] = acc[i][j];
    }
  }
}

// part[chunk][c] = sum of dy[r][c] over the chunk's DB_ROWS rows, in order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
colsum_kernel(const T* __restrict__ dy, int M, int C, float* __restrict__ part) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const int r0 = blockIdx.y * DB_ROWS, r1 = min(M, r0 + DB_ROWS);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += stage::to_f32(dy[static_cast<long long>(r) * C + c]);
  part[static_cast<long long>(blockIdx.y) * C + c] = s;
}

// out[l] = sum over s < S, in order, of part[s * L + l].
__global__ void __launch_bounds__(THREADS)
fold_kernel(const float* __restrict__ part, int S, long long L, float* __restrict__ out) {
  const long long l = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (l >= L) return;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s += part[static_cast<long long>(i) * L + l];
  out[l] = s;
}

cudaError_t fold(const float* part, int S, long long L, float* out, cudaStream_t s) {
  const long long blocks = (L + THREADS - 1) / THREADS;
  fold_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(part, S, L, out);
  return cudaGetLastError();
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

struct Scratch {
  long long dw, dgrad, db;  // float offsets: wgrad partials, dmul/dadd partials, db partials
  long long total;
};

Scratch scratch_layout(int M, int Ci, int Co, int K, int splits) {
  Scratch s;
  s.dw = 0;
  s.dgrad = static_cast<long long>(splits) * K * K * Ci * Co;
  s.db = s.dgrad + 2 * ceil_div(M, BM) * Ci;
  s.total = s.db + ceil_div(M, DB_ROWS) * Co;
  return s;
}

template <typename T>
cudaError_t backward(const void* x, const void* dy, const float* mul, const float* add,
                     const void* w, void* dx, float* dw, float* db, float* dmul,
                     float* dadd, int B, int H, int W, int Ci, int Co, int K, int pad_lo,
                     float slope, int has_prologue, int splits, float* scratch,
                     cudaStream_t s) {
  const int M = B * H * W;
  const Scratch lay = scratch_layout(M, Ci, Co, K, splits);
  cudaError_t err;
  // 1. dgrad, with the dmul/dadd partials in its epilogue
  stage::ConvArgs d{dy, w, mul, add, nullptr, x, dx, scratch + lay.dgrad,
                    B, H, W, Ci, Co, K, pad_lo, slope, has_prologue};
  if ((err = stage::launch_conv_gemm<T, true>(d, s)) != cudaSuccess) return err;
  if (has_prologue) {
    const int mb = static_cast<int>(ceil_div(M, BM));
    if ((err = fold(scratch + lay.dgrad, mb, Ci, dmul, s)) != cudaSuccess) return err;
    if ((err = fold(scratch + lay.dgrad + static_cast<long long>(mb) * Ci, mb, Ci, dadd,
                    s)) != cudaSuccess)
      return err;
  }
  // 2. wgrad, split over pixel ranges, then folded
  const int span = static_cast<int>(ceil_div(ceil_div(M, splits), BK) * BK);
  WgradArgs g{x, dy, mul, add, scratch + lay.dw, B, H, W, Ci, Co, K, pad_lo, slope,
              has_prologue, span, make_fastdiv(H * W), make_fastdiv(W)};
  const int bn = Co <= 64 ? 64 : 128;
  const dim3 grid(static_cast<unsigned>(ceil_div(Ci, BM) * ceil_div(Co, bn)), splits, K * K);
  if (bn == 64) {
    wgrad_kernel<T, 64><<<grid, THREADS, 0, s>>>(g);
  } else {
    wgrad_kernel<T, 128><<<grid, THREADS, 0, s>>>(g);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = fold(scratch + lay.dw, splits, static_cast<long long>(K) * K * Ci * Co, dw,
                  s)) != cudaSuccess)
    return err;
  // 3. db
  const dim3 cgrid(static_cast<unsigned>(ceil_div(Co, THREADS)),
                   static_cast<unsigned>(ceil_div(M, DB_ROWS)));
  colsum_kernel<T><<<cgrid, THREADS, 0, s>>>(static_cast<const T*>(dy), M, Co,
                                             scratch + lay.db);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return fold(scratch + lay.db, static_cast<int>(ceil_div(M, DB_ROWS)), Co, db, s);
}

}  // namespace

extern "C" long long stage_bwd_scratch_floats(int M, int Ci, int Co, int K, int splits) {
  return scratch_layout(M, Ci, Co, K, splits).total;
}

// dtype: 0 = float32, 1 = bfloat16; 1 <= splits <= 65535. `scratch` holds
// stage_bwd_scratch_floats(B*H*W, Ci, Co, K, splits) float32. Launches on `stream` and
// does not synchronise.
extern "C" int stage_bwd(const void* x, const void* dy, const float* mul, const float* add,
                         const void* w, void* dx, float* dw, float* db, float* dmul,
                         float* dadd, int B, int H, int W, int Ci, int Co, int K,
                         int pad_lo, float slope, int has_prologue, int dtype, int splits,
                         float* scratch, void* stream) {
  if (stage::bad_conv_shape(B, H, W, Ci, Co, K, pad_lo) || splits < 1 || splits > 65535 ||
      ceil_div(static_cast<long long>(B) * H * W, DB_ROWS) > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return backward<float>(x, dy, mul, add, w, dx, dw, db, dmul, dadd, B, H, W, Ci, Co, K,
                             pad_lo, slope, has_prologue, splits, scratch, s);
    case 1:
      return backward<__nv_bfloat16>(x, dy, mul, add, w, dx, dw, db, dmul, dadd, B, H, W,
                                     Ci, Co, K, pad_lo, slope, has_prologue, splits,
                                     scratch, s);
    default: return cudaErrorInvalidValue;
  }
}
