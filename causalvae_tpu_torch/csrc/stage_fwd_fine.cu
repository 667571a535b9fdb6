// Stage forward on the fine grid for Hopper (sm_90a): the same function as stage_fwd.cu,
//   y = conv(leaky(x * mul + add, slope)) + bias
// on phase-packed tensors, but computed as the model's own 3x3 convolution on the fine
// (unpacked) pixel grid, with only its real taps, reading x and writing y where they lie
// in packed storage. A tensor packed L levels is (B, Hc, Wc, 4^L * C); fine pixel (h, w),
// channel c, lives at [b, h >> L, w >> L, phase * C + c] with
//   phase = sum_{k < L} (2 * ((h >> k) & 1) + ((w >> k) & 1)) * 4^k
// (the finest bit pair innermost; ops/subpixel.py packed_offset, space_to_depth_n).
// The base kernel is (3, 3, Ci, Co) in x's type, the tensor ops/subpixel.py lifts:
//   conv  (recipe 0): pad-1 stride-1, y fine (h, w) <- x fine (h + u - 1, w + v - 1), levels
//                     L in and out;
//   stem  (recipe 1): pad-1 stride-2, y fine (h, w) <- x fine (2h + u - 1, 2w + v - 1), L in,
//                     L - 1 out;
//   convT (recipe 2): torch ConvTranspose2d(3, stride 2, padding 1, output_padding 1) with
//                     W[kh][kw][ci][co] = weight[ci][co][kh][kw]; output fine 2q + a on each
//                     axis takes k = 1 at input q (a = 0), or k = 2 at q and k = 0 at q + 1
//                     (a = 1); L in, L + 1 out.
// mul/add are per packed input channel (4^L_in * Ci,), bias per packed output channel, all
// float32. Zero padding comes after the activation, at the fine image's edge. Sums are
// float32 FMA (no TF32); in bfloat16 the activation rounds to bf16 before the product, as
// the plain version casts it, and the prologue rounds as stage_gemm.cuh's affine does.
//
// Replaces the Pallas TPU kernel _stage_kernel / _stage_call
// (causalvae_tpu/ops/kernels/stage.py), row 6 of PERF.md's kernel table, on the model's
// path (stage_fwd.cu, the lifted form, stays for the generic op).
//
// What bounds it on this card: the real work is small. The lifted kernels carried 807
// GFLOP per packed-fused forward, 120 of it real; counted on the real taps and on each
// byte read or written once, the large shapes are operations-bound at 67 TFLOP/s only
// when Co >= 32, and the three decoder-tail shapes (Co <= 16, 0.5-0.6 GB of packed
// activations each, a few GFLOP) are bytes-bound at 3.35 TB/s.
// Design, two paths:
// - GEMM path (Co > 16): the implicit GEMM of stage_gemm.cuh (Tiles, mma_step; 128 x 64/128
//   block tiles, depth 8) with M = fine output pixels (for convT those of one output
//   phase, blockIdx.z, so the reduction runs over exactly that phase's 1, 2 or 4 taps),
//   N = Co, depth = real taps x Ci. The A gather maps each fine pixel to its packed
//   address and applies the prologue with its packed channel's mul/add; the epilogue
//   stores to the packed output address.
// - Direct path (Co <= 16): a block owns a 16 x 16 tile of fine pixels made of whole
//   coarse pixels (output pixels for conv/stem, input pixels for convT). It stages the
//   activated input window once in shared memory (the prologue runs once per element, not
//   once per tap) with the base kernel, in channel chunks; each thread computes all Co
//   outputs of one fine pixel (convT: of the four output pixels 2q + (a, b) of its input
//   pixel q, nine taps, no divergence). Threads follow the packed phase order, so the
//   4^L * Co outputs of a coarse pixel are written as one contiguous run.
//
// C interface: stage_fwd_fine(...) returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a type or a shape it does not take).

#include "stage_gemm.cuh"

namespace fine {

using stage::BK;
using stage::BM;
using stage::THREADS;

enum Recipe { CONV = 0, STEM = 1, CONVT = 2 };

constexpr int TILE = 16;                    // direct path: fine pixels per tile side
constexpr int SMEM_LIMIT = 48 * 1024;       // direct path: dynamic shared memory per block

struct FineArgs {
  const void* x;       // (B, Hc, Wc, 4^Lin * Ci) packed
  const void* w;       // (3, 3, Ci, Co) base kernel
  const float* mul;    // (4^Lin * Ci,)
  const float* add;
  const float* bias;   // (4^Lout * Co,)
  void* y;             // (B, Hc, Wc, 4^Lout * Co) packed
  int B, Hc, Wc, Ci, Co, Lin, Lout, recipe;
  float slope;
  int has_prologue;
};

// The packed phase of fine pixel (h, w) at `levels` levels.
__device__ __forceinline__ int phase_of(int h, int w, int levels) {
  int p = 0;
  for (int k = 0; k < levels; ++k) p |= ((((h >> k) & 1) << 1) | ((w >> k) & 1)) << (2 * k);
  return p;
}

// Fine offsets (dh, dw) inside its coarse pixel of the phase p: the inverse of phase_of.
__device__ __forceinline__ void unphase(int p, int levels, int& dh, int& dw) {
  dh = dw = 0;
  for (int k = 0; k < levels; ++k) {
    dh |= ((p >> (2 * k + 1)) & 1) << k;
    dw |= ((p >> (2 * k)) & 1) << k;
  }
}

// Element offset of channel 0 of coarse pixel (b, ch, cw) in a tensor with C channels per
// fine pixel packed `levels` times.
__device__ __forceinline__ long long coarse_offset(const FineArgs& p, int b, int ch, int cw,
                                                   int C, int levels) {
  return ((static_cast<long long>(b) * p.Hc + ch) * p.Wc + cw) *
         (static_cast<long long>(C) << (2 * levels));
}

// The taps of one axis for an output at sub-position a (convT's output phase bit, else 0):
// kernel index k[i] and input offset d[i] from the row's base input coordinate.
__device__ __forceinline__ int axis_taps(int recipe, int a, int (&k)[3], int (&d)[3]) {
  if (recipe == CONVT) {
    k[0] = a == 0 ? 1 : 2; d[0] = 0;
    k[1] = 0; d[1] = 1;
    k[2] = 0; d[2] = 0;
    return a == 0 ? 1 : 2;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    k[i] = i;
    d[i] = i - 1;
  }
  return 3;
}

// The activated value of x at fine input pixel (b, h, w), channel c (0 outside the image).
template <typename T>
__device__ __forceinline__ float activated(const FineArgs& p, const T* X, int b, int h, int w,
                                           int c, int Hin, int Win) {
  if (h < 0 || h >= Hin || w < 0 || w >= Win) return 0.f;
  const int pc = phase_of(h, w, p.Lin) * p.Ci + c;
  float v = stage::to_f32(X[coarse_offset(p, b, h >> p.Lin, w >> p.Lin, p.Ci, p.Lin) + pc]);
  if (p.has_prologue) {
    v = stage::round_to<T>(stage::leaky(stage::affine(v, p.mul[pc], p.add[pc]), p.slope));
  }
  return v;
}

// GEMM path. Rows: the M grid of fine pixels (output pixels for conv and stem, input pixels
// q of output phase blockIdx.z for convT), columns: Co, depth: taps x Ci.
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) fine_gemm_kernel(const FineArgs p) {
  constexpr int TN = BN / 16;
  constexpr int BLOADS = BN * BK / THREADS;
  __shared__ __align__(16) stage::Tiles<BN> sm;
  const T* X = static_cast<const T*>(p.x);
  const T* Wt = static_cast<const T*>(p.w);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const bool convt = p.recipe == CONVT;
  const int s_in = p.recipe == STEM ? 2 : 1;  // input coordinate of a row = s_in * row + d
  const int s_out = convt ? 2 : 1;            // output coordinate = s_out * row + phase bit
  const int Hin = p.Hc << p.Lin, Win = p.Wc << p.Lin;
  const int Hm = convt ? Hin : p.Hc << p.Lout, Wm = convt ? Win : p.Wc << p.Lout;
  const int M = p.B * Hm * Wm;
  const int pa = convt ? static_cast<int>(blockIdx.z) >> 1 : 0;
  const int pb = convt ? static_cast<int>(blockIdx.z) & 1 : 0;
  int kh[3], dh[3], kw[3], dw[3];
  const int nth = axis_taps(p.recipe, pa, kh, dh);
  const int ntw = axis_taps(p.recipe, pb, kw, dw);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int chunks = (p.Ci + BK - 1) / BK;
  const int KT = nth * ntw * chunks;

  // A loads: channel column ka of the k-step, rows m0 + t / 8 + 32 i
  const int ka = t % BK;
  int ab[4], ah[4], aw[4];
  bool am[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + t / BK + 32 * i;
    am[i] = m < M;
    const int mm = am[i] ? m : 0;
    ab[i] = mm / (Hm * Wm);
    const int rem = mm - ab[i] * Hm * Wm;
    ah[i] = rem / Wm;
    aw[i] = rem - ah[i] * Wm;
  }
  long long asrc[4];  // offset of the tap's source pixel, channel 0; -1 outside the image
  int aph[4];         // its phase * Ci: the packed channel of mul/add
  float ra[4], rb[BLOADS];

  auto load = [&](int kt) {
    const int tap = kt / chunks;
    const int c0 = (kt - tap * chunks) * BK;
    const int ti = tap / ntw, tj = tap - ti * ntw;
    if (c0 == 0) {  // a new tap: move the rows' source pixels
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int sh = s_in * ah[i] + dh[ti], sw = s_in * aw[i] + dw[tj];
        const bool ok = am[i] && sh >= 0 && sh < Hin && sw >= 0 && sw < Win;
        aph[i] = ok ? phase_of(sh, sw, p.Lin) * p.Ci : 0;
        asrc[i] = ok ? coarse_offset(p, ab[i], sh >> p.Lin, sw >> p.Lin, p.Ci, p.Lin) + aph[i]
                     : -1;
      }
    }
    const int c = c0 + ka;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
      if (asrc[i] >= 0 && c < p.Ci) {
        v = stage::to_f32(X[asrc[i] + c]);
        if (p.has_prologue) {
          v = stage::round_to<T>(stage::leaky(
              stage::affine(v, p.mul[aph[i] + c], p.add[aph[i] + c]), p.slope));
        }
      }
      ra[i] = v;
    }
    const long long wtap = static_cast<long long>(kh[ti] * 3 + kw[tj]) * p.Ci;
#pragma unroll
    for (int j = 0; j < BLOADS; ++j) {
      const int e = t + THREADS * j;
      const int kc = c0 + e / BN, n = n0 + e % BN;
      rb[j] = (kc < p.Ci && n < p.Co) ? stage::to_f32(Wt[(wtap + kc) * p.Co + n]) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sm.a[buf][ka][t / BK + 32 * i] = ra[i];
#pragma unroll
    for (int j = 0; j < BLOADS; ++j) {
      const int e = t + THREADS * j;
      sm.b[buf][e / BN][e % BN] = rb[j];
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
    stage::mma_step<BN>(sm.a[cur], sm.b[cur], ty, tx, acc);
    if (kt + 1 < KT) store(cur ^ 1);
    __syncthreads();
  }

  T* Y = static_cast<T*>(p.y);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + stage::row_of(ty, i);
    if (m >= M) continue;
    const int b = m / (Hm * Wm);
    const int rem = m - b * Hm * Wm;
    const int oh = rem / Wm, ow = rem - (rem / Wm) * Wm;
    const int fh = s_out * oh + pa, fw = s_out * ow + pb;
    const int ph = phase_of(fh, fw, p.Lout) * p.Co;
    const long long base = coarse_offset(p, b, fh >> p.Lout, fw >> p.Lout, p.Co, p.Lout) + ph;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + stage::col_of(tx, j);
      if (n < p.Co) Y[base + n] = stage::from_f32<T>(acc[i][j] + p.bias[ph + n]);
    }
  }
}

// Direct path geometry: the tile grid's level (the thread's pixel is one of its fine
// pixels) and the input window's side in fine pixels.
__host__ __device__ inline int tile_level(const FineArgs& p) {
  return p.recipe == CONVT ? p.Lin : p.Lout;
}
__host__ __device__ inline int window_side(int recipe) {
  return recipe == STEM ? 2 * TILE + 1 : (recipe == CONVT ? TILE + 1 : TILE + 2);
}
__host__ __device__ inline int window_stride(int recipe) {  // odd: spreads the staging stores
  const int side = window_side(recipe);
  return (side * side) | 1;
}
inline size_t direct_smem_bytes(int recipe, int cc, int cop) {
  const size_t a = (static_cast<size_t>(cc) * window_stride(recipe) + 3) & ~size_t(3);
  return (a + 9 * static_cast<size_t>(cc) * cop) * sizeof(float);
}

// Direct path. COP: Co padded (1, 4 or 16); CONVT: the transposed recipe (four outputs per
// thread), else conv or stem (one output pixel per thread). cc: channels per staged chunk.
template <typename T, int COP, bool CONVT>
__global__ void __launch_bounds__(THREADS) fine_direct_kernel(const FineArgs p, int cc) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NOUT = CONVT ? 4 : 1;
  const T* X = static_cast<const T*>(p.x);
  const T* Wt = static_cast<const T*>(p.w);
  const int t = threadIdx.x;
  const int L = tile_level(p);
  const int tc = TILE >> L;  // coarse pixels per tile side
  const int cp = t >> (2 * L), ph = t & ((1 << (2 * L)) - 1);
  int dh, dw;
  unphase(ph, L, dh, dw);
  const int b = blockIdx.z;
  const int ch0 = blockIdx.y * tc, cw0 = blockIdx.x * tc;
  const int ch = ch0 + cp / tc, cw = cw0 + cp % tc;
  const int lh = ((cp / tc) << L) + dh, lw = ((cp % tc) << L) + dw;  // in the tile, [0, TILE)
  const int Hin = p.Hc << p.Lin, Win = p.Wc << p.Lin;
  const int scale = p.recipe == STEM ? 2 : 1;
  const int halo = CONVT ? 0 : 1;
  const int side = window_side(p.recipe), stride = window_stride(p.recipe);
  const int ih0 = scale * (ch0 << L) - halo, iw0 = scale * (cw0 << L) - halo;
  float* a_s = smem;  // [cc][stride]: the activated window, channel-major
  float* w_s = smem + ((cc * stride + 3) & ~3);  // [9][cc][COP]

  float acc[NOUT][COP];
#pragma unroll
  for (int s = 0; s < NOUT; ++s) {
#pragma unroll
    for (int co = 0; co < COP; ++co) acc[s][co] = 0.f;
  }
  for (int c0 = 0; c0 < p.Ci; c0 += cc) {
    const int nc = min(cc, p.Ci - c0);
    // channels fastest: consecutive threads read a pixel's channels, contiguous in x
    for (int e = t; e < side * side * nc; e += THREADS) {
      const int pix = e / nc, c = e - pix * nc;
      const int r = pix / side;
      a_s[c * stride + pix] =
          activated<T>(p, X, b, ih0 + r, iw0 + pix - r * side, c0 + c, Hin, Win);
    }
    for (int e = t; e < 9 * nc * COP; e += THREADS) {
      const int co = e % COP, rest = e / COP;
      const int c = rest % nc, tap = rest / nc;
      w_s[(tap * cc + c) * COP + co] =
          co < p.Co ? stage::to_f32(Wt[(static_cast<long long>(tap) * p.Ci + c0 + c) * p.Co + co])
                    : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const float* a = a_s + c * stride;
      if constexpr (CONVT) {
        float v[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) v[i][j] = a[(lh + i) * side + lw + j];
        }
        // per axis, combination i = (input offset d, output bit a, kernel index k):
        // 0 = (0, 0, 1), 1 = (0, 1, 2), 2 = (1, 1, 0)
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float av = v[i == 2][j == 2];
            const int ki = i == 0 ? 1 : (i == 1 ? 2 : 0), kj = j == 0 ? 1 : (j == 1 ? 2 : 0);
            const int s = (i > 0) * 2 + (j > 0);
            const float* wr = w_s + ((ki * 3 + kj) * cc + c) * COP;
#pragma unroll
            for (int co = 0; co < COP; ++co) acc[s][co] = fmaf(av, wr[co], acc[s][co]);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < 3; ++u) {
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const float av = a[(scale * lh + u) * side + scale * lw + v];
            const float* wr = w_s + ((u * 3 + v) * cc + c) * COP;
#pragma unroll
            for (int co = 0; co < COP; ++co) acc[0][co] = fmaf(av, wr[co], acc[0][co]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (ch >= p.Hc || cw >= p.Wc) return;
  // output phase of sub-output s: the thread's phase (convT: shifted up one level, with the
  // output bits (a, b) = (s >> 1, s & 1) innermost), so a thread's NOUT * Co values are one run
  const int oph = CONVT ? 4 * ph : ph;
  T* Y = static_cast<T*>(p.y) + coarse_offset(p, b, ch, cw, p.Co, p.Lout) +
         static_cast<long long>(oph) * p.Co;
  const float* bias = p.bias + static_cast<long long>(oph) * p.Co;
#pragma unroll
  for (int s = 0; s < NOUT; ++s) {
#pragma unroll
    for (int co = 0; co < COP; ++co) {
      if (co < p.Co) Y[s * p.Co + co] = stage::from_f32<T>(acc[s][co] + bias[s * p.Co + co]);
    }
  }
}

template <typename T, int COP, bool CONVT>
cudaError_t launch_direct(const FineArgs& p, cudaStream_t stream) {
  int cc = p.Ci < 64 ? p.Ci : 64;
  while (cc > 1 && direct_smem_bytes(p.recipe, cc, COP) > SMEM_LIMIT) cc = (cc + 1) / 2;
  const int tc = TILE >> tile_level(p);
  const dim3 grid((p.Wc + tc - 1) / tc, (p.Hc + tc - 1) / tc, p.B);
  fine_direct_kernel<T, COP, CONVT>
      <<<grid, THREADS, direct_smem_bytes(p.recipe, cc, COP), stream>>>(p, cc);
  return cudaGetLastError();
}

template <typename T, bool CONVT>
cudaError_t launch_direct_co(const FineArgs& p, cudaStream_t stream) {
  if (p.Co == 1) return launch_direct<T, 1, CONVT>(p, stream);
  if (p.Co <= 4) return launch_direct<T, 4, CONVT>(p, stream);
  return launch_direct<T, 16, CONVT>(p, stream);
}

template <typename T>
cudaError_t launch(const FineArgs& p, cudaStream_t stream) {
  if (p.Co <= 16) {
    return p.recipe == CONVT ? launch_direct_co<T, true>(p, stream)
                             : launch_direct_co<T, false>(p, stream);
  }
  const bool convt = p.recipe == CONVT;
  const long long hm = convt ? static_cast<long long>(p.Hc) << p.Lin
                             : static_cast<long long>(p.Hc) << p.Lout;
  const long long wm = convt ? static_cast<long long>(p.Wc) << p.Lin
                             : static_cast<long long>(p.Wc) << p.Lout;
  const long long M = p.B * hm * wm;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), p.Co <= 64 ? 1 : (p.Co + 127) / 128,
                  convt ? 4 : 1);
  if (p.Co <= 64) {
    fine_gemm_kernel<T, 64><<<grid, THREADS, 0, stream>>>(p);
  } else {
    fine_gemm_kernel<T, 128><<<grid, THREADS, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

bool bad_shape(const FineArgs& p) {
  if (p.B < 1 || p.Hc < 1 || p.Wc < 1 || p.Ci < 1 || p.Co < 1) return true;
  if (p.recipe < CONV || p.recipe > CONVT || p.Lin < 0 || p.Lout < 0) return true;
  const int want_out = p.Lin + (p.recipe == STEM ? -1 : (p.recipe == CONVT ? 1 : 0));
  if (p.Lout != want_out || p.Lin > 8 || p.Lout > 8) return true;
  if (p.Co <= 16 && tile_level(p) > 4) return true;  // a direct tile holds whole coarse pixels
  if (p.B > 65535) return true;
  const long long fine = (static_cast<long long>(p.Hc) << p.Lin) * (static_cast<long long>(p.Wc) << p.Lin);
  const long long out_fine = (static_cast<long long>(p.Hc) << p.Lout) * (static_cast<long long>(p.Wc) << p.Lout);
  const long long rows = p.B * (fine > out_fine ? fine : out_fine);
  return rows >= (1ll << 31) - BM || (p.Hc << p.Lin) >= (1 << 30) || (p.Wc << p.Lin) >= (1 << 30);
}

}  // namespace fine

// dtype: 0 = float32, 1 = bfloat16; recipe: 0 conv, 1 stem, 2 convT; levels: the input's
// packing levels. Ci and Co are the base kernel's channels. Launches on `stream` and does
// not synchronise.
extern "C" int stage_fwd_fine(const void* x, const float* mul, const float* add, const void* w,
                              const float* bias, void* y, int B, int Hc, int Wc, int Ci, int Co,
                              int recipe, int levels, float slope, int has_prologue, int dtype,
                              void* stream) {
  const int out_levels = levels + (recipe == fine::STEM ? -1 : (recipe == fine::CONVT ? 1 : 0));
  fine::FineArgs p{x, w, mul, add, bias, y, B, Hc, Wc, Ci, Co, levels, out_levels, recipe,
                   slope, has_prologue};
  if (fine::bad_shape(p)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return fine::launch<float>(p, s);
    case 1: return fine::launch<__nv_bfloat16>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
