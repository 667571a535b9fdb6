// The fine-grid stage kernels' shared core (stage_fwd_fine.cu, stage_dgrad_fine.cu; the
// address helpers also serve stage_wgrad_fine.cu): a 3x3 convolution of a phase-packed tensor
// computed on the fine (unpacked) pixel grid, with only its real taps, reading its input and
// writing its output where they lie in packed storage.
//
// A tensor packed L levels is (B, Hc, Wc, 4^L * C); fine pixel (h, w), channel c, lives at
// [b, h >> L, w >> L, phase * C + c] with
//   phase = sum_{k < L} (2 * ((h >> k) & 1) + ((w >> k) & 1)) * 4^k
// (the finest bit pair innermost; ops/subpixel.py packed_offset, space_to_depth_n). Every
// packed tensor of one call has the same Hc x Wc. The kernel w is (3, 3, Ci, Co):
//   conv  (recipe 0): pad-1 stride-1, out fine (h, w) <- in fine (h + u - 1, w + v - 1), levels
//                     L in and out;
//   stem  (recipe 1): pad-1 stride-2, out fine (h, w) <- in fine (2h + u - 1, 2w + v - 1), L in,
//                     L - 1 out;
//   convT (recipe 2): torch ConvTranspose2d(3, stride 2, padding 1, output_padding 1) with
//                     w[kh][kw][ci][co] = weight[ci][co][kh][kw]; output fine 2q + a on each
//                     axis takes k = 1 at input q (a = 0), or k = 2 at q and k = 0 at q + 1
//                     (a = 1); L in, L + 1 out.
// Zero padding comes at the fine image's edge. Sums are float32 FMA (no TF32).
//
// Two uses, chosen by the kernels' DGRAD parameter:
// - the stage forward (DGRAD false): in = x with the prologue leaky(x * mul + add) applied as
//   it is read (mul/add per packed input channel; in bfloat16 the activation rounds to bf16
//   before the product), out = y plus the packed bias;
// - the stage dgrad (DGRAD true): in = dy read as it is, w the module's kernel rotated and
//   transposed (stage_dgrad_fine.cu), out = da, and the epilogue with mul/add per packed
//   output channel: dz = da * leaky'(x * mul + add), dx = dz * mul written where x lies, and
//   fixed-order block partials of dmul = sum dz * x and dadd = sum dz, one row of
//   4^Lout * Co floats per block (partials[kind][blockIdx.x][pc]), folded later.
//
// Two paths:
// - GEMM (Co > 16): stage_gemm.cuh's tiles and mma_step, M = rows of the row grid (output
//   pixels for conv and stem; for convT the input pixels q of output phase (a, b)), N = Co,
//   depth = real taps x Ci. The forward takes the rows in fine order; the dgrad takes the
//   coarse pixels of one row phase per blockIdx.z, so all of a block's outputs share one
//   packed phase and its column sums are one slice of its partial row.
// - Direct (Co <= 16): a block owns a 16 x 16 tile of fine pixels made of whole coarse
//   pixels of the row grid and stages the input window (activated once per element) and the
//   kernel in shared memory, in channel chunks; each thread computes all Co outputs of one
//   fine pixel (convT: the four outputs 2q + (a, b) of its input pixel q, nine taps, no
//   divergence). Threads follow the packed phase order, so a coarse pixel's outputs are one
//   contiguous run. The forward runs one block per tile. The dgrad's blocks walk over tiles
//   blockIdx.x, + gridDim.x, ...: a thread's packed phase is the same in every tile, so it
//   keeps its partials in registers across tiles and the block folds them once, and the
//   number of partial rows is the grid's, not the tiles'.

#pragma once

#include "stage_gemm.cuh"

namespace fine {

using stage::BK;
using stage::BM;
using stage::THREADS;

enum Recipe { CONV = 0, STEM = 1, CONVT = 2 };

constexpr int TILE = 16;                    // direct path: fine pixels per tile side
constexpr int SMEM_LIMIT = 48 * 1024;       // direct path: dynamic shared memory per block

struct FineArgs {
  const void* x;       // in (B, Hc, Wc, 4^Lin * Ci) packed: x (forward) or dy (dgrad)
  const void* w;       // (3, 3, Ci, Co)
  const float* mul;    // forward: (4^Lin * Ci,); dgrad: (4^Lout * Co,)
  const float* add;
  const float* bias;   // forward: (4^Lout * Co,)
  void* y;             // out (B, Hc, Wc, 4^Lout * Co) packed: y (forward) or dx (dgrad)
  int B, Hc, Wc, Ci, Co, Lin, Lout, recipe;
  float slope;
  int has_prologue;
  const void* xe;      // dgrad: x, at the output's shape, for the epilogue
  float* partials;     // dgrad with a prologue: (2, gridDim.x, 4^Lout * Co)
};

// Packing levels of the output of a `recipe` conv whose input is packed `levels` times.
__host__ __device__ inline int out_levels(int recipe, int levels) {
  return levels + (recipe == STEM ? -1 : (recipe == CONVT ? 1 : 0));
}

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

// The input at fine pixel (b, h, w), channel c (0 outside the image), activated when
// `prologue`.
template <typename T>
__device__ __forceinline__ float activated(const FineArgs& p, const T* X, int b, int h, int w,
                                           int c, int Hin, int Win, bool prologue) {
  if (h < 0 || h >= Hin || w < 0 || w >= Win) return 0.f;
  const int pc = phase_of(h, w, p.Lin) * p.Ci + c;
  float v = stage::to_f32(X[coarse_offset(p, b, h >> p.Lin, w >> p.Lin, p.Ci, p.Lin) + pc]);
  if (prologue) v = stage::round_to<T>(stage::leaky(stage::affine(v, p.mul[pc], p.add[pc]), p.slope));
  return v;
}

// The level of the row grid: the output's for conv and stem, the input's for convT (whose
// rows are input pixels, four outputs each).
__host__ __device__ inline int tile_level(const FineArgs& p) {
  return p.recipe == CONVT ? p.Lin : p.Lout;
}

// GEMM path. Rows: see the file note; columns: Co; depth: taps x Ci. grid: x = row tiles,
// y = Co tiles, z = convT output phase (forward) or, for the dgrad, (output phase) * 4^Lrow
// + row phase.
template <typename T, int BN, bool DGRAD>
__global__ void __launch_bounds__(THREADS) fine_gemm_kernel(const FineArgs p) {
  constexpr int TN = BN / 16;
  constexpr int BLOADS = BN * BK / THREADS;
  __shared__ __align__(16) stage::Tiles<BN> sm;
  const T* X = static_cast<const T*>(p.x);
  const T* Wt = static_cast<const T*>(p.w);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const bool convt = p.recipe == CONVT;
  const bool prologue = !DGRAD && p.has_prologue;  // the dgrad reads dy as it is
  const int s_in = p.recipe == STEM ? 2 : 1;  // input coordinate of a row = s_in * row + d
  const int s_out = convt ? 2 : 1;            // output coordinate = s_out * row + phase bit
  const int Hin = p.Hc << p.Lin, Win = p.Wc << p.Lin;
  const int Lrow = tile_level(p);
  // dgrad: the block's rows are the coarse pixels of row phase rp, each at fine (i << Lrow |
  // rdh, j << Lrow | rdw); forward: the fine pixels of the row grid (rs = 0, rp = 0)
  const int nrp = DGRAD ? 1 << (2 * Lrow) : 1;
  const int rp = static_cast<int>(blockIdx.z) % nrp, sub = static_cast<int>(blockIdx.z) / nrp;
  const int rs = DGRAD ? Lrow : 0;
  int rdh = 0, rdw = 0;
  unphase(rp, rs, rdh, rdw);
  const int Hm = p.Hc << (Lrow - rs), Wm = p.Wc << (Lrow - rs);
  const int M = p.B * Hm * Wm;
  const int pa = convt ? sub >> 1 : 0;
  const int pb = convt ? sub & 1 : 0;
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
    ah[i] = ((rem / Wm) << rs) | rdh;
    aw[i] = ((rem - (rem / Wm) * Wm) << rs) | rdw;
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
        if (prologue) {
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
  const T* XE = static_cast<const T*>(p.xe);
  float smul[TN], sadd[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) smul[j] = sadd[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + stage::row_of(ty, i);
    if (m >= M) continue;
    const int b = m / (Hm * Wm);
    const int rem = m - b * Hm * Wm;
    const int oh = ((rem / Wm) << rs) | rdh, ow = ((rem - (rem / Wm) * Wm) << rs) | rdw;
    const int fh = s_out * oh + pa, fw = s_out * ow + pb;
    const int ph = phase_of(fh, fw, p.Lout) * p.Co;
    const long long base = coarse_offset(p, b, fh >> p.Lout, fw >> p.Lout, p.Co, p.Lout) + ph;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + stage::col_of(tx, j);
      if (n >= p.Co) continue;
      if constexpr (!DGRAD) {
        Y[base + n] = stage::from_f32<T>(acc[i][j] + p.bias[ph + n]);
      } else if (p.has_prologue) {
        Y[base + n] = stage::from_f32<T>(stage::dgrad_point(
            stage::to_f32(XE[base + n]), p.mul[ph + n], p.add[ph + n], p.slope, acc[i][j],
            smul[j], sadd[j]));
      } else {
        Y[base + n] = stage::from_f32<T>(acc[i][j]);
      }
    }
  }
  if constexpr (DGRAD) {
    if (p.has_prologue) {
      // every row of the block has the packed output phase oph: its column sums are the
      // slice [oph * Co + n0, + BN) of the block's partial row
      const int oph = convt ? 4 * rp + sub : rp;
      float cm, ca;
      stage::block_column_sums<BN>(reinterpret_cast<float*>(&sm), smul, sadd, ty, tx, t, cm, ca);
      if (t < BN && n0 + t < p.Co) {
        const long long P = static_cast<long long>(p.Co) << (2 * p.Lout);
        const long long col = static_cast<long long>(oph) * p.Co + n0 + t;
        p.partials[static_cast<long long>(blockIdx.x) * P + col] = cm;
        p.partials[(static_cast<long long>(gridDim.x) + blockIdx.x) * P + col] = ca;
      }
    }
  }
}

// Direct path geometry: the input window's side in fine pixels.
__host__ __device__ inline int window_side(int recipe) {
  return recipe == STEM ? 2 * TILE + 1 : (recipe == CONVT ? TILE + 1 : TILE + 2);
}
__host__ __device__ inline int window_stride(int recipe) {  // odd: spreads the staging stores
  const int side = window_side(recipe);
  return (side * side) | 1;
}
// Dynamic shared memory of a direct block: the staged window and kernel, and for the dgrad's
// partials the fold buffer [THREADS][cop + 1] that reuses them.
inline size_t direct_smem_bytes(int recipe, int cc, int cop, bool dgrad) {
  const size_t a = (static_cast<size_t>(cc) * window_stride(recipe) + 3) & ~size_t(3);
  const size_t stage_bytes = (a + 9 * static_cast<size_t>(cc) * cop) * sizeof(float);
  const size_t fold_bytes = dgrad ? static_cast<size_t>(THREADS) * (cop + 1) * sizeof(float) : 0;
  return stage_bytes > fold_bytes ? stage_bytes : fold_bytes;
}
// Tiles of the direct path: (B, tile rows, tile columns) of whole coarse pixels.
__host__ __device__ inline int direct_tiles(const FineArgs& p) {
  const int tc = TILE >> tile_level(p);
  return p.B * ((p.Hc + tc - 1) / tc) * ((p.Wc + tc - 1) / tc);
}

// One tile of the direct path: stage the window and the kernel chunk by chunk, multiply, and
// the thread's epilogue (forward: y + bias; dgrad: dx, adding to the thread's dmul/dadd
// partials smul/sadd). COP: Co padded (1, 4 or 16); CONVT: the transposed recipe (four
// outputs per thread), else conv or stem (one output pixel per thread). cc: channels per
// staged chunk.
template <typename T, int COP, bool CONVT, bool DGRAD>
__device__ __forceinline__ void direct_tile(const FineArgs& p, int cc, int tile, float* smem,
                                            float (&smul)[CONVT ? 4 : 1][COP],
                                            float (&sadd)[CONVT ? 4 : 1][COP]) {
  constexpr int NOUT = CONVT ? 4 : 1;
  const T* X = static_cast<const T*>(p.x);
  const T* Wt = static_cast<const T*>(p.w);
  const int t = threadIdx.x;
  const int L = tile_level(p);
  const int tc = TILE >> L;  // coarse pixels per tile side
  const int cp = t >> (2 * L), ph = t & ((1 << (2 * L)) - 1);
  int dh, dw;
  unphase(ph, L, dh, dw);
  const int ntw = (p.Wc + tc - 1) / tc, nth = (p.Hc + tc - 1) / tc;
  const int b = tile / (nth * ntw);
  const int r = tile - b * nth * ntw;
  const int ch0 = (r / ntw) * tc, cw0 = (r - (r / ntw) * ntw) * tc;
  const int ch = ch0 + cp / tc, cw = cw0 + cp % tc;
  const int lh = ((cp / tc) << L) + dh, lw = ((cp % tc) << L) + dw;  // in the tile, [0, TILE)
  const int Hin = p.Hc << p.Lin, Win = p.Wc << p.Lin;
  const int scale = p.recipe == STEM ? 2 : 1;
  const int halo = CONVT ? 0 : 1;
  const int side = window_side(p.recipe), stride = window_stride(p.recipe);
  const int ih0 = scale * (ch0 << L) - halo, iw0 = scale * (cw0 << L) - halo;
  const bool prologue = !DGRAD && p.has_prologue;
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
      const int rr = pix / side;
      a_s[c * stride + pix] =
          activated<T>(p, X, b, ih0 + rr, iw0 + pix - rr * side, c0 + c, Hin, Win, prologue);
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
  const long long base = coarse_offset(p, b, ch, cw, p.Co, p.Lout) +
                         static_cast<long long>(oph) * p.Co;
  T* Y = static_cast<T*>(p.y) + base;
  if constexpr (!DGRAD) {
    const float* bias = p.bias + static_cast<long long>(oph) * p.Co;
#pragma unroll
    for (int s = 0; s < NOUT; ++s) {
#pragma unroll
      for (int co = 0; co < COP; ++co) {
        if (co < p.Co) Y[s * p.Co + co] = stage::from_f32<T>(acc[s][co] + bias[s * p.Co + co]);
      }
    }
  } else {
    const T* XE = static_cast<const T*>(p.xe) + base;
    const float* mul = p.mul + static_cast<long long>(oph) * p.Co;
    const float* add = p.add + static_cast<long long>(oph) * p.Co;
#pragma unroll
    for (int s = 0; s < NOUT; ++s) {
#pragma unroll
      for (int co = 0; co < COP; ++co) {
        if (co >= p.Co) continue;
        const int k = s * p.Co + co;
        Y[k] = stage::from_f32<T>(
            p.has_prologue ? stage::dgrad_point(stage::to_f32(XE[k]), mul[k], add[k], p.slope,
                                                acc[s][co], smul[s][co], sadd[s][co])
                           : acc[s][co]);
      }
    }
  }
}

// Direct path: the forward runs one tile per block; the dgrad's blocks walk over tiles
// blockIdx.x, + gridDim.x, ... and then fold their threads' partials into one row.
template <typename T, int COP, bool CONVT, bool DGRAD>
__global__ void __launch_bounds__(THREADS) fine_direct_kernel(const FineArgs p, int cc) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NOUT = CONVT ? 4 : 1;
  float smul[NOUT][COP], sadd[NOUT][COP];  // dgrad: the thread's dmul/dadd partials
#pragma unroll
  for (int s = 0; s < NOUT; ++s) {
#pragma unroll
    for (int co = 0; co < COP; ++co) smul[s][co] = sadd[s][co] = 0.f;
  }
  if constexpr (!DGRAD) {
    direct_tile<T, COP, CONVT, DGRAD>(p, cc, blockIdx.x, smem, smul, sadd);
  } else {
    const int ntiles = direct_tiles(p);
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
      direct_tile<T, COP, CONVT, DGRAD>(p, cc, tile, smem, smul, sadd);
    if (!p.has_prologue) return;
    // fold the threads of each packed phase (t = cp * 4^L + ph) in cp order into the block's
    // partial row, one (sub-output, sum) at a time through red [THREADS][COP + 1]
    float* red = smem;
    const int t = threadIdx.x, L = tile_level(p);
    const int nph = 1 << (2 * L), ncp = THREADS >> (2 * L);
    const long long P = static_cast<long long>(p.Co) << (2 * p.Lout);
#pragma unroll
    for (int s = 0; s < NOUT; ++s) {
#pragma unroll
      for (int kind = 0; kind < 2; ++kind) {
        __syncthreads();
#pragma unroll
        for (int co = 0; co < COP; ++co) red[t * (COP + 1) + co] = kind ? sadd[s][co] : smul[s][co];
        __syncthreads();
        for (int e = t; e < nph * p.Co; e += THREADS) {
          const int q = e / p.Co, co = e - q * p.Co;
          float sum = 0.f;
          for (int c2 = 0; c2 < ncp; ++c2) sum += red[(c2 * nph + q) * (COP + 1) + co];
          const int o = CONVT ? 4 * q + s : q;
          p.partials[(static_cast<long long>(kind) * gridDim.x + blockIdx.x) * P +
                     static_cast<long long>(o) * p.Co + co] = sum;
        }
      }
    }
  }
}

// The direct kernel's launch: channels per chunk, shared memory and grid. One block per
// tile, except for a dgrad with partials: as many blocks as fit on the card at once, each
// walking over tiles. With `blocks` set, stores the grid's size there and launches nothing
// (the partials' scratch is sized by it).
template <typename T, int COP, bool CONVT, bool DGRAD>
cudaError_t launch_direct(const FineArgs& p, cudaStream_t stream, int* blocks) {
  int cc = p.Ci < 64 ? p.Ci : 64;
  while (cc > 1 && direct_smem_bytes(p.recipe, cc, COP, DGRAD) > SMEM_LIMIT) cc = (cc + 1) / 2;
  const size_t smem = direct_smem_bytes(p.recipe, cc, COP, DGRAD);
  int grid = direct_tiles(p);
  if (DGRAD && p.has_prologue) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fine_direct_kernel<T, COP, CONVT, DGRAD>, THREADS, smem)) != cudaSuccess)
      return err;
    const int resident = (per_sm > 0 ? per_sm : 1) * sms;
    grid = grid < resident ? grid : resident;
  }
  if (blocks != nullptr) {
    *blocks = grid;
    return cudaSuccess;
  }
  fine_direct_kernel<T, COP, CONVT, DGRAD><<<grid, THREADS, smem, stream>>>(p, cc);
  return cudaGetLastError();
}

// launch_direct with COP for Co (1, 4 or 16) and the recipe's thread mapping.
template <typename T, bool DGRAD>
cudaError_t launch_direct_co(const FineArgs& p, cudaStream_t stream, int* blocks = nullptr) {
  const bool convt = p.recipe == CONVT;
  if (p.Co == 1) {
    return convt ? launch_direct<T, 1, true, DGRAD>(p, stream, blocks)
                 : launch_direct<T, 1, false, DGRAD>(p, stream, blocks);
  }
  if (p.Co <= 4) {
    return convt ? launch_direct<T, 4, true, DGRAD>(p, stream, blocks)
                 : launch_direct<T, 4, false, DGRAD>(p, stream, blocks);
  }
  return convt ? launch_direct<T, 16, true, DGRAD>(p, stream, blocks)
               : launch_direct<T, 16, false, DGRAD>(p, stream, blocks);
}

// The GEMM path's grid: row tiles, Co tiles, and z (see fine_gemm_kernel).
template <bool DGRAD>
dim3 gemm_grid(const FineArgs& p) {
  const bool convt = p.recipe == CONVT;
  const int lrow = tile_level(p);
  const long long rows = DGRAD ? static_cast<long long>(p.B) * p.Hc * p.Wc
                               : (static_cast<long long>(p.B) * p.Hc * p.Wc) << (2 * lrow);
  const int z = (convt ? 4 : 1) * (DGRAD ? 1 << (2 * lrow) : 1);
  return dim3(static_cast<unsigned>((rows + BM - 1) / BM),
              p.Co <= 64 ? 1 : (p.Co + 127) / 128, z);
}

template <typename T, bool DGRAD>
cudaError_t launch_gemm(const FineArgs& p, cudaStream_t stream) {
  const dim3 grid = gemm_grid<DGRAD>(p);
  if (p.Co <= 64) {
    fine_gemm_kernel<T, 64, DGRAD><<<grid, THREADS, 0, stream>>>(p);
  } else {
    fine_gemm_kernel<T, 128, DGRAD><<<grid, THREADS, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

inline bool bad_shape(const FineArgs& p) {
  if (p.B < 1 || p.Hc < 1 || p.Wc < 1 || p.Ci < 1 || p.Co < 1) return true;
  if (p.recipe < CONV || p.recipe > CONVT || p.Lin < 0 || p.Lout < 0) return true;
  if (p.Lout != out_levels(p.recipe, p.Lin) || p.Lin > 8 || p.Lout > 8) return true;
  if (p.Co <= 16 && tile_level(p) > 4) return true;  // a direct tile holds whole coarse pixels
  if (p.B > 65535) return true;
  const long long fine = (static_cast<long long>(p.Hc) << p.Lin) * (static_cast<long long>(p.Wc) << p.Lin);
  const long long out_fine = (static_cast<long long>(p.Hc) << p.Lout) * (static_cast<long long>(p.Wc) << p.Lout);
  const long long rows = p.B * (fine > out_fine ? fine : out_fine);
  return rows >= (1ll << 31) - BM || (p.Hc << p.Lin) >= (1 << 30) || (p.Wc << p.Lin) >= (1 << 30);
}

}  // namespace fine
