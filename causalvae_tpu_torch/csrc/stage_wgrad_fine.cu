// Stage wgrad on the fine grid for Hopper (sm_90a): the weight-side cotangents of
//   y = conv(leaky(x * mul + add, slope)) + bias
// (stage_fwd_fine.cu) on phase-packed tensors, from x, dy, mul and add:
//   a        = leaky(x * mul + add, slope), recomputed (rounded twice, never FMA-contracted;
//              in bfloat16 rounded to bf16 before the product); a = x without a prologue,
//   dW[u][v] = sum over the output fine pixels o where tap (u, v) is real of
//              a[src(o, u, v)]^T dy[o], (3, 3, Ci, Co) in the base layout, float32 (for convT
//              dW[kh][kw][ci][co] means torch's ConvTranspose2d.weight[ci][co][kh][kw]),
//   db       = the sum of dy over the pixels, per packed output channel, (4^Lout * Co,) float32.
// x and dy are read where they lie in packed storage (stage_fine.cuh); x, dy in float32 or
// bfloat16, every product a float32 FMA on the CUDA cores (no TF32).
//
// Replaces the dW/db half of the Pallas TPU kernel _stage_bwd_kernel / _stage_bwd_call
// (causalvae_tpu/ops/kernels/stage.py: the wgrad dW[u,v] = a_slice^T @ dy_slice, db = sum dy),
// row 7b of PERF.md's kernel table, on the model's path. The lifted wgrad-only entry of
// stage_bwd.cu (stage_bwd_wgrad) multiplied the lifted kernel's structural zeros: ~800 GFLOP
// per packed-fused step where 120 are real.
//
// What bounds it on this card: the real work, 2 * pixels * 9 * Ci * Co flops. The shapes with
// base Ci >= 32 are operations-bound at 67 TFLOP/s (float32 outside the tensor cores); the two
// decoder-tail shapes with Ci = 16 are bytes-bound at 3.35 TB/s: dec_ct[4] reads dy (503 MB)
// and x (126 MB), dec_out reads x (503 MB) and dy (31 MB) (chip_smoke.py stage_work,
// bytes_wgrad).
// Design:
// - Real taps only, phase-regular addressing. The GEMM path's blocks take the coarse pixels
//   of one row phase (blockIdx.z, with convT's output phase (a, b) as in the forward): for a
//   fixed row phase and tap, the source of every row is one fixed packed phase of the coarse
//   pixel at a fixed coarse offset (the carry), so a thread's address pattern is set once.
// - Tiles that fit (Co > 16): M = (real tap, ci) rows, so the taps fill the tile (9 * Ci for
//   conv and stem, 1-4 taps * Ci per convT output phase), N = Co in tiles of 32, 64 or 128
//   (stage_gemm.cuh's mma_step), depth = the phase's coarse pixels, split (split-K) into two
//   full waves of resident blocks. dy is the B operand every tap shares; the first M tile
//   also sums dy's columns (db), so dy is read once for both. A k-step's global reads are
//   issued before the previous step's products and used (prologue, db) after them.
// - Direct path (Co <= 16: dec_out, dec_ct[3], dec_ct[4], the bytes-bound tail): blocks, as
//   many as fit on the card, walk over 16 x 16 fine-pixel tiles of the row grid, stage the
//   activated input window (activated once per element, a slice of 16 channels a block) and
//   the tile's dy in shared memory, and compute all nine taps from them. Each thread keeps
//   the partial dW of its (ci, four Co) for the nine taps in registers over every tile; db's
//   column sums stay in shared memory; the block folds once at the end. x and dy are read
//   once (dy once per slice of 16 channels), each thread issuing a batch of reads at once;
//   the window's packed addresses come from per-tile tables of its rows and columns.
// - No atomics: every split or block writes its partial ((S, 9, Ci, Co), S = row phases *
//   splits or blocks; the splits are capped so the partials stay under 32 MB), and
//   stage::fold sums them in a fixed order. Two launches on the same inputs give the same
//   bits.
//
// C interface: stage_wgrad_fine(...) returns cudaGetLastError() after its launches
// (cudaErrorInvalidValue for a type or a shape it does not take);
// stage_wgrad_fine_scratch_floats(...) gives the float32 scratch of the partials.

#include <algorithm>

#include "stage_fine.cuh"

namespace {

using fine::FineArgs;
using stage::BK;
using stage::BM;
using stage::THREADS;

constexpr long long SCRATCH_CAP = 8ll << 20;  // GEMM path: partial floats the splits aim under
constexpr int MIN_SPAN = 256;                 // GEMM path: coarse pixels a split takes, at least
constexpr int CS = 16;                        // direct path: channels of x a block takes
constexpr int SMEM_MAX = 227 * 1024;          // dynamic shared memory a block may opt in to
constexpr int UW = 4;                         // direct path: window reads a thread issues at once
constexpr int UD = 8;                         // direct path: dy reads a thread issues at once

struct WgradArgs {
  FineArgs f;     // x, mul, add (per packed input channel), shape, recipe, levels, prologue
  const void* dy; // (B, Hc, Wc, 4^Lout * Co) packed
  float* part;    // dW partials (S, 9, Ci, Co)
  float* dbpart;  // db partials (R, 4^Lout * Co)
  int span;       // GEMM path: coarse pixels per split, a multiple of BK
};

// GEMM path: BN for Co.
inline int gemm_bn(int co) { return co <= 32 ? 32 : (co <= 64 ? 64 : 128); }

// grid: x = M tiles * N tiles, y = split, z = convT output phase * 4^Lrow + row phase.
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) wgrad_gemm_kernel(const WgradArgs a) {
  constexpr int TN = BN / 16;
  constexpr int BLOADS = BN * BK / THREADS;
  __shared__ __align__(16) stage::Tiles<BN> sm;
  const FineArgs& p = a.f;
  const T* X = static_cast<const T*>(p.x);
  const T* DY = static_cast<const T*>(a.dy);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const bool convt = p.recipe == fine::CONVT;
  const int Lrow = fine::tile_level(p);
  const int nrp = 1 << (2 * Lrow);
  const int rp = static_cast<int>(blockIdx.z) % nrp, sub = static_cast<int>(blockIdx.z) / nrp;
  int rdh = 0, rdw = 0;
  fine::unphase(rp, Lrow, rdh, rdw);
  int kh[3], dh[3], kw[3], dw[3];
  const int nth = fine::axis_taps(p.recipe, convt ? sub >> 1 : 0, kh, dh);
  const int ntw = fine::axis_taps(p.recipe, convt ? sub & 1 : 0, kw, dw);
  const int M = nth * ntw * p.Ci;
  const int ntiles = (p.Co + BN - 1) / BN;
  const int m0 = (static_cast<int>(blockIdx.x) / ntiles) * BM;
  const int n0 = (static_cast<int>(blockIdx.x) % ntiles) * BN;
  if (m0 >= M) return;  // convT output phases with fewer taps
  const int depth = p.B * p.Hc * p.Wc;
  const int r_begin = blockIdx.y * a.span;
  const int r_end = min(depth, r_begin + a.span);
  const int KT = r_end > r_begin ? (r_end - r_begin + BK - 1) / BK : 0;

  // A: the thread's row m (tap, ci) is fixed for the block's life, and so is its source for
  // the row pixel at coarse (ch, cw): coarse (ch + cy, cw + cx), packed channel sc
  const int m = m0 + t % BM;
  const bool mok = m < M;
  const int tap = mok ? m / p.Ci : 0, ci = mok ? m - tap * p.Ci : 0;
  const int ti = tap / ntw, tj = tap - ti * ntw;
  const int s_in = p.recipe == fine::STEM ? 2 : 1;
  const int eh = s_in * rdh + dh[ti], ew = s_in * rdw + dw[tj];  // in [-1, 2^Lin]
  const int lmask = (1 << p.Lin) - 1;
  const int cy = eh >> p.Lin, cx = ew >> p.Lin;                   // the carry: -1, 0 or 1
  const int sc = fine::phase_of(eh & lmask, ew & lmask, p.Lin) * p.Ci + ci;
  const long long cin_p = static_cast<long long>(p.Ci) << (2 * p.Lin);
  const long long delta = static_cast<long long>(cy) * p.Wc + cx;
  float mu = 1.f, ad = 0.f;
  if (p.has_prologue && mok) {
    mu = p.mul[sc];
    ad = p.add[sc];
  }
  // B: dy at the row pixel's output, packed phase oph
  const int oph = convt ? 4 * rp + sub : rp;
  const long long cout_p = static_cast<long long>(p.Co) << (2 * p.Lout);
  const long long dcol = static_cast<long long>(oph) * p.Co + n0;
  const bool dbrow = m0 == 0;  // the first M tile also sums dy's columns (db)

  // coarse (ch, cw) of the thread's A pixels r_begin + kt * BK + t / BM + 2 i, advanced by
  // BK per k-step
  int ach[4], acw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r_begin + t / BM + 2 * i;
    const int rem = r % (p.Hc * p.Wc);
    ach[i] = rem / p.Wc;
    acw[i] = rem - ach[i] * p.Wc;
  }
  const T* xsrc = X + delta * cin_p + sc;  // + r * cin_p: the source of row pixel r
  const T zero = stage::from_f32<T>(0.f);
  // load() only issues the global reads (raw values and the A mask); store(), after the
  // next mma_step, applies the prologue and sums db, so the reads' latency is hidden
  T xa[4], xb[BLOADS];
  bool aok[4];
  float dbs = 0.f;

  auto load = [&](int kt) {
    const int rbase = r_begin + kt * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rbase + t / BM + 2 * i;
      aok[i] = mok && r < r_end &&
               static_cast<unsigned>(ach[i] + cy) < static_cast<unsigned>(p.Hc) &&
               static_cast<unsigned>(acw[i] + cx) < static_cast<unsigned>(p.Wc);
      xa[i] = aok[i] ? xsrc[static_cast<long long>(r) * cin_p] : zero;
    }
#pragma unroll
    for (int j = 0; j < BLOADS; ++j) {
      const int e = t + THREADS * j;
      const int r = rbase + e / BN, nb = e % BN;
      xb[j] = (r < r_end && n0 + nb < p.Co) ? DY[static_cast<long long>(r) * cout_p + dcol + nb]
                                            : zero;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acw[i] += BK;
      while (acw[i] >= p.Wc) {
        acw[i] -= p.Wc;
        if (++ach[i] == p.Hc) ach[i] = 0;
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = stage::to_f32(xa[i]);
      if (p.has_prologue && aok[i])
        v = stage::round_to<T>(stage::leaky(stage::affine(v, mu, ad), p.slope));
      sm.a[buf][t / BM + 2 * i][t % BM] = v;
    }
#pragma unroll
    for (int j = 0; j < BLOADS; ++j) {
      const int e = t + THREADS * j;
      const float v = stage::to_f32(xb[j]);
      if (dbrow) dbs += v;
      sm.b[buf][e / BN][e % BN] = v;
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
    stage::mma_step<BN>(sm.a[cur], sm.b[cur], ty, tx, acc);
    if (kt + 1 < KT) store(cur ^ 1);
    __syncthreads();
  }

  // the partial of slot (row phase, split): every convT tap belongs to one output phase, so
  // the slots of one row phase hold all nine taps
  const long long slot = static_cast<long long>(rp) * gridDim.y + blockIdx.y;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int mm = m0 + stage::row_of(ty, i);
    if (mm >= M) continue;
    const int tp = mm / p.Ci, c = mm - tp * p.Ci;
    const int k = kh[tp / ntw] * 3 + kw[tp % ntw];
    const long long base = ((slot * 9 + k) * p.Ci + c) * p.Co;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + stage::tile_col<BN>(tx, j);
      if (n < p.Co) a.part[base + n] = acc[i][j];
    }
  }
  if (dbrow) {
    // threads t = nb + BN g loaded column nb: their sums in g order (the tiles are free)
    float* red = reinterpret_cast<float*>(&sm);
    red[t] = dbs;
    __syncthreads();
    if (t < BN && n0 + t < p.Co) {
      float s = 0.f;
      for (int g = 0; g < THREADS / BN; ++g) s += red[g * BN + t];
      a.dbpart[static_cast<long long>(blockIdx.y) * cout_p + dcol + t] = s;
    }
  }
}

// Direct path: COP = Co padded (1, 4 or 16); a thread holds CO_T of them.
template <int COP>
struct Direct {
  static constexpr int CO_T = COP == 1 ? 1 : 4;
  static constexpr int NCOG = COP / CO_T;            // Co groups
  static constexpr int NPG = THREADS / (CS * NCOG);  // pixel groups
};

constexpr int TAB = 2 * fine::TILE + 1;  // direct path: the widest window side (stem)

// Shared memory of a direct block, in floats: the window [CS][stride] and dy [rows][NOUT][COP]
// while staging, the fold buffer [THREADS][9][CO_T] after; then db's sums [4^Lout * Co]; then
// the window's offset tables (long long row_off[TAB], col_off[TAB]; int row_ph[TAB],
// col_ph[TAB]).
struct DirectLayout {
  long long window, body, cols, tab;
  size_t bytes() const {
    return static_cast<size_t>(tab) * sizeof(float) + TAB * (2 * sizeof(long long) + 2 * sizeof(int));
  }
};

inline DirectLayout direct_layout(const FineArgs& p, int cop) {
  const long long win = (static_cast<long long>(CS) * fine::window_stride(p.recipe) + 3) & ~3ll;
  const long long dy = 256ll * (p.recipe == fine::CONVT ? 4 : 1) * cop;
  const long long red = static_cast<long long>(THREADS) * 9 * (cop == 1 ? 1 : 4);
  const long long body = win + dy > red ? win + dy : red;
  const long long cols = static_cast<long long>(p.Co) << (2 * p.Lout);
  return DirectLayout{win, body, cols, (body + cols + 1) & ~1ll};
}

// grid: x = blocks walking over the tiles, y = slice of CS channels of x.
template <typename T, int COP, bool CONVT>
__global__ void __launch_bounds__(THREADS) wgrad_direct_kernel(const WgradArgs a, DirectLayout lay) {
  using D = Direct<COP>;
  constexpr int CO_T = D::CO_T;
  extern __shared__ __align__(16) float smem[];
  const FineArgs& p = a.f;
  const T* X = static_cast<const T*>(p.x);
  const T* DY = static_cast<const T*>(a.dy);
  const int t = threadIdx.x;
  const int cl = t % CS, cog = (t / CS) % D::NCOG, pg = t / (CS * D::NCOG);
  const int c0 = blockIdx.y * CS, nc = min(CS, p.Ci - c0);
  const int L = fine::tile_level(p);
  const int tc = fine::TILE >> L, nph = 1 << (2 * L);
  static_assert(fine::TILE == 1 << 4, "tcs below takes log2(TILE) = 4");
  const int side = fine::window_side(p.recipe), stride = fine::window_stride(p.recipe);
  const int scale = p.recipe == fine::STEM ? 2 : 1;
  const int halo = CONVT ? 0 : 1;
  const int Hin = p.Hc << p.Lin, Win = p.Wc << p.Lin;
  const int tiles_w = (p.Wc + tc - 1) / tc, tiles_h = (p.Hc + tc - 1) / tc;
  const int ntiles = p.B * tiles_h * tiles_w;
  const int ophs = 1 << (2 * p.Lout);  // output phases of a coarse pixel
  const int cols = static_cast<int>(lay.cols);
  float* a_s = smem;                // [CS][stride]: the activated window, channel-major
  float* dy_s = smem + lay.window;  // [tc * tc][ophs][COP]: the tile's dy
  float* red = smem;                // [THREADS][9][CO_T], after the last tile
  float* dbs = smem + lay.body;     // [cols]: db's running sums
  long long* row_off = reinterpret_cast<long long*>(smem + lay.tab);
  long long* col_off = row_off + TAB;
  int* row_ph = reinterpret_cast<int*>(col_off + TAB);
  int* col_ph = row_ph + TAB;
  const long long cin_p = static_cast<long long>(p.Ci) << (2 * p.Lin);
  const int tcs = 4 - L;  // log2(tc)
  const int run_shift = 2 * p.Lout + (COP == 1 ? 0 : (COP == 4 ? 2 : 4));  // log2(ophs * COP)
  const T zero = stage::from_f32<T>(0.f);
  const bool dbblk = blockIdx.y == 0;
  if (dbblk) {
    for (int col = t; col < cols; col += THREADS) dbs[col] = 0.f;
  }

  float acc[9][CO_T];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int c = 0; c < CO_T; ++c) acc[k][c] = 0.f;
  }
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_h * tiles_w);
    const int r = tile - b * tiles_h * tiles_w;
    const int ch0 = (r / tiles_w) * tc, cw0 = (r - (r / tiles_w) * tiles_w) * tc;
    const int ih0 = scale * (ch0 << L) - halo, iw0 = scale * (cw0 << L) - halo;
    // the window's packed offsets by axis: row rr -> its image row's part and its phase bits,
    // column cc -> its coarse column's part and its phase bits (offset -1: outside the image)
    if (t < 2 * side) {
      const bool row = t < side;
      const int i = row ? t : t - side;
      const int f = (row ? ih0 : iw0) + i;
      int bits = 0;  // the fine bits of f, spread to the phase's odd (row) or even positions
      for (int k = 0; k < p.Lin; ++k) bits |= ((f >> k) & 1) << (2 * k + row);
      const bool ok = f >= 0 && f < (row ? Hin : Win);
      const long long coarse = row ? (static_cast<long long>(b) * p.Hc + (f >> p.Lin)) * p.Wc
                                   : static_cast<long long>(f >> p.Lin);
      (row ? row_off : col_off)[i] = ok ? coarse * cin_p + bits * p.Ci : -1;
      (row ? row_ph : col_ph)[i] = bits * p.Ci;
    }
    __syncthreads();
    // Both staging loops issue a batch of global reads before they use any (the reads'
    // latency, not their bytes, bounds a tile that reads each value once).
    {
      // channel c of the slice; pixels t / CS + 16 k of the window, row-major
      const int c = t % CS;
      int rr = 0, cc = t / CS;  // t / CS < 16 < side
      for (int pix = t / CS; pix < side * side; pix += UW * (THREADS / CS)) {
        T raw[UW];
        int pcs[UW];
        bool ok[UW];
#pragma unroll
        for (int u = 0; u < UW; ++u) {
          const long long ro = row_off[rr], co = col_off[cc];
          ok[u] = c < nc && pix + u * (THREADS / CS) < side * side && ro >= 0 && co >= 0;
          pcs[u] = row_ph[rr] + col_ph[cc] + c0 + c;
          raw[u] = ok[u] ? X[ro + co + c0 + c] : zero;
          cc += THREADS / CS;  // < side: one wrap at most
          if (cc >= side) {
            cc -= side;
            ++rr;
          }
          rr = rr < side ? rr : side - 1;  // past the window: read no row beyond the table
        }
#pragma unroll
        for (int u = 0; u < UW; ++u) {
          float v = stage::to_f32(raw[u]);
          if (p.has_prologue && ok[u])
            v = stage::round_to<T>(stage::leaky(stage::affine(v, p.mul[pcs[u]], p.add[pcs[u]]),
                                                p.slope));
          if (c < nc && pix + u * (THREADS / CS) < side * side)
            a_s[c * stride + pix + u * (THREADS / CS)] = v;
        }
      }
    }
    // dy of the tile's coarse pixels, each one run of ophs * Co channels in dy
    for (int e0 = t; e0 < (tc * tc) << run_shift; e0 += UD * THREADS) {
      T raw[UD];
#pragma unroll
      for (int u = 0; u < UD; ++u) {
        const int e = e0 + u * THREADS;
        const int cp = e >> run_shift, j = e & ((1 << run_shift) - 1);
        const int ch = ch0 + (cp >> tcs), cw = cw0 + (cp & (tc - 1));
        const bool ok = e < (tc * tc) << run_shift && ch < p.Hc && cw < p.Wc &&
                        (p.Co == COP || j % COP < p.Co);
        const long long off = fine::coarse_offset(p, b, ch, cw, p.Co, p.Lout) +
                              (p.Co == COP ? j : (j / COP) * p.Co + j % COP);
        raw[u] = ok ? DY[off] : zero;
      }
#pragma unroll
      for (int u = 0; u < UD; ++u) {
        const int e = e0 + u * THREADS;
        if (e < (tc * tc) << run_shift) dy_s[e] = stage::to_f32(raw[u]);
      }
    }
    __syncthreads();
    if (dbblk) {
      for (int col = t; col < cols; col += THREADS) {
        const int o = col / p.Co, co = col - o * p.Co;
        float s = dbs[col];
        for (int cp = 0; cp < tc * tc; ++cp) s += dy_s[(cp * ophs + o) * COP + co];
        dbs[col] = s;
      }
    }
    if (cl < nc) {
      const float* ac = a_s + cl * stride;
      // row pixel q of the tile in packed order: coarse pixel q >> 2L, phase q & (nph - 1)
      for (int q = pg; q < THREADS; q += D::NPG) {
        const int cp = q >> (2 * L), ph = q & (nph - 1);
        if (ch0 + (cp >> tcs) >= p.Hc || cw0 + (cp & (tc - 1)) >= p.Wc) continue;
        int dh, dw;
        fine::unphase(ph, L, dh, dw);
        const int lh = ((cp >> tcs) << L) + dh, lw = ((cp & (tc - 1)) << L) + dw;
        const float* g = dy_s + (cp * ophs + (CONVT ? 4 * ph : ph)) * COP + cog * CO_T;
        if constexpr (CONVT) {
          float gv[4][CO_T], v[2][2];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
#pragma unroll
            for (int c = 0; c < CO_T; ++c) gv[s][c] = g[s * COP + c];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) v[i][j] = ac[(lh + i) * side + lw + j];
          }
          // per axis, combination i = (input offset d, output bit a, kernel index k):
          // 0 = (0, 0, 1), 1 = (0, 1, 2), 2 = (1, 1, 0), as the forward's direct path
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const float av = v[i == 2][j == 2];
              const int ki = i == 0 ? 1 : (i == 1 ? 2 : 0), kj = j == 0 ? 1 : (j == 1 ? 2 : 0);
              const int s = (i > 0) * 2 + (j > 0);
#pragma unroll
              for (int c = 0; c < CO_T; ++c)
                acc[ki * 3 + kj][c] = fmaf(av, gv[s][c], acc[ki * 3 + kj][c]);
            }
          }
        } else {
          float gv[CO_T];
#pragma unroll
          for (int c = 0; c < CO_T; ++c) gv[c] = g[c];
#pragma unroll
          for (int u = 0; u < 3; ++u) {
#pragma unroll
            for (int v = 0; v < 3; ++v) {
              const float av = ac[(scale * lh + u) * side + scale * lw + v];
#pragma unroll
              for (int c = 0; c < CO_T; ++c) acc[u * 3 + v][c] = fmaf(av, gv[c], acc[u * 3 + v][c]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // fold the pixel groups in order: thread t = cl + CS (cog + NCOG pg)
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int c = 0; c < CO_T; ++c) red[(t * 9 + k) * CO_T + c] = acc[k][c];
  }
  __syncthreads();
  for (int e = t; e < 9 * nc * p.Co; e += THREADS) {
    const int co = e % p.Co, rest = e / p.Co;
    const int c = rest % nc, k = rest / nc;
    const int g0 = c + CS * (co / CO_T), cc = co % CO_T;
    float s = 0.f;
    for (int pgi = 0; pgi < D::NPG; ++pgi)
      s += red[((g0 + CS * D::NCOG * pgi) * 9 + k) * CO_T + cc];
    a.part[((static_cast<long long>(blockIdx.x) * 9 + k) * p.Ci + c0 + c) * p.Co + co] = s;
  }
  if (dbblk) {
    for (int col = t; col < cols; col += THREADS)
      a.dbpart[static_cast<long long>(blockIdx.x) * cols + col] = dbs[col];
  }
}

// What a launch takes: the path, its grid and the partials' count and floats.
struct Plan {
  bool direct;
  dim3 grid;
  int span;         // GEMM: coarse pixels per split
  int slots;        // dW partial sets (GEMM: row phases * splits; direct: blocks)
  int db_slots;     // db partial rows (GEMM: splits; direct: blocks)
  DirectLayout lay;
  long long floats;
};

template <typename T, int COP, bool CONVT>
cudaError_t direct_blocks(const FineArgs& p, const DirectLayout& lay, int& blocks) {
  const size_t bytes = lay.bytes();
  if (bytes > static_cast<size_t>(SMEM_MAX)) return cudaErrorInvalidValue;
  auto kernel = wgrad_direct_kernel<T, COP, CONVT>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(bytes))) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes)) !=
          cudaSuccess)
    return err;
  const int slices = (p.Ci + CS - 1) / CS;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  const int tc = fine::TILE >> fine::tile_level(p);
  const int tiles = p.B * ((p.Hc + tc - 1) / tc) * ((p.Wc + tc - 1) / tc);
  blocks = resident / slices > 1 ? resident / slices : 1;
  blocks = blocks < tiles ? blocks : tiles;
  return cudaSuccess;
}

template <typename T>
cudaError_t direct_blocks_co(const FineArgs& p, const DirectLayout& lay, int cop, int& blocks) {
  const bool convt = p.recipe == fine::CONVT;
  if (cop == 1)
    return convt ? direct_blocks<T, 1, true>(p, lay, blocks) : direct_blocks<T, 1, false>(p, lay, blocks);
  if (cop == 4)
    return convt ? direct_blocks<T, 4, true>(p, lay, blocks) : direct_blocks<T, 4, false>(p, lay, blocks);
  return convt ? direct_blocks<T, 16, true>(p, lay, blocks) : direct_blocks<T, 16, false>(p, lay, blocks);
}

inline int direct_cop(int co) { return co == 1 ? 1 : (co <= 4 ? 4 : 16); }

template <typename T>
cudaError_t make_plan(const FineArgs& p, Plan& plan) {
  const long long w_floats = 9ll * p.Ci * p.Co;
  const long long cols = static_cast<long long>(p.Co) << (2 * p.Lout);
  plan.direct = p.Co <= 16;
  if (plan.direct) {
    const int cop = direct_cop(p.Co);
    plan.lay = direct_layout(p, cop);
    int blocks = 0;
    const cudaError_t err = direct_blocks_co<T>(p, plan.lay, cop, blocks);
    if (err != cudaSuccess) return err;
    plan.grid = dim3(blocks, (p.Ci + CS - 1) / CS, 1);
    plan.span = 0;
    plan.slots = plan.db_slots = blocks;
    plan.floats = blocks * (w_floats + cols);
    return cudaSuccess;
  }
  const bool convt = p.recipe == fine::CONVT;
  const int bn = gemm_bn(p.Co);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, bn == 32 ? wgrad_gemm_kernel<T, 32>
                             : (bn == 64 ? wgrad_gemm_kernel<T, 64> : wgrad_gemm_kernel<T, 128>),
           THREADS, 0)) != cudaSuccess)
    return err;
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int lrow = fine::tile_level(p);
  const long long nrp = 1ll << (2 * lrow);
  const long long nz = (convt ? 4 : 1) * nrp;
  const long long mtiles = ((convt ? 4ll : 9ll) * p.Ci + BM - 1) / BM;
  const long long ntiles = (p.Co + bn - 1) / bn;
  // blocks of one split that run (convT's output phases have 1, 2, 2 and 4 taps)
  const long long live = convt ? ((p.Ci + BM - 1) / BM + 2 * ((2ll * p.Ci + BM - 1) / BM) +
                                  (4ll * p.Ci + BM - 1) / BM) * nrp * ntiles
                               : mtiles * ntiles * nrp;
  const long long depth = static_cast<long long>(p.B) * p.Hc * p.Wc;
  // splits: two full waves of resident blocks (else one; the last wave nearly full), each
  // split at least MIN_SPAN pixels, the partials under SCRATCH_CAP
  const long long most = std::max(1ll, std::min({(depth + MIN_SPAN - 1) / MIN_SPAN,
                                                 SCRATCH_CAP / (nrp * w_floats), 65535ll}));
  const long long two = 2 * resident / live, one = resident / live;
  long long splits = std::max(1ll, two <= most ? two : (one <= most ? one : most));
  const long long span = ((depth + splits - 1) / splits + BK - 1) / BK * BK;
  splits = (depth + span - 1) / span;
  plan.grid = dim3(static_cast<unsigned>(mtiles * ntiles), static_cast<unsigned>(splits),
                   static_cast<unsigned>(nz));
  plan.span = static_cast<int>(span);
  plan.slots = static_cast<int>(nrp * splits);
  plan.db_slots = static_cast<int>(splits);
  plan.floats = plan.slots * w_floats + plan.db_slots * cols;
  return cudaSuccess;
}

template <typename T, int COP, bool CONVT>
void launch_direct(const WgradArgs& a, const Plan& plan, cudaStream_t s) {
  wgrad_direct_kernel<T, COP, CONVT><<<plan.grid, THREADS, plan.lay.bytes(), s>>>(a, plan.lay);
}

template <typename T>
cudaError_t wgrad(WgradArgs a, float* dw, float* db, float* scratch, cudaStream_t s) {
  Plan plan;
  cudaError_t err = make_plan<T>(a.f, plan);
  if (err != cudaSuccess) return err;
  const FineArgs& p = a.f;
  const long long w_floats = 9ll * p.Ci * p.Co;
  const long long cols = static_cast<long long>(p.Co) << (2 * p.Lout);
  a.part = scratch;
  a.dbpart = scratch + plan.slots * w_floats;
  a.span = plan.span;
  if (plan.direct) {
    const int cop = direct_cop(p.Co);
    const bool convt = p.recipe == fine::CONVT;
    if (cop == 1) {
      convt ? launch_direct<T, 1, true>(a, plan, s) : launch_direct<T, 1, false>(a, plan, s);
    } else if (cop == 4) {
      convt ? launch_direct<T, 4, true>(a, plan, s) : launch_direct<T, 4, false>(a, plan, s);
    } else {
      convt ? launch_direct<T, 16, true>(a, plan, s) : launch_direct<T, 16, false>(a, plan, s);
    }
  } else {
    const int bn = gemm_bn(p.Co);
    if (bn == 32) {
      wgrad_gemm_kernel<T, 32><<<plan.grid, THREADS, 0, s>>>(a);
    } else if (bn == 64) {
      wgrad_gemm_kernel<T, 64><<<plan.grid, THREADS, 0, s>>>(a);
    } else {
      wgrad_gemm_kernel<T, 128><<<plan.grid, THREADS, 0, s>>>(a);
    }
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = stage::fold(a.part, plan.slots, w_floats, dw, s)) != cudaSuccess) return err;
  return stage::fold(a.dbpart, plan.db_slots, cols, db, s);
}

FineArgs wgrad_args(const void* x, const float* mul, const float* add, int B, int Hc, int Wc,
                    int Ci, int Co, int recipe, int levels, float slope, int has_prologue) {
  return FineArgs{x, nullptr, mul, add, nullptr, nullptr, B, Hc, Wc, Ci, Co, levels,
                  fine::out_levels(recipe, levels), recipe, slope, has_prologue, nullptr, nullptr};
}

bool bad_args(const FineArgs& p, int dtype) {
  if (fine::bad_shape(p) || (dtype != 0 && dtype != 1)) return true;
  // the GEMM path's grid z: row phases (times convT's four output phases)
  return p.Co > 16 && ((p.recipe == fine::CONVT ? 4ll : 1ll) << (2 * fine::tile_level(p))) > 65535;
}

}  // namespace

// The float32 scratch stage_wgrad_fine needs for its partials, for the same arguments on the
// current device (-1 for a shape or a type it does not take).
extern "C" long long stage_wgrad_fine_scratch_floats(int B, int Hc, int Wc, int Ci, int Co,
                                                     int recipe, int levels, int has_prologue,
                                                     int dtype) {
  const FineArgs p = wgrad_args(nullptr, nullptr, nullptr, B, Hc, Wc, Ci, Co, recipe, levels,
                                0.f, has_prologue);
  if (bad_args(p, dtype)) return -1;
  Plan plan;
  const cudaError_t err = dtype == 0 ? make_plan<float>(p, plan) : make_plan<__nv_bfloat16>(p, plan);
  return err == cudaSuccess ? plan.floats : -1;
}

// x (B, Hc, Wc, 4^levels Ci) and dy (B, Hc, Wc, 4^Lout Co) packed, in the type `dtype` (0 =
// float32, 1 = bfloat16); recipe (0 conv, 1 stem, 2 convT) and levels as stage_fwd_fine's;
// mul/add (4^levels Ci,) float32, read with a prologue. Writes dw (3, 3, Ci, Co) and db
// (4^Lout Co,) float32. `scratch` holds stage_wgrad_fine_scratch_floats(...) float32.
// Launches on `stream` and does not synchronise.
extern "C" int stage_wgrad_fine(const void* x, const void* dy, const float* mul,
                                const float* add, float* dw, float* db, float* scratch, int B,
                                int Hc, int Wc, int Ci, int Co, int recipe, int levels,
                                float slope, int has_prologue, int dtype, void* stream) {
  WgradArgs a{wgrad_args(x, mul, add, B, Hc, Wc, Ci, Co, recipe, levels, slope, has_prologue),
              dy, nullptr, nullptr, 0};
  if (bad_args(a.f, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? wgrad<float>(a, dw, db, scratch, s)
                    : wgrad<__nv_bfloat16>(a, dw, db, scratch, s);
}
