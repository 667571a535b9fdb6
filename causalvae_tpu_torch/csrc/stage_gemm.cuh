// The tiled float32 GEMM core shared by the stage kernels (stage_fwd.cu, stage_bwd.cu, and
// through stage_fine.cuh the fine-grid ones), the dgrad epilogue's arithmetic and block
// column sums, the fixed-order fold of split partials, and the implicit-GEMM convolution
// kernel that the lifted forward and dgrad run.
//
// Block tile: BM = 128 rows by BN = 128 (or 64, or 32) columns, depth BK = 8 per k-step, 256
// threads. Thread (ty, tx) = (t / 16, t % 16) owns rows ty*4 + i and 64 + ty*4 + i
// (i < 4) and columns tx*4 + j and, for BN = 128, 64 + tx*4 + j (BN = 32: tx*2 + j): 8 x 8
// (8 x 4, 8 x 2) sums in registers, fed by float4 reads of the shared tiles As[k][m] and
// Bs[k][n] (BN = 32: float2 reads of Bs). The
// next k-step's tiles are loaded into registers while the current one is multiplied,
// then stored into the other of two shared buffers (one barrier per k-step). Every
// product is a float32 FMA (no TF32), whatever the storage type.
//
// conv_gemm_kernel: a same-size KxK convolution of an NHWC tensor as a GEMM with
// M = B*H*W pixels, N output channels and depth K*K times the input channels. The A
// tile is gathered pixel by pixel from the tap's shifted position (zero outside the
// image), so no padded or unfolded copy of the input exists.
//   forward (DGRAD false): A = x with the prologue leaky(x*mul + add) applied as it
//     loads (zero padding AFTER the activation), B = W[u][v] (Ci x Co), epilogue +bias;
//   dgrad (DGRAD true): A = dy shifted the other way, B = W[u][v]^T (Co x Ci), epilogue
//     dx = da * leaky'(pre) * mul and per-block column partials of da * leaky' * x and
//     da * leaky' (dmul, dadd), folded later in a fixed order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace stage {

constexpr int THREADS = 256;
constexpr int BM = 128;
constexpr int BK = 8;
constexpr int PAD = 4;  // floats of padding per shared row: conflict-free transposed stores

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The value a tensor of type T holds for v (bf16 rounds, float is exact).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

__device__ __forceinline__ float leaky(float pre, float slope) {
  return pre >= 0.f ? pre : slope * pre;
}

// pre = x * mul + add rounded after the product and after the sum (no FMA contraction),
// as the plain version's two elementwise ops round it: where pre lies within an ulp of
// 0, a contracted FMA could take the other side of the LeakyReLU and the backward's gate
// would differ from the plain version's by (1 - slope) * da * mul.
__device__ __forceinline__ float affine(float x, float mul, float add) {
  return __fadd_rn(__fmul_rn(x, mul), add);
}

// The dgrad epilogue at one element: with pre recomputed as the forward rounds it, dz = da *
// leaky'(pre); adds dz * x and dz to the running dmul and dadd sums and returns dx = dz * mul.
__device__ __forceinline__ float dgrad_point(float xv, float mul, float add, float slope,
                                             float da, float& smul, float& sadd) {
  const float pre = affine(xv, mul, add);
  const float dpre = pre >= 0.f ? da : slope * da;
  smul += dpre * xv;
  sadd += dpre;
  return dpre * mul;
}

template <int BN>
struct Tiles {
  float a[2][BK][BM + PAD];
  float b[2][BK][BN + PAD];
};

__device__ __forceinline__ int row_of(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}
__device__ __forceinline__ int col_of(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}
// col_of for any BN of mma_step (BN = 32: two adjacent columns a thread)
template <int BN>
__device__ __forceinline__ int tile_col(int tx, int j) {
  return BN == 32 ? tx * 2 + j : col_of(tx, j);
}

// acc[i][j] += sum over the BK rows k of As[k][row_of(ty, i)] * Bs[k][col_of(tx, j)].
template <int BN>
__device__ __forceinline__ void mma_step(const float (*As)[BM + PAD],
                                         const float (*Bs)[BN + PAD], int ty, int tx,
                                         float (&acc)[8][BN / 16]) {
  constexpr int TN = BN / 16;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[8], b[TN];
    const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    if constexpr (TN == 2) {
      const float2 b0 = *reinterpret_cast<const float2*>(&Bs[k][tx * 2]);
      b[0] = b0.x; b[1] = b0.y;
    } else {
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    }
    if constexpr (TN == 8) {
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Column sums of a block's BM x BN tile in a fixed order: each thread's sums over its 8 rows
// (cmul, cadd per column j), then the 16 row groups in order, through `red` (the shared tiles,
// free after the main loop's last barrier; 32 * BN floats). Thread t < BN gets column t's.
template <int BN>
__device__ __forceinline__ void block_column_sums(float* red, const float (&cmul)[BN / 16],
                                                  const float (&cadd)[BN / 16], int ty, int tx,
                                                  int t, float& smul, float& sadd) {
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    red[ty * BN + col_of(tx, j)] = cmul[j];
    red[(16 + ty) * BN + col_of(tx, j)] = cadd[j];
  }
  __syncthreads();
  smul = sadd = 0.f;
  if (t < BN) {
    for (int r = 0; r < 16; ++r) {
      smul += red[r * BN + t];
      sadd += red[(16 + r) * BN + t];
    }
  }
}

// out[l] = sum over s < S, in order, of part[s * L + l]: the fixed-order fold of split
// partials (the same inputs give the same bits).
__global__ void __launch_bounds__(THREADS)
fold_kernel(const float* __restrict__ part, int S, long long L, float* __restrict__ out) {
  const long long l = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (l >= L) return;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s += part[static_cast<long long>(i) * L + l];
  out[l] = s;
}

inline cudaError_t fold(const float* part, int S, long long L, float* out, cudaStream_t s) {
  const long long blocks = (L + THREADS - 1) / THREADS;
  fold_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(part, S, L, out);
  return cudaGetLastError();
}

struct ConvArgs {
  const void* a;       // A operand, NHWC: x (forward) or dy (dgrad)
  const void* w;       // kernel HWIO (K, K, Ci, Co)
  const float* mul;    // (Ci,) prologue affine
  const float* add;
  const float* bias;   // (Co,), forward
  const void* x;       // dgrad: x (B, H, W, Ci) for the epilogue
  void* out;           // forward: y (B, H, W, Co); dgrad: dx (B, H, W, Ci)
  float* partials;     // dgrad with prologue: (2, gridDim.x, Ci)
  int B, H, W, Ci, Co, K, pad_lo;
  float slope;
  int has_prologue;
};

template <typename T, int BN, bool DGRAD>
__global__ void __launch_bounds__(THREADS) conv_gemm_kernel(const ConvArgs p) {
  constexpr int TN = BN / 16;
  constexpr int BLOADS = BN * BK / THREADS;
  __shared__ __align__(16) Tiles<BN> sm;
  const T* A = static_cast<const T*>(p.a);
  const T* Wt = static_cast<const T*>(p.w);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int M = p.B * p.H * p.W;
  const int Ca = DGRAD ? p.Co : p.Ci;  // channels of A: the reduction
  const int N = DGRAD ? p.Ci : p.Co;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int chunks = (Ca + BK - 1) / BK;
  const int KT = p.K * p.K * chunks;
  const bool prologue = !DGRAD && p.has_prologue;

  // A loads: channel column ka of the k-step, pixels m0 + t / 8 + 32 i
  const int ka = t % BK;
  int ab[4], ah[4], aw[4];
  bool am[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + t / BK + 32 * i;
    am[i] = m < M;
    const int mm = am[i] ? m : 0;
    ab[i] = mm / (p.H * p.W);
    const int rem = mm - ab[i] * p.H * p.W;
    ah[i] = rem / p.W;
    aw[i] = rem - ah[i] * p.W;
  }
  long long asrc[4];  // element offset of the tap's source pixel, -1 outside the image
  float ra[4], rb[BLOADS];

  auto b_coords = [&](int j, int& kb, int& nb) {
    if (DGRAD) {  // W[u][v][n][k]: k contiguous
      kb = t % BK;
      nb = t / BK + (THREADS / BK) * j;
    } else {      // W[u][v][k][n]: n contiguous
      const int e = t + THREADS * j;
      kb = e / BN;
      nb = e % BN;
    }
  };
  auto load = [&](int kt) {
    const int tap = kt / chunks;
    const int c0 = (kt - tap * chunks) * BK;
    if (c0 == 0) {  // a new tap: shift the pixels
      const int u = tap / p.K, v = tap - u * p.K;
      const int dh = DGRAD ? p.pad_lo - u : u - p.pad_lo;
      const int dw = DGRAD ? p.pad_lo - v : v - p.pad_lo;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int sh = ah[i] + dh, sw = aw[i] + dw;
        const bool ok = am[i] && sh >= 0 && sh < p.H && sw >= 0 && sw < p.W;
        asrc[i] = ok ? (static_cast<long long>(ab[i] * p.H + sh) * p.W + sw) * Ca : -1;
      }
    }
    const int c = c0 + ka;
    float mu = 1.f, ad = 0.f;
    if (prologue && c < Ca) {
      mu = p.mul[c];
      ad = p.add[c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
      if (asrc[i] >= 0 && c < Ca) {
        v = to_f32(A[asrc[i] + c]);
        if (prologue) v = round_to<T>(leaky(affine(v, mu, ad), p.slope));
      }
      ra[i] = v;
    }
#pragma unroll
    for (int j = 0; j < BLOADS; ++j) {
      int kb, nb;
      b_coords(j, kb, nb);
      const int kc = c0 + kb, n = n0 + nb;
      float v = 0.f;
      if (kc < Ca && n < N) {
        const long long off = DGRAD
            ? (static_cast<long long>(tap) * p.Ci + n) * p.Co + kc
            : (static_cast<long long>(tap) * p.Ci + kc) * p.Co + n;
        v = to_f32(Wt[off]);
      }
      rb[j] = v;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sm.a[buf][ka][t / BK + 32 * i] = ra[i];
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
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
    mma_step<BN>(sm.a[cur], sm.b[cur], ty, tx, acc);
    if (kt + 1 < KT) store(cur ^ 1);
    __syncthreads();
  }

  T* out = static_cast<T*>(p.out);
  if constexpr (!DGRAD) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + row_of(ty, i);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + col_of(tx, j);
        if (n < N) out[static_cast<long long>(m) * N + n] = from_f32<T>(acc[i][j] + p.bias[n]);
      }
    }
  } else {
    const T* X = static_cast<const T*>(p.x);
    float cmul[TN], cadd[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) cmul[j] = cadd[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + row_of(ty, i);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + col_of(tx, j);
        if (n >= N) continue;
        const long long off = static_cast<long long>(m) * N + n;
        out[off] = from_f32<T>(p.has_prologue
                                   ? dgrad_point(to_f32(X[off]), p.mul[n], p.add[n], p.slope,
                                                 acc[i][j], cmul[j], cadd[j])
                                   : acc[i][j]);
      }
    }
    if (p.has_prologue) {
      float sm_mul, sm_add;
      block_column_sums<BN>(reinterpret_cast<float*>(&sm), cmul, cadd, ty, tx, t, sm_mul, sm_add);
      if (t < BN && n0 + t < N) {
        p.partials[static_cast<long long>(blockIdx.x) * N + n0 + t] = sm_mul;
        p.partials[(static_cast<long long>(gridDim.x) + blockIdx.x) * N + n0 + t] = sm_add;
      }
    }
  }
}

template <typename T, bool DGRAD>
cudaError_t launch_conv_gemm(const ConvArgs& p, cudaStream_t stream) {
  const int M = p.B * p.H * p.W;
  const int N = DGRAD ? p.Ci : p.Co;
  const dim3 grid((M + BM - 1) / BM, N <= 64 ? 1 : (N + 127) / 128);
  if (N <= 64) {
    conv_gemm_kernel<T, 64, DGRAD><<<grid, THREADS, 0, stream>>>(p);
  } else {
    conv_gemm_kernel<T, 128, DGRAD><<<grid, THREADS, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

inline bool bad_conv_shape(int B, int H, int W, int Ci, int Co, int K, int pad_lo) {
  if (B < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 || K < 1) return true;
  if (pad_lo < 0 || pad_lo >= K) return true;
  const long long M = static_cast<long long>(B) * H * W;
  return M >= (1ll << 31) - BM || (Co + 127) / 128 > 65535 || (Ci + 127) / 128 > 65535;
}

}  // namespace stage
