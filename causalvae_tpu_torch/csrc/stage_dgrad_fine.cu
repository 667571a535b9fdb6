// Stage dgrad on the fine grid for Hopper (sm_90a): the x-side cotangents of
//   y = conv(leaky(x * mul + add, slope)) + bias
// (stage_fwd_fine.cu) on phase-packed tensors, from dy, x, mul, add and the module's base
// kernel W (3, 3, Ci, Co):
//   da   = the transpose of the module's own 3x3 conv applied to dy, on the fine grid, real
//          taps only,
//   dz   = da * leaky'(pre), pre = x * mul + add (recomputed, rounded twice as the forward
//          rounds it, never FMA-contracted),
//   dx   = dz * mul, written where x lies in packed storage,
//   dmul[pc] = sum of dz * x,  dadd[pc] = sum of dz, per packed channel pc = phase * Ci + c,
//          float32.
// Without a prologue dx = da and dmul/dadd are not written. x, dy, dx in x's type (float32
// or bfloat16; sums float32, no TF32).
//
// Replaces the dx/dmul/dadd half of the Pallas TPU kernel _stage_bwd_kernel /
// _stage_bwd_call (causalvae_tpu/ops/kernels/stage.py), row 7 of PERF.md's kernel table,
// on the model's path; stage_bwd.cu's lifted dgrad stays for the generic op, and its
// wgrad-only entry gives dW and db beside this kernel.
//
// What bounds it on this card: as the forward's, the real work is small. The lifted dgrad
// carried the structural zeros of the lifted kernel (807 GFLOP per packed-fused step, 120
// real); counted on the real taps and on each byte read or written once, the Ci >= 32
// shapes are operations-bound at 67 TFLOP/s (the stem's conv 1: 18.1 GFLOP, 0.270 ms) and
// the two decoder-tail shapes (base Ci = 16) are bytes-bound at 3.35 TB/s: dec_out reads
// dy and x and writes dx (1.04 GB, 0.310 ms), dec_ct[4] reads dy and writes dx (0.63 GB,
// 0.188 ms).
// Design: the transpose of each recipe is another recipe of the forward's machinery
// (stage_fine.cuh), so the packed-address gather, the store and the per-phase tap tables
// are the forward's and only the epilogue is new:
//   conv  -> conv  with W'[u][v] = W[2 - u][2 - v]^T, dy at level L to da at L;
//   stem  -> convT with W'[u][v] = W[u][v]^T, dy at level L - 1 to da at L;
//   convT -> stem  with W'[u][v] = W[u][v]^T, dy at level L + 1 to da at L.
// The caller applies the map: it passes the transposed recipe, dy's levels and W' (3, 3, Co,
// Ci) (ops/kernels/stage.py stage_dgrad_fine, stage_dgrad_weight, held to the autograd of
// the plain version by a CPU test). The dgrad's "output channels" are the base Ci. Ci > 16 takes the GEMM path, each block
// on the coarse pixels of one packed phase so its column sums are a slice of one partial
// row; Ci <= 16 (dec_out and dec_ct[4], where the bytes go) the direct path, with as many
// blocks as fit on the card walking over the tiles and keeping their threads' partials in
// registers. The partial rows ((2, R, 4^L * Ci), R the grid's rows or blocks, a few MB) are
// folded without atomics in a fixed order, so the same inputs give the same bits.
//
// C interface: stage_dgrad_fine(...) returns cudaGetLastError() after its launches
// (cudaErrorInvalidValue for a type or a shape it does not take);
// stage_dgrad_fine_scratch_floats(...) gives the float32 scratch of the partials.

#include "stage_fine.cuh"

namespace {

using fine::FineArgs;
using stage::THREADS;

constexpr int FOLD_ROWS = 8;  // row groups of a fold block (32 columns each)

// dmul[l] / dadd[l] = sum over r < R, in order, of part[0 / 1][r][l]: thread (x, y) of a
// block sums the rows [y R / 8, (y + 1) R / 8) of column 32 blockIdx.x + x in order, then
// y = 0 adds the eight sums in order. grid: (columns / 32, 2 = dmul, dadd).
__global__ void __launch_bounds__(32 * FOLD_ROWS)
fold_rows_kernel(const float* __restrict__ part, int R, int P, float* __restrict__ dmul,
                 float* __restrict__ dadd) {
  __shared__ float red[FOLD_ROWS][33];
  const int l = blockIdx.x * 32 + threadIdx.x;
  const int r0 = static_cast<int>(static_cast<long long>(R) * threadIdx.y / FOLD_ROWS);
  const int r1 = static_cast<int>(static_cast<long long>(R) * (threadIdx.y + 1) / FOLD_ROWS);
  const float* src = part + static_cast<long long>(blockIdx.y) * R * P;
  float s = 0.f;
  if (l < P) {
    for (int r = r0; r < r1; ++r) s += src[static_cast<long long>(r) * P + l];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && l < P) {
    float total = 0.f;
    for (int i = 0; i < FOLD_ROWS; ++i) total += red[i][threadIdx.x];
    (blockIdx.y == 0 ? dmul : dadd)[l] = total;
  }
}

// The transposed conv as the forward machinery's arguments: in = dy, out = dx.
FineArgs dgrad_args(const void* x, const void* dy, const float* mul, const float* add,
                    const void* wt, void* dx, float* scratch, int B, int Hc, int Wc, int Ci,
                    int Co, int recipe, int levels, float slope, int has_prologue) {
  return FineArgs{dy, wt, mul, add, nullptr, dx, B, Hc, Wc, Ci, Co, levels,
                  fine::out_levels(recipe, levels), recipe, slope, has_prologue, x, scratch};
}

// Rows of the partials: the GEMM grid's row tiles or the direct grid's blocks.
template <typename T>
cudaError_t partial_rows(const FineArgs& p, int& rows) {
  if (p.Co > 16) {
    rows = static_cast<int>(fine::gemm_grid<true>(p).x);
    return cudaSuccess;
  }
  return fine::launch_direct_co<T, true>(p, nullptr, &rows);
}

template <typename T>
cudaError_t dgrad(const FineArgs& p, float* dmul, float* dadd, cudaStream_t stream) {
  cudaError_t err = p.Co > 16 ? fine::launch_gemm<T, true>(p, stream)
                              : fine::launch_direct_co<T, true>(p, stream);
  if (err != cudaSuccess || !p.has_prologue) return err;
  int rows = 0;
  if ((err = partial_rows<T>(p, rows)) != cudaSuccess) return err;
  const int P = p.Co << (2 * p.Lout);
  const dim3 grid((P + 31) / 32, 2);
  fold_rows_kernel<<<grid, dim3(32, FOLD_ROWS), 0, stream>>>(p.partials, rows, P, dmul, dadd);
  return cudaGetLastError();
}

bool bad_dtype(int dtype) { return dtype != 0 && dtype != 1; }

}  // namespace

// The float32 scratch stage_dgrad_fine needs for its partials (0 without a prologue), for
// the same arguments on the current device.
extern "C" long long stage_dgrad_fine_scratch_floats(int B, int Hc, int Wc, int Ci, int Co,
                                                     int recipe, int levels, int has_prologue,
                                                     int dtype) {
  const FineArgs p = dgrad_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                B, Hc, Wc, Ci, Co, recipe, levels, 0.f, has_prologue);
  if (fine::bad_shape(p) || bad_dtype(dtype)) return -1;
  if (!has_prologue) return 0;
  int rows = 0;
  const cudaError_t err = dtype == 0 ? partial_rows<float>(p, rows)
                                     : partial_rows<__nv_bfloat16>(p, rows);
  if (err != cudaSuccess) return -1;
  return 2ll * rows * (static_cast<long long>(Co) << (2 * p.Lout));
}

// The transposed conv as it runs (the file note's map, applied by the caller): recipe (0
// conv, 1 stem, 2 convT) and levels are its own, from dy (B, Hc, Wc, 4^levels Ci) packed to
// dx at x's shape (B, Hc, Wc, 4^Lout Co); Ci and Co are the module's Co and Ci; wt (3, 3, Ci,
// Co) the transposed kernel in x's type. mul/add (4^Lout Co,) float32; dmul/dadd the same,
// written with a prologue. dtype: 0 = float32, 1 = bfloat16. `scratch` holds
// stage_dgrad_fine_scratch_floats(...) float32. Launches on `stream` and does not
// synchronise.
extern "C" int stage_dgrad_fine(const void* x, const void* dy, const float* mul,
                                const float* add, const void* wt, void* dx, float* dmul,
                                float* dadd, float* scratch, int B, int Hc, int Wc, int Ci,
                                int Co, int recipe, int levels, float slope, int has_prologue,
                                int dtype, void* stream) {
  const FineArgs p = dgrad_args(x, dy, mul, add, wt, dx, scratch, B, Hc, Wc, Ci, Co, recipe,
                                levels, slope, has_prologue);
  if (fine::bad_shape(p) || bad_dtype(dtype)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dgrad<float>(p, dmul, dadd, s) : dgrad<__nv_bfloat16>(p, dmul, dadd, s);
}
