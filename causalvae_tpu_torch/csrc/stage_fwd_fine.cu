// Stage forward on the fine grid for Hopper (sm_90a): the same function as stage_fwd.cu,
//   y = conv(leaky(x * mul + add, slope)) + bias
// on phase-packed tensors, but computed as the model's own 3x3 convolution on the fine
// (unpacked) pixel grid, with only its real taps, reading x and writing y where they lie
// in packed storage (stage_fine.cuh: the layout, the three recipes and both paths). The
// base kernel is (3, 3, Ci, Co) in x's type, the tensor ops/subpixel.py lifts. mul/add are
// per packed input channel (4^L_in * Ci,), bias per packed output channel, all float32.
// Zero padding comes after the activation, at the fine image's edge. Sums are float32 FMA
// (no TF32); in bfloat16 the activation rounds to bf16 before the product, as the plain
// version casts it, and the prologue rounds as stage_gemm.cuh's affine does.
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
// Design, two paths (stage_fine.cuh):
// - GEMM path (Co > 16): the implicit GEMM of stage_gemm.cuh (Tiles, mma_step; 128 x 64/128
//   block tiles, depth 8) with M = fine output pixels (for convT those of one output
//   phase, blockIdx.z, so the reduction runs over exactly that phase's 1, 2 or 4 taps),
//   N = Co, depth = real taps x Ci. The A gather maps each fine pixel to its packed
//   address and applies the prologue with its packed channel's mul/add; the epilogue
//   stores to the packed output address.
// - Direct path (Co <= 16): one block per 16 x 16 tile of fine pixels made of whole coarse
//   pixels (output pixels for conv/stem, input pixels for convT). It stages the activated
//   input window once in shared memory (the prologue runs once per element, not once per
//   tap) with the base kernel, in channel chunks; each thread computes all Co outputs of
//   one fine pixel (convT: of the four output pixels 2q + (a, b) of its input pixel q,
//   nine taps, no divergence). Threads follow the packed phase order, so the 4^L * Co
//   outputs of a coarse pixel are written as one contiguous run.
//
// C interface: stage_fwd_fine(...) returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a type or a shape it does not take).

#include "stage_fine.cuh"

namespace {

template <typename T>
cudaError_t launch(const fine::FineArgs& p, cudaStream_t stream) {
  if (p.Co <= 16) return fine::launch_direct_co<T, false>(p, stream);
  return fine::launch_gemm<T, false>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; recipe: 0 conv, 1 stem, 2 convT; levels: the input's
// packing levels. Ci and Co are the base kernel's channels. Launches on `stream` and does
// not synchronise.
extern "C" int stage_fwd_fine(const void* x, const float* mul, const float* add, const void* w,
                              const float* bias, void* y, int B, int Hc, int Wc, int Ci, int Co,
                              int recipe, int levels, float slope, int has_prologue, int dtype,
                              void* stream) {
  fine::FineArgs p{x, w, mul, add, bias, y, B, Hc, Wc, Ci, Co, levels,
                   fine::out_levels(recipe, levels), recipe, slope, has_prologue};
  if (fine::bad_shape(p)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(p, s);
    case 1: return launch<__nv_bfloat16>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
