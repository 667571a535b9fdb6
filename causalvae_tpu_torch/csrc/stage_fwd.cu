// Stage forward for Hopper (sm_90a): BatchNorm-apply + LeakyReLU folded into the
// consuming same-size KxK convolution,
//   y[b, h, w, :] = bias + sum_{u, v} a[b, h + u - pad_lo, w + v - pad_lo, :] . W[u, v]
//   a = leaky(x * mul + add, slope) inside the image, 0 outside (padding after the
//       activation); a = x when there is no prologue,
// x NHWC (B, H, W, Ci) float32 or bfloat16, W HWIO (K, K, Ci, Co) in x's type, mul/add
// (Ci,) and bias (Co,) float32, y in x's type. Sums are float32 (FMA, no TF32); in
// bfloat16 the activation rounds to bf16 before the product, as the JAX reference casts it.
//
// Replaces the Pallas TPU kernel _stage_kernel / _stage_call
// (causalvae_tpu/ops/kernels/stage.py). That kernel kept a whole image in VMEM as
// (H*W, C) rows, turned each tap into a shifted row slice with column-wrap masks and
// one MXU matmul, and computed the activation once per image into a scratch buffer.
//
// What bounds it on this card: operations. The phase-packed model's lifted kernels
// carry structural zeros, and the work counted here is the lifted work (2 * B*H*W *
// K*K * Ci * Co flops: 145 GFLOP for dec_out at batch 8, against ~50 MB read), far
// above the ~20 flops per byte where float32 FMA on the CUDA cores (67 TFLOP/s)
// balances 3.35 TB/s.
// Design (stage_gemm.cuh): an implicit GEMM, M = B*H*W pixels, N = Co, depth K*K*Ci, in
// 128 x 128 (or x 64 for Co <= 64) block tiles. The A tile is gathered from the tap's
// shifted pixels with the affine and the activation applied as it is staged in shared
// memory, so the normalized tensor never reaches device memory; the bias is added in the
// epilogue. Indexing is 2-D (pixel, channel): no flat-row geometry or wrap masks.
//
// C interface: stage_fwd(...) returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a type or a shape it does not take).

#include "stage_gemm.cuh"

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` and does not synchronise.
extern "C" int stage_fwd(const void* x, const float* mul, const float* add, const void* w,
                         const float* bias, void* y, int B, int H, int W, int Ci, int Co,
                         int K, int pad_lo, float slope, int has_prologue, int dtype,
                         void* stream) {
  if (stage::bad_conv_shape(B, H, W, Ci, Co, K, pad_lo)) return cudaErrorInvalidValue;
  stage::ConvArgs p{x, w, mul, add, bias, nullptr, y, nullptr,
                    B, H, W, Ci, Co, K, pad_lo, slope, has_prologue};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return stage::launch_conv_gemm<float, false>(p, s);
    case 1: return stage::launch_conv_gemm<__nv_bfloat16, false>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
