// Tensor-core products in TF32 on Hopper (sm_80 and later), with the 3xTF32
// split that keeps float32 accuracy, and cp.async staging into shared memory.
//
// One warp-wide mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 computes
// C (16x8, f32) += A (16x8) * B (8x8). Lane l of the warp, with g = l >> 2 and
// t = l & 3, holds (PTX ISA "Matrix fragments for mma.m16n8k8", the layouts of
// CUTLASS's SM80_16x8x8_F32TF32TF32F32_TN):
//   A: a0 = A[g][t],   a1 = A[g + 8][t],   a2 = A[g][t + 4],   a3 = A[g + 8][t + 4]
//   B: b0 = B[t][g],   b1 = B[t + 4][g]                     (B indexed [k][n])
//   C: c0 = C[g][2t],  c1 = C[g][2t + 1],  c2 = C[g + 8][2t],  c3 = C[g + 8][2t + 1]
// A lane's C elements lie in the rows of its A elements, but in other columns.
// Where a C fragment is the A operand of the next product, the product's k
// index is relabelled instead of moving data: k slot t stands for column 2t and
// slot t + 4 for column 2t + 1, so A = (c0, c2, c1, c3), and B's rows are read
// in the same order (b0 = B[2t][g], b1 = B[2t + 1][g]).
//
// TF32 keeps 10 explicit mantissa bits. A float32 product runs split:
// x = hi + lo with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x - hi
// is exact), and a * b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b, each term one mma
// accumulating in f32; the dropped lo_a lo_b is ~2^-22 of the product. Inputs
// that are exact in TF32 (bf16 values) take one mma.

#pragma once

#include <stdint.h>

namespace tf32 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> (hi, lo); with kSplit false only hi (x rounded to TF32), lo = 0.
template <bool kSplit>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = kSplit ? to_tf32(x - __uint_as_float(hi)) : 0u;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b: three mmas (small terms first) when kSplit, else hi * hi alone.
template <bool kSplit>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  if (kSplit) {
    mma(c, alo, bhi);
    mma(c, ahi, blo);
  }
  mma(c, ahi, bhi);
}

// ---- cp.async: global -> shared without registers; src_size 0 zero-fills ----

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

}  // namespace tf32
