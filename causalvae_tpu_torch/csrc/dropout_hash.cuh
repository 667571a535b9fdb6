// Counter-based attention-dropout mask shared by the attention forward and backward
// kernels: a pure function of the global coordinates (seed, head, query row, key
// column), so every kernel regenerates the same mask whatever its tiling.
//
// Bit-identical to dropout_keep / _mix32 / keep_from_bits of
// causalvae_tpu/ops/kernels/attention.py (the JAX package's interpret-mode and
// host-side mask; its TPU hardware generator _hw_tile_bits is not ported):
//   h = mix32(((row * M1) ^ (col * M2) ^ (bh * M3)) + seed)   in uint32 (wrapping)
//   keep  iff  h >= thresh,   thresh = uint32(min(rate * 2^32, 2^32 - 1))

#pragma once

#include <stdint.h>

namespace dropout_hash {

constexpr uint32_t M1 = 0x9E3779B1u;
constexpr uint32_t M2 = 0x85EBCA77u;
constexpr uint32_t M3 = 0xC2B2AE3Du;

// murmur3 finalizer: full-avalanche 32-bit mixer
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ bool keep(uint32_t seed, uint32_t bh, uint32_t row,
                                     uint32_t col, uint32_t thresh) {
  return mix32(((row * M1) ^ (col * M2) ^ (bh * M3)) + seed) >= thresh;
}

}  // namespace dropout_hash
