// The counter-based uniform of cdae_tpu's tiling-invariant mask stream
// (cdae_tpu/ops/cdae_fused.py _hash_uniform), shared by hw_uniform.cu and
// cdae_fused.cu so that the unfused train step and the fused kernel draw the
// very same masks.
//
// u(seed, row, col, draw) = low 24 bits of a murmur-style mix of the four
// 32-bit words, times 2^-24: a float in [0, 1) that depends on nothing but
// its coordinates. All arithmetic is unsigned 32-bit, wrapping, with
// logical shifts -- the same bits as cdae_tpu's int32 version.

#pragma once

#include <cstdint>

namespace cdae {

constexpr uint32_t kHashRow = 0x9E3779B9u;  // -1640531527 as int32
constexpr uint32_t kHashCol = 0x85EBCA77u;  // -2048144777
constexpr uint32_t kHashM1 = 0x85EBCA6Bu;   // -2048144789
constexpr uint32_t kHashM2 = 0xC2B2AE35u;   // -1028477387

__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t row,
                                              uint32_t col, uint32_t draw) {
  uint32_t x = seed + row * kHashRow + col * kHashCol + draw * kHashM2;
  x ^= x >> 16;
  x *= kHashM1;
  x ^= x >> 13;
  x *= kHashM2;
  x ^= x >> 16;
  // 24 bits convert to float exactly, and the scale is a power of two
  return static_cast<float>(x & 0xFFFFFFu) * (1.0f / 16777216.0f);
}

}  // namespace cdae
