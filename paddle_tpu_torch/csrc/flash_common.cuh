// What the dense (flash_attention.cu) and varlen (flash_attention_varlen.cu)
// flash kernels share, so that both draw the same dropout bits.
#pragma once

#include "common.cuh"

// tiles: a block of 4 warps takes 32 q rows (8 per warp) against 32 keys
constexpr int kFaWarps = 4;
constexpr int kFaRows = 8;  // q rows per warp
constexpr int kFaBQ = kFaWarps * kFaRows;
constexpr int kFaBK = 32;
constexpr int kFaThreads = kFaWarps * 32;

// flash_attention.py::_dropout_keep on one (row, col): murmur3-style
// mixing in wrapping 32-bit arithmetic with logical shifts.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh, uint32_t row,
                                             uint32_t col, uint32_t thresh) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  x = x ^ (bh * 0xC2B2AE3Du) ^ seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x & 0x7FFFFFFFu) >= thresh;
}
