// Shared pieces of the carry tails K5 (orbit_tail.cu), K10 and K11
// (fused_tail.cuh): carry maps {-1, 0, 1} -> {-1, 0, 1} in two bits per
// value, their composition, and block-wide minimum and maximum.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// a map {-1, 0, 1} -> {-1, 0, 1}, two bits per value (value + 1)
__device__ __forceinline__ uint32_t enc(int fm, int f0, int fp) {
  return static_cast<uint32_t>((fm + 1) | ((f0 + 1) << 2) | ((fp + 1) << 4));
}
__device__ __forceinline__ int apply(uint32_t f, int c) {
  return static_cast<int>((f >> (2 * (c + 1))) & 3u) - 1;
}
// g after f
__device__ __forceinline__ uint32_t compose(uint32_t g, uint32_t f) {
  return enc(apply(g, apply(f, -1)), apply(g, apply(f, 0)),
             apply(g, apply(f, 1)));
}

__device__ int block_min(int v, int *red) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : INT_MAX;
    for (int o = 16; o; o >>= 1)
      v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (threadIdx.x == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
  return v;
}

__device__ int block_max(int v, int *red) {
  return -block_min(-v, red);
}

}  // namespace
