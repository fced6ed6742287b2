// K5's device functions, shared by its launches (orbit_tail.cu) and by
// K12 (orbit_chunk.cu): the digit sums of one step, the carry map of a
// segment, the wide form's scratch layout and scan of maps, and its last
// two phases (W5, W6) as loop bodies over (block, component) items, so
// that K12's grid form can run them between grid-wide barriers.  The carry
// argument is orbit_tail.cu's.
//
// As in ntt_orbit.cuh, no pointer that a phase writes is __restrict__:
// K12 reads the coefficients, the digits, the scratch and the rows in the
// launch that writes them.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tail_common.cuh"

namespace {

// One instance's inputs and outputs.  K = 2 (K5): row_in holds the
// pre-update z's signs at 10 and 11, row_out gets the shadow row [12] of
// the new z.  K = 4 (K5-NR): row_in is unused, row_out gets the signs [4].
struct Tail {
  const int64_t *coef;     // [K][L]
  const int32_t *row_in;
  int32_t *row_out;
  const uint32_t *cx, *cy;
  int scx, scy;
  uint32_t *out[4];        // digits F..F+D-1 of each magnitude
};

// the multiplier of a component's coefficients, from the pre-update signs
// sx, sy (K = 2; unused for K = 4)
template <int K>
__device__ __forceinline__ int64_t tail_mul(int comp, int sx, int sy) {
  if (!comp) return 1;
  if (K == 2) return 2 * static_cast<int64_t>(sx) * sy;
  return 2;
}

template <int K>
__device__ __forceinline__ int64_t tail_mul(const Tail &t, int comp) {
  return K == 2 ? tail_mul<K>(comp, t.row_in[10], t.row_in[11])
                : tail_mul<K>(comp, 1, 1);
}

// what digit sum j of a component adds to its scaled coefficient: c at
// digit F, the +1 of dz/dc at digit 2F and the round bit at F - 1
template <int K>
__device__ __forceinline__ int64_t tail_addend(int comp, int j, int D,
                                               int scx, int scy,
                                               const uint32_t *cx,
                                               const uint32_t *cy) {
  const int F = D - 2;
  int64_t a = 0;
  if (comp < 2 && j >= F && j < F + D)
    a += (comp ? scy : scx) * static_cast<int64_t>((comp ? cy : cx)[j - F]);
  if (K == 4 && comp == 2 && j == 2 * F) a += 1;
  if (j == F - 1) a += 1 << 15;
  return a;
}

// digit sum j of a component: its scaled coefficient plus the addend
template <int K>
__device__ __forceinline__ int64_t digit_sum(const Tail &t, int comp,
                                             int64_t mul, int j, int D,
                                             int L) {
  return mul * t.coef[static_cast<size_t>(comp) * L + j] +
         tail_addend<K>(comp, j, D, t.scx, t.scy, t.cx, t.cy);
}

// the carry map of a segment from its carry-out e and whether its digits
// are all 0xFFFF or all 0
__device__ __forceinline__ uint32_t segment_map(int e, bool all_ffff,
                                                bool all_zero) {
  return enc(e - (all_zero ? 1 : 0), e, e + (all_ffff ? 1 : 0));
}

constexpr int kWideThreads = 256;
constexpr int kWideSeg = 4;           // digits per thread

// the wide form's scratch, in uint32 words of a buffer of >= 4L (K = 2)
// or 7L (K = 4): digits [K][L], carries int64 [K][L/4], exclusive prefix
// maps uint8 [K][L/4], block aggregates [K][G], block carry-ins int32
// [K][G], then per component neg, lowest and highest nonzero index
struct Wide {
  uint32_t *dig;
  int64_t *carry;
  uint8_t *prefix;
  uint32_t *agg;
  int32_t *bcin;
  int32_t *flag;   // neg[K], lo[K], hi[K]
};

template <int K>
__device__ __forceinline__ Wide wide(uint32_t *s, int L) {
  const int ns = L / kWideSeg;
  const int g = ns / kWideThreads;
  Wide w;
  w.dig = s;
  w.carry = reinterpret_cast<int64_t *>(s + K * L);
  w.prefix = reinterpret_cast<uint8_t *>(s + K * L + K * L / 2);
  w.agg = s + K * L + K * L / 2 + K * ns / 4;
  w.bcin = reinterpret_cast<int32_t *>(w.agg + K * g);
  w.flag = w.bcin + K * g;
  return w;
}

// inclusive Hillis-Steele scan of carry maps over the block (blockDim.x
// <= N); the result is left in maps[0] for every thread to read
template <int N>
__device__ uint32_t scan_maps(uint32_t f, uint32_t (*maps)[N]) {
  const int t = threadIdx.x;
  maps[0][t] = f;
  __syncthreads();
  int src = 0;
  for (int off = 1; off < static_cast<int>(blockDim.x); off <<= 1) {
    uint32_t cur = maps[src][t];
    if (t >= off) cur = compose(cur, maps[src][t - off]);
    maps[src ^ 1][t] = cur;
    __syncthreads();
    src ^= 1;
  }
  const uint32_t inc = maps[src][t];
  if (src) {
    maps[0][t] = inc;
    __syncthreads();
  }
  return inc;
}

// W5: negate if the sum is negative, write digits F..F+D-1, the highest
// nonzero one (item (bx, comp))
template <int K>
__device__ void wide_finish_item(const Tail &tl, uint32_t *scratch, int D,
                                 int m, int bx, int comp, int *red) {
  const int L = 1 << m;
  const int F = D - 2;
  const Wide w = wide<K>(scratch, L);
  const int s = bx * kWideThreads + threadIdx.x;
  const uint32_t *dig = w.dig + comp * L + s * kWideSeg;
  const bool neg = w.flag[comp];
  const int lo = w.flag[K + comp];
  uint32_t *out = tl.out[comp];
  int hi = -1;
  for (int q = 0; q < kWideSeg; ++q) {
    const int j = s * kWideSeg + q;
    uint32_t d = dig[q];
    if (neg) d = j < lo ? 0u : (j == lo ? 0x10000u - d : 0xFFFFu - d);
    if (j >= F && j < F + D) {
      out[j - F] = d;
      if (d) hi = j - F;
    }
  }
  if (K == 4) return;   // no shadow row
  hi = block_max(hi, red);
  if (threadIdx.x == 0 && hi >= 0) atomicMax(&w.flag[2 * K + comp], hi);
}

// W6: the shadow row of the new value (K5) or the sign (K5-NR) of one
// component, on one thread
template <int K>
__device__ void wide_row_item(const Tail &tl, uint32_t *scratch, int D, int m,
                              int comp) {
  const Wide w = wide<K>(scratch, 1 << m);
  const int neg = w.flag[comp];
  if (K == 4) {
    tl.row_out[comp] = neg ? -1 : 1;
    return;
  }
  const uint32_t *out = tl.out[comp];
  int b = w.flag[2 * K + comp] - 3;
  b = b < 0 ? 0 : (b > D - 4 ? D - 4 : b);
  for (int k = 0; k < 4; ++k)
    tl.row_out[5 * comp + k] = static_cast<int32_t>(out[b + k]);
  tl.row_out[5 * comp + 4] = b;
  tl.row_out[10 + comp] = neg ? -1 : 1;
}

}  // namespace
