// Radix-8 register rounds of a length-2^lg NTT held in shared memory, one
// source for K8 (ntt_phase.cu) and K9/K11 (ntt_products.cuh).
//
// A sequence ("column") of m = 2^lg points lies in shared memory, its word
// i at swz(i), so that a warp's 32 points of one column fall in 32 banks
// in every round.  A thread owns kE points of a column (a slot u of the
// m / kE slots): each round runs k <= log2(kE) radix-2 stages on them in
// registers between two trips through shared memory, so a transform
// takes ceil(lg / log2(kE)) rounds and as many barriers, against lg for
// stage-by-stage passes.
//   forward: DIF, natural order in, bit-reversed out; the stage of
//            half-span h = 2^b takes the twiddle w_(2h)^j after the
//            difference; the bits are taken from the top, the round of
//            lg % log2(kE) bits first;
//   inverse: DIT, bit-reversed in, natural out, w_(2h)^-j before the
//            butterfly; the bits from the bottom, the short round last.
// The twiddles of the stage of half-span 2^b sit at [2^b - 1, 2^(b+1) - 1)
// of a per-prime table (ntt.py _k8_table), each (w, floor(w * 2^32 / p))
// for the Shoup product, so neighbouring lanes read neighbouring words.
// Every butterfly yields canonical residues, so any schedule of the same
// stages gives the same words.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_common.cuh"

namespace {

// x*w mod p for x < 2^32, w < p < 2^31, canonical (Shoup): wp =
// floor(w * 2^32 / p), so x*w - floor(x*wp / 2^32)*p lies in [0, 2p)
__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint32_t w,
                                              uint32_t wp, uint32_t p) {
  const uint32_t r = x * w - __umulhi(x, wp) * p;
  return r >= p ? r - p : r;
}

// where word i of a column lives: its bank is spread by the 32-word block
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 5) & 31); }

// the words between columns, so that the load's rows of TL words from
// 32 / TL columns fall in 32 banks (none for one column a block)
__host__ __device__ __forceinline__ int pad_words(int lg_tl) {
  return lg_tl == 0 ? 0 : (lg_tl < 5 ? 32 >> lg_tl : 1);
}

// One round of K radix-2 stages over the index bits [blo, blo + K) of the
// column c: each thread runs kE >> K groups of 2^K points in registers.
// A group is (hi, lo), its points i = hi << (blo + K) | mid << blo | lo.
template <bool kInverse, int kE, int K>
__device__ __forceinline__ void round_k(uint32_t *c, const uint2 *tws,
                                        int blo, int u, int gpc, uint32_t p) {
  constexpr int kPts = 1 << K;
#pragma unroll
  for (int q = 0; q < (kE >> K); ++q) {
    const int g = u + q * gpc;
    const int lo = g & ((1 << blo) - 1);
    const int ibase = ((g >> blo) << (blo + K)) | lo;
    uint32_t v[kPts];
#pragma unroll
    for (int mid = 0; mid < kPts; ++mid) v[mid] = c[swz(ibase | (mid << blo))];
#pragma unroll
    for (int tt = 0; tt < K; ++tt) {
      // forward: the highest bit first; inverse: the lowest first
      const int t = kInverse ? tt : K - 1 - tt;
      const int b = blo + t;
      const int h = 1 << b;
#pragma unroll
      for (int mid = 0; mid < kPts; ++mid) {
        if (mid & (1 << t)) continue;
        const int j = (ibase | (mid << blo)) & (h - 1);
        const uint2 w = tws[h - 1 + j];
        const uint32_t u0 = v[mid];
        if (kInverse) {
          const uint32_t u1 = shoup_mul(v[mid | (1 << t)], w.x, w.y, p);
          v[mid] = add_mod(u0, u1, p);
          v[mid | (1 << t)] = sub_mod(u0, u1, p);
        } else {
          // u0 - u1 + p < 2p: the product takes it unreduced
          const uint32_t u1 = v[mid | (1 << t)];
          v[mid] = add_mod(u0, u1, p);
          v[mid | (1 << t)] = shoup_mul(u0 + p - u1, w.x, w.y, p);
        }
      }
    }
#pragma unroll
    for (int mid = 0; mid < kPts; ++mid) c[swz(ibase | (mid << blo))] = v[mid];
  }
}

template <bool kInverse, int kE>
__device__ __forceinline__ void run_round(uint32_t *c, const uint2 *tws,
                                          int blo, int k, int u, int gpc,
                                          uint32_t p) {
  if (k == 3 && kE >= 8)
    round_k<kInverse, kE, (kE >= 8 ? 3 : 1)>(c, tws, blo, u, gpc, p);
  else if (k == 2 && kE >= 4)
    round_k<kInverse, kE, (kE >= 4 ? 2 : 1)>(c, tws, blo, u, gpc, p);
  else
    round_k<kInverse, kE, 1>(c, tws, blo, u, gpc, p);
}

// log2 of kE, the bits of a full round
template <int kE>
__host__ __device__ constexpr int lg_points() {
  return kE >= 8 ? 3 : (kE >= 4 ? 2 : 1);
}

// the rounds of a length-2^lg transform
template <int kE>
__device__ __forceinline__ int rounds_of(int lg) {
  constexpr int kLgE = lg_points<kE>();
  return (lg + kLgE - 1) / kLgE;
}

// round q's bits [blo, blo + k): the short round takes the top bits, so
// it comes first forward and last inverse
template <bool kInverse, int kE>
__device__ __forceinline__ void round_bits(int lg, int q, int *blo, int *k) {
  constexpr int kLgE = lg_points<kE>();
  const int rem = lg % kLgE;
  const int full = lg / kLgE;
  if (kInverse) {
    *blo = q * kLgE;
    *k = q < full ? kLgE : rem;
  } else if (rem && q == 0) {
    *blo = lg - rem;
    *k = rem;
  } else {
    const int qq = q - (rem ? 1 : 0);
    *blo = (full - 1 - qq) * kLgE;
    *k = kLgE;
  }
}

}  // namespace
