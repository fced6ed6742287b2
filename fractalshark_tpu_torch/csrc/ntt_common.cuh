// Shared pieces of the NTT kernels: the two primes of
// fractalshark_tpu_torch/ops/bignum/ntt.py, Montgomery products (R = 2^32),
// modular adds and the CRT, for K4/K12 (ntt_orbit.cu, orbit_chunk.cu), K8
// (ntt_phase.cu), K9 and K11 (ntt_products.cuh, iterate_full.cu) and the
// tails; K4's and K12's twiddle loads from the n-point root tables
// (ntt.kernel_tables) and in-place radix-2 transforms in shared memory (K8,
// K9 and K11 run the radix-8 rounds of ntt_rounds.cuh).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kP1 = 2013265921u;   // ntt.P1
constexpr uint32_t kP2 = 1811939329u;   // ntt.P2
constexpr uint32_t kPp1 = 2013265919u;  // -p1^-1 mod 2^32 (ntt.mont_const)
constexpr uint32_t kPp2 = 1811939327u;  // -p2^-1 mod 2^32
constexpr uint64_t kP1P2 = 3647915701995307009ull;

__device__ __forceinline__ uint32_t prime(int i) { return i ? kP2 : kP1; }
__device__ __forceinline__ uint32_t pprime(int i) { return i ? kPp2 : kPp1; }

// a*b*R^-1 mod p for a, b < p < 2^31: t + m*p < 2^62 + 2^63 fits, result < 2p
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t pp) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(t) * pp;
  const uint32_t u =
      static_cast<uint32_t>((t + static_cast<uint64_t>(m) * p) >> 32);
  return u >= p ? u - p : u;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  return a >= b ? a - b : a + p - b;
}

// The twiddles of a length-M transform (M = 2^lg), both primes, into
// shared memory: tws[pr][e] = w_M^e for e < M/2, which is the n-point root
// table at e*n/M.  The caller synchronises before use.
template <bool kForward>
__device__ void load_twiddles(uint32_t *tws, int lg, int m,
                              const uint32_t *__restrict__ tw) {
  const int half = 1 << (lg - 1);
  for (int i = threadIdx.x; i < 2 * half; i += blockDim.x) {
    const int pr = i >> (lg - 1);
    tws[i] = tw[((kForward ? 0 : 2) + pr) * (1 << m) +
                ((i & (half - 1)) << (m - lg))];
  }
}

// In-place radix-2 transforms of length 2^lg in shared memory, over
// (array a, column cc) sequences: element i of a sequence sits at
// a*astride + cc + i*stride; there are 2^lgc columns and array a uses
// prime (a & 1) and its twiddles tws (load_twiddles).
//   DIF (forward): natural in, bit-reversed out, twiddle after the
//   difference; DIT (inverse): bit-reversed in, natural out, twiddle before.
// A butterfly of half-span h = 2^sh at offset j takes w_(2h)^j, which is
// w_M^(j << (lg - 1 - sh)).
template <bool kForward>
__device__ void transform(uint32_t *sm, int arrays, int lgc, int astride,
                          int stride, int lg, const uint32_t *tws) {
  const int half_len = 1 << (lg - 1);
  const int total = arrays << (lgc + lg - 1);
  for (int s = 0; s < lg; ++s) {
    const int sh = kForward ? lg - 1 - s : s;
    const int h = 1 << sh;
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      const int cc = b & ((1 << lgc) - 1);
      const int k = (b >> lgc) & (half_len - 1);
      const int a = b >> (lgc + lg - 1);
      const int pr = a & 1;
      const uint32_t p = prime(pr);
      const uint32_t pp = pprime(pr);
      const int j = k & (h - 1);
      const int i0 = 2 * (k - j) + j;
      uint32_t *x0 = sm + a * astride + cc + i0 * stride;
      uint32_t *x1 = x0 + h * stride;
      const uint32_t w = tws[pr * half_len + (j << (lg - 1 - sh))];
      const uint32_t u = *x0;
      if (kForward) {
        const uint32_t v = *x1;
        *x0 = add_mod(u, v, p);
        *x1 = mont_mul(sub_mod(u, v, p), w, p, pp);
      } else {
        const uint32_t v = mont_mul(*x1, w, p, pp);
        *x0 = add_mod(u, v, p);
        *x1 = sub_mod(u, v, p);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t neg_mod(uint32_t a, uint32_t p) {
  return a ? p - a : 0u;
}

// +-a mod p for a sign product s of +-1
__device__ __forceinline__ uint32_t signed_mod(int s, uint32_t a, uint32_t p) {
  return s > 0 ? a : neg_mod(a, p);
}

// CRT of canonical residues r1 mod p1, r2 mod p2 to the integer in
// [0, p1*p2); crt = p1^-1 * R mod p2
__device__ __forceinline__ uint64_t crt_rec(uint32_t r1, uint32_t r2,
                                            uint32_t crt) {
  const uint32_t r1m = r1 >= kP2 ? r1 - kP2 : r1;   // p1 < 2*p2
  const uint32_t t = mont_mul(sub_mod(r2, r1m, kP2), crt, kP2, kPp2);
  return static_cast<uint64_t>(r1) + static_cast<uint64_t>(kP1) * t;
}

// read as negative above p1*p2/2
__device__ __forceinline__ int64_t crt_signed(uint64_t rec) {
  return rec > kP1P2 / 2
             ? static_cast<int64_t>(rec) - static_cast<int64_t>(kP1P2)
             : static_cast<int64_t>(rec);
}

int launch_smem(const void *fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace
