// The CRT + carry tail from residue rows, the reference's fused_tail
// (ntt_pallas.py:1326): its inputs (FusedTail, make_tail) and digit sums
// (tail_coef, part), shared by K10 (fused_tail.cu, over the whole card)
// and K11 (iterate_full.cu), whose tail is tail_component below, one
// component on one block.
//
// Component c's digit sums over L positions are
//   a_j = sum_{q<4} part_q(s_{j-q}) + (csign > 0 ? c_j : -c_j) + rnd_j,
// s_k the CRT of its residue rows (r1 mod p1, r2 mod p2), read as negative
// above p1*p2/2, doubled and/or negated by its config (double, gswap: the
// reference's stream swap), and part_q(s) the q-th 16-bit part of |s| with
// s's sign: the reference's positive and negative digit streams
// (_tail_stream_cfg, :1098), summed as one signed stream.  |a_j| < 2^19,
// so K5's carry machinery (orbit_tail.cu) resolves them exactly:
//   1. each thread ripples its segment of S >= 4 digits (a multiple of 4),
//      computing each coefficient's CRT once as it walks;
//   2. it absorbs the carry of the segment below (|carry| < 2^4) and forms
//      its carry map {-1, 0, 1} -> {-1, 0, 1};
//   3. a scan of the maps over the block gives every carry-in and the
//      carry out of the top;
//   4. the carry-ins are applied; a negative total (P < N) is negated in
//      two's complement modulo 2^(16L).
// The sign is -1 iff P < N and the magnitude is not zero, as the
// reference's biased finish gives it (_signed_finish, :1034); digits of
// the coefficients at L or beyond are dropped, as its flat shifts drop
// them.  The shadow row, when asked for, is the 4 digits ending at the top
// non-zero digit of the value slice [F, F+D) and their base index
// (_shadow_rows, :1178).
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "ntt_common.cuh"
#include "tail_common.cuh"

namespace {

constexpr int kTailThreads = 1024;
constexpr int kMaxTail = 4;                 // components
constexpr uint32_t kCrtConst = 1207959574u;  // p1^-1 * R mod p2

struct FusedTail {
  const uint32_t *inv;     // [K][2][n] residue rows
  const uint32_t *cadd;    // [K][L] addend planes
  const uint32_t *rnd;     // [L] round plane
  const int32_t *zsign;    // null, or component 1's gswap = zsign[0]*zsign[1]
  uint32_t *dig;           // [K][L] magnitudes out (also the working digits)
  int32_t *sgn;            // [K] signs out
  int32_t *shw;            // null, or [K][5] shadow rows out
  int cfg[4 * kMaxTail];   // per component: double, gswap, csign, 0
  int K, n, L, F, D;
};

struct TailShared {
  int64_t carry[kTailThreads];
  uint32_t maps[2][kTailThreads];
  int red[33];
};

// coefficient k of a component, signed and scaled (0 outside [0, n))
__device__ __forceinline__ int64_t tail_coef(const uint32_t *rows, int n,
                                             int k, bool dbl, bool swap) {
  if (k < 0 || k >= n) return 0;
  int64_t s = crt_signed(crt_rec(rows[k], rows[n + k], kCrtConst));
  if (dbl) s *= 2;
  return swap ? -s : s;
}

__device__ __forceinline__ int64_t part(int64_t s, int q) {
  const uint64_t m = s < 0 ? static_cast<uint64_t>(-s)
                           : static_cast<uint64_t>(s);
  const int64_t v = static_cast<int64_t>((m >> (16 * q)) & 0xFFFFu);
  return s < 0 ? -v : v;
}

// component c of t on the calling block (all its threads)
__device__ void tail_component(const FusedTail &t, int c, TailShared &sh) {
  const int L = t.L;
  const int T = blockDim.x;
  int S = (L + T - 1) / T;
  S = S < 4 ? 4 : (S + 3) & ~3;
  const int ntr = (L + S - 1) / S;         // threads holding digits
  const int tid = threadIdx.x;
  const int base = tid * S;
  const bool active = tid < ntr;
  const int len = active ? min(S, L - base) : 0;
  const bool dbl = t.cfg[4 * c] > 0;
  int gsw = t.cfg[4 * c + 1];
  if (c == 1 && t.zsign) gsw = t.zsign[0] * t.zsign[1];
  const bool swap = gsw < 0;
  const bool cpos = t.cfg[4 * c + 2] > 0;
  const uint32_t *rows = t.inv + static_cast<size_t>(c) * 2 * t.n;
  const uint32_t *ca = t.cadd + static_cast<size_t>(c) * L;
  uint32_t *dig = t.dig + static_cast<size_t>(c) * L;

  // 1. ripple the segment's own sums
  int64_t cr = 0;
  if (active) {
    int64_t w1 = tail_coef(rows, t.n, base - 1, dbl, swap);
    int64_t w2 = tail_coef(rows, t.n, base - 2, dbl, swap);
    int64_t w3 = tail_coef(rows, t.n, base - 3, dbl, swap);
    for (int q = 0; q < len; ++q) {
      const int j = base + q;
      const int64_t w0 = tail_coef(rows, t.n, j, dbl, swap);
      const int64_t cv = ca[j];
      const int64_t a = part(w0, 0) + part(w1, 1) + part(w2, 2) +
                        part(w3, 3) + (cpos ? cv : -cv) +
                        static_cast<int64_t>(t.rnd[j]) + cr;
      dig[j] = static_cast<uint32_t>(a & 0xFFFF);
      cr = a >> 16;
      w3 = w2;
      w2 = w1;
      w1 = w0;
    }
  }
  sh.carry[tid] = cr;
  __syncthreads();

  // 2. absorb the carry of the segment below; the segment's carry map
  uint32_t f = enc(-1, 0, 1);
  if (active) {
    int64_t ci = tid ? sh.carry[tid - 1] : 0;
    bool all_ffff = true;
    bool all_zero = true;
    for (int q = 0; q < len; ++q) {
      const int j = base + q;
      uint32_t d = dig[j];
      if (ci) {
        const int64_t a = static_cast<int64_t>(d) + ci;
        d = static_cast<uint32_t>(a & 0xFFFF);
        ci = a >> 16;
        dig[j] = d;
      }
      all_ffff &= d == 0xFFFFu;
      all_zero &= d == 0u;
    }
    const int e = static_cast<int>(ci);
    f = enc(e - (all_zero ? 1 : 0), e, e + (all_ffff ? 1 : 0));
  }

  // 3. inclusive scan of the maps: maps[t] = f_t o ... o f_0
  sh.maps[0][tid] = f;
  __syncthreads();
  int src = 0;
  for (int off = 1; off < T; off <<= 1) {
    uint32_t cur = sh.maps[src][tid];
    if (tid >= off) cur = compose(cur, sh.maps[src][tid - off]);
    sh.maps[src ^ 1][tid] = cur;
    __syncthreads();
    src ^= 1;
  }
  const int cin = tid ? apply(sh.maps[src][tid - 1], 0) : 0;
  const int64_t top = sh.carry[ntr - 1] + apply(sh.maps[src][ntr - 1], 0);

  // 4. apply the carry-in: +1 over a run of 0xFFFF, -1 over a run of 0
  if (active && cin) {
    for (int q = 0; q < len; ++q) {
      const int j = base + q;
      const uint32_t d = dig[j];
      if (cin > 0) {
        dig[j] = (d + 1u) & 0xFFFFu;
        if (d != 0xFFFFu) break;
      } else {
        dig[j] = (d - 1u) & 0xFFFFu;
        if (d != 0u) break;
      }
    }
  }
  __syncthreads();
  const bool neg = top < 0;
  if (neg) {
    int lo = INT_MAX;
    for (int q = 0; q < len; ++q) {
      if (dig[base + q]) {
        lo = base + q;
        break;
      }
    }
    lo = block_min(lo, sh.red);
    for (int q = 0; q < len; ++q) {
      const int j = base + q;
      const uint32_t d = dig[j];
      dig[j] = j < lo ? 0u : (j == lo ? 0x10000u - d : 0xFFFFu - d);
    }
    __syncthreads();
  }

  // 5. the sign; the shadow row of the value slice
  int nz = 0;
  int hi = -1;
  for (int q = 0; q < len; ++q) {
    const int j = base + q;
    if (dig[j]) {
      nz = 1;
      if (j >= t.F && j < t.F + t.D) hi = j - t.F;
    }
  }
  nz = block_max(nz, sh.red);
  if (tid == 0) t.sgn[c] = neg && nz ? -1 : 1;
  if (t.shw) {
    hi = block_max(hi, sh.red);
    if (tid == 0) {
      int b = hi - 3;
      b = b < 0 ? 0 : (b > t.D - 4 ? t.D - 4 : b);
      for (int k = 0; k < 4; ++k)
        t.shw[5 * c + k] = static_cast<int32_t>(dig[t.F + b + k]);
      t.shw[5 * c + 4] = b;
    }
  }
  __syncthreads();   // the next component reuses the shared memory
}

// A FusedTail from host arguments; cudaErrorInvalidValue when they do
// not fit (1 to 4 components, L <= n a multiple of 4, the slice inside L).
int make_tail(FusedTail *t, const void *inv, const void *cadd,
              const void *rnd, const int32_t *cfg, const void *zsign,
              void *dig, void *sgn, void *shw, int K, int log2n, int L,
              int F, int D) {
  if (K < 1 || K > kMaxTail || log2n < 2 || log2n > 17 || L < 4 ||
      L > (1 << log2n) || (L & 3) || (shw && (D < 4 || F < 0 || F + D > L)))
    return static_cast<int>(cudaErrorInvalidValue);
  t->inv = static_cast<const uint32_t *>(inv);
  t->cadd = static_cast<const uint32_t *>(cadd);
  t->rnd = static_cast<const uint32_t *>(rnd);
  t->zsign = static_cast<const int32_t *>(zsign);
  t->dig = static_cast<uint32_t *>(dig);
  t->sgn = static_cast<int32_t *>(sgn);
  t->shw = static_cast<int32_t *>(shw);
  for (int i = 0; i < 4 * kMaxTail; ++i) t->cfg[i] = i < 4 * K ? cfg[i] : 0;
  t->K = K;
  t->n = 1 << log2n;
  t->L = L;
  t->F = F;
  t->D = D;
  return 0;
}

}  // namespace
