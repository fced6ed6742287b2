// The CRT + carry tail from residue rows, the reference's fused_tail
// (ntt_pallas.py:1326): its inputs (FusedTail, make_tail), digit sums
// (tail_coef, part) and the two loop bodies over tiles of digits
// (tail_tile, finish_tile), shared by K10 (fused_tail.cu: two launches
// over the whole card) and K11 (iterate_full.cu: two grid phases of its
// one cooperative launch).
//
// Component c's digit sums over L positions are
//   a_j = sum_{q<4} part_q(s_{j-q}) + (csign > 0 ? c_j : -c_j) + rnd_j,
// s_k the CRT of its residue rows (r1 mod p1, r2 mod p2), read as negative
// above p1*p2/2, doubled and/or negated by its config (double, gswap: the
// reference's stream swap), and part_q(s) the q-th 16-bit part of |s| with
// s's sign: the reference's positive and negative digit streams
// (_tail_stream_cfg, :1098), summed as one signed stream.  |a_j| < 2^19,
// so K5's carry machinery (orbit_tail.cu) resolves them exactly: each
// thread ripples a segment of 4 digits, the segments' carry maps
// {-1, 0, 1} -> {-1, 0, 1} are scanned over a tile and composed across
// tiles (tail_tile), the carry-ins are applied, and a negative total
// (P < N) is negated in two's complement modulo 2^(16L) (finish_tile).
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

constexpr int kSeg = 4;                 // digits a thread
constexpr int kHalo = 8;                // coefficients below a tile
constexpr int kMinTileThreads = 32;     // K11's smallest tile: 128 digits
constexpr int kMaxTiles = (1 << 17) / (kSeg * kMinTileThreads);

// a published word: flag in bits 30-31, then a map or a carry-out + 1
constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kPrefix = 2u << 30;

// device scratch, all zero between calls
struct TailState {
  uint32_t word[kMaxTail][kMaxTiles];   // each tile's published word
  uint32_t ticket[kMaxTail];            // K10's tile order
  uint32_t done[kMaxTail];              // tiles through the finish
  int32_t lo[kMaxTail];    // INT_MAX - lowest nonzero digit; 0: none
  int32_t hi[kMaxTail];    // 1 + highest nonzero digit of the slice - F
  int32_t neg[kMaxTail];   // the total is negative (set by the tiles)
};

// a tile's shared memory: kT threads of kSeg digits
template <int kT>
struct TileShared {
  int64_t coef[kHalo + kSeg * kT];
  int32_t carry[kT + 1];
  uint32_t warp_map[kT / 32];
  int red[33];
  int rin;
  uint32_t agg;
};

// component c's settings: doubled, swapped (negated), +cadd or -cadd
struct Comp {
  bool dbl, swap, cpos;
};

__device__ __forceinline__ Comp comp_of(const FusedTail &t, int c) {
  int gsw = t.cfg[4 * c + 1];
  if (c == 1 && t.zsign) gsw = t.zsign[0] * t.zsign[1];
  return {t.cfg[4 * c] > 0, gsw < 0, t.cfg[4 * c + 2] > 0};
}

// the local ripple of the 4 digit sums at j, j+1, j+2, j+3 (co: the
// coefficients with co[0] at j; the three below at co[-1..-3]; cv, rv:
// the addend and round words at j): the digits and the carry-out
__device__ __forceinline__ int32_t ripple(const int64_t *co, const Comp &k,
                                          const uint4 &cv, const uint4 &rv,
                                          uint32_t d[kSeg]) {
  const uint32_t ca[4] = {cv.x, cv.y, cv.z, cv.w};
  const uint32_t rn[4] = {rv.x, rv.y, rv.z, rv.w};
  int64_t cr = 0;
#pragma unroll
  for (int q = 0; q < kSeg; ++q) {
    const int64_t cs = k.cpos ? static_cast<int64_t>(ca[q])
                              : -static_cast<int64_t>(ca[q]);
    const int64_t a = part(co[q], 0) + part(co[q - 1], 1) +
                      part(co[q - 2], 2) + part(co[q - 3], 3) + cs +
                      static_cast<int64_t>(rn[q]) + cr;
    d[q] = static_cast<uint32_t>(a & 0xFFFF);
    cr = a >> 16;
  }
  return static_cast<int32_t>(cr);
}

__device__ __forceinline__ uint4 load4(const uint32_t *p) {
  return *reinterpret_cast<const uint4 *>(p);
}

__device__ __forceinline__ uint32_t load_word(const uint32_t *p) {
  return *reinterpret_cast<const volatile uint32_t *>(p);
}

// The tile body: digits [b*kSeg*kT, (b+1)*kSeg*kT) of component c on the
// calling block of kT threads.  The block
//   1. computes the CRT of every coefficient its tile's digits read once,
//      into shared memory, with kHalo below the tile (3 for its first
//      digits' 16-bit parts, 4 for the segment below), the residue rows
//      read coalesced;
//   2. gives each thread a segment of 4 digits: their sums from shared
//      memory and one 16-byte load each of the addend and round planes,
//      rippled into digits and a carry-out (|carry| < 2^4); thread 0 also
//      ripples the segment below the tile, whose carry-out it absorbs;
//   3. absorbs the carry of the segment below, forms the segment's carry
//      map (tail_common.cuh: which of {-1, 0, 1} comes out for each that
//      comes in; a segment of 4 digits passes on at most one), and scans
//      the maps over the block with warp shuffles;
//   4. finds the carry into the tile by decoupled look-back: it publishes
//      its aggregate map, composes its predecessors' aggregates back to
//      the first one that has published its carry-out, 32 tiles a step
//      (a lane a tile, the maps composed over the warp), then publishes
//      its own carry-out.  A tile waits only on lower tiles of its
//      component, which must be running or done: K10 numbers the tiles by
//      a ticket in the order they start, K11's blocks take their tiles in
//      increasing order and are all co-resident;
//   5. applies each segment's carry-in, stores its digits once (16 bytes a
//      thread), and meets the other tiles' lowest nonzero digit in an
//      atomic; the top tile writes whether the total is negative.
template <int kT>
__device__ void tail_tile(const FusedTail &t, TailState *st, int c, int b,
                          TileShared<kT> &sh) {
  constexpr int kTile = kSeg * kT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const Comp k = comp_of(t, c);
  const int L = t.L;
  const uint32_t *rows = t.inv + static_cast<size_t>(c) * 2 * t.n;
  const uint32_t *ca = t.cadd + static_cast<size_t>(c) * L;
  const int j0 = b * kTile;

  // the segment's addend and round words (thread 0's also of the segment
  // below the tile), loaded with the coefficients
  const int base = j0 + kSeg * tid;
  const bool active = base < L;
  const bool under = tid == 0 && b;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  const uint4 cv = active ? load4(ca + base) : zero4;
  const uint4 rv = active ? load4(t.rnd + base) : zero4;
  const uint4 cvb = under ? load4(ca + j0 - kSeg) : zero4;
  const uint4 rvb = under ? load4(t.rnd + j0 - kSeg) : zero4;

  // 1. the CRT of coefficients j0 - kHalo .. j0 + kTile - 1 (those at L or
  // beyond reach no digit): every thread's loads issued before any is used
  {
    constexpr int kPer = (kHalo + kTile + kT - 1) / kT;
    int64_t co[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + q * kT;
      const int j = j0 - kHalo + i;
      co[q] = i < kHalo + kTile && j < L
                  ? tail_coef(rows, t.n, j, k.dbl, k.swap) : 0;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (tid + q * kT < kHalo + kTile) sh.coef[tid + q * kT] = co[q];
  }
  __syncthreads();

  // 2. the segment's own sums; thread 0 also the segment below the tile
  uint32_t d[kSeg] = {0, 0, 0, 0};
  int32_t cr = 0;
  if (active) cr = ripple(sh.coef + kHalo + kSeg * tid, k, cv, rv, d);
  sh.carry[tid + 1] = cr;
  if (tid == 0) {
    uint32_t dl[kSeg];
    sh.carry[0] = b ? ripple(sh.coef + kHalo - kSeg, k, cvb, rvb, dl) : 0;
  }
  __syncthreads();

  // 3. absorb the carry of the segment below; the segment's map; the
  // block's scan of maps (incl: f_tid o ... o f_0)
  uint32_t f = enc(-1, 0, 1);
  if (active) {
    int32_t ci = sh.carry[tid];
    bool all_ffff = true;
    bool all_zero = true;
#pragma unroll
    for (int q = 0; q < kSeg; ++q) {
      if (ci) {
        const int32_t a = static_cast<int32_t>(d[q]) + ci;
        d[q] = static_cast<uint32_t>(a & 0xFFFF);
        ci = a >> 16;
      }
      all_ffff &= d[q] == 0xFFFFu;
      all_zero &= d[q] == 0u;
    }
    f = enc(ci - (all_zero ? 1 : 0), ci, ci + (all_ffff ? 1 : 0));
  }
  uint32_t incl = f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t lower = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl = compose(incl, lower);
  }
  if (lane == 31) sh.warp_map[w] = incl;
  __syncthreads();
  uint32_t below = enc(-1, 0, 1);   // the warps below this one
  for (int i = 0; i < w; ++i) below = compose(sh.warp_map[i], below);
  incl = compose(incl, below);
  uint32_t excl = __shfl_up_sync(~0u, incl, 1);
  if (lane == 0) excl = below;
  if (tid == kT - 1) sh.agg = incl;
  __syncthreads();

  // 4. the carry into the tile, by decoupled look-back, a warp at a time:
  // lane i reads tile p - i's published word; the maps of the tiles above
  // the nearest carry-out found are composed over the warp
  if (w == 0) {
    uint32_t *word = st->word[c];
    const uint32_t agg = sh.agg;
    int rin = 0;
    if (b) {
      if (lane == 0) atomicExch(&word[b], kAggregate | agg);
      uint32_t acc = enc(-1, 0, 1);   // the tiles between p and b
      for (int p = b - 1;; p -= 32) {
        const int q = p - lane;
        uint32_t v = 0;
        if (q >= 0)
          do {
            v = load_word(&word[q]);
          } while (!(v & (kAggregate | kPrefix)));
        const unsigned pre = __ballot_sync(~0u, (v & kPrefix) != 0);
        const int stop = pre ? __ffs(pre) - 1 : 32;   // nearest carry-out
        // m_0 o m_1 o ... o m_(stop-1), lane 0 the tile nearest b
        uint32_t m = lane < stop ? (v & 63u) : enc(-1, 0, 1);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t lower = __shfl_down_sync(~0u, m, o);
          if (lane + o < 32) m = compose(m, lower);
        }
        acc = compose(acc, __shfl_sync(~0u, m, 0));
        if (pre) {
          const uint32_t pv = __shfl_sync(~0u, v, stop);
          rin = apply(acc, static_cast<int>(pv & 3u) - 1);
          break;
        }
      }
    }
    if (lane == 0) {
      atomicExch(&word[b],
                 kPrefix | static_cast<uint32_t>(apply(agg, rin) + 1));
      sh.rin = rin;
    }
  }
  __syncthreads();
  const int rin = sh.rin;

  // 5. apply the carry-in: +1 over a run of 0xFFFF, -1 over a run of 0;
  // store; the lowest nonzero digit; the sign of the total (top tile)
  int lo = INT_MAX;
  if (active) {
    int run = apply(excl, rin);
#pragma unroll
    for (int q = 0; q < kSeg; ++q) {
      if (run > 0) {
        d[q] = (d[q] + 1u) & 0xFFFFu;
        if (d[q] != 0u) run = 0;
      } else if (run < 0) {
        d[q] = (d[q] - 1u) & 0xFFFFu;
        if (d[q] != 0xFFFFu) run = 0;
      }
      if (d[q] && lo == INT_MAX) lo = base + q;
    }
    *reinterpret_cast<uint4 *>(t.dig + static_cast<size_t>(c) * L + base) =
        make_uint4(d[0], d[1], d[2], d[3]);
    if (base + kSeg == L)
      st->neg[c] = sh.carry[tid + 1] + apply(incl, rin) < 0;
  }
  lo = block_min(lo, sh.red);
  if (tid == 0 && lo != INT_MAX) atomicMax(&st->lo[c], INT_MAX - lo);
}

// The finishing body, after every tile of the component is through
// tail_tile: the sign (negative and not zero modulo 2^(16L)), the
// two's-complement negation from the lowest nonzero digit where the total
// is negative, the highest nonzero digit of the value slice [F, F+D) in
// an atomic, and, in the last of the component's `tiles` tiles to get
// here, its shadow row and the state cleared for the next call.
template <int kT>
__device__ void finish_tile(const FusedTail &t, TailState *st, int c, int b,
                            int tiles, int *red) {
  constexpr int kTile = kSeg * kT;
  const int tid = threadIdx.x;
  const int L = t.L;
  const int j0 = b * kTile;
  const int base = j0 + kSeg * tid;
  uint32_t *dig = t.dig + static_cast<size_t>(c) * L;
  // the digits loaded with the component's words, whether needed or not
  const uint4 v = base < L ? load4(dig + base) : make_uint4(0, 0, 0, 0);
  const bool neg = st->neg[c];
  const int lo_enc = st->lo[c];
  const int lo = lo_enc ? INT_MAX - lo_enc : INT_MAX;
  if (b == 0 && tid == 0) t.sgn[c] = neg && lo_enc ? -1 : 1;
  const bool slice = t.shw && j0 < t.F + t.D && j0 + kTile > t.F;
  int hi = -1;
  if (base < L && (neg || slice)) {
    uint32_t d[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < kSeg; ++q) {
      const int j = base + q;
      if (neg) d[q] = j < lo ? 0u : (j == lo ? 0x10000u - d[q]
                                             : 0xFFFFu - d[q]);
      if (d[q] && j >= t.F && j < t.F + t.D) hi = j - t.F;
    }
    if (neg)
      *reinterpret_cast<uint4 *>(dig + base) = make_uint4(d[0], d[1], d[2],
                                                          d[3]);
  }
  if (t.shw) {
    hi = block_max(hi, red);
    if (tid == 0 && hi >= 0) atomicMax(&st->hi[c], hi + 1);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    st->word[c][b] = 0;
    if (atomicAdd(&st->done[c], 1u) == static_cast<uint32_t>(tiles - 1)) {
      // the last tile of the component: every digit is final
      __threadfence();
      if (t.shw) {
        int s = atomicAdd(&st->hi[c], 0) - 4;   // highest - 3
        s = s < 0 ? 0 : (s > t.D - 4 ? t.D - 4 : s);
        for (int q = 0; q < 4; ++q)
          t.shw[5 * c + q] = static_cast<int32_t>(__ldcg(dig + t.F + s + q));
        t.shw[5 * c + 4] = s;
      }
      st->ticket[c] = 0;
      st->done[c] = 0;
      st->lo[c] = 0;
      st->hi[c] = 0;
    }
  }
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
