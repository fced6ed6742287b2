// K10: the CRT + carry tail from residue rows, over the whole card.
//
// Replaces: fractalshark_tpu/ops/bignum/ntt_pallas.py:1265
// _tail_batched_kernel (B-f4, BATCHED_TAIL) and :1134 _tail_split_kernel
// run on residue rows (B8c's fused_tail, :1326, the route with the flag
// off).  Both compute one function (fused_tail.cuh's header says which);
// both flags reach these two launches, counted apart by the wrapper.
//
// What bounds it: the bytes.  At nfft 65,536 and two components it reads
// 1 MB of residue rows and 768 KB of addend planes and writes 512 KB of
// digits (0.7 us at 3.35 TB/s); the arithmetic is tens of integer
// operations a digit.  A tail on one block per component (its parent,
// fused_tail.cuh tail_component, which K11 keeps) used 2-4 of 132 SMs, a
// thread walking 64 consecutive digits, so every warp access touched 32
// sectors, and passed the digits through device memory five times.
//
// Design: launch 1, tail_tiles, has a block of 256 threads for each tile
// of 1,024 consecutive digits of a component (grid (tiles, K): the
// components on blockIdx.y, all in one launch).  The block
//   1. computes the CRT of every coefficient its tile's digits read once,
//      into shared memory, with 8 below the tile as a halo (3 for its
//      first digits' 16-bit parts, 4 for the segment below), the residue
//      rows read coalesced;
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
//      the first one that has published its carry-out, then publishes its
//      own carry-out.  Tiles take their index from a ticket in the order
//      they start, so a tile waits only on tiles that are running;
//   5. applies each segment's carry-in, stores its digits once (16 bytes a
//      thread), and meets the other tiles' lowest nonzero digit in an
//      atomic; the top tile writes whether the total is negative.
// Launch 2, tail_finish, on the same grid: the sign (negative and not
// zero modulo 2^(16L)), the two's-complement negation from the lowest
// nonzero digit where the total is negative, the highest nonzero digit of
// the value slice [F, F+D) in an atomic, and, in the last block of a
// component, its shadow row.  No host sync: component 1's gswap (zsign)
// is read on the card.  The two launches' state (tickets, published
// words, the atomics) is device scratch that is zero between calls:
// launch 2 clears what launch 1 set, and a refused launch 2 is cleared
// here with a memset.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "fused_tail.cuh"

namespace {

constexpr int kGridThreads = 256;
constexpr int kGridSeg = 4;                          // digits a thread
constexpr int kGridTile = kGridThreads * kGridSeg;   // digits a block
constexpr int kHalo = 8;                             // coefficients below
constexpr int kMaxTiles = (1 << 17) / kGridTile;

// a published word: flag in bits 30-31, then a map or a carry-out + 1
constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kPrefix = 2u << 30;

// device scratch, all zero between calls
struct TailState {
  uint32_t word[kMaxTail][kMaxTiles];   // each tile's published word
  uint32_t ticket[kMaxTail];
  uint32_t done[kMaxTail];              // finished tiles of launch 2
  int32_t lo[kMaxTail];    // INT_MAX - lowest nonzero digit; 0: none
  int32_t hi[kMaxTail];    // 1 + highest nonzero digit of the slice - F
  int32_t neg[kMaxTail];   // the total is negative (set by launch 1)
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
// coefficients with co[0] at j; the three below at co[-1..-3]): the
// digits and the carry-out
__device__ __forceinline__ int32_t ripple(const int64_t *co, const Comp &k,
                                          const uint32_t *cadd,
                                          const uint32_t *rnd, int j,
                                          uint32_t d[kGridSeg]) {
  const uint4 cv = *reinterpret_cast<const uint4 *>(cadd + j);
  const uint4 rv = *reinterpret_cast<const uint4 *>(rnd + j);
  const uint32_t ca[4] = {cv.x, cv.y, cv.z, cv.w};
  const uint32_t rn[4] = {rv.x, rv.y, rv.z, rv.w};
  int64_t cr = 0;
#pragma unroll
  for (int q = 0; q < kGridSeg; ++q) {
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

__device__ __forceinline__ uint32_t load_word(const uint32_t *p) {
  return *reinterpret_cast<const volatile uint32_t *>(p);
}

// launch 1: grid (tiles, K), kGridThreads threads
__global__ void __launch_bounds__(kGridThreads)
    tail_tiles(FusedTail t, TailState *st) {
  __shared__ int64_t coef[kHalo + kGridTile];
  __shared__ int32_t carry[kGridThreads + 1];
  __shared__ uint32_t warp_map[kGridThreads / 32];
  __shared__ int red[33];
  __shared__ int tile_s, rin_s;
  __shared__ uint32_t agg_s;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  if (tid == 0) tile_s = static_cast<int>(atomicAdd(&st->ticket[c], 1u));
  const Comp k = comp_of(t, c);
  const int L = t.L;
  const uint32_t *rows = t.inv + static_cast<size_t>(c) * 2 * t.n;
  const uint32_t *ca = t.cadd + static_cast<size_t>(c) * L;
  __syncthreads();
  const int b = tile_s;
  const int j0 = b * kGridTile;

  // 1. the CRT of coefficients j0 - kHalo .. j0 + kGridTile - 1 (those at
  // L or beyond reach no digit)
  for (int i = tid; i < kHalo + kGridTile; i += kGridThreads) {
    const int j = j0 - kHalo + i;
    coef[i] = j < L ? tail_coef(rows, t.n, j, k.dbl, k.swap) : 0;
  }
  __syncthreads();

  // 2. the segment's own sums; thread 0 also the segment below the tile
  const int base = j0 + kGridSeg * tid;
  const bool active = base < L;
  uint32_t d[kGridSeg] = {0, 0, 0, 0};
  int32_t cr = 0;
  if (active)
    cr = ripple(coef + kHalo + kGridSeg * tid, k, ca, t.rnd, base, d);
  carry[tid + 1] = cr;
  if (tid == 0) {
    uint32_t below[kGridSeg];
    carry[0] = b ? ripple(coef + kHalo - kGridSeg, k, ca, t.rnd,
                          j0 - kGridSeg, below)
                 : 0;
  }
  __syncthreads();

  // 3. absorb the carry of the segment below; the segment's map; the
  // block's scan of maps (incl: f_tid o ... o f_0)
  uint32_t f = enc(-1, 0, 1);
  if (active) {
    int32_t ci = carry[tid];
    bool all_ffff = true;
    bool all_zero = true;
#pragma unroll
    for (int q = 0; q < kGridSeg; ++q) {
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
  if (lane == 31) warp_map[w] = incl;
  __syncthreads();
  uint32_t below = enc(-1, 0, 1);   // the warps below this one
  for (int i = 0; i < w; ++i) below = compose(warp_map[i], below);
  incl = compose(incl, below);
  uint32_t excl = __shfl_up_sync(~0u, incl, 1);
  if (lane == 0) excl = below;
  if (tid == kGridThreads - 1) agg_s = incl;
  __syncthreads();

  // 4. the carry into the tile, by decoupled look-back
  if (tid == 0) {
    uint32_t *word = st->word[c];
    const uint32_t agg = agg_s;
    int rin = 0;
    if (b) {
      atomicExch(&word[b], kAggregate | agg);
      uint32_t acc = enc(-1, 0, 1);   // the tiles between p and b
      for (int p = b - 1;;) {
        const uint32_t v = load_word(&word[p]);
        if (v & kPrefix) {
          rin = apply(acc, static_cast<int>(v & 3u) - 1);
          break;
        }
        if (v & kAggregate) {
          acc = compose(acc, v & 63u);
          --p;
        }
      }
    }
    atomicExch(&word[b],
               kPrefix | static_cast<uint32_t>(apply(agg, rin) + 1));
    rin_s = rin;
  }
  __syncthreads();
  const int rin = rin_s;

  // 5. apply the carry-in: +1 over a run of 0xFFFF, -1 over a run of 0;
  // store; the lowest nonzero digit; the sign of the total (top tile)
  int lo = INT_MAX;
  if (active) {
    int run = apply(excl, rin);
#pragma unroll
    for (int q = 0; q < kGridSeg; ++q) {
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
    if (base + kGridSeg == L)
      st->neg[c] = carry[tid + 1] + apply(incl, rin) < 0;
  }
  lo = block_min(lo, red);
  if (tid == 0 && lo != INT_MAX) atomicMax(&st->lo[c], INT_MAX - lo);
}

// launch 2: grid (tiles, K), kGridThreads threads
__global__ void __launch_bounds__(kGridThreads)
    tail_finish(FusedTail t, TailState *st) {
  __shared__ int red[33];
  const int c = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int L = t.L;
  const int j0 = b * kGridTile;
  const int base = j0 + kGridSeg * tid;
  const bool neg = st->neg[c];
  const int lo_enc = st->lo[c];
  const int lo = lo_enc ? INT_MAX - lo_enc : INT_MAX;
  uint32_t *dig = t.dig + static_cast<size_t>(c) * L;
  if (b == 0 && tid == 0) t.sgn[c] = neg && lo_enc ? -1 : 1;
  const bool slice = t.shw && j0 < t.F + t.D && j0 + kGridTile > t.F;
  int hi = -1;
  if (base < L && (neg || slice)) {
    uint4 v = *reinterpret_cast<const uint4 *>(dig + base);
    uint32_t d[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < kGridSeg; ++q) {
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
  if (tid) return;
  st->word[c][b] = 0;
  if (atomicAdd(&st->done[c], 1u) != gridDim.x - 1) return;
  // the last block of the component: every digit is final
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

}  // namespace

// K10.  inv: uint32 [K][2][n] residue rows; cadd: uint32 [K][L]; rnd:
// uint32 [L]; cfg: int32 host [4K] (double, gswap, csign, 0); zsign: int32
// [2] on the card or null (component 1's gswap = zsign[0]*zsign[1]); dig:
// uint32 [K][L] out; sgn: int32 [K] out; shw: int32 [K][5] out or null
// (the slice [F, F+D)); state: fs_fused_tail_state_bytes() of device
// scratch, zero on entry and on return.  n = 2^log2n <= 2^17, L <= n a
// multiple of 4; cadd, rnd and dig 16-byte aligned.  Two launches on the
// stream.
extern "C" int fs_fused_tail(const void *inv, const void *cadd,
                             const void *rnd, const void *cfg,
                             const void *zsign, void *dig, void *sgn,
                             void *shw, void *state, int K, int log2n, int L,
                             int F, int D, void *stream) {
  FusedTail t;
  int rc = make_tail(&t, inv, cadd, rnd, static_cast<const int32_t *>(cfg),
                     zsign, dig, sgn, shw, K, log2n, L, F, D);
  if (rc) return rc;
  // the planes and digits are read and written 16 bytes a thread
  if ((reinterpret_cast<uintptr_t>(cadd) | reinterpret_cast<uintptr_t>(rnd) |
       reinterpret_cast<uintptr_t>(dig)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<TailState *>(state);
  const dim3 grid((L + kGridTile - 1) / kGridTile, K);
  tail_tiles<<<grid, kGridThreads, 0, st>>>(t, s);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  tail_finish<<<grid, kGridThreads, 0, st>>>(t, s);
  if ((rc = static_cast<int>(cudaGetLastError())))
    cudaMemsetAsync(state, 0, sizeof(TailState), st);
  return rc;
}

extern "C" int fs_fused_tail_state_bytes() {
  return static_cast<int>(sizeof(TailState));
}
