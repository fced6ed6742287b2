// K12: a whole chunk of device-orbit steps, or of Newton-Raphson steps, in
// one launch.  It computes exactly what K4 then K5 compute, step after
// step (ntt_orbit.cu, orbit_tail.cu): the products by NTT modulo the two
// primes, the CRT, the digit sums with +c and the round bit, the exact
// carries, the signed finish, and the shadow row of each new z.  Every
// output is an exact integer, so K12 equals the per-step loop bit for bit.
//   orbit (V = 2 values, K = 2 components): x, y in place and rows[1..steps]
//     of the [steps + 1][12] shadow rows (row 0, the state's, on entry),
//     and with R > 0 rows[1..steps] of the [steps + 1][2R + 2] reuse rows
//     (the top R digits of x and of y and both signs of each new z, the
//     reference's reuse digits, fractalshark_tpu/ops/bignum/orbit.py:
//     220-222), the outputs of fs_orbit_chunk;
//   NR (V = 4, K = 4): x, y, dx, dy in place and their four signs on the
//     card, the outputs of fs_nr_chunk.
//
// Replaces, with the chunk loop of the reference's session
// (fractalshark_tpu/ops/bignum/orbit.py:150-246, a lax.scan over the
// steps): B5 ntt_mxu.py:800 _iter_paired_kernel, B8a :618 _iter_kernel,
// B8b :557 _nr_kernel, B7 :812 _nr_paired_kernel, B6 ntt_pallas.py:1530
// _tail_paired_kernel and B8c :1134 _tail_split_kernel: the products and
// the tails that the reference launches once per step, here all the steps
// of a chunk in one launch.
//
// Bound per step (chip_smoke.py's ntt_ops + tail_ops, or the NR pair): at
// 32 limbs (n = 128) about 38,000 integer operations, 2.3 ns at the card's
// int32 rate; at 16,384 limbs (n = 65,536) about 34 M, 2 us.  The bytes
// that must move are the state in and out once per chunk and 48 bytes of
// shadow row a step.  Neither bounds a step: its phases depend on each
// other, so the floor is the latency of the barriers between them.
//
// Two forms, chosen by n alone (orbit.chunk_form):
//   block form (n up to orbit.BLOCK_MAX_NFFT): one CTA of block_threads(n)
//     threads runs the whole chunk with the state, c, the twiddles, the
//     residues and the digit sums in shared memory (block_bytes: 48n + 64
//     bytes for the orbit, 84n + 64 for NR, within the 232,448 a block may
//     have up to n = 4,096 and 2,048).  A step is the forward radix-2
//     NTTs of length n over all values and both primes, the pointwise
//     products, the inverse NTTs, the digit sums (the n^-1 R^2 scale, the
//     CRT, the multiplier and the addend, one position a thread), then the
//     carries on one warp per component: each lane ripples a segment of
//     S = n/32 >= 4 digits, and the segments' carries and carry maps (K5's
//     argument below) pass by warp shuffles.  The NTT stages of span 32 or
//     less stay within a warp's 64 elements and end with __syncwarp, so a
//     step at n = 128 has 10 __syncthreads and writes 48 bytes to global
//     memory (the shadow row); the latency of the stages and barriers on
//     one SM is the floor.
//   grid form (larger n): one cooperative launch of 256-thread blocks, as
//     many as are co-resident and have work, at most two an SM (the
//     occupancy query once per chunk), runs K4's three passes
//     (ntt_orbit.cuh, with column tiles of 2 columns so that the column
//     passes reach 128 SMs at 16,384 limbs) and K5's wide tail
//     (orbit_tail.cuh), each phase's items spread over the whole grid,
//     with a grid-wide barrier after each.  The tail's six phases W1-W6
//     take three barriers: W1 + W2 (each segment recomputes the ripple
//     carry of the segment below), W3 + W4 (each block scans the block
//     aggregates itself), W5; W6 of step k runs beside step k + 1's first
//     pass.  So 6 barriers a step; they and the latency of the column and
//     row passes are the floor (PERF.md §6).  Digits, work, coefficients
//     and the tail's scratch stay in global memory (3.3 MB at 16,384
//     limbs, 6.6 MB at 32,768, L2-resident).  At the largest size, n =
//     2^17 (32,768 limbs), a step measured 53 us on the H100 against 37
//     at n = 2^16: twice the work for 1.45x the time, 11x the 4.9 us
//     operation bound, so the barriers and the passes' latency are still
//     the floor there; column tiles of 4 or 8 columns and 3 blocks an SM
//     measured slower at both sizes (tools/time_orbit32.py --set).
//     The lowest/highest-nonzero atomics are reset inside the launch in
//     the W1 + W2 phase, after the barriers that follow W5's and W6's
//     reads; step k + 1 reads the signs of row k + 1 (the NR sign row)
//     only after the barrier that follows their write.
//
// Exactness, for each instance apart (D digits of 16 bits, n = 2^m >=
// 2D, so no product wraps around the cyclic convolution):
//   orbit (V = 2): coef[0] = x^2 - y^2 and coef[1] = xy are sums of at
//     most D products of two digits, |coef| < D*2^32 <= 2^48; their CRT
//     from the two primes is exact, since that is below p1*p2/2 ~ 2^60.7.
//     The digit sums are coef[0] + scx*cx_j + 2^15 and +-2*coef[1] +
//     scy*cy_j + 2^15, so |acc| < 2D*2^32 + 2^17 < 2^50 for D <= 2^16
//     (32,768 limbs, n = 2^17);
//   NR (V = 4): u = x*dx - y*dy and v = x*dy + y*dx are sums of at most
//     2D products of two digits, so |2u|, |2v| <= 4D(2^16 - 1)^2, which at
//     D = 2^16 is 2^50 - 2^35 + 2^18; with the addends (c, the +1 of dz/dc
//     at digit 2F, the round bit: below 2^17) |acc| < 2^50 - 2^34 for D
//     <= 2^16 (32,768 limbs, n = 2^17), and |u| < 2^49 keeps the CRT exact.
// K5's carries (orbit_tail.cu) are exact for any |acc| < 2^51, so both
// instances keep a margin of 2x: segments of S >= 4 digits ripple their
// own sums (|carry| <= 2^35 + 1, int64), absorb the carry of the segment
// below (after three digits its carry is -1, 0 or 1), and then carry -1,
// 0 or 1, as a map of their carry-in; a scan of the maps gives every
// carry-in at once.  n <= 2^17 is K4-NR's cap and the grid
// form's W3 scan of n/1,024 block aggregates in one 256-thread block.  At
// n = 2^17 every index stays below 2^21 (work [2Vn], coef [Vn], scratch
// [7n] words), the digit positions below 2^17 in int32, the shadow row's
// base index below 2^16 in int32, a reuse row's offset in size_t; no
// 16-bit field holds a position.
//
// No fallback: a refused opt-in to shared memory or a refused cooperative
// launch returns its error (cleared from CUDA's last error), which the
// wrapper raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "ntt_common.cuh"
#include "ntt_orbit.cuh"
#include "orbit_tail.cuh"
#include "tail_common.cuh"

namespace {

constexpr int kBlockMaxThreads = 1024;
constexpr size_t kMaxSmem = 232448;    // the most a block may opt in to
constexpr int kChunkMaxLog2 = 17;
constexpr int kGridMinLog2 = 10;       // one wide-tail block of digits
// the grid form's column tiles: 2 columns, four times K4's count of
// column items, so that the column passes spread over the card (at 16,384
// limbs 128 inverse items, not 32)
constexpr int kGridLogCols = 1;
constexpr int kGridBlocksPerSm = 2;    // more blocks only slow the barriers

// one chunk's arguments
struct Chunk {
  uint32_t *st[4];        // the state's digits, in place: uint32 [D] each
  int32_t *rows;          // V = 2: [steps + 1][12]; V = 4: the signs [4]
  int32_t *reuse;         // V = 2, R > 0: [steps + 1][2R + 2], else null
  const uint32_t *cx, *cy;
  const uint32_t *tw;     // ntt.kernel_tables(n)
  uint32_t *work;         // grid form: uint32 [2Vn]
  int64_t *coef;          // grid form: int64 [Vn]
  uint32_t *scratch;      // grid form: the wide tail's, uint32 [7n]
  int scx, scy, D, m, steps, R;
};

// the reuse row of the state after step k - 1 (row k): the top R digits of
// x and of y, then the signs; thread t of `threads`, digits from `st`
__device__ __forceinline__ void reuse_item(const Chunk &c, int k,
                                           const uint32_t *x,
                                           const uint32_t *y, int sx, int sy,
                                           int t, int threads) {
  int32_t *ru = c.reuse + static_cast<size_t>(2 * c.R + 2) * k;
  for (int i = t; i < 2 * c.R; i += threads)
    ru[i] = static_cast<int32_t>(i < c.R ? x[c.D - c.R + i]
                                         : y[c.D - 2 * c.R + i]);
  if (t == 0) {
    ru[2 * c.R] = sx;
    ru[2 * c.R + 1] = sy;
  }
}

// the block form's threads: one butterfly a thread per stage, 64 to 1,024
int block_threads(int m, int V) {
  const int t = V << m;
  return t < 64 ? 64 : (t > kBlockMaxThreads ? kBlockMaxThreads : t);
}

// the block form's shared memory, in the kernel's order: digit sums
// int64 [V][n]; residues [2V][n]; the state [V][D]; cx, cy [D]; forward
// and inverse twiddles [2][n/2] each; 16 ints of signs and digit indices
size_t block_bytes(int m, int D, int V) {
  const size_t n = size_t{1} << m;
  return 4 * (4 * V * n + V * D + 2 * D + 2 * n + 16);
}

constexpr unsigned kFullWarp = 0xffffffffu;

// transform() of ntt_common.cuh on contiguous sequences (2^lg elements
// each, one after the other).  A warp's butterflies b in [32w, 32w + 32)
// touch only their own 64 elements while the span h is 32 or less, so
// between two such stages the warp needs only __syncwarp; any other stage
// ends with __syncthreads.
template <bool kForward>
__device__ void transform_flat(uint32_t *sm, int arrays, int lg,
                               const uint32_t *tws) {
  const int half = 1 << (lg - 1);
  const int total = arrays * half;
  for (int s = 0; s < lg; ++s) {
    const int sh = kForward ? lg - 1 - s : s;
    const int h = 1 << sh;
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      const int k = b & (half - 1);
      const int a = b >> (lg - 1);
      const int pr = a & 1;
      const uint32_t p = prime(pr);
      const uint32_t pp = pprime(pr);
      const int j = k & (h - 1);
      uint32_t *x0 = sm + (a << lg) + 2 * (k - j) + j;
      uint32_t *x1 = x0 + h;
      const uint32_t w = tws[pr * half + (j << (lg - 1 - sh))];
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
    const int next = kForward ? h >> 1 : h << 1;
    if (s + 1 < lg && h <= 32 && next <= 32)
      __syncwarp();
    else
      __syncthreads();
  }
}

template <int V>
__global__ void __launch_bounds__(kBlockMaxThreads)
chunk_block(Chunk c) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int K = V;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int m = c.m;
  const int n = 1 << m;
  const int D = c.D;
  const int F = D - 2;
  int64_t *acc = reinterpret_cast<int64_t *>(sm);   // [K][n] digit sums
  uint32_t *res = sm + 2 * V * n;      // array 2v + prime
  uint32_t *stv = res + 2 * V * n;     // the state: value v at v*D
  uint32_t *cxy = stv + V * D;
  uint32_t *twf = cxy + 2 * D;
  uint32_t *twi = twf + n;
  int *sg = reinterpret_cast<int *>(twi + n);   // the state's signs
  int *neg = sg + 4;                   // per component: the sum is negative
  int *hi = neg + 4;                   // the highest nonzero of its value

  // once a chunk: the state, c, the twiddles and the signs
  for (int i = t; i < V * D; i += T) stv[i] = c.st[i / D][i % D];
  for (int i = t; i < D; i += T) {
    cxy[i] = c.cx[i];
    cxy[D + i] = c.cy[i];
  }
  load_twiddles<true>(twf, m, m, c.tw);
  load_twiddles<false>(twi, m, m, c.tw);
  if (t < 4) sg[t] = V == 2 ? (t < 2 ? c.rows[10 + t] : 1) : c.rows[t];
  const uint32_t scale1 = c.tw[4 * n];
  const uint32_t scale2 = c.tw[4 * n + 1];
  const uint32_t crt = c.tw[4 * n + 2];   // p1^-1 * R mod p2
  // the tail runs on the first warp of each component's group of T/K
  // threads: lane g owns segment g of S >= 4 digits, nseg <= 32 of them
  const int Tg = T / K;
  const int comp = t / Tg;
  const int g = t - comp * Tg;
  const int nseg = (n >> 2) < 32 ? (n >> 2) : 32;
  const int S = n / nseg;
  const bool active = g < nseg;
  const int base = g * S;
  uint32_t *dig = res + 2 * comp * n;   // the component's working digits
  const int64_t *sums = acc + comp * n;  // and its digit sums
  __syncthreads();

  for (int k = 0; k < c.steps; ++k) {
    // the digits into both primes' arrays, zero beyond D
    for (int i = t; i < V * n; i += T) {
      const int v = i >> m;
      const int e = i & (n - 1);
      const uint32_t d = e < D ? stv[v * D + e] : 0u;
      res[2 * v * n + e] = d;
      res[(2 * v + 1) * n + e] = d;
    }
    if (t < K) hi[t] = -1;
    __syncthreads();
    transform_flat<true>(res, 2 * V, m, twf);
    pointwise<V>(res, n, sg);
    __syncthreads();
    transform_flat<false>(res, 2 * V, m, twi);

    // the digit sums of every component: the coefficient from the CRT of
    // its scaled residues, times the multiplier, plus the addend
    for (int i = t; i < K * n; i += T) {
      const int q = i >> m;
      const int j = i & (n - 1);
      const uint32_t r1 = mont_mul(res[2 * q * n + j], scale1, kP1, kPp1);
      const uint32_t r2 =
          mont_mul(res[(2 * q + 1) * n + j], scale2, kP2, kPp2);
      acc[i] = tail_mul<K>(q, sg[0], sg[1]) *
                   crt_signed(crt_rec(r1, r2, crt)) +
               tail_addend<K>(q, j, D, c.scx, c.scy, cxy, cxy + D);
    }
    __syncthreads();

    if (g < 32) {
      // 1. each segment ripples its digit sums
      int64_t cr = 0;
      if (active) {
        for (int q = 0; q < S; ++q) {
          const int64_t a = sums[base + q] + cr;
          dig[base + q] = static_cast<uint32_t>(a & 0xFFFF);
          cr = a >> 16;
        }
      }

      // 2. absorb the carry of the segment below; the segment's carry map
      int64_t ci = __shfl_up_sync(kFullWarp, cr, 1);
      if (g == 0) ci = 0;
      uint32_t f = enc(-1, 0, 1);   // identity past the number
      if (active) {
        bool all_ffff = true;
        bool all_zero = true;
        for (int q = 0; q < S; ++q) {
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
        f = segment_map(static_cast<int>(ci), all_ffff, all_zero);
      }

      // 3. inclusive scan of the maps over the warp; the carry out of the
      // top and the sign
      uint32_t inc = f;
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t o = __shfl_up_sync(kFullWarp, inc, off);
        if (g >= off) inc = compose(inc, o);
      }
      const uint32_t below = __shfl_up_sync(kFullWarp, inc, 1);
      const int64_t top = __shfl_sync(kFullWarp, cr, nseg - 1) +
                          apply(__shfl_sync(kFullWarp, inc, nseg - 1), 0);
      const bool negative = top < 0;

      // 4. apply the carry-in (+1 over a run of 0xFFFF, -1 over a run of
      // 0); the lowest nonzero digit; a negative sum in two's complement
      int lowest = INT_MAX;
      if (active) {
        int run = g ? apply(below, 0) : 0;
        for (int q = 0; q < S; ++q) {
          const int j = base + q;
          uint32_t d = dig[j];
          if (run > 0) {
            d = (d + 1u) & 0xFFFFu;
            dig[j] = d;
            if (d != 0u) run = 0;
          } else if (run < 0) {
            d = (d - 1u) & 0xFFFFu;
            dig[j] = d;
            if (d != 0xFFFFu) run = 0;
          }
          if (d && lowest == INT_MAX) lowest = j;
        }
      }
      lowest = __reduce_min_sync(kFullWarp, lowest);
      if (active && negative) {
        for (int q = 0; q < S; ++q) {
          const int j = base + q;
          const uint32_t d = dig[j];
          dig[j] = j < lowest ? 0u
                              : (j == lowest ? 0x10000u - d : 0xFFFFu - d);
        }
      }
      if (g == 0) neg[comp] = negative;
    }
    __syncthreads();

    // 5. digits F..F+D-1 are the new value; its highest nonzero digit
    int top = -1;
    for (int i = g; i < D; i += Tg) {
      const uint32_t d = dig[F + i];
      stv[comp * D + i] = d;
      if (d) top = i;
    }
    if (top >= 0) atomicMax(&hi[comp], top);
    __syncthreads();

    // the next step's signs; the shadow row of the new z (V = 2)
    if (t < K) sg[t] = neg[t] ? -1 : 1;
    if (V == 2 && t < 2) {
      int32_t *row = c.rows + 12 * (k + 1);
      int b = hi[t] - 3;
      b = b < 0 ? 0 : (b > D - 4 ? D - 4 : b);
      for (int q = 0; q < 4; ++q)
        row[5 * t + q] = static_cast<int32_t>(stv[t * D + b + q]);
      row[5 * t + 4] = b;
      row[10 + t] = neg[t] ? -1 : 1;
    }
    if (V == 2 && c.reuse)
      reuse_item(c, k + 1, stv, stv + D, neg[0] ? -1 : 1, neg[1] ? -1 : 1, t,
                 T);
    __syncthreads();
  }

  for (int i = t; i < V * D; i += T) c.st[i / D][i % D] = stv[i];
  if (V == 4 && t < 4) c.rows[t] = sg[t];
}

// The grid form's tail in three phases, not K5's six launches: W1 and W2
// in one, each segment recomputing the ripple carry of the segment below
// (four digit sums) instead of reading it after a barrier; W3 and W4 in
// one, each block scanning the component's block aggregates itself; then
// K5's W5 (wide_finish_item), and W6 beside the next step's first pass.

// W1 + W2 (item (bx, comp)): the segment's ripple, the carry of the
// segment below, the segment's map and the block's scan of maps; the top
// segment's ripple carry for W3 + W4
template <int K, int N>
__device__ void ripple_maps_item(const Tail &tl, uint32_t *scratch, int D,
                                 int m, int bx, int comp, int64_t mul,
                                 uint32_t (*maps)[N]) {
  const int L = 1 << m;
  const int ns = L / kWideSeg;
  const Wide w = wide<K>(scratch, L);
  const int t = threadIdx.x;
  const int s = bx * kWideThreads + t;
  uint32_t d[kWideSeg];
  int64_t cr = 0;
  for (int q = 0; q < kWideSeg; ++q) {
    const int64_t a = digit_sum<K>(tl, comp, mul, s * kWideSeg + q, D, L) +
                      cr;
    d[q] = static_cast<uint32_t>(a & 0xFFFF);
    cr = a >> 16;
  }
  if (s == ns - 1) w.carry[comp * ns + s] = cr;
  int64_t ci = 0;
  if (s)
    for (int q = 0; q < kWideSeg; ++q)
      ci = (digit_sum<K>(tl, comp, mul, (s - 1) * kWideSeg + q, D, L) + ci) >>
           16;
  bool all_ffff = true;
  bool all_zero = true;
  for (int q = 0; q < kWideSeg; ++q) {
    if (ci) {
      const int64_t a = static_cast<int64_t>(d[q]) + ci;
      d[q] = static_cast<uint32_t>(a & 0xFFFF);
      ci = a >> 16;
    }
    all_ffff &= d[q] == 0xFFFFu;
    all_zero &= d[q] == 0u;
    w.dig[comp * L + s * kWideSeg + q] = d[q];
  }
  const uint32_t inc =
      scan_maps(segment_map(static_cast<int>(ci), all_ffff, all_zero), maps);
  w.prefix[comp * ns + s] =
      static_cast<uint8_t>(t ? maps[0][t - 1] : enc(-1, 0, 1));
  if (t == kWideThreads - 1)
    w.agg[comp * (ns / kWideThreads) + bx] = inc;
}

// W3 + W4 (item (bx, comp)): the scan of the component's block aggregates
// (blockDim.x >= G), the block's carry-in and the sign, then each
// segment's carry-in applied and the lowest nonzero digit
template <int K, int N>
__device__ void scan_apply_item(uint32_t *scratch, int m, int bx, int comp,
                                uint32_t (*maps)[N], int *red) {
  const int L = 1 << m;
  const int ns = L / kWideSeg;
  const int g = ns / kWideThreads;
  const Wide w = wide<K>(scratch, L);
  const int t = threadIdx.x;
  scan_maps(t < g ? w.agg[comp * g + t] : enc(-1, 0, 1), maps);
  const int bcin = bx ? apply(maps[0][bx - 1], 0) : 0;
  if (bx == 0 && t == 0)
    w.flag[comp] = w.carry[comp * ns + ns - 1] + apply(maps[0][g - 1], 0) < 0;
  const int s = bx * kWideThreads + t;
  uint32_t *dig = w.dig + comp * L + s * kWideSeg;
  int run = apply(w.prefix[comp * ns + s], bcin);
  int lo = INT_MAX;
  for (int q = 0; q < kWideSeg; ++q) {
    uint32_t d = dig[q];
    if (run > 0) {
      d = (d + 1u) & 0xFFFFu;
      dig[q] = d;
      if (d != 0u) run = 0;
    } else if (run < 0) {
      d = (d - 1u) & 0xFFFFu;
      dig[q] = d;
      if (d != 0xFFFFu) run = 0;
    }
    if (d && lo == INT_MAX) lo = s * kWideSeg + q;
  }
  lo = block_min(lo, red);
  if (t == 0 && lo != INT_MAX) atomicMin(&w.flag[K + comp], lo);
}

template <int V>
__global__ void __launch_bounds__(kOrbitThreads)
chunk_grid(Chunk c) {
  extern __shared__ __align__(16) uint32_t sm[];
  __shared__ uint32_t maps[2][kWideThreads];
  __shared__ int red[33];
  constexpr int K = V;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const Split s = split_of(c.m, kGridLogCols);
  const int tiles = col_tiles(s);
  const int rows = 1 << s.m1;
  const int G = (1 << c.m) / (kWideThreads * kWideSeg);
  int32_t *flag = wide<K>(c.scratch, 1 << c.m).flag;
  const Values in = {{c.st[0], c.st[1], c.st[2], c.st[3]}};
  const int32_t *signs = V == 4 ? c.rows : nullptr;
  Tail tl = {c.coef, nullptr, V == 4 ? c.rows : nullptr, c.cx, c.cy,
             c.scx, c.scy, {c.st[0], c.st[1], c.st[2], c.st[3]}};
  for (int k = 0; k < c.steps; ++k) {
    // W6 of the previous step, beside the forward column pass, and its
    // reuse row (the state is final until this step's W5)
    if (k && blockIdx.x == 0 && threadIdx.x < K)
      wide_row_item<K>(tl, c.scratch, c.D, c.m, threadIdx.x);
    if (V == 2 && k && c.reuse && blockIdx.x == 0)
      reuse_item(c, k, c.st[0], c.st[1], flag[0] ? -1 : 1, flag[1] ? -1 : 1,
                 threadIdx.x, blockDim.x);
    if (V == 2) {
      tl.row_in = c.rows + 12 * k;
      tl.row_out = c.rows + 12 * (k + 1);
    }
    for (int it = blockIdx.x; it < V * tiles; it += gridDim.x) {
      col_fwd_item(in, c.work, c.tw, c.D, s, it % tiles, it / tiles, sm);
      __syncthreads();
    }
    grid.sync();
    for (int r = blockIdx.x; r < rows; r += gridDim.x) {
      row_item<V>(c.work, c.tw, signs, s, r, sm);
      __syncthreads();
    }
    grid.sync();
    for (int it = blockIdx.x; it < tiles; it += gridDim.x) {
      col_inv_item<V>(c.work, c.coef, c.tw, s, it, sm);
      __syncthreads();
    }
    grid.sync();
    // the lowest/highest nonzero digits of this step: W5 and W6 of the
    // previous one have read them
    if (blockIdx.x == 0 && threadIdx.x < K) {
      flag[K + threadIdx.x] = INT_MAX;
      flag[2 * K + threadIdx.x] = -1;
    }
    for (int it = blockIdx.x; it < G * K; it += gridDim.x) {
      ripple_maps_item<K>(tl, c.scratch, c.D, c.m, it % G, it / G,
                          tail_mul<K>(tl, it / G), maps);
      __syncthreads();
    }
    grid.sync();
    for (int it = blockIdx.x; it < G * K; it += gridDim.x) {
      scan_apply_item<K>(c.scratch, c.m, it % G, it / G, maps, red);
      __syncthreads();
    }
    grid.sync();
    for (int it = blockIdx.x; it < G * K; it += gridDim.x) {
      wide_finish_item<K>(tl, c.scratch, c.D, c.m, it % G, it / G, red);
      __syncthreads();
    }
    grid.sync();
  }
  if (c.steps && blockIdx.x == 0 && threadIdx.x < K)
    wide_row_item<K>(tl, c.scratch, c.D, c.m, threadIdx.x);
  if (V == 2 && c.steps && c.reuse && blockIdx.x == 0)
    reuse_item(c, c.steps, c.st[0], c.st[1], flag[0] ? -1 : 1,
               flag[1] ? -1 : 1, threadIdx.x, blockDim.x);
}

// the block form: one CTA, the opt-in to its shared memory first
template <int V>
int launch_block(Chunk c, cudaStream_t st) {
  const size_t smem = block_bytes(c.m, c.D, V);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int rc = launch_smem(reinterpret_cast<const void *>(chunk_block<V>), smem);
  if (!rc)
    chunk_block<V><<<1, block_threads(c.m, V), smem, st>>>(c);
  const int last = static_cast<int>(cudaGetLastError());
  return rc ? rc : last;
}

// the grid form: one cooperative launch of as many blocks as are
// co-resident (at most kGridBlocksPerSm an SM) and have work in some phase
template <int V>
int launch_grid(Chunk c, cudaStream_t st) {
  const void *fn = reinterpret_cast<const void *>(chunk_grid<V>);
  const Split s = split_of(c.m, kGridLogCols);
  size_t smem = fwd_bytes(s);
  if (row_bytes(s, V) > smem) smem = row_bytes(s, V);
  if (inv_bytes(s, V) > smem) smem = inv_bytes(s, V);
  int items = V * col_tiles(s);
  if ((1 << s.m1) > items) items = 1 << s.m1;
  const int tail_items = V * ((1 << c.m) / (kWideThreads * kWideSeg));
  if (tail_items > items) items = tail_items;
  int rc = static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  int dev = 0, sms = 0, per_sm = 0;
  if (!rc) rc = static_cast<int>(cudaGetDevice(&dev));
  if (!rc)
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (!rc)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, kOrbitThreads, smem));
  if (!rc && per_sm < 1)
    rc = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (!rc) {
    if (per_sm > kGridBlocksPerSm) per_sm = kGridBlocksPerSm;
    const int blocks = per_sm * sms < items ? per_sm * sms : items;
    void *args[] = {&c};
    rc = static_cast<int>(cudaLaunchCooperativeKernel(
        fn, dim3(blocks), dim3(kOrbitThreads), args, smem, st));
  }
  const int last = static_cast<int>(cudaGetLastError());
  return rc ? rc : last;
}

// the most digits an instance takes (the exactness argument above)
constexpr int max_digits(int) { return 1 << 16; }

template <int V>
int chunk(Chunk c, int grid, cudaStream_t st) {
  if (c.D < 16 || c.D > max_digits(V) || c.m > kChunkMaxLog2 ||
      2 * c.D > (1 << c.m) || c.steps < 0 ||
      (grid && (c.m < kGridMinLog2 || !c.work || !c.coef || !c.scratch)) ||
      (c.reuse && (c.R < 1 || c.R > c.D)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!c.steps) return 0;
  return grid ? launch_grid<V>(c, st) : launch_block<V>(c, st);
}

}  // namespace

// The block form's shared memory in bytes for n = 2^log2n, D digits and V
// values (2: the orbit, 4: NR): the reckoning launch_block holds to
// kMaxSmem, exported so that the wrapper's mirror can be held to it.
extern "C" int fs_k12_block_bytes(int log2n, int D, int V) {
  return static_cast<int>(block_bytes(log2n, D, V));
}

// K12, the orbit: `steps` steps in place on x, y (uint32 [D]); rows int32
// [steps + 1][12], row 0 holding the state's row on entry, row k + 1 the
// shadow row after step k (fs_orbit_chunk's outputs).  grid = 0: the block
// form (work, coef and scratch unused); grid = 1: the grid form, with work
// uint32 [4n], coef int64 [2n] and scratch uint32 [4n].  n = 2^log2n >= 2D,
// 16 <= D <= 2^16, n <= 2^17 (the grid form: n >= 2^10).  reuse: null, or
// int32 [steps + 1][2R + 2] (1 <= R <= D), row 0 the state's on entry, row
// k + 1 written after step k.
extern "C" int fs_orbit_chunk_k12(void *x, void *y, void *rows,
                                  const void *cx, const void *cy, int scx,
                                  int scy, void *work, void *coef,
                                  void *scratch, const void *tables, int D,
                                  int log2n, int steps, int grid,
                                  void *reuse, int R, void *stream) {
  Chunk c = {{static_cast<uint32_t *>(x), static_cast<uint32_t *>(y),
              nullptr, nullptr},
             static_cast<int32_t *>(rows),
             static_cast<int32_t *>(reuse),
             static_cast<const uint32_t *>(cx),
             static_cast<const uint32_t *>(cy),
             static_cast<const uint32_t *>(tables),
             static_cast<uint32_t *>(work),
             static_cast<int64_t *>(coef),
             static_cast<uint32_t *>(scratch),
             scx, scy, D, log2n, steps, R};
  return chunk<2>(c, grid, static_cast<cudaStream_t>(stream));
}

// K12, the NR instance: `steps` NR steps in place on x, y, dx, dy (uint32
// [D]) and their signs (int32 [4] on the card), fs_nr_chunk's outputs.
// grid as above, with work uint32 [8n], coef int64 [4n] and scratch
// uint32 [7n]; 16 <= D <= 2^16.
extern "C" int fs_nr_chunk_k12(void *x, void *y, void *dx, void *dy,
                               void *signs, const void *cx, const void *cy,
                               int scx, int scy, void *work, void *coef,
                               void *scratch, const void *tables, int D,
                               int log2n, int steps, int grid,
                               void *stream) {
  Chunk c = {{static_cast<uint32_t *>(x), static_cast<uint32_t *>(y),
              static_cast<uint32_t *>(dx), static_cast<uint32_t *>(dy)},
             static_cast<int32_t *>(signs),
             nullptr,
             static_cast<const uint32_t *>(cx),
             static_cast<const uint32_t *>(cy),
             static_cast<const uint32_t *>(tables),
             static_cast<uint32_t *>(work),
             static_cast<int64_t *>(coef),
             static_cast<uint32_t *>(scratch),
             scx, scy, D, log2n, steps, 0};
  return chunk<4>(c, grid, static_cast<cudaStream_t>(stream));
}
