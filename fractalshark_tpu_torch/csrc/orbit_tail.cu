// K5: from the products of one orbit step to the next z.  Per component
// (block 0: x' = x^2 - y^2 + cx, block 1: y' = 2xy + cy) it forms the
// signed digit sums acc_j over L = n >= 2D positions,
//   acc = coef[0] + scx*cx<<F + h          (x)
//   acc = 2*sx*sy*coef[1] + scy*cy<<F + h  (y),   h = 2^15 at digit F-1,
// resolves every carry exactly, finishes in sign-magnitude form (sign -1
// iff the sum is negative; digits F..F+D-1 of its magnitude), and writes
// the [12] shadow row of the new z: per component the 4 digits ending at
// the top nonzero digit and their base index, then the two signs
// (fractalshark_tpu/ops/bignum/orbit.py:72-80, 145-148).
//
// Replaces: fractalshark_tpu/ops/bignum/ntt_pallas.py:1530
// _tail_paired_kernel (B6; call :1585, API fused_tail_paired :1564;
// nfft >= 32768) and :1134 _tail_split_kernel (B8c; call :1370, API
// fused_tail :1326).  Both compute this one function on the TPU from CRT
// residues; here K4 hands over exact int64 coefficients, so the CRT is
// K4's and this kernel starts from integers.
//
// Carries, exactly.  The number is cut into segments of S >= 4 digits:
//   1. each segment's sums are rippled sequentially (int64): digits in
//      [0, 2^16) and a signed carry-out C_s, |C_s| < 2^34 since
//      |acc| < 2^50;
//   2. each segment adds C_(s-1): with S >= 4 digits its carry-out e_s is
//      -1, 0 or 1, and its map from a carry-in c in {-1, 0, 1} to its
//      carry-out, f_s(c) = e_s + [c = 1, all digits 0xFFFF] - [c = -1, all
//      digits 0], stays in {-1, 0, 1};
//   3. a scan composes the maps (2 bits per value), giving every
//      segment's carry-in and the carry out of the top, so no carry
//      ripples across segments (the imaginary part of View #30's centre,
//      just below 1, starts with 1,661 fractional digits of 0xFFFF);
//   4. each segment applies its carry-in; if the total (digits plus
//      (C_last + top carry) * 2^(16L)) is negative, the digits are negated
//      in two's complement from the lowest nonzero digit.
// The JAX tail's overflow-count plane (ntt_pallas.py:1418-1527) is what
// this replaces; its exactness is kept, its layout is not.
//
// K5-NR, the same steps over K = 4 components, is the tail of one
// Newton-Raphson step (fixedpoint.py:797-827; on the TPU fused_tail(nr=
// True), ntt_pallas.py:1326 with the cfg of :1338-1344, B8c, and
// fused_tail_paired(nr=True), :1564-1590, B6).  From K4-NR's signed
// coefficients (x^2 - y^2, sx*sy*xy, u, v):
//   x'  : acc = coef[0] + scx*cx<<F + h
//   y'  : acc = 2*coef[1] + scy*cy<<F + h
//   dx' : acc = 2*coef[2] + 2^(16*2F) + h     (the +1 of dz/dc = 2z*dz/dc + 1
//                                             sits at digit 2F of the stream)
//   dy' : acc = 2*coef[3] + h
// and it writes the four signs to a device row, with no shadow row.  Its
// digits are F..F+D-1 of each magnitude as for z, so |dz/dc| wraps modulo
// 2^32, as in the reference.  Bound: a coefficient of u or v is a sum of
// at most 2D products of two digits, so |2u|, |2v| <= 4D(2^16 - 1)^2 =
// 2^50 - 2^35 + 2^18 at D = 2^16; the addends (c, the +1, the round bit)
// add less than 2^17, so |acc| < 2^50 - 2^34 for D <= 2^16 (32,768 limbs,
// n = 2^17, K4-NR's cap).  The carry steps above are exact for any |acc|
// < 2^51: the ripple carry |C_s| <= 2^35 + 1 stays in int64; absorbed
// into a segment, it falls below 2^19 + 2, then 10, then into {-1, 0, 1}
// after the third digit, so S >= 4 holds; the maps and positions are
// int32 or 2-bit fields (positions below 2^17).  The plain twin's four
// split-and-shift rounds (fixedpoint._carry_resolve) take any |acc| <
// 2^51 to [-1, 2^16]: bounds 2^35, 2^19 + 2^16, 2^16 + 8, then [-1, 2^16].
//
// Two forms of the same steps, chosen by size:
//   narrow (L < 16,384, below 4,096 limbs): one launch, one block of 1,024
//     threads per component, thread t owning S = max(4, L/1024) digits and
//     a Hillis-Steele scan over the block.  Each thread walks its own
//     segment, so every warp access touches 32 sectors; on the H100 this
//     form took 0.26 ms at 16,384 limbs (two SMs' load/store throughput).
//   wide (L >= 16,384): six launches over L/1,024 blocks of 256 threads
//     per component, S = 4 digits a thread, so a warp covers 128
//     consecutive digits and the whole card works: local ripple,
//     maps with a block scan, a one-block scan of the block aggregates,
//     apply, finish, shadow row.  The lowest and highest nonzero digits
//     meet in atomics.
//
// Bound on the H100: at 16,384 limbs it reads 2 x 512 KB of coefficients
// and writes 128 KB; the arithmetic is a few operations per digit, so the
// bound is the bytes (0.5 us); launch latency dominates the wide form.
// K5-NR moves twice that.
//
// K10 (fused_tail.cu) is the same carry machinery on residue rows: the
// reference's fused_tail, gridded or batched (B-f4, ntt_pallas.py:1265).
// The carry maps are in tail_common.cuh; the digit sums, the wide form's
// layout and its last two phases in orbit_tail.cuh, which K12
// (orbit_chunk.cu) shares.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "orbit_tail.cuh"
#include "tail_common.cuh"

namespace {

constexpr int kThreads = 1024;   // the narrow form's block

// grid K: one block of kThreads per component
template <int K>
__global__ void __launch_bounds__(kThreads)
tail_kernel(Tail tl, uint32_t *__restrict__ scratch, int D, int m) {
  __shared__ int64_t carry[kThreads];
  __shared__ uint32_t maps[2][kThreads];
  __shared__ int red[33];
  const int comp = blockIdx.x;
  const int L = 1 << m;
  const int F = D - 2;
  const int S = (L >> 10) > 4 ? (L >> 10) : 4;
  const int T = L / S;
  const int t = threadIdx.x;
  const bool active = t < T;
  const int base = t * S;
  uint32_t *dig = scratch + static_cast<size_t>(comp) * L;
  const int64_t mul = tail_mul<K>(tl, comp);

  // 1. ripple the segment's own sums
  int64_t cr = 0;
  if (active) {
    for (int k = 0; k < S; ++k) {
      const int j = base + k;
      const int64_t a = digit_sum<K>(tl, comp, mul, j, D, L) + cr;
      dig[j] = static_cast<uint32_t>(a & 0xFFFF);
      cr = a >> 16;
    }
  }
  carry[t] = cr;
  __syncthreads();

  // 2. absorb the carry of the segment below; the segment's carry map
  uint32_t f = enc(-1, 0, 1);   // identity for threads past the number
  if (active) {
    int64_t ci = t ? carry[t - 1] : 0;
    bool all_ffff = true;
    bool all_zero = true;
    for (int k = 0; k < S; ++k) {
      const int j = base + k;
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

  // 3. inclusive scan of the maps: maps[t] = f_t o ... o f_0
  maps[0][t] = f;
  __syncthreads();
  int src = 0;
  for (int off = 1; off < kThreads; off <<= 1) {
    uint32_t cur = maps[src][t];
    if (t >= off) cur = compose(cur, maps[src][t - off]);
    maps[src ^ 1][t] = cur;
    __syncthreads();
    src ^= 1;
  }
  const int cin = t ? apply(maps[src][t - 1], 0) : 0;
  const int64_t top = carry[T - 1] + apply(maps[src][T - 1], 0);

  // 4. apply the carry-in: +1 over a run of 0xFFFF, -1 over a run of 0
  if (active && cin) {
    for (int k = 0; k < S; ++k) {
      const int j = base + k;
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
    if (active) {
      for (int k = 0; k < S; ++k) {
        if (dig[base + k]) {
          lo = base + k;
          break;
        }
      }
    }
    lo = block_min(lo, red);
    if (active) {
      for (int k = 0; k < S; ++k) {
        const int j = base + k;
        const uint32_t d = dig[j];
        dig[j] = j < lo ? 0u : (j == lo ? 0x10000u - d : 0xFFFFu - d);
      }
    }
    __syncthreads();
  }

  // 5. digits F..F+D-1 out, then the shadow row of the new value (K5) or
  // the sign (K5-NR)
  uint32_t *out = tl.out[comp];
  int hi = -1;
  for (int i = t; i < D; i += kThreads) {
    const uint32_t d = dig[F + i];
    out[i] = d;
    if (d) hi = i;
  }
  if (K == 4) {
    if (t == 0) tl.row_out[comp] = neg ? -1 : 1;
    return;
  }
  hi = block_max(hi, red);
  if (t == 0) {
    int b = hi - 3;
    b = b < 0 ? 0 : (b > D - 4 ? D - 4 : b);
    for (int k = 0; k < 4; ++k)
      tl.row_out[5 * comp + k] = static_cast<int32_t>(dig[F + b + k]);
    tl.row_out[5 * comp + 4] = b;
    tl.row_out[10 + comp] = neg ? -1 : 1;
  }
}

constexpr int kWideMinLog2 = 14;      // L >= 2^14 takes the wide form

// W1: each segment's own ripple (grid (G, K))
template <int K>
__global__ void __launch_bounds__(kWideThreads)
wide_local(Tail tl, uint32_t *__restrict__ scratch, int D, int m) {
  const int comp = blockIdx.y;
  const int L = 1 << m;
  const Wide w = wide<K>(scratch, L);
  const int s = blockIdx.x * kWideThreads + threadIdx.x;
  const int64_t mul = tail_mul<K>(tl, comp);
  int64_t cr = 0;
  for (int q = 0; q < kWideSeg; ++q) {
    const int j = s * kWideSeg + q;
    const int64_t a = digit_sum<K>(tl, comp, mul, j, D, L) + cr;
    w.dig[comp * L + j] = static_cast<uint32_t>(a & 0xFFFF);
    cr = a >> 16;
  }
  w.carry[comp * (L / kWideSeg) + s] = cr;
}

// W2: absorb the carry of the segment below, the segment's map, the
// block's scan of maps (grid (G, K))
template <int K>
__global__ void __launch_bounds__(kWideThreads)
wide_maps(uint32_t *__restrict__ scratch, int m) {
  __shared__ uint32_t maps[2][kWideThreads];
  const int comp = blockIdx.y;
  const int L = 1 << m;
  const int ns = L / kWideSeg;
  const Wide w = wide<K>(scratch, L);
  const int t = threadIdx.x;
  const int s = blockIdx.x * kWideThreads + t;
  uint32_t *dig = w.dig + comp * L + s * kWideSeg;
  int64_t ci = s ? w.carry[comp * ns + s - 1] : 0;
  bool all_ffff = true;
  bool all_zero = true;
  for (int q = 0; q < kWideSeg; ++q) {
    uint32_t d = dig[q];
    if (ci) {
      const int64_t a = static_cast<int64_t>(d) + ci;
      d = static_cast<uint32_t>(a & 0xFFFF);
      ci = a >> 16;
      dig[q] = d;
    }
    all_ffff &= d == 0xFFFFu;
    all_zero &= d == 0u;
  }
  const uint32_t inc =
      scan_maps(segment_map(static_cast<int>(ci), all_ffff, all_zero), maps);
  w.prefix[comp * ns + s] =
      static_cast<uint8_t>(t ? maps[0][t - 1] : enc(-1, 0, 1));
  if (t == kWideThreads - 1)
    w.agg[comp * (ns / kWideThreads) + blockIdx.x] = inc;
}

// W3: scan of the block aggregates, the block carry-ins, the sign
// (grid K, 1,024 threads >= G)
template <int K>
__global__ void __launch_bounds__(kThreads)
wide_blocks(uint32_t *__restrict__ scratch, int m) {
  __shared__ uint32_t maps[2][kThreads];
  const int comp = blockIdx.x;
  const int L = 1 << m;
  const int ns = L / kWideSeg;
  const int g = ns / kWideThreads;
  const Wide w = wide<K>(scratch, L);
  const int t = threadIdx.x;
  scan_maps(t < g ? w.agg[comp * g + t] : enc(-1, 0, 1), maps);
  const uint32_t *inc = maps[0];
  if (t < g) w.bcin[comp * g + t] = t ? apply(inc[t - 1], 0) : 0;
  if (t == 0) {
    const int64_t top = w.carry[comp * ns + ns - 1] + apply(inc[g - 1], 0);
    w.flag[comp] = top < 0;
    w.flag[K + comp] = INT_MAX;
    w.flag[2 * K + comp] = -1;
  }
}

// W4: apply each segment's carry-in; the lowest nonzero digit (grid (G, K))
template <int K>
__global__ void __launch_bounds__(kWideThreads)
wide_apply(uint32_t *__restrict__ scratch, int m) {
  __shared__ int red[33];
  const int comp = blockIdx.y;
  const int L = 1 << m;
  const int ns = L / kWideSeg;
  const int g = ns / kWideThreads;
  const Wide w = wide<K>(scratch, L);
  const int s = blockIdx.x * kWideThreads + threadIdx.x;
  uint32_t *dig = w.dig + comp * L + s * kWideSeg;
  const int cin =
      apply(w.prefix[comp * ns + s], w.bcin[comp * g + blockIdx.x]);
  int run = cin;   // +1 runs over 0xFFFF digits, -1 over 0 digits
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
  if (threadIdx.x == 0 && lo != INT_MAX) atomicMin(&w.flag[K + comp], lo);
}

// W5 and W6 (orbit_tail.cuh, which K12 shares): one block per item, one
// thread per component
template <int K>
__global__ void __launch_bounds__(kWideThreads)
wide_finish(Tail tl, uint32_t *__restrict__ scratch, int D, int m) {
  __shared__ int red[33];
  wide_finish_item<K>(tl, scratch, D, m, blockIdx.x, blockIdx.y, red);
}

template <int K>
__global__ void wide_row(Tail tl, uint32_t *__restrict__ scratch, int D,
                         int m) {
  if (threadIdx.x < K) wide_row_item<K>(tl, scratch, D, m, threadIdx.x);
}

// one instance's launches: the narrow form below L = 2^14, else the wide
template <int K>
int tail(const Tail &tl, void *scratch, int D, int log2n, cudaStream_t st) {
  auto sc = static_cast<uint32_t *>(scratch);
  if (log2n < kWideMinLog2) {
    tail_kernel<K><<<K, kThreads, 0, st>>>(tl, sc, D, log2n);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((1 << log2n) / (kWideThreads * kWideSeg), K);
  int rc;
  wide_local<K><<<grid, kWideThreads, 0, st>>>(tl, sc, D, log2n);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  wide_maps<K><<<grid, kWideThreads, 0, st>>>(sc, log2n);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  wide_blocks<K><<<K, kThreads, 0, st>>>(sc, log2n);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  wide_apply<K><<<grid, kWideThreads, 0, st>>>(sc, log2n);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  wide_finish<K><<<grid, kWideThreads, 0, st>>>(tl, sc, D, log2n);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  wide_row<K><<<1, 32, 0, st>>>(tl, sc, D, log2n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fs_ntt_orbit(const void *x, const void *y, void *coef,
                            void *work, const void *tables, int D, int log2n,
                            void *stream);

// coef: int64 [2][n]; row_in/row_out: int32 [12]; cx, cy, nx, ny: uint32
// [D]; scratch: uint32 [4n].  n = 2^log2n >= 2D, 16 <= D.
extern "C" int fs_orbit_tail(const void *coef, const void *row_in,
                             void *row_out, const void *cx, const void *cy,
                             int scx, int scy, void *nx, void *ny,
                             void *scratch, int D, int log2n, void *stream) {
  if (D < 16 || log2n > 20 || (1 << log2n) < 2 * D)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tail tl = {static_cast<const int64_t *>(coef),
                   static_cast<const int32_t *>(row_in),
                   static_cast<int32_t *>(row_out),
                   static_cast<const uint32_t *>(cx),
                   static_cast<const uint32_t *>(cy),
                   scx,
                   scy,
                   {static_cast<uint32_t *>(nx), static_cast<uint32_t *>(ny),
                    nullptr, nullptr}};
  return tail<2>(tl, scratch, D, log2n, static_cast<cudaStream_t>(stream));
}

// K5-NR.  coef: int64 [4][n]; signs: int32 [4] out (sx, sy, sdx, sdy);
// cx, cy, nx, ny, ndx, ndy: uint32 [D]; scratch: uint32 [7n].
// n = 2^log2n >= 2D, 16 <= D <= 2^16.
extern "C" int fs_nr_tail(const void *coef, void *signs, const void *cx,
                          const void *cy, int scx, int scy, void *nx,
                          void *ny, void *ndx, void *ndy, void *scratch,
                          int D, int log2n, void *stream) {
  if (D < 16 || D > (1 << 16) || log2n > 17 || (1 << log2n) < 2 * D)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tail tl = {static_cast<const int64_t *>(coef),
                   nullptr,
                   static_cast<int32_t *>(signs),
                   static_cast<const uint32_t *>(cx),
                   static_cast<const uint32_t *>(cy),
                   scx,
                   scy,
                   {static_cast<uint32_t *>(nx), static_cast<uint32_t *>(ny),
                    static_cast<uint32_t *>(ndx),
                    static_cast<uint32_t *>(ndy)}};
  return tail<4>(tl, scratch, D, log2n, static_cast<cudaStream_t>(stream));
}

extern "C" int fs_ntt_orbit(const void *x, const void *y, void *coef,
                            void *work, const void *tables, int D, int log2n,
                            void *stream);
extern "C" int fs_ntt_nr(const void *x, const void *y, const void *dx,
                         const void *dy, const void *signs, void *coef,
                         void *work, const void *tables, int D, int log2n,
                         void *stream);

namespace {

// one reuse row: the top R digits of x, then of y, then the signs sx, sy
// (row[10], row[11] of the same state's shadow row)
__global__ void reuse_row(const uint32_t *x, const uint32_t *y,
                          const int32_t *row, int32_t *out, int D, int R) {
  for (int i = threadIdx.x; i < 2 * R + 2; i += blockDim.x)
    out[i] = i < R       ? static_cast<int32_t>(x[D - R + i])
             : i < 2 * R ? static_cast<int32_t>(y[D - 2 * R + i])
                         : row[10 + i - 2 * R];
}

}  // namespace

// The reuse row of a state (x, y uint32 [D], its shadow row int32 [12])
// into out (int32 [2R + 2]), the reference's x[D - R:], y[D - R:], sx, sy
// (fractalshark_tpu/ops/bignum/orbit.py:220-222): the epilogue of the
// chunk loops that step one launch at a time (here and iterate_full.cu).
// 1 <= R <= D.
extern "C" int fs_reuse_row(const void *x, const void *y, const void *row,
                            void *out, int D, int R, void *stream) {
  if (R < 1 || R > D) return static_cast<int>(cudaErrorInvalidValue);
  reuse_row<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t *>(x), static_cast<const uint32_t *>(y),
      static_cast<const int32_t *>(row), static_cast<int32_t *>(out), D, R);
  return static_cast<int>(cudaGetLastError());
}

// `steps` orbit steps in place on x, y (uint32 [D]): K4 then K5 per step.
// rows: int32 [steps + 1][12], row 0 holding the state's row on entry;
// step k reads its signs from row k and writes row k + 1.  coef (int64
// [2n]) and work (uint32 [4n]) are scratch; K5's scratch reuses work,
// which K4 has finished with by then (same stream).  reuse: null, or int32
// [steps + 1][2R + 2] whose row k + 1 the loop writes after step k (row 0,
// the state's, on entry).
extern "C" int fs_orbit_chunk(void *x, void *y, void *rows, const void *cx,
                              const void *cy, int scx, int scy, void *coef,
                              void *work, const void *tables, int D,
                              int log2n, int steps, void *reuse, int R,
                              void *stream) {
  auto r = static_cast<int32_t *>(rows);
  auto ru = static_cast<int32_t *>(reuse);
  for (int k = 0; k < steps; ++k) {
    int rc = fs_ntt_orbit(x, y, coef, work, tables, D, log2n, stream);
    if (rc) return rc;
    rc = fs_orbit_tail(coef, r + 12 * k, r + 12 * (k + 1), cx, cy, scx, scy,
                       x, y, work, D, log2n, stream);
    if (!rc && ru)
      rc = fs_reuse_row(x, y, r + 12 * (k + 1), ru + (2 * R + 2) * (k + 1),
                        D, R, stream);
    if (rc) return rc;
  }
  return 0;
}

// `steps` NR steps in place on x, y, dx, dy (uint32 [D]) and their signs
// (int32 [4], device): K4-NR then K5-NR per step.  K4-NR reads the signs,
// K5-NR then overwrites them (same stream), so the host never waits
// inside a chunk.  coef (int64 [4n]) and work (uint32 [8n]) are scratch;
// K5-NR's scratch reuses work.
extern "C" int fs_nr_chunk(void *x, void *y, void *dx, void *dy,
                           void *signs, const void *cx, const void *cy,
                           int scx, int scy, void *coef, void *work,
                           const void *tables, int D, int log2n, int steps,
                           void *stream) {
  for (int k = 0; k < steps; ++k) {
    int rc = fs_ntt_nr(x, y, dx, dy, signs, coef, work, tables, D, log2n,
                       stream);
    if (rc) return rc;
    rc = fs_nr_tail(coef, signs, cx, cy, scx, scy, x, y, dx, dy, work, D,
                    log2n, stream);
    if (rc) return rc;
  }
  return 0;
}
