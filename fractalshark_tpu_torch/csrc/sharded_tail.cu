// K20: one rank's block of the CRT + carry tail when the digits of one
// bignum are sharded over a mesh of M ranks (parallel/orbit_sharded.py).
//
// Replaces: fractalshark_tpu/parallel/orbit_sharded.py:81-167 (_pcarry,
// _psigned_finish, _pparts_acc, _pstreams) and :251-262, plain jnp there,
// given a kernel here as the XLA loops K13-K19 were.  The JAX form runs
// four carry passes, each a Kogge-Stone scan with its own all_gather: in
// torch that is over a hundred launches a step at 32,768 digits a rank.
//
// Function: rank r holds the digits [B, B + Lloc) of the L = nfft digits
// (B = r * Lloc) and the residue rows of the coefficients there, with a
// halo of H = 8 coefficients and addend/round words below B (zeros on rank
// 0).  The digit sums are fused_tail.cuh's single signed stream, whose
// per-digit sums satisfy |a_j| < 2^19; their total is cut to L digits, the
// sign is -1 iff the total is negative and the magnitude modulo 2^(16L)
// is not zero, the magnitude the two's complement of the digits then:
// exactly _psigned_finish's digits and signs.
//
// Carries.  As in K10, each thread ripples a segment of 4 digits and
// absorbs the raw carry of the segment below (|carry| < 2^4; the segment
// below the rank's first is rippled from the halo), after which the carry
// into a segment is in {-1, 0, 1}.  A segment is then described by
//   f: its carry map {-1, 0, 1} -> {-1, 0, 1} (tail_common.cuh), and
//   z: for each carry-in, whether its 4 final digits are all zero,
// and (f, z) compose: (f2, z2) after (f1, z1) = (f2 o f1,
// x -> z1(x) && z2(f1(x))).  So the carry into any digit, and whether
// every digit below it is zero (which decides the two's-complement
// negation), both come from the composition of the pairs below it, with a
// carry of 0 into digit 0 of rank 0.
//
//   launch A (fs_sharded_tail_a), grid (tiles of 1,024 digits, K): the
//     CRT of the tile's coefficients into shared memory once, the segments'
//     ripple and absorption, the digits so far, each segment's (f, z)
//     word, and each tile's composed word; the rank's top segment also
//     stores its raw carry-out (the sign of the total comes from rank M-1's);
//   one all_gather of the M ranks' [K][tiles + 1] words (host side);
//   launch B (fs_sharded_tail_b), same grid: each tile composes the
//     gathered words of every tile below it (warp 0, 32 a step) and of all
//     tiles (the sign), scans its segments' words, and applies each
//     segment's carry-in and, where the total is negative, the negation.
// No collective runs inside a launch: a rank's blocks are held against
// the plain twins block by block on one card (chip_smoke.py).
//
// What bounds it: the bytes (residue rows, planes, digits twice), as K10;
// at 32,768 digits a rank a launch reads and writes under 1 MB.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_tail.cuh"

namespace {

constexpr int kShardThreads = 256;
constexpr int kShardTile = kSeg * kShardThreads;   // digits a block
constexpr int kShardHalo = 8;                      // words below the block

struct ShardTail {
  const uint32_t *inv;   // [K][2][W] residue rows, W = H + Lloc
  const uint32_t *cadd;  // [K][W] addend planes
  const uint32_t *rnd;   // [W] round plane
  const int32_t *zsign;  // null, or component 1's gswap = zsign[0]*zsign[1]
  uint32_t *dig;         // [K][Lloc] digits
  uint32_t *fz;          // [K][Lloc / 4] segment words
  int32_t *agg;          // [K][T + 1] tile words, then the raw top carry
  int cfg[4 * kMaxTail];
  int K, lloc, tiles;
};

// the identity (f, z): no change to the carry, every digit zero
constexpr uint32_t kFzIdentity = 0x24u | (7u << 6);   // enc(-1, 0, 1)

// (f, z) of u after l
__device__ __forceinline__ uint32_t fz_compose(uint32_t u, uint32_t l) {
  const uint32_t fl = l & 63u;
  uint32_t z = 0;
#pragma unroll
  for (int x = -1; x <= 1; ++x)
    if (((l >> (7 + x)) & 1u) && ((u >> (7 + apply(fl, x))) & 1u))
      z |= 1u << (x + 1);
  return compose(u & 63u, fl) | (z << 6);
}

__device__ __forceinline__ bool fz_zero(uint32_t w, int x) {
  return (w >> (7 + x)) & 1u;
}

// inclusive scan of (f, z) words over the block, lower threads first;
// excl: this thread's exclusive prefix; returns the block's composition
__device__ uint32_t block_scan(uint32_t w, uint32_t *excl, uint32_t *warps) {
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  uint32_t incl = w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t lower = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl = fz_compose(incl, lower);
  }
  if (lane == 31) warps[wi] = incl;
  __syncthreads();
  uint32_t below = kFzIdentity;
  for (int i = 0; i < wi; ++i) below = fz_compose(warps[i], below);
  uint32_t all = kFzIdentity;
  for (int i = 0; i < kShardThreads / 32; ++i) all = fz_compose(warps[i], all);
  uint32_t e = __shfl_up_sync(~0u, incl, 1);
  *excl = lane == 0 ? below : fz_compose(e, below);
  __syncthreads();
  return all;
}

// the composition of words[0, count) (lower first), on warp 0
__device__ uint32_t warp_fold(const int32_t *words, int stride, int count) {
  const int lane = threadIdx.x & 31;
  uint32_t acc = kFzIdentity;
  for (int base = 0; base < count; base += 32) {
    uint32_t v = base + lane < count
                     ? static_cast<uint32_t>(words[(base + lane) * stride])
                     : kFzIdentity;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t lower = __shfl_up_sync(~0u, v, o);
      if (lane >= o) v = fz_compose(v, lower);
    }
    acc = fz_compose(__shfl_sync(~0u, v, 31), acc);
  }
  return acc;
}

__global__ void __launch_bounds__(kShardThreads) shard_tail_a(ShardTail t) {
  __shared__ int64_t coef[kHalo + kShardTile];
  __shared__ int32_t carry[kShardThreads + 1];
  __shared__ uint32_t warps[kShardThreads / 32];
  const int c = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int W = kShardHalo + t.lloc;
  int gsw = t.cfg[4 * c + 1];
  if (c == 1 && t.zsign) gsw = t.zsign[0] * t.zsign[1];
  const Comp k = {t.cfg[4 * c] > 0, gsw < 0, t.cfg[4 * c + 2] > 0};
  // local index j of the block: word kShardHalo + j of a row
  const uint32_t *r1 = t.inv + static_cast<size_t>(c) * 2 * W + kShardHalo;
  const uint32_t *r2 = r1 + W;
  const uint32_t *ca = t.cadd + static_cast<size_t>(c) * W + kShardHalo;
  const uint32_t *rn = t.rnd + kShardHalo;
  const int j0 = b * kShardTile;
  const int base = j0 + kSeg * tid;
  const bool active = base < t.lloc;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  const uint4 cv = active ? load4(ca + base) : zero4;
  const uint4 rv = active ? load4(rn + base) : zero4;
  // the segment below the tile: in the halo for tile 0
  const uint4 cvb = tid == 0 ? load4(ca + j0 - kSeg) : zero4;
  const uint4 rvb = tid == 0 ? load4(rn + j0 - kSeg) : zero4;

  // coefficients j0 - kHalo .. j0 + kShardTile - 1 (none at Lloc or above
  // reaches a digit of this rank)
  for (int i = tid; i < kHalo + kShardTile; i += kShardThreads) {
    const int j = j0 - kHalo + i;
    int64_t s = 0;
    if (j < t.lloc) {
      s = crt_signed(crt_rec(r1[j], r2[j], kCrtConst));
      if (k.dbl) s *= 2;
      if (k.swap) s = -s;
    }
    coef[i] = s;
  }
  __syncthreads();

  uint32_t d[kSeg] = {0, 0, 0, 0};
  int32_t cr = 0;
  if (active) cr = ripple(coef + kHalo + kSeg * tid, k, cv, rv, d);
  carry[tid + 1] = cr;
  if (tid == 0) {
    uint32_t dl[kSeg];
    carry[0] = ripple(coef + kHalo - kSeg, k, cvb, rvb, dl);
  }
  __syncthreads();

  uint32_t w = kFzIdentity;
  if (active) {
    int32_t ci = carry[tid];
#pragma unroll
    for (int q = 0; q < kSeg; ++q) {
      if (ci) {
        const int32_t a = static_cast<int32_t>(d[q]) + ci;
        d[q] = static_cast<uint32_t>(a & 0xFFFF);
        ci = a >> 16;
      }
    }
    const bool ffff = d[0] == 0xFFFFu && d[1] == 0xFFFFu && d[2] == 0xFFFFu &&
                      d[3] == 0xFFFFu;
    const bool hi0 = d[1] == 0u && d[2] == 0u && d[3] == 0u;
    const uint32_t z = (d[0] == 1u && hi0 ? 1u : 0u) |
                       (d[0] == 0u && hi0 ? 2u : 0u) | (ffff ? 4u : 0u);
    w = enc(ci - (d[0] == 0u && hi0 ? 1 : 0), ci, ci + (ffff ? 1 : 0)) |
        (z << 6);
    *reinterpret_cast<uint4 *>(t.dig + static_cast<size_t>(c) * t.lloc +
                               base) = make_uint4(d[0], d[1], d[2], d[3]);
    t.fz[static_cast<size_t>(c) * (t.lloc / kSeg) + base / kSeg] = w;
    if (base + kSeg == t.lloc)
      t.agg[c * (t.tiles + 1) + t.tiles] = carry[tid + 1];
  }
  uint32_t excl;
  const uint32_t all = block_scan(w, &excl, warps);
  if (tid == 0) t.agg[c * (t.tiles + 1) + b] = static_cast<int32_t>(all);
}

struct ShardFinish {
  uint32_t *dig;          // [K][Lloc] digits in, final digits out
  const uint32_t *fz;     // [K][Lloc / 4] segment words
  const int32_t *words;   // [M][K][T + 1] every rank's launch-A words
  int32_t *sgn;           // [K] signs out
  int K, lloc, tiles, ranks, rank;
};

__global__ void __launch_bounds__(kShardThreads)
    shard_tail_b(ShardFinish t) {
  __shared__ uint32_t warps[kShardThreads / 32];
  __shared__ uint32_t below_s;
  __shared__ int neg_s;
  const int c = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int base = b * kShardTile + kSeg * tid;
  const bool active = base < t.lloc;
  const size_t segs = t.lloc / kSeg;
  uint4 v = make_uint4(0, 0, 0, 0);
  uint32_t w = kFzIdentity;
  if (active) {
    v = load4(t.dig + static_cast<size_t>(c) * t.lloc + base);
    w = t.fz[c * segs + base / kSeg];
  }
  if (tid < 32) {
    // tile g = rank * T + b of the whole number; word (g', c) sits at
    // (g' / T) * K * (T + 1) + c * (T + 1) + g' % T
    const int T = t.tiles;
    const int rowlen = t.K * (T + 1);
    uint32_t below = kFzIdentity;
    uint32_t total = kFzIdentity;
    for (int r = 0; r < t.ranks; ++r) {
      const uint32_t own = warp_fold(t.words + r * rowlen + c * (T + 1), 1,
                                     T);
      if (r < t.rank) below = fz_compose(own, below);
      if (r == t.rank)
        below = fz_compose(
            warp_fold(t.words + r * rowlen + c * (T + 1), 1, b), below);
      total = fz_compose(own, total);
    }
    if (tid == 0) {
      const int top = t.words[(t.ranks - 1) * rowlen + c * (T + 1) + T];
      const bool neg = top + apply(total & 63u, 0) < 0;
      below_s = below;
      neg_s = neg;
      if (b == 0) t.sgn[c] = neg && !fz_zero(total, 0) ? -1 : 1;
    }
  }
  __syncthreads();
  uint32_t excl;
  block_scan(w, &excl, warps);
  if (!active) return;
  const uint32_t pre = fz_compose(excl, below_s);
  int run = apply(pre & 63u, 0);
  bool zb = fz_zero(pre, 0);
  const bool neg = neg_s;
  uint32_t d[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < kSeg; ++q) {
    if (run > 0) {
      d[q] = (d[q] + 1u) & 0xFFFFu;
      if (d[q] != 0u) run = 0;
    } else if (run < 0) {
      d[q] = (d[q] - 1u) & 0xFFFFu;
      if (d[q] != 0xFFFFu) run = 0;
    }
    if (neg) {
      if (!zb) {
        d[q] = 0xFFFFu - d[q];
      } else if (d[q]) {
        d[q] = 0x10000u - d[q];
        zb = false;
      }
    }
  }
  *reinterpret_cast<uint4 *>(t.dig + static_cast<size_t>(c) * t.lloc + base) =
      make_uint4(d[0], d[1], d[2], d[3]);
}

int check_block(int K, int lloc) {
  return K < 1 || K > kMaxTail || lloc < kSeg || (lloc % kSeg) ||
                 lloc > (1 << 17)
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

}  // namespace

// K20 launch A.  inv: uint32 [K][2][8 + Lloc] residue rows (the halo of 8
// coefficients first); cadd: uint32 [K][8 + Lloc]; rnd: uint32 [8 + Lloc];
// cfg: int32 host [4K] (double, gswap, csign, 0); zsign: int32 [2] on the
// card or null; dig: uint32 [K][Lloc] out; fz: uint32 [K][Lloc / 4] out;
// agg: int32 [K][T + 1] out, T = ceil(Lloc / 1,024).  Lloc a multiple of 4
// up to 2^17; cadd, rnd and dig 16-byte aligned.
extern "C" int fs_sharded_tail_a(const void *inv, const void *cadd,
                                 const void *rnd, const void *cfg,
                                 const void *zsign, void *dig, void *fz,
                                 void *agg, int K, int lloc, void *stream) {
  int rc = check_block(K, lloc);
  if (rc) return rc;
  if ((reinterpret_cast<uintptr_t>(cadd) | reinterpret_cast<uintptr_t>(rnd) |
       reinterpret_cast<uintptr_t>(dig)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  ShardTail t;
  t.inv = static_cast<const uint32_t *>(inv);
  t.cadd = static_cast<const uint32_t *>(cadd);
  t.rnd = static_cast<const uint32_t *>(rnd);
  t.zsign = static_cast<const int32_t *>(zsign);
  t.dig = static_cast<uint32_t *>(dig);
  t.fz = static_cast<uint32_t *>(fz);
  t.agg = static_cast<int32_t *>(agg);
  const auto *cf = static_cast<const int32_t *>(cfg);
  for (int i = 0; i < 4 * kMaxTail; ++i) t.cfg[i] = i < 4 * K ? cf[i] : 0;
  t.K = K;
  t.lloc = lloc;
  t.tiles = (lloc + kShardTile - 1) / kShardTile;
  const dim3 grid(t.tiles, K);
  shard_tail_a<<<grid, kShardThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t);
  return static_cast<int>(cudaGetLastError());
}

// K20 launch B.  dig: uint32 [K][Lloc] (launch A's, finished in place);
// fz: launch A's; words: int32 [M][K][T + 1], every rank's agg in rank
// order; sgn: int32 [K] out.  rank in [0, M).
extern "C" int fs_sharded_tail_b(void *dig, const void *fz, const void *words,
                                 void *sgn, int K, int lloc, int ranks,
                                 int rank, void *stream) {
  int rc = check_block(K, lloc);
  if (rc) return rc;
  if (ranks < 1 || rank < 0 || rank >= ranks ||
      (reinterpret_cast<uintptr_t>(dig) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  ShardFinish t;
  t.dig = static_cast<uint32_t *>(dig);
  t.fz = static_cast<const uint32_t *>(fz);
  t.words = static_cast<const int32_t *>(words);
  t.sgn = static_cast<int32_t *>(sgn);
  t.K = K;
  t.lloc = lloc;
  t.tiles = (lloc + kShardTile - 1) / kShardTile;
  t.ranks = ranks;
  t.rank = rank;
  const dim3 grid(t.tiles, K);
  shard_tail_b<<<grid, kShardThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t);
  return static_cast<int>(cudaGetLastError());
}
