// K20: one rank's block of the CRT + carry tail when the digits of one
// bignum are sharded over a mesh of M ranks (parallel/orbit_sharded.py).
//
// Replaces: fractalshark_tpu/parallel/orbit_sharded.py:81-167 (_pcarry,
// _psigned_finish, _pparts_acc, _pstreams) and :246-262 (the reshard's
// all_to_all and reshape, then the tail), plain jnp there, given a kernel
// here as the XLA loops K13-K19 were.  The JAX form runs four carry
// passes, each a Kogge-Stone scan with its own all_gather: in torch that
// is over a hundred launches a step at 32,768 digits a rank.
//
// Function: rank r holds the digits [B, B + Lloc) of the L = nfft = n1*n2
// digits (B = r * Lloc, Lloc = h * n2, h = n1 / M) and, in the receive
// buffer of the reshard's all_to_all, the residue rows of the coefficients
// there: slot s (sent by rank s) holds the R = 2K rows [R][h][w] of rank
// r's h rows in rank s's w = n2 / M columns, then R x 8 halo words, so
// coefficient j of the block (row j / n2, column j % n2) is word
//   s * slot + q * h*w + (j / n2) * w + (j % n2) % w,   s = (j % n2) / w,
// of row q (component q / 2, prime q % 2), slot = R * (h*w + 8).  The 8
// coefficients below B are in the halo words of the ranks whose columns
// hold them, halo[i] giving the slot of coefficient B - 8 + i (rank 0: all
// zero); the addend and round planes carry 8 words below B too.  The
// digit sums are fused_tail.cuh's single signed stream, whose per-digit
// sums satisfy |a_j| < 2^19; their total is cut to L digits, the sign is
// -1 iff the total is negative and the magnitude modulo 2^(16L) is not
// zero, the magnitude the two's complement of the digits then: exactly
// _psigned_finish's digits and signs.
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
// negation), both come from the composition of the words below it, with
// a carry of 0 into digit 0 of rank 0.
//
//   launch A (kTile = 512 digits a block of 128 threads, grid (tiles, K),
//     128 blocks at 32,768 digits a rank, about one an SM): the CRT of the
//     tile's coefficients into shared memory once, read from the receive
//     buffer by their (slot, row, column) address; the segments' ripple
//     and absorption; the digits so far; the segments' (f, z) words
//     scanned over the block; then the carry words across the rank's
//     tiles: each tile publishes its block's word and composes the words
//     of all the tiles below it, read at once (K10's decoupled look-back,
//     fused_tail.cuh, publishes carries and stops at the nearest; here the
//     rank's carry-in is not known yet, and 64 tiles a rank at 16,384
//     limbs and M = 2, at most 256, are two to eight rounds of a warp's
//     loads, with no chain of tiles waiting on tiles).  A tile is its
//     block's index, as in CUB's single-pass scan: blocks start in index
//     order, and a launch's blocks (at most 1,024 of 128 threads and 6 KB
//     of shared memory) all fit on the card at once, so a tile waits only
//     on tiles already running.  A ticket a block gives the launch's
//     number, which the published words carry, so the state is never
//     reset.  It stores each segment's exclusive prefix word within the
//     rank, and the rank's top tile the rank's word and the raw carry-out
//     of its top segment: K x 2 int32, all the all_gather carries;
//   one all_gather of the M ranks' [K][2] words (host side);
//   launch B (same grid): elementwise.  Each thread composes the words of
//     the ranks below its own (and of all ranks, for the sign), then its
//     segment's stored prefix, applies the carry-in and, where the total
//     is negative, the negation, in place; a segment that neither carry
//     nor negation changes is not read or written.
// No collective runs inside a launch: a rank's blocks are held against
// the plain twins block by block on one card (chip_smoke.py).
//
// What bounds it: the bytes the pair must move, 1.18 MB at 32,768 digits
// a rank (the receive buffer's rows and the planes in, the digits and
// signs out), 0.35 us at the card's 3.35 TB/s; a launch takes some
// microseconds, so the launches' latency bounds a step, and launch A's
// chain of dependent trips to memory (the coefficients' loads issued
// together, the look-back) is its floor.  The first form launched 32
// x 2 blocks of 256 threads and had launch B fold the M x T tile words and
// scan the block again; this form keeps launch B to one pass and moves
// the reshard's gather (a permute, a scatter and two cats in torch) into
// launch A's addressing.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_tail.cuh"

namespace {

constexpr int kShardThreads = 128;
constexpr int kShardTile = kSeg * kShardThreads;   // digits a block
constexpr int kShardHalo = 8;                      // words below the block
constexpr int kShardMaxLloc = 1 << 17;
constexpr int kShardMaxTiles = kShardMaxLloc / kShardTile;
constexpr uint32_t kWordBits = 0x1FFu;             // (f, z): 9 bits

// The look-back state of a block size, zero when made, never reset: a
// launch takes `tiles` tickets a component, one a block, so its tickets
// are [n * tiles, (n + 1) * tiles) for the n-th launch on the state, and a
// tile's published word carries that number n (its epoch), so that a word
// left by an earlier launch is never read as this one's.  Word: (f, z) in
// bits 0-8, kAgg, the epoch's low 21 bits in bits 11-31.
struct LookBack {
  unsigned long long ticket[kMaxTail];
  uint32_t word[kMaxTail][kShardMaxTiles];
};
constexpr uint32_t kAgg = 1u << 9;    // published: the tile's own word
constexpr int kEpochShift = 11;

// Both launches' arguments, one host struct (orbit_sharded.py mirrors it
// with ctypes and fills it once a workspace).
struct ShardArgs {
  const void *recv;       // uint32 [M][slot] the all_to_all's receive buffer
  const void *cadd;       // uint32 [K][8 + Lloc] addend planes
  const void *rnd;        // uint32 [8 + Lloc] round plane
  const void *zsign;      // null, or int32 [2]: component 1's gswap
  const void *halo;       // int32 [8] the halo's slots; null on rank 0
  void *dig;              // uint32 [K][Lloc] digits (B: in place)
  void *pre;              // uint32 [K][Lloc / 4] segment prefix words
  void *words;            // int32 [K][2] A's rank words
  void *state;            // LookBack, zero when made
  const void *gathered;   // int32 [M][K][2] every rank's words, for B
  void *sgn;              // int32 [K] signs out of B
  int32_t cfg[4 * kMaxTail];   // per component: double, gswap, csign, 0
  int32_t K, lloc, log2_n2, log2_w, ranks, rank;
};

struct ShardA {
  const uint32_t *recv, *cadd, *rnd;
  const int32_t *zsign, *halo;
  uint32_t *dig, *pre;
  int32_t *words;
  LookBack *st;
  int cfg[4 * kMaxTail];
  int K, lloc, tiles, lg_n2, lg_w, hw, slot;
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

// row q's residue of coefficient j of the block (j >= -8), from the
// receive buffer
__device__ __forceinline__ uint32_t residue(const ShardA &t, int q, int j) {
  if (j < 0)
    return t.recv[static_cast<size_t>(t.halo[j + kShardHalo]) * t.slot +
                  2 * t.K * t.hw + q * kShardHalo + j + kShardHalo];
  const int col = j & ((1 << t.lg_n2) - 1);
  return t.recv[static_cast<size_t>(col >> t.lg_w) * t.slot + q * t.hw +
                ((j >> t.lg_n2) << t.lg_w) + (col & ((1 << t.lg_w) - 1))];
}

__global__ void __launch_bounds__(kShardThreads) shard_tail_a(ShardA t) {
  __shared__ int64_t coef[kHalo + kShardTile];
  __shared__ int32_t carry[kShardThreads + 1];
  __shared__ uint32_t warps[kShardThreads / 32];
  __shared__ uint32_t below_s;
  const int c = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the ticket's trip to memory overlaps the loads; only the look-back
  // (warp 0) reads it
  unsigned long long ticket = 0;
  if (tid == 0) ticket = atomicAdd(&t.st->ticket[c], 1ull);
  const int W = kShardHalo + t.lloc;
  int gsw = t.cfg[4 * c + 1];
  if (c == 1 && t.zsign) gsw = t.zsign[0] * t.zsign[1];
  const Comp k = {t.cfg[4 * c] > 0, gsw < 0, t.cfg[4 * c + 2] > 0};
  // local index j of the block: word kShardHalo + j of a plane
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
  // reaches a digit of this rank; below 0 only rank 0's, which are zero):
  // every thread's loads issued before any is used
  {
    constexpr int kPer = (kHalo + kShardTile + kShardThreads - 1) /
                         kShardThreads;
    uint32_t r1[kPer], r2[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + q * kShardThreads;
      const int j = j0 - kHalo + i;
      const bool in = i < kHalo + kShardTile && j < t.lloc &&
                      (j >= 0 || t.halo);
      r1[q] = in ? residue(t, 2 * c, j) : 0u;
      r2[q] = in ? residue(t, 2 * c + 1, j) : 0u;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + q * kShardThreads;
      if (i >= kHalo + kShardTile) break;
      // a zero pair is the coefficient 0
      int64_t s = crt_signed(crt_rec(r1[q], r2[q], kCrtConst));
      if (k.dbl) s *= 2;
      if (k.swap) s = -s;
      coef[i] = s;
    }
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
    if (base + kSeg == t.lloc) t.words[2 * c + 1] = carry[tid + 1];
  }
  uint32_t excl;
  const uint32_t agg = block_scan(w, &excl, warps);

  // the composition of the rank's tiles below this one, on warp 0: each
  // tile publishes its aggregate word, tagged with this launch's epoch, by
  // a plain volatile store (a word is its own payload), and reads the
  // aggregates of all the tiles below it at once, lane i the tiles i, i +
  // 32, ..., every first load issued before any wait; then composes them
  // in order over the warp, 32 a step.  A tile waits only for the tiles
  // below it to reach this point, never for their look-back.
  if (tid < 32) {
    volatile uint32_t *word = t.st->word[c];
    const uint32_t tag = (static_cast<uint32_t>(
        __shfl_sync(~0u, ticket, 0) / t.tiles) << kEpochShift) | kAgg;
    if (lane == 0) word[b] = tag | agg;
    uint32_t ex = kFzIdentity;
#pragma unroll 1
    for (int p = 0; p < b; p += 32) {
      // m_31 after ... after m_0 on lane 0 (lanes at b or past, identity)
      const int q = p + lane;
      uint32_t v = tag | kFzIdentity;
      if (q < b)
        do {
          v = word[q];
        } while ((v & ~kWordBits) != tag);
      uint32_t m = v & kWordBits;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t upper = __shfl_down_sync(~0u, m, o);
        if (lane + o < 32) m = fz_compose(upper, m);
      }
      ex = fz_compose(__shfl_sync(~0u, m, 0), ex);
    }
    if (lane == 0) {
      below_s = ex;
      if (b == t.tiles - 1)
        t.words[2 * c] = static_cast<int32_t>(fz_compose(agg, ex));
    }
  }
  __syncthreads();
  if (active)
    t.pre[static_cast<size_t>(c) * (t.lloc / kSeg) + base / kSeg] =
        fz_compose(excl, below_s);
}

struct ShardB {
  uint32_t *dig;            // [K][Lloc] launch A's digits, final out
  const uint32_t *pre;      // [K][Lloc / 4] launch A's prefix words
  const int32_t *words;     // [M][K][2] every rank's words
  int32_t *sgn;             // [K] signs out
  int K, lloc, ranks, rank;
};

__global__ void __launch_bounds__(kShardThreads)
    shard_tail_b(ShardB t) {
  const int c = blockIdx.y;
  const int seg = blockIdx.x * kShardThreads + threadIdx.x;
  const int base = kSeg * seg;
  uint32_t below = kFzIdentity;
  uint32_t total = kFzIdentity;
  for (int r = 0; r < t.ranks; ++r) {
    const uint32_t w = static_cast<uint32_t>(t.words[2 * (r * t.K + c)]);
    if (r < t.rank) below = fz_compose(w, below);
    total = fz_compose(w, total);
  }
  const int top = t.words[2 * ((t.ranks - 1) * t.K + c) + 1];
  const bool neg = top + apply(total & 63u, 0) < 0;
  if (seg == 0) t.sgn[c] = neg && !fz_zero(total, 0) ? -1 : 1;
  if (base >= t.lloc) return;
  const uint32_t pre = fz_compose(
      t.pre[static_cast<size_t>(c) * (t.lloc / kSeg) + seg], below);
  int run = apply(pre & 63u, 0);
  if (!run && !neg) return;   // the digits stand as launch A left them
  bool zb = fz_zero(pre, 0);
  uint32_t *p = t.dig + static_cast<size_t>(c) * t.lloc + base;
  const uint4 v = load4(p);
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
  *reinterpret_cast<uint4 *>(p) = make_uint4(d[0], d[1], d[2], d[3]);
}

bool pow2(int v) { return v > 0 && !(v & (v - 1)); }

// the block's shape: 1 to 4 components, Lloc a multiple of 4 up to 2^17,
// Lloc = h * n2 with w = n2 / M columns a slot, 1 <= rank < M
int check_block(const ShardArgs &a) {
  const bool bad = a.K < 1 || a.K > kMaxTail || a.lloc < kSeg ||
                   (a.lloc % kSeg) || a.lloc > kShardMaxLloc ||
                   a.log2_n2 < 0 || a.log2_w < 0 || a.log2_w > a.log2_n2 ||
                   a.log2_n2 > 17 || (a.lloc & ((1 << a.log2_n2) - 1)) ||
                   a.ranks < 1 || a.rank < 0 || a.rank >= a.ranks ||
                   (a.ranks << a.log2_w) != (1 << a.log2_n2) ||
                   !pow2(a.lloc >> a.log2_n2);
  return bad ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

int tiles_of(int lloc) { return (lloc + kShardTile - 1) / kShardTile; }

}  // namespace

// The look-back state's size in 32-bit words (zeroed once by the caller;
// one state serves one block size, launch after launch).
extern "C" int fs_sharded_tail_state_words() {
  return static_cast<int>(sizeof(LookBack) / 4);
}

// K20 launch A from ShardArgs (recv, cadd, rnd, zsign, halo -> dig, pre,
// words, with state; the halo's slots only on rank > 0).  cadd, rnd and
// dig 16-byte aligned.
extern "C" int fs_sharded_tail_a(const void *args, void *stream) {
  const ShardArgs &a = *static_cast<const ShardArgs *>(args);
  int rc = check_block(a);
  if (rc) return rc;
  if (((reinterpret_cast<uintptr_t>(a.cadd) |
        reinterpret_cast<uintptr_t>(a.rnd) |
        reinterpret_cast<uintptr_t>(a.dig)) & 15) ||
      !a.state || (a.rank > 0) != (a.halo != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ShardA t;
  t.recv = static_cast<const uint32_t *>(a.recv);
  t.cadd = static_cast<const uint32_t *>(a.cadd);
  t.rnd = static_cast<const uint32_t *>(a.rnd);
  t.zsign = static_cast<const int32_t *>(a.zsign);
  t.halo = static_cast<const int32_t *>(a.halo);
  t.dig = static_cast<uint32_t *>(a.dig);
  t.pre = static_cast<uint32_t *>(a.pre);
  t.words = static_cast<int32_t *>(a.words);
  t.st = static_cast<LookBack *>(a.state);
  for (int i = 0; i < 4 * kMaxTail; ++i) t.cfg[i] = i < 4 * a.K ? a.cfg[i] : 0;
  t.K = a.K;
  t.lloc = a.lloc;
  t.tiles = tiles_of(a.lloc);
  t.lg_n2 = a.log2_n2;
  t.lg_w = a.log2_w;
  t.hw = (a.lloc >> a.log2_n2) << a.log2_w;
  t.slot = 2 * a.K * (t.hw + kShardHalo);
  shard_tail_a<<<dim3(t.tiles, a.K), kShardThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// K20 launch B from ShardArgs (dig, pre, gathered -> dig in place, sgn).
extern "C" int fs_sharded_tail_b(const void *args, void *stream) {
  const ShardArgs &a = *static_cast<const ShardArgs *>(args);
  int rc = check_block(a);
  if (rc) return rc;
  if (reinterpret_cast<uintptr_t>(a.dig) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  ShardB t;
  t.dig = static_cast<uint32_t *>(a.dig);
  t.pre = static_cast<const uint32_t *>(a.pre);
  t.words = static_cast<const int32_t *>(a.gathered);
  t.sgn = static_cast<int32_t *>(a.sgn);
  t.K = a.K;
  t.lloc = a.lloc;
  t.ranks = a.ranks;
  t.rank = a.rank;
  shard_tail_b<<<dim3(tiles_of(a.lloc), a.K), kShardThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
