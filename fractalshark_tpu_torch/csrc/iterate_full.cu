// K11: one whole orbit step z <- z^2 + c in one launch.  From x, y (D
// digits) it computes the residue rows of x^2 - y^2 and x*y (K9's phases
// for that plan), then, after a grid-wide barrier, the tail of both
// components (K10's function: CRT, +c, the round digit, exact carries,
// signed finish) with their shadow rows: digits uint32 [2][n], signs [2]
// and the shadow rows [2][5] of the value slice [F, F+D).
//
// Replaces: fractalshark_tpu/ops/bignum/ntt_mxu.py:920 _iterfull_kernel
// (B-f5; pallas_call :1006 in mxu_iterate_full :965; n >= 8,192 a power of
// two, 2D = n), which fixedpoint.iterate_z takes under ntt_mxu.MXU_ITER_FULL
// (:668-690, :707-722).  Its outputs are mxu_iter_products -> fused_tail's,
// which equal K4 then K5 (iterate_z's default route) for every state in
// the fixed-point range: the only differences are the reference's dropped
// parts at L and beyond and the sign of a magnitude that is zero modulo
// 2^(16L), neither of which an in-range step reaches.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel) of five
// grid phases with four grid barriers (cooperative_groups grid sync):
// K9's three phases (ntt_products.cuh: radix-8 register rounds, blocks
// spread over the card), then K10's two tail bodies (fused_tail.cuh
// tail_tile, finish_tile) over K10's tiles of 1,024 digits of both
// components, the same functions K10 launches twice.  The block has K10's
// 256 threads (more than K9 alone takes at these sizes: its column phases
// then have fewer, wider tiles, at 8 points a thread all the same).  Inside the launch
// every block is co-resident and takes its tiles in increasing order, so
// the carry into a tile comes by the same decoupled look-back as K10's,
// with no ticket: a tile waits only on lower tiles of its component,
// which are running or done.  (A scan of the tiles' aggregates between
// two more grid barriers would work too; the look-back keeps one tile
// body for both kernels and costs no barrier.)  The grid is what can be
// co-resident (queried once and cached); a refused launch returns its
// error.  The TPU's int8 phase matrices exist for Mosaic's matrix unit
// and are not copied.
//
// Bound on the H100: at 16,384 limbs (n = 65,536) a step reads 256 KB of
// digits and 768 KB of addend and round planes and writes 512 KB of
// digits, and runs 8 transforms of 2^15 x 16 butterflies, the twiddle
// matrices, the products, the CRT and the digit sums (about 43 M integer
// operations, 2.6 us at the int32 rate: chip_smoke.py products_ops and
// tail_fused_ops).  As in K9 the work is a few thousand threads' worth,
// so a step's time is the launch, the four barriers and each phase's
// load and store.

// The chunk loops of the flagged routes are here too: fs_orbit_chunk_fused
// (K9 then K10, or K11, per step, the shadow rows and signs written into
// the session's rows as K5 writes them) and fs_nr_chunk_fused (K9 then K10
// per NR step, the signs kept on the card), one C call per chunk.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_tail.cuh"
#include "ntt_products.cuh"

namespace {

constexpr int kPlanWords = 1 + kMaxCombos * (1 + 3 * kMaxTerms);

// ntt_pallas.PLAN_ITER and PLAN_NR_ITER as plan words
struct PlanWords {
  int32_t w[kPlanWords];
};

PlanWords plan_words(int K, const int (*terms)[7]) {
  PlanWords p = {};
  p.w[0] = K;
  for (int k = 0; k < K; ++k)
    for (int i = 0; i < 7; ++i) p.w[1 + k * 7 + i] = terms[k][i];
  return p;
}

// (count, sign, ia, ib, sign, ia, ib) per combination
const int kIter[2][7] = {{2, 1, 0, 0, -1, 1, 1}, {1, 1, 0, 1, 0, 0, 0}};
const int kNrIter[4][7] = {{2, 1, 0, 0, -1, 1, 1},
                           {1, 1, 0, 1, 0, 0, 0},
                           {2, 1, 0, 2, -1, 1, 3},
                           {2, 1, 0, 3, 1, 1, 2}};

// the block size: K10's tiles of 1,024 digits, and at K11's sizes (n >=
// 8,192) as many as products_threads wants or more
constexpr int kFullThreads = 256;

__global__ void __launch_bounds__(kFullThreads)
iterate_full_kernel(Products P, FusedTail t, TailState *st) {
  extern __shared__ uint32_t sm[];
  __shared__ TileShared<kFullThreads> sh;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  products_whole<8, 8>(P, sm);
  grid.sync();
  constexpr int kTile = kSeg * kFullThreads;
  const int tiles = (t.L + kTile - 1) / kTile;
  // item = tile * K + component: each block's tiles in increasing order
  for (int it = blockIdx.x; it < tiles * t.K; it += gridDim.x) {
    tail_tile<kFullThreads>(t, st, it % t.K, it / t.K, sh);
    __syncthreads();
  }
  grid.sync();
  for (int it = blockIdx.x; it < tiles * t.K; it += gridDim.x) {
    finish_tile<kFullThreads>(t, st, it % t.K, it / t.K, tiles, sh.red);
    __syncthreads();
  }
}

int iterate_full(const void *x, const void *y, int din, const void *cadd,
                 const void *rnd, const int32_t *cfg, const void *zsign,
                 void *dig, void *sgn, void *shw, uint32_t *work,
                 uint32_t *inv, const void *tables, void *state, int log2n,
                 int F, int D, cudaStream_t st) {
  // K10's tiles need kFullThreads threads a block, n >= 8 * 256
  if (log2n < 11) return static_cast<int>(cudaErrorInvalidValue);
  const void *vals[2] = {x, y};
  const PlanWords plan = plan_words(2, kIter);
  Products P;
  int rc = make_products(&P, vals, 2, din, nullptr, plan.w, inv, work,
                         static_cast<const uint32_t *>(tables), log2n,
                         kFullThreads);
  if (rc) return rc;
  FusedTail t;
  rc = make_tail(&t, inv, cadd, rnd, cfg, zsign, dig, sgn, shw, 2, log2n,
                 1 << log2n, F, D);
  if (rc) return rc;
  // the planes and digits are read and written 16 bytes a thread
  if ((reinterpret_cast<uintptr_t>(cadd) | reinterpret_cast<uintptr_t>(rnd) |
       reinterpret_cast<uintptr_t>(dig)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (P.threads != kFullThreads)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = ((1 << log2n) + kSeg * kFullThreads - 1) /
                    (kSeg * kFullThreads);
  int items = fwd_items(P);
  if (row_items(P) > items) items = row_items(P);
  if (inv_items(P) > items) items = inv_items(P);
  if (2 * tiles > items) items = 2 * tiles;
  auto s = static_cast<TailState *>(state);
  void *args[] = {&P, &t, &s};
  return coop_launch(reinterpret_cast<const void *>(iterate_full_kernel),
                     kFullThreads, items, max_smem(P), args, st);
}

}  // namespace

// K11.  x, y: uint32, din digits each; cadd: uint32 [2][n]; rnd: uint32
// [n]; cfg: int32 host [8]; zsign: int32 [2] on the card or null
// (component 1's gswap = zsign[0]*zsign[1]); dig: uint32 [2][n] out; sgn:
// int32 [2] out; shw: int32 [2][5] out or null (slice [F, F+D)); scratch:
// uint32 [12n]; tables: ntt.k9_tables(n) on the card; state: K10's
// (fs_fused_tail_state_bytes), zero on entry and on return.  n = 2^log2n,
// 2,048 <= n <= 2^17; cadd, rnd and dig 16-byte aligned.
extern "C" int fs_iterate_full(const void *x, const void *y, int din,
                               const void *cadd, const void *rnd,
                               const void *cfg, const void *zsign, void *dig,
                               void *sgn, void *shw, void *scratch,
                               const void *tables, void *state, int log2n,
                               int F, int D, void *stream) {
  auto s = static_cast<uint32_t *>(scratch);
  return iterate_full(x, y, din, cadd, rnd, static_cast<const int32_t *>(cfg),
                      zsign, dig, sgn, shw, s, s + (8u << log2n), tables,
                      state, log2n, F, D, static_cast<cudaStream_t>(stream));
}

extern "C" int fs_ntt_products(const void *v0, const void *v1, const void *v2,
                               const void *v3, int V, int din,
                               const void *signs, const void *plan, void *out,
                               void *work, const void *tables, int log2n,
                               int whole, void *stream);
extern "C" int fs_fused_tail(const void *inv, const void *cadd,
                             const void *rnd, const void *cfg,
                             const void *zsign, void *dig, void *sgn,
                             void *shw, void *state, int K, int log2n, int L,
                             int F, int D, void *stream);

// the chunk routes (orbit._ROUTES): K9 whole or split, then K10; K11
constexpr int kRouteWhole = 1;
constexpr int kRouteSplit = 2;
constexpr int kRouteFull = 3;

// The digits of component c after a step: digits F..F+D-1 of its row of
// the working digits dig [K][2D].
static void copy_back(void *const *state, const uint32_t *dig, int K, int D,
                      cudaStream_t st) {
  for (int c = 0; c < K; ++c)
    cudaMemcpyAsync(state[c], dig + static_cast<size_t>(c) * 2 * D + D - 2,
                    static_cast<size_t>(D) * 4, cudaMemcpyDeviceToDevice,
                    st);
}

extern "C" int fs_reuse_row(const void *x, const void *y, const void *row,
                            void *out, int D, int R, void *stream);

// `steps` orbit steps in place on x, y (uint32 [D]) on a flagged route:
// rows int32 [steps + 1][12] as fs_orbit_chunk's (step k reads its signs
// from row k, writes row k + 1); cadd uint32 [2][2D], rnd uint32 [2D]
// (fixedpoint.addend_planes); dig uint32 [2][2D], inv uint32 [2][2][n] and
// work uint32 [8n] scratch; tables: ntt.k9_tables(n); tail_state: K10's
// (fs_fused_tail), which K11 shares.  K11 needs 2D = n.  reuse: null, or
// int32 [steps + 1][2R + 2] as fs_orbit_chunk's.
extern "C" int fs_orbit_chunk_fused(void *x, void *y, void *rows,
                                    const void *cadd, const void *rnd,
                                    int scx, int scy, void *dig, void *inv,
                                    void *work, const void *tables, int D,
                                    int log2n, int steps, int route,
                                    void *tail_state, void *reuse, int R,
                                    void *stream) {
  const int L = 2 * D;
  const int F = D - 2;
  if (D < 16 || L > (1 << log2n) || route < kRouteWhole ||
      route > kRouteFull || (route == kRouteFull && L != (1 << log2n)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int32_t cfg[8] = {0, 1, scx, 0, 1, 1, scy, 0};
  const PlanWords plan = plan_words(2, kIter);
  auto r = static_cast<int32_t *>(rows);
  auto dg = static_cast<uint32_t *>(dig);
  for (int k = 0; k < steps; ++k) {
    const void *xi = k ? static_cast<const void *>(dg + F) : x;
    const void *yi = k ? static_cast<const void *>(dg + L + F) : y;
    int32_t *rin = r + 12 * k;
    int32_t *rout = r + 12 * (k + 1);
    int rc;
    if (route == kRouteFull) {
      rc = iterate_full(xi, yi, D, cadd, rnd, cfg, rin + 10, dig, rout + 10,
                        rout, static_cast<uint32_t *>(work),
                        static_cast<uint32_t *>(inv), tables, tail_state,
                        log2n, F, D, st);
    } else {
      rc = fs_ntt_products(xi, yi, nullptr, nullptr, 2, D, nullptr, plan.w,
                           inv, work, tables, log2n, route == kRouteWhole,
                           stream);
      if (!rc)
        rc = fs_fused_tail(inv, cadd, rnd, cfg, rin + 10, dig, rout + 10,
                           rout, tail_state, 2, log2n, L, F, D, stream);
    }
    if (!rc && reuse)
      rc = fs_reuse_row(dg + F, dg + L + F, rout,
                        static_cast<int32_t *>(reuse) + (2 * R + 2) * (k + 1),
                        D, R, stream);
    if (rc) return rc;
  }
  void *state[2] = {x, y};
  if (steps) copy_back(state, dg, 2, D, st);
  return static_cast<int>(cudaGetLastError());
}

// `steps` NR steps in place on x, y, dx, dy (uint32 [D]) and their signs
// (int32 [4] on the card) on a flagged route: K9 (the signed NR plan)
// then K10 (four components) per step; cadd uint32 [4][2D], rnd uint32
// [2D]; dig uint32 [4][2D], inv uint32 [4][2][n], work uint32 [16n];
// tables: ntt.k9_tables(n); tail_state: K10's.
extern "C" int fs_nr_chunk_fused(void *x, void *y, void *dx, void *dy,
                                 void *signs, const void *cadd,
                                 const void *rnd, int scx, int scy,
                                 void *dig, void *inv, void *work,
                                 const void *tables, int D, int log2n,
                                 int steps, int route, void *tail_state,
                                 void *stream) {
  const int L = 2 * D;
  if (D < 16 || L > (1 << log2n) ||
      (route != kRouteWhole && route != kRouteSplit))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int32_t cfg[16] = {0, 1, scx, 0, 1, 1, scy, 0,
                           1, 1, 1,   0, 1, 1, 1,   0};
  const PlanWords plan = plan_words(4, kNrIter);
  auto dg = static_cast<uint32_t *>(dig);
  void *state[4] = {x, y, dx, dy};
  for (int k = 0; k < steps; ++k) {
    const void *v[4];
    for (int c = 0; c < 4; ++c)
      v[c] = k ? static_cast<const void *>(dg + c * L + D - 2) : state[c];
    int rc = fs_ntt_products(v[0], v[1], v[2], v[3], 4, D, signs, plan.w,
                             inv, work, tables, log2n, route == kRouteWhole,
                             stream);
    if (!rc)
      rc = fs_fused_tail(inv, cadd, rnd, cfg, nullptr, dig, signs, nullptr,
                         tail_state, 4, log2n, L, 0, 0, stream);
    if (rc) return rc;
  }
  if (steps) copy_back(state, dg, 4, D, st);
  return static_cast<int>(cudaGetLastError());
}
