// K15: BLA perturbation rendering (the PerturbedBLA names), one lane per
// pixel.
//
// Replaces: fractalshark_tpu/ops/bla_kernel.py:29 _bla_impl (XLA; its
// entry point bla_perturb_render :125), HDR with f32 mantissas (hdr32
// names) or f64 (f64 and hdr64 names).  The reference has no Pallas kernel
// for it; the port gives its per-pixel loop a kernel, as it did for the
// XLA perturbation loops (K6).
//
// Per pixel, from dz = 0 (HDR zero) at orbit position j = 0, until it
// escapes or its count reaches the budget n (the reference's body, op for
// op; the plain twin is ops/bla_kernel.py bla_plain):
//   LookupBackwards: at j > 0 with k = j - 1 even, walk the stored levels
//   deepest first (level li + 2, while level <= min(trailing_zeros(k) (32
//   at k = 0), lm2) and k >> level < the level's count) and take the first
//   entry whose r^2 exceeds reduce(|dz|^2);
//   if one was found and j + l < max_ref + 1 and count + l < n (int32, as
//   the reference adds): dz <- reduce(A dz + B dc), j += l, count += l;
//   else one perturbation step: dz <- reduce(dz (2 Z[j] + dz) + dc), j += 1,
//   count += 1;
//   then z = reduce(Z[j] + dz): |z|^2 > 256 escapes (the state stays);
//   else the new state is kept, rebased (dz <- z, j <- 0) if |z|^2 < |dz|^2
//   or j >= max_ref.  Orbit reads are clipped to [0, max_ref].
// f64 results are flushed in code (hdr.cuh ftz), as XLA:CPU flushes them.
//
// Design: the reference steps every pixel in lockstep and walks every
// level for every pixel with a gather per level; here each lane runs its
// own pixel and stops its walk at the first hit (the reference's `found`
// mask gives the same entry).  The table is three row tables: one a walk
// reads (r^2: mantissa and exponent), one the step reads (A, B, l), and
// `bound`, one row for each position k = 4r up to the last at which a
// level can be visited: the largest r^2 (exponent, then mantissa:
// lt_reduced's order) of the entries the walk can visit at k (the levels kFirstLevel..min(trailing_zeros(k),
// lm2) whose index k >> level is below the level's count; at k = 0 each
// such level's entry 0).  So:
//  * a lookup is one 8- or 16-byte load: lt_reduced is monotone in its
//    second operand, so when dz^2 is not below bound[k/4] no entry hits
//    and the walk is skipped; a position k = 2 (mod 4) has no eligible
//    level and loads nothing; a walk, when it runs, starts at the deepest
//    eligible level instead of stepping over the others;
//  * the orbit rows come as in K6's cursor (pixel_loop.cuh OrbitCursor):
//    a single step at j reads row j = (Z[j], Z[j+1]), which is in
//    registers when the step starts, and loads row j+1 for the next one
//    (its position clamped in int32 here, as the step counts are int32:
//    int64 ones measured 6-8 % slower on the 1e8 frame, PERF.md §6);
//    row 0, the rebase target, is held; a BLA step to j + l loads row
//    j + l, which its escape test and the next step both read;
//  * with more pixels than the card holds lanes, lanes take further
//    pixels from a work queue (kQueue, K3's form) in rounds of kRound
//    steps, so warps stay full while the frame drains; between launches
//    ops/bla_kernel.py bla_run hands the next launch only the pixels still
//    live, one lane each;
//  * |z|^2 of a reduced z (the lookup's dz^2 and both compares) skips the
//    sum's ftz(), which is the identity there (norm2 below).
// What bounds it: on a frame of more pixels than lanes, the integer issue
// of the steps (HDR's exponent logic, the loop's bookkeeping) and, for
// f64, its flushes; on a small deep frame, one pixel's chain of steps (a
// BLA step ~50 dependent operations, a single step ~60).
// Counters and positions are int32, as the reference's (its int32 budget
// refuses 2^31).

#include <cuda_runtime.h>

#include <cstdint>

#include "hdr.cuh"
#include "la_common.cuh"
#include "pixel_loop.cuh"

namespace {

constexpr int kBlock = 128;       // threads per block
constexpr int kFirstLevel = 2;    // engine/bla.py FIRST_LEVEL
constexpr int kRound = 32;        // steps a queue lane runs between looks

struct BlaParams {
  int n_work;
  int32_t max_ref;
  int32_t max_iter;
  int64_t chunk_steps;
  int32_t num_levels;
  int32_t lm2;
  int32_t n_bound;
  int init;
};

template <typename T>
using HdrC = fs::HdrCT<T>;

// reduce(norm_squared(z)) for a reduced z (hdr.cuh), the sum unflushed:
// the larger component is at least 1 in magnitude after reduce_complex
// (or inf or NaN, or both are 0), so its square is at least 1 and the sum
// is at least 1, infinite, NaN or a zero: never subnormal, and ftz() is
// the identity on it.  The squares keep their flush (the smaller
// component's can be subnormal).
template <typename T>
__device__ __forceinline__ fs::HdrT<T> norm2(HdrC<T> z) {
  return fs::reduce(fs::HdrT<T>{fs::ftz(z.re * z.re) + fs::ftz(z.im * z.im),
                                fs::wadd(z.e, z.e)});
}

template <typename T, bool kQueue>
__global__ void __launch_bounds__(kBlock)
    bla_kernel(const T *__restrict__ dcr, const T *__restrict__ dci,
               const int32_t *__restrict__ dce, const T *__restrict__ orbit,
               const T *__restrict__ probe, const T *__restrict__ bound,
               const T *__restrict__ steps,
               const int32_t *__restrict__ levels, T *st_dzr, T *st_dzi,
               int32_t *st_dze, int32_t *st_j, int32_t *st_it,
               uint8_t *st_done, const int32_t *__restrict__ work,
               int32_t *counter, int64_t *tally, BlaParams P) {
  // rows clamped to [0, max_ref], the reference's clip of orbit reads
  const fs::OrbitCursor<T> oc(orbit, P.max_ref);
  const fs::HdrT<T> two56 = {T(1), 8};
  // steps a pixel may run in this launch (chunk_steps 0: no bound); the
  // step counts are int32, as a launch's share of a pixel's steps stays
  // below 2^31
  const int32_t chunk = P.chunk_steps > 0 && P.chunk_steps < INT32_MAX
                            ? static_cast<int32_t>(P.chunk_steps)
                            : INT32_MAX;
  const int lanes = gridDim.x * blockDim.x;
  int item = blockIdx.x * blockDim.x + threadIdx.x;  // this lane's first
  int p = -1;  // this lane's pixel, -1 while it has none

  HdrC<T> dc{}, dz{};
  int32_t j = 0, it = 0;
  bool done = true;
  fs::Row<T> og{};  // row j: (Z[j], Z[j+1])
  int32_t s = 0, n_bla = 0;  // this pixel's steps here, its BLA steps

  for (;;) {
    if (p < 0) {
      if (item < 0) item = kQueue ? lanes + atomicAdd(counter, 1) : P.n_work;
      if (item >= P.n_work) break;
      p = work ? work[item] : item;
      item = -1;
      dc = {dcr[p], dci[p], dce[p]};
      if (P.init) {
        dz = {T(0), T(0), fs::kMinBigExponent};
        j = 0;
        it = 0;
        done = false;  // the reference's first body runs for every pixel
      } else {
        dz = {st_dzr[p], st_dzi[p], st_dze[p]};
        j = st_j[p];
        it = st_it[p];
        done = st_done[p] != 0;
      }
      og = oc.at(j);
      s = n_bla = 0;
    }

    // a round of up to kRound steps (the queue), or all of the launch's
    const int32_t stop = kQueue && chunk - s > kRound ? s + kRound : chunk;
    for (; !done && s < stop; ++s) {
      // row j+1, for a single step, its position clamped in int32
      const int32_t j1 = j < 0 ? 0 : (j < P.max_ref ? j + 1 : P.max_ref);
      const fs::Row<T> nx =
          fs::load_orbit_row(orbit + 4 * static_cast<int64_t>(j1));
      // LookupBackwards at k = j - 1 = 0 (mod 4), deepest level first,
      // the first hit; k = 2 (mod 4) has no level from kFirstLevel on
      int32_t g = -1;
      const int32_t k = j - 1;
      if (j > 0 && (k & 3) == 0 && (k >> 2) < P.n_bound) {
        const fs::HdrT<T> dz2 = norm2(dz);
        const T *b = bound + 2 * (k >> 2);
        if (fs::lt_reduced(dz2, fs::HdrT<T>{b[0], fs::bits(b[1])})) {
          const int32_t zeros = k == 0 ? 32 : __ffs(k) - 1;
          const int32_t start = zeros < P.lm2 ? zeros : P.lm2;
          const int32_t top = start - kFirstLevel;
          for (int32_t li = top < P.num_levels - 1 ? top : P.num_levels - 1;
               li >= 0; --li) {
            const int32_t level = li + kFirstLevel;
            const int32_t ix = level >= 32 ? 0 : (k >> level);
            if (ix >= __ldg(levels + 2 * li + 1)) continue;
            const int32_t q = __ldg(levels + 2 * li) + ix;
            const fs::HdrT<T> r2 = {probe[2 * q], fs::bits(probe[2 * q + 1])};
            if (fs::lt_reduced(dz2, r2)) {
              g = q;
              break;
            }
          }
        }
      }
      HdrC<T> ndz;
      int32_t nj, nit;
      bool bla = false;
      if (g >= 0) {
        const T *row = steps + 8 * static_cast<int64_t>(g);
        const int32_t l = fs::bits(row[6]);
        nj = fs::wadd(j, l);
        nit = fs::wadd(it, l);
        bla = nj < fs::wadd(P.max_ref, 1) && nit < P.max_iter;
        if (bla) {
          const HdrC<T> A = {row[0], row[1], fs::bits(row[2])};
          const HdrC<T> B = {row[3], row[4], fs::bits(row[5])};
          ndz = fs::reduce_complex(fs::complex_add(fs::complex_mul(A, dz),
                                                   fs::complex_mul(B, dc)));
        }
      }
      n_bla += bla;
      // the row at nj: (Z[nj], Z[nj+1])
      fs::Row<T> nr;
      if (bla) {
        nr = oc.at(nj);
      } else {
        const HdrC<T> t = fs::complex_add(
            fs::complex_mul_pow2(HdrC<T>{og.z0r, og.z0i, 0}, 1), dz);
        ndz = fs::reduce_complex(fs::complex_add(fs::complex_mul(t, dz), dc));
        nj = j + 1;
        nit = it + 1;
        // Z[j+1] is row j's second half; row j+1 is the one loaded ahead.
        // A position below 0 (j + l wrapped past 2^31, as the reference's
        // int32 add wraps) reads Z at the clip of j + 1, row 0 there.
        nr = {og.z1r, og.z1i, nx.z1r, nx.z1i};
        if (j < 0) nr = oc.at(nj);
      }
      const HdrC<T> zf =
          fs::reduce_complex(fs::complex_add(HdrC<T>{nr.z0r, nr.z0i, 0}, ndz));
      const fs::HdrT<T> nsq = norm2(zf);
      const fs::HdrT<T> dsq = norm2(ndz);
      if (fs::gt_reduced(nsq, two56)) {
        done = true;
      } else {
        const bool reb = fs::lt_reduced(nsq, dsq) || nj >= P.max_ref;
        dz = reb ? zf : ndz;
        j = reb ? 0 : nj;
        it = nit;
        og = reb ? oc.row0 : nr;
        done = it >= P.max_iter;
      }
    }

    if (done || s >= chunk) {
      st_dzr[p] = dz.re;
      st_dzi[p] = dz.im;
      st_dze[p] = dz.e;
      st_j[p] = j;
      st_it[p] = it;
      st_done[p] = done ? 1 : 0;
      if (tally) {
        tally[2 * p] += n_bla;
        tally[2 * p + 1] += s - n_bla;
      }
      p = -1;
    }
  }
}

template <typename T>
int launch(const void *dcr, const void *dci, const void *dce,
           const void *orbit, const void *probe, const void *bound,
           const void *steps, const void *levels, void *st_dzr,
           void *st_dzi, void *st_dze, void *st_j, void *st_it,
           void *st_done, const void *work, void *counter, void *tally,
           int32_t n_work, int32_t max_ref, int32_t max_iter,
           int64_t chunk_steps, int32_t num_levels, int32_t lm2,
           int32_t n_bound, int32_t init, void *stream) {
  if (n_work <= 0) return 0;
  if (num_levels < 1 || max_ref < 1 || n_bound < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BlaParams P = {n_work, max_ref, max_iter, chunk_steps,
                       num_levels, lm2, n_bound, init};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int64_t resident =
      fs::resident_blocks(bla_kernel<T, true>, kBlock, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the queue only when some lane must take a second pixel
  const int64_t want = (n_work + int64_t{kBlock} - 1) / kBlock;
  const bool queue = want > resident;
  err = cudaMemsetAsync(counter, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = queue ? bla_kernel<T, true> : bla_kernel<T, false>;
  kernel<<<static_cast<int>(queue ? resident : want), kBlock, 0, st>>>(
      static_cast<const T *>(dcr), static_cast<const T *>(dci),
      static_cast<const int32_t *>(dce), static_cast<const T *>(orbit),
      static_cast<const T *>(probe), static_cast<const T *>(bound),
      static_cast<const T *>(steps), static_cast<const int32_t *>(levels),
      static_cast<T *>(st_dzr), static_cast<T *>(st_dzi),
      static_cast<int32_t *>(st_dze), static_cast<int32_t *>(st_j),
      static_cast<int32_t *>(st_it), static_cast<uint8_t *>(st_done),
      static_cast<const int32_t *>(work), static_cast<int32_t *>(counter),
      static_cast<int64_t *>(tally), P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K15.  dc (3) [pixels]; orbit: the packed [max_ref + 1, 4] rows
// (tables.py pack_orbit_np); probe [R, 2] (r2 mantissa, r2 exponent);
// bound [n_bound, 2] (the same layout; row r for position k = 4r, none
// past the last row); steps [R, 8] (A re, A im, A exp, B re, B im, B
// exp, l, 0); levels int32 [num_levels, 2] (first entry, entries);
// integer fields of the float tables bit-cast (f32) or exactly converted
// (f64), tables.py ibits_np; state (6) [pixels]: dz re, im, exp, j, count
// (int32), done (uint8); work: the launch's pixel indices (int32
// [n_work]) or null for 0..n_work-1; counter: one int32 of device scratch
// for the work queue; tally: null, or int64 [pixels, 2] to which each
// pixel adds the BLA steps and the single steps it ran (a measurement's
// count of the work); init: start every pixel from the zero state.
#define FS_BLA_ARGS                                                          \
  const void *dcr, const void *dci, const void *dce, const void *orbit,      \
      const void *probe, const void *bound, const void *steps,               \
      const void *levels, void *st_dzr, void *st_dzi, void *st_dze,          \
      void *st_j, void *st_it, void *st_done, const void *work,              \
      void *counter, void *tally, int32_t n_work, int32_t max_ref,           \
      int32_t max_iter, int64_t chunk_steps, int32_t num_levels,             \
      int32_t lm2, int32_t n_bound, int32_t init, void *stream
#define FS_BLA_PASS                                                          \
  dcr, dci, dce, orbit, probe, bound, steps, levels, st_dzr, st_dzi, st_dze, \
      st_j, st_it, st_done, work, counter, tally, n_work, max_ref, max_iter, \
      chunk_steps, num_levels, lm2, n_bound, init, stream

extern "C" int fs_bla_f32(FS_BLA_ARGS) { return launch<float>(FS_BLA_PASS); }

extern "C" int fs_bla_f64(FS_BLA_ARGS) { return launch<double>(FS_BLA_PASS); }
