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
// mask gives the same entry).  The table is two row tables, one a lookup
// reads (r^2: mantissa and exponent) and one the step reads (A, B, l), so
// a probe is one 8- or 16-byte load and a step two or four 16-byte loads;
// the levels' (offset, count) pairs are a few words L1 keeps.  What bounds
// it: a pixel's chain of steps (a BLA step ~50 dependent operations and up
// to ~10 probes of ~8, a single step ~60), over pixels of very different
// lengths; so, as K6, the run loop (ops/bla_kernel.py bla_run) bounds each
// launch to chunk_steps steps a pixel and hands the next launch only the
// pixels still live, so later launches run dense warps.
// Counters and positions are int32, as the reference's (its int32 budget
// refuses 2^31).

#include <cuda_runtime.h>

#include <cstdint>

#include "hdr.cuh"
#include "la_common.cuh"

namespace {

constexpr int kBlock = 128;       // threads per block
constexpr int kFirstLevel = 2;    // engine/bla.py FIRST_LEVEL

struct BlaParams {
  int n_work;
  int32_t max_ref;
  int32_t max_iter;
  int64_t chunk_steps;
  int32_t num_levels;
  int32_t lm2;
  int init;
};

template <typename T>
using HdrC = fs::HdrCT<T>;

template <typename T>
__global__ void __launch_bounds__(kBlock)
    bla_kernel(const T *__restrict__ dcr, const T *__restrict__ dci,
               const int32_t *__restrict__ dce, const T *__restrict__ orbit,
               const T *__restrict__ probe, const T *__restrict__ steps,
               const int32_t *__restrict__ levels, T *st_dzr, T *st_dzi,
               int32_t *st_dze, int32_t *st_j, int32_t *st_it,
               uint8_t *st_done, const int32_t *__restrict__ work,
               int64_t *tally, BlaParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n_work) return;
  const int p = work ? work[i] : i;
  const HdrC<T> dc = {dcr[p], dci[p], dce[p]};
  const fs::HdrT<T> two56 = {T(1), 8};

  HdrC<T> dz;
  int32_t j, it;
  bool done;
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
  // Z[q] for q clipped to [0, max_ref]: the first half of packed row q
  auto z_at = [&](int32_t q) {
    q = q < 0 ? 0 : (q > P.max_ref ? P.max_ref : q);
    const T *r = orbit + 4 * static_cast<int64_t>(q);
    return HdrC<T>{r[0], r[1], 0};
  };

  int64_t n_bla = 0, n_single = 0;  // this launch's steps of each kind
  for (int64_t s = 0; !done && (P.chunk_steps == 0 || s < P.chunk_steps);
       ++s) {
    // LookupBackwards, deepest level first, the first hit
    int32_t g = -1;
    const int32_t k = j - 1;
    if (j > 0 && (k & 1) == 0) {
      const fs::HdrT<T> dz2 = fs::reduce(fs::norm_squared(dz));
      const int32_t zeros = k == 0 ? 32 : __ffs(k) - 1;
      const int32_t start = zeros < P.lm2 ? zeros : P.lm2;
      for (int32_t li = P.num_levels - 1; li >= 0; --li) {
        const int32_t level = li + kFirstLevel;
        if (level > start) continue;
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
    n_single += !bla;
    if (!bla) {
      const HdrC<T> t =
          fs::complex_add(fs::complex_mul_pow2(z_at(j), 1), dz);
      ndz = fs::reduce_complex(fs::complex_add(fs::complex_mul(t, dz), dc));
      nj = j + 1;
      nit = it + 1;
    }
    const HdrC<T> zf = fs::reduce_complex(fs::complex_add(z_at(nj), ndz));
    const fs::HdrT<T> nsq = fs::reduce(fs::norm_squared(zf));
    const fs::HdrT<T> dsq = fs::reduce(fs::norm_squared(ndz));
    if (fs::gt_reduced(nsq, two56)) {
      done = true;
    } else {
      const bool reb = fs::lt_reduced(nsq, dsq) || nj >= P.max_ref;
      dz = reb ? zf : ndz;
      j = reb ? 0 : nj;
      it = nit;
      done = it >= P.max_iter;
    }
  }

  st_dzr[p] = dz.re;
  st_dzi[p] = dz.im;
  st_dze[p] = dz.e;
  st_j[p] = j;
  st_it[p] = it;
  st_done[p] = done ? 1 : 0;
  if (tally) {
    tally[2 * p] += n_bla;
    tally[2 * p + 1] += n_single;
  }
}

template <typename T>
int launch(const void *dcr, const void *dci, const void *dce,
           const void *orbit, const void *probe, const void *steps,
           const void *levels, void *st_dzr, void *st_dzi, void *st_dze,
           void *st_j, void *st_it, void *st_done, const void *work,
           void *tally, int32_t n_work, int32_t max_ref, int32_t max_iter,
           int64_t chunk_steps, int32_t num_levels, int32_t lm2,
           int32_t init, void *stream) {
  if (n_work <= 0) return 0;
  if (num_levels < 1 || max_ref < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BlaParams P = {n_work, max_ref, max_iter, chunk_steps,
                       num_levels, lm2, init};
  const int grid = static_cast<int>((n_work + int64_t{kBlock} - 1) / kBlock);
  bla_kernel<T><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T *>(dcr), static_cast<const T *>(dci),
      static_cast<const int32_t *>(dce), static_cast<const T *>(orbit),
      static_cast<const T *>(probe), static_cast<const T *>(steps),
      static_cast<const int32_t *>(levels), static_cast<T *>(st_dzr),
      static_cast<T *>(st_dzi), static_cast<int32_t *>(st_dze),
      static_cast<int32_t *>(st_j), static_cast<int32_t *>(st_it),
      static_cast<uint8_t *>(st_done), static_cast<const int32_t *>(work),
      static_cast<int64_t *>(tally), P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K15.  dc (3) [pixels]; orbit: the packed [max_ref + 1, 4] rows
// (tables.py pack_orbit_np); probe [R, 2] (r2 mantissa, r2 exponent);
// steps [R, 8] (A re, A im, A exp, B re, B im, B exp, l, 0); levels int32
// [num_levels, 2] (first entry, entries); integer fields of the float
// tables bit-cast (f32) or exactly converted (f64), tables.py ibits_np;
// state (6) [pixels]: dz re, im, exp, j, count (int32), done (uint8); work:
// the launch's pixel indices (int32 [n_work]) or null for 0..n_work-1;
// tally: null, or int64 [pixels, 2] to which each pixel adds the BLA steps
// and the single steps it ran (a measurement's count of the work); init:
// start every pixel from the zero state.
#define FS_BLA_ARGS                                                          \
  const void *dcr, const void *dci, const void *dce, const void *orbit,      \
      const void *probe, const void *steps, const void *levels,              \
      void *st_dzr, void *st_dzi, void *st_dze, void *st_j, void *st_it,     \
      void *st_done, const void *work, void *tally, int32_t n_work,          \
      int32_t max_ref, int32_t max_iter, int64_t chunk_steps,                \
      int32_t num_levels, int32_t lm2, int32_t init, void *stream
#define FS_BLA_PASS                                                          \
  dcr, dci, dce, orbit, probe, steps, levels, st_dzr, st_dzi, st_dze, st_j,  \
      st_it, st_done, work, tally, n_work, max_ref, max_iter, chunk_steps,   \
      num_levels, lm2, init, stream

extern "C" int fs_bla_f32(FS_BLA_ARGS) { return launch<float>(FS_BLA_PASS); }

extern "C" int fs_bla_f64(FS_BLA_ARGS) { return launch<double>(FS_BLA_PASS); }
