// K6: perturbation-only rendering (no LA), one lane per pixel.
//
// Replaces: fractalshark_tpu/ops/perturb_pallas.py:50 _kernel (B10, Pallas:
// HDR-f32 with the orbit resident in VMEM, orbits of at most 8,192 entries
// and budgets of at most 200,000), fractalshark_tpu/ops/perturb_stream.py:112
// _kernel (B11, Pallas: HDR-f32 lockstep sweeps that stream the orbit from
// HBM, 64-bit budgets), and the XLA loops they are held to,
// fractalshark_tpu/ops/perturb.py:177 _perturb_hdr_impl (HDR, f32 or f64
// mantissas) and :112 _perturb_float_impl (native f32 or f64); its glitch
// instance (glitch_kernel, fs_perturb_scaled) replaces
// fractalshark_tpu/ops/scaled.py:47 _perturb_f32_glitch_impl, the Scaled
// family's f32 pass: the native f32 step, plus a per-pixel flag, the OR of
// bad[j] over the orbit positions j of the steps the pixel ran (its
// escaping step too), which the run loop stores with the state.
//
// Per pixel, from dz = 0 at orbit position j = 0 (perturb.py:6-11):
//   dz <- dz(2Z[j] + dz) + dc;  z = Z[j+1] + dz
//   |z|^2 > 256: escaped, the count stays;
//   else count += 1, and dz <- z, j <- 0 if |z|^2 < |dz|^2 or j+1 reaches
//   max_ref, else j <- j+1.
// The HDR step is K2's tail step (lav2.cu), with the reduced compares of
// _perturb_hdr_impl; B11's unreduced compares are boolean-identical
// (fractalshark_tpu/ops/hdrfloat.py:220-238).  The float step rounds and
// flushes every * and + on its own, in _perturb_float_impl's order.
//
// Design: the TPU kernels keep every pixel of a tile in lockstep and bring
// Z[j] to the tile, by a select-gather over VMEM rows (B10) or by sweeping
// one orbit position for all pixels at once (B11), because Mosaic has no
// vector gather.  Here each lane runs its own pixel and reads its own row
// (Z[j], Z[j+1]) of the packed [M, 4] orbit, so neither B10's length cap
// nor B11's sweep is needed.  What bounds a deep frame is one pixel's
// chain of steps: View #6 runs 4,718,592 steps on its deepest pixels, each
// step a chain of ~60 dependent HDR operations (its serial floor, one
// pixel over a one-row orbit, is ~177 ns a step in HDR-f32 on the H100).
// So:
//  * the row a step needs is loaded a step ahead (csrc/pixel_loop.cuh
//    OrbitCursor): row 0, the rebase target, is held for the launch, and
//    row j+1 is loaded during step j, so the 7.3 MB orbit of View #6 is
//    read from L2 beside the arithmetic instead of in front of it;
//  * reduce_complex reads its scale off the bits (csrc/hdr.cuh), a shorter
//    chain with the same bits;
//  * between launches ops/perturb.py hands the kernel only the pixels
//    still live (its work list), one lane each, so a launch after the
//    first runs dense warps instead of warps whose escaped pixels idle.
// The order in which pixels run changes nothing: each pixel's steps depend
// on its own state alone.  Counters are int64, so budgets of 2^31 and more
// need no (hi, lo) pairs.  The state goes to memory once per pixel per
// launch; a launch runs at most chunk_steps steps per pixel, and the first
// one starts from the zero state (dze = MIN_BIG_EXPONENT in HDR form,
// perturb_pallas.py:99-103).
//
// The glitch instance (glitch_kernel) shares the float step with
// perturb_kernel and is built for what bounds it on a full frame:
// instruction issue, the integer and select work on a pipe half the f32
// pipe's width beside 17 f32 operations a step (PERF.md §6 counts each
// form's instructions a step).  So:
//  * no bad[] load: a pixel's positions run 0, 1, 2, ... from the zero
//    state and from every rebase, so the OR of bad[j] over the positions
//    it stepped from is set exactly when it stepped from some j >= fb,
//    the first index with bad[fb] set (the host's, ops/perturb.py
//    first_bad; past the last position when none is).  A lane keeps the
//    furthest position it stepped from in a round (one max a step) and
//    tests it once a round.  This holds for a state the instance carried
//    from the zero state, in any chunks: the only states it is given;
//  * j, the count and the step counters are int32: the Scaled family's
//    budgets are below 2^31 (ops/tables.py int32_budget) and the wrapper
//    refuses an orbit of 2^31 - 1 positions or more; the state keeps its
//    int64 tensors;
//  * a round runs to the count at which it ends (the budget, the launch's
//    chunk or kRound steps) or to an escape, one compare a step, its loop
//    unrolled by 4 (by 1 the compiler recomputed the round's bound on
//    every step; 4 measured faster than 2, PERF.md §6);
//  * a step loads its own row j when it starts, with no row in flight and
//    no select between the row loaded ahead and row 0: the orbit (16
//    bytes a position) is read from L1, and on a full frame the other
//    warps hide the load (measured against K6's schedule, PERF.md §6);
//  * with more pixels than the card holds lanes, lanes take further pixels
//    from a work queue in rounds of kRound steps (K15's form), so warps
//    stay full while the frame drains.

#include <cuda_runtime.h>

#include <cstdint>

#include "hdr.cuh"
#include "pixel_loop.cuh"

namespace {

template <typename T>
using HdrC = fs::HdrCT<T>;

// threads per block
constexpr int kBlock = 128;

struct PerturbParams {
  int n_work;
  int64_t max_ref;
  int64_t max_iter;
  int64_t chunk_steps;
  int init;
  int handoff;
};

// the native-float step (_perturb_float_impl's order) from row og =
// (Z[j], Z[j+1]): ndz = dz(2Z[j] + dz) + dc, zf = Z[j+1] + ndz, escape at
// |zf|^2 > 256, lower = |zf|^2 < |ndz|^2; every * and + rounded and
// flushed on its own
template <typename T>
struct FloatStep {
  T ndzr, ndzi, zfr, zfi;
  bool esc, lower;
};

template <typename T>
__device__ __forceinline__ FloatStep<T> float_step(const fs::Row<T> &og,
                                                   T dzr, T dzi, T dcr,
                                                   T dci) {
  using fs::ftz;
  FloatStep<T> o;
  const T tx = ftz(ftz(T(2) * og.z0r) + dzr);
  const T ty = ftz(ftz(T(2) * og.z0i) + dzi);
  o.ndzr = ftz(ftz(ftz(tx * dzr) - ftz(ty * dzi)) + dcr);
  o.ndzi = ftz(ftz(ftz(tx * dzi) + ftz(ty * dzr)) + dci);
  o.zfr = ftz(og.z1r + o.ndzr);
  o.zfi = ftz(og.z1i + o.ndzi);
  const T nsq = ftz(ftz(o.zfr * o.zfr) + ftz(o.zfi * o.zfi));
  const T dsq = ftz(ftz(o.ndzr * o.ndzr) + ftz(o.ndzi * o.ndzi));
  o.esc = nsq > T(256);
  o.lower = nsq < dsq;
  return o;
}

template <typename T, bool kHdr>
__global__ void __launch_bounds__(kBlock)
    perturb_kernel(const T *__restrict__ dcr, const T *__restrict__ dci,
                   const int32_t *__restrict__ dce,
                   const T *__restrict__ orbit, T *st_dzr, T *st_dzi,
                   int32_t *st_dze, int64_t *st_j, int64_t *st_it,
                   uint8_t *st_done, const int32_t *__restrict__ work,
                   PerturbParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n_work) return;
  const int p = work ? work[i] : i;
  const int64_t jmax = P.max_ref - 1 > 0 ? P.max_ref - 1 : 0;
  const fs::OrbitCursor<T> oc(orbit, jmax);
  const HdrC<T> dc = {dcr[p], dci[p], kHdr ? dce[p] : 0};

  HdrC<T> dz;
  int64_t j, it;
  bool done;
  if (P.init) {
    dz = {T(0), T(0), kHdr ? fs::kMinBigExponent : 0};
    j = 0;
    it = 0;
    done = P.max_iter <= 0;
  } else {
    dz = {st_dzr[p], st_dzi[p], st_dze[p]};
    j = st_j[p];
    it = st_it[p];
    done = st_done[p] != 0;
  }
  if (P.handoff) {
    // an LA phase's handoff (j = jwait): a pixel at the budget is done; a
    // live one handed over at max_ref rebases there (dz <- Z[max_ref] + dz,
    // position 0) without spending an iteration, the others' positions
    // are clamped to [0, max_ref - 1] (perturb_stream.py:671-716)
    if (it >= P.max_iter) done = true;
    if (!done && j >= P.max_ref) {
      const fs::Row<T> last = oc.at(jmax);  // (Z[max_ref - 1], Z[max_ref])
      dz = fs::reduce_complex(
          fs::complex_add(HdrC<T>{last.z1r, last.z1i, 0}, dz));
      j = 0;
    } else if (!done) {
      j = j < 0 ? 0 : (j > jmax ? jmax : j);
    }
  }

  fs::Row<T> og = oc.at(j);  // the row of the step about to run
  for (int64_t k = 0; !done && (P.chunk_steps == 0 || k < P.chunk_steps);
       ++k) {
    const fs::Row<T> nx = oc.ahead(j);
    HdrC<T> ndz, zf;
    bool esc, lower;
    if (kHdr) {
      const fs::HdrStep<T> o =
          fs::hdr_step<false>(og.z0r, og.z0i, og.z1r, og.z1i, dz, dc);
      ndz = o.ndz;
      zf = o.zf;
      esc = o.esc;
      lower = o.lower;
    } else {
      const FloatStep<T> o = float_step(og, dz.re, dz.im, dc.re, dc.im);
      ndz = {o.ndzr, o.ndzi, 0};
      zf = {o.zfr, o.zfi, 0};
      esc = o.esc;
      lower = o.lower;
    }
    // an escaped pixel is done and never reads its next row, so the row
    // is picked on every step
    const bool reb = lower || (j + 1) >= P.max_ref;
    og = oc.pick(reb, nx);
    if (esc) {
      done = true;
    } else {
      dz = reb ? zf : ndz;
      j = reb ? 0 : j + 1;
      it += 1;
      if (it >= P.max_iter) done = true;
    }
  }

  st_dzr[p] = dz.re;
  st_dzi[p] = dz.im;
  st_dze[p] = dz.e;
  st_j[p] = j;
  st_it[p] = it;
  st_done[p] = done ? 1 : 0;
}

template <typename T, bool kHdr>
int launch(const void *dcr, const void *dci, const void *dce,
           const void *orbit, void *st_dzr, void *st_dzi, void *st_dze,
           void *st_j, void *st_it, void *st_done, const void *work,
           int32_t n_work, int64_t max_ref, int64_t max_iter,
           int64_t chunk_steps, int32_t init, int32_t handoff,
           cudaStream_t stream) {
  const PerturbParams P = {n_work,      max_ref, max_iter,
                           chunk_steps, init,    handoff};
  const int grid = static_cast<int>((n_work + int64_t{kBlock} - 1) / kBlock);
  perturb_kernel<T, kHdr><<<grid, kBlock, 0, stream>>>(
      static_cast<const T *>(dcr), static_cast<const T *>(dci),
      static_cast<const int32_t *>(dce), static_cast<const T *>(orbit),
      static_cast<T *>(st_dzr), static_cast<T *>(st_dzi),
      static_cast<int32_t *>(st_dze), static_cast<int64_t *>(st_j),
      static_cast<int64_t *>(st_it), static_cast<uint8_t *>(st_done),
      static_cast<const int32_t *>(work), P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void *dcr, const void *dci, const void *dce,
             const void *orbit, void *st_dzr, void *st_dzi, void *st_dze,
             void *st_j, void *st_it, void *st_done, const void *work,
             int32_t n_work, int64_t max_ref, int64_t max_iter,
             int64_t chunk_steps, int32_t flags, void *stream) {
  if (n_work <= 0) return 0;
  const auto go = (flags & 2) ? launch<T, true> : launch<T, false>;
  // a handoff resumes a state: never with the zero state
  if ((flags & 1) && (flags & 4))
    return static_cast<int>(cudaErrorInvalidValue);
  return go(dcr, dci, dce, orbit, st_dzr, st_dzi, st_dze, st_j, st_it,
            st_done, work, n_work, max_ref, max_iter, chunk_steps, flags & 1,
            (flags >> 2) & 1, static_cast<cudaStream_t>(stream));
}

// ------------------------------------------------ the glitch instance

constexpr int kRound = 32;  // steps a queue lane runs between looks

struct GlitchParams {
  int32_t n_work;
  int32_t max_ref;
  int32_t max_iter;
  int32_t first_bad;  // the first position whose bad[] is set
  int64_t chunk_steps;
  int32_t init;
};

// K6's float step in f32 over the pixels `work`, plus the glitch flag;
// kQueue: the card's resident blocks, lanes taking further pixels from
// the queue (counter) in rounds of kRound steps; else one lane a pixel
template <bool kQueue>
__global__ void __launch_bounds__(kBlock)
    glitch_kernel(const float *__restrict__ dcr,
                  const float *__restrict__ dci,
                  const float *__restrict__ orbit, float *st_dzr,
                  float *st_dzi, int64_t *st_j, int64_t *st_it,
                  uint8_t *st_done, uint8_t *st_glitch,
                  const int32_t *__restrict__ work, int32_t *counter,
                  GlitchParams P) {
  const int32_t jmax = P.max_ref - 1 > 0 ? P.max_ref - 1 : 0;
  // steps a pixel may run in this launch (chunk_steps 0: no bound)
  const int32_t chunk = P.chunk_steps > 0 && P.chunk_steps < INT32_MAX
                            ? static_cast<int32_t>(P.chunk_steps)
                            : INT32_MAX;
  const int lanes = gridDim.x * blockDim.x;
  int item = blockIdx.x * blockDim.x + threadIdx.x;  // this lane's first
  int p = -1;  // this lane's pixel, -1 while it has none

  float cr = 0.0f, ci = 0.0f, zr = 0.0f, zi = 0.0f;
  int32_t j = 0, it = 0, s = 0;  // position, count, steps in this launch
  bool done = true, glitch = false;

  for (;;) {
    if (p < 0) {
      if (item < 0) item = kQueue ? lanes + atomicAdd(counter, 1) : P.n_work;
      if (item >= P.n_work) break;
      p = work ? work[item] : item;
      item = -1;
      cr = dcr[p];
      ci = dci[p];
      if (P.init) {
        zr = zi = 0.0f;
        j = it = 0;
        done = P.max_iter <= 0;
        glitch = false;
      } else {
        zr = st_dzr[p];
        zi = st_dzi[p];
        j = static_cast<int32_t>(st_j[p]);
        it = static_cast<int32_t>(st_it[p]);
        done = st_done[p] != 0;
        glitch = st_glitch[p] != 0;
      }
      // (a position the instance stored is in [0, jmax] already)
      j = j < 0 ? 0 : (j > jmax ? jmax : j);
      s = 0;
    }

    if (!done) {
      // a round: up to kRound steps (the queue) or the launch's, none past
      // the budget (a live pixel at or past it runs one, as the twin's)
      int32_t n = kQueue && chunk - s > kRound ? kRound : chunk - s;
      const int32_t left = P.max_iter - it;
      if (left < n) n = left > 1 ? left : 1;
      const int32_t it0 = it, end = it + n;
      int32_t top = j;  // the furthest position a step ran from
#pragma unroll 4
      do {
        // row j (j in [0, jmax]) when the step starts: the orbit is read
        // from L1, and the warps of a full frame hide its latency
        const fs::Row<float> og =
            fs::load_orbit_row(orbit + 4 * static_cast<int64_t>(j));
        top = top > j ? top : j;
        const FloatStep<float> o = float_step(og, zr, zi, cr, ci);
        if (o.esc) {
          done = true;
          break;
        }
        const bool reb = o.lower || j + 1 >= P.max_ref;
        zr = reb ? o.zfr : o.ndzr;
        zi = reb ? o.zfi : o.ndzi;
        j = reb ? 0 : j + 1;
      } while (++it < end);
      glitch |= top >= P.first_bad;
      s += it - it0;
      if (it >= P.max_iter) done = true;
    }

    if (done || s >= chunk) {
      st_dzr[p] = zr;
      st_dzi[p] = zi;
      st_j[p] = j;
      st_it[p] = it;
      st_done[p] = done ? 1 : 0;
      st_glitch[p] = glitch ? 1 : 0;
      p = -1;
    }
  }
}

}  // namespace

// work: the launch's pixel indices (int32 [n_work]), or null for pixels
// 0..n_work-1, one lane each.  flags: bit 0 = start from the zero state,
// bit 1 = HDR form (else native float), bit 2 = the state is an LA
// phase's handoff (j holds jwait), which the launch applies first.
#define FS_PERTURB_ARGS                                                      \
  const void *dcr, const void *dci, const void *dce, const void *orbit,      \
      void *st_dzr, void *st_dzi, void *st_dze, void *st_j, void *st_it,     \
      void *st_done, const void *work, int32_t n_work, int64_t max_ref,      \
      int64_t max_iter, int64_t chunk_steps, int32_t flags, void *stream
#define FS_PERTURB_PASS                                                      \
  dcr, dci, dce, orbit, st_dzr, st_dzi, st_dze, st_j, st_it, st_done, work,  \
      n_work, max_ref, max_iter, chunk_steps, flags, stream

extern "C" int fs_perturb_f32(FS_PERTURB_ARGS) {
  return dispatch<float>(FS_PERTURB_PASS);
}

extern "C" int fs_perturb_f64(FS_PERTURB_ARGS) {
  return dispatch<double>(FS_PERTURB_PASS);
}

// K6-glitch, the Scaled family's f32 pass: native f32 from the zero state
// (init) or resumed, plus per pixel the OR of bad[j] over the orbit
// positions j of the steps it ran, as j >= first_bad (the first position
// whose bad[] is set, or one past the last position, max(max_ref, 1), if
// none is).  dcr, dci, orbit as fs_perturb_f32's; state (6) [pixels]: dz
// re, im (f32), j, count (int64), done, glitch (uint8) (the float state's
// exponent is not read or written); work: the launch's pixel indices
// (int32 [n_work]) or null for 0..n_work-1; counter: four bytes of device
// scratch for the work queue; max_ref below 2^31 - 1, max_iter below
// 2^31.
extern "C" int fs_perturb_scaled(const void *dcr, const void *dci,
                                 const void *orbit, void *st_dzr,
                                 void *st_dzi, void *st_j, void *st_it,
                                 void *st_done, void *st_glitch,
                                 const void *work, void *counter,
                                 int32_t n_work, int32_t max_ref,
                                 int32_t max_iter, int32_t first_bad,
                                 int64_t chunk_steps, int32_t init,
                                 void *stream) {
  if (n_work <= 0) return 0;
  if (max_ref < 0 || max_ref == INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const GlitchParams P = {n_work,    max_ref,     max_iter,
                          first_bad, chunk_steps, init};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int64_t resident =
      fs::resident_blocks(glitch_kernel<true>, kBlock, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the queue only when some lane must take a second pixel
  const int64_t want = (n_work + int64_t{kBlock} - 1) / kBlock;
  const bool queue = want > resident;
  err = cudaMemsetAsync(counter, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = queue ? glitch_kernel<true> : glitch_kernel<false>;
  kernel<<<static_cast<int>(queue ? resident : want), kBlock, 0, st>>>(
      static_cast<const float *>(dcr), static_cast<const float *>(dci),
      static_cast<const float *>(orbit), static_cast<float *>(st_dzr),
      static_cast<float *>(st_dzi), static_cast<int64_t *>(st_j),
      static_cast<int64_t *>(st_it), static_cast<uint8_t *>(st_done),
      static_cast<uint8_t *>(st_glitch), static_cast<const int32_t *>(work),
      static_cast<int32_t *>(counter), P);
  return static_cast<int>(cudaGetLastError());
}
