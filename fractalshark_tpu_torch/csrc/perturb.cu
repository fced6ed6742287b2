// K6: perturbation-only rendering (no LA), one lane per pixel.
//
// Replaces: fractalshark_tpu/ops/perturb_pallas.py:50 _kernel (B10, Pallas:
// HDR-f32 with the orbit resident in VMEM, orbits of at most 8,192 entries
// and budgets of at most 200,000), fractalshark_tpu/ops/perturb_stream.py:112
// _kernel (B11, Pallas: HDR-f32 lockstep sweeps that stream the orbit from
// HBM, 64-bit budgets), and the XLA loops they are held to,
// fractalshark_tpu/ops/perturb.py:177 _perturb_hdr_impl (HDR, f32 or f64
// mantissas) and :112 _perturb_float_impl (native f32 or f64); its glitch
// instance (kGlitch, fs_perturb_scaled) replaces
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

template <typename T, bool kHdr, bool kGlitch>
__global__ void __launch_bounds__(kBlock)
    perturb_kernel(const T *__restrict__ dcr, const T *__restrict__ dci,
                   const int32_t *__restrict__ dce,
                   const T *__restrict__ orbit, T *st_dzr, T *st_dzi,
                   int32_t *st_dze, int64_t *st_j, int64_t *st_it,
                   uint8_t *st_done, const int32_t *__restrict__ work,
                   const uint8_t *__restrict__ bad, uint8_t *st_glitch,
                   PerturbParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n_work) return;
  const int p = work ? work[i] : i;
  const int64_t jmax = P.max_ref - 1 > 0 ? P.max_ref - 1 : 0;
  const fs::OrbitCursor<T> oc(orbit, jmax);
  const HdrC<T> dc = {dcr[p], dci[p], kHdr ? dce[p] : 0};

  HdrC<T> dz;
  int64_t j, it;
  bool done, glitch = false;
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
    if (kGlitch) glitch = st_glitch[p] != 0;
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
  // the glitch instance: bad[] of the row in use, the next one's loaded
  // with that row, bad[0] (the rebase target's) held for the launch
  const bool b0 = kGlitch && bad[0];
  bool bj = kGlitch && bad[oc.clamp(j)];
  for (int64_t k = 0; !done && (P.chunk_steps == 0 || k < P.chunk_steps);
       ++k) {
    const fs::Row<T> nx = oc.ahead(j);
    bool bn = false;
    if (kGlitch) {
      glitch |= bj;
      bn = bad[oc.clamp(j + 1)];
    }
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
      using fs::ftz;
      const T tx = ftz(ftz(T(2) * og.z0r) + dz.re);
      const T ty = ftz(ftz(T(2) * og.z0i) + dz.im);
      ndz = {ftz(ftz(ftz(tx * dz.re) - ftz(ty * dz.im)) + dc.re),
             ftz(ftz(ftz(tx * dz.im) + ftz(ty * dz.re)) + dc.im), 0};
      zf = {ftz(og.z1r + ndz.re), ftz(og.z1i + ndz.im), 0};
      const T nsq = ftz(ftz(zf.re * zf.re) + ftz(zf.im * zf.im));
      const T dsq = ftz(ftz(ndz.re * ndz.re) + ftz(ndz.im * ndz.im));
      esc = nsq > T(256);
      lower = nsq < dsq;
    }
    // an escaped pixel is done and never reads its next row, so the row
    // is picked on every step
    const bool reb = lower || (j + 1) >= P.max_ref;
    og = oc.pick(reb, nx);
    if (kGlitch) bj = reb ? b0 : bn;
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
  if (kGlitch) st_glitch[p] = glitch ? 1 : 0;
}

template <typename T, bool kHdr, bool kGlitch>
int launch(const void *dcr, const void *dci, const void *dce,
           const void *orbit, void *st_dzr, void *st_dzi, void *st_dze,
           void *st_j, void *st_it, void *st_done, const void *work,
           const void *bad, void *st_glitch, int32_t n_work, int64_t max_ref,
           int64_t max_iter, int64_t chunk_steps, int32_t init,
           int32_t handoff, cudaStream_t stream) {
  const PerturbParams P = {n_work,      max_ref, max_iter,
                           chunk_steps, init,    handoff};
  const int grid = static_cast<int>((n_work + int64_t{kBlock} - 1) / kBlock);
  perturb_kernel<T, kHdr, kGlitch><<<grid, kBlock, 0, stream>>>(
      static_cast<const T *>(dcr), static_cast<const T *>(dci),
      static_cast<const int32_t *>(dce), static_cast<const T *>(orbit),
      static_cast<T *>(st_dzr), static_cast<T *>(st_dzi),
      static_cast<int32_t *>(st_dze), static_cast<int64_t *>(st_j),
      static_cast<int64_t *>(st_it), static_cast<uint8_t *>(st_done),
      static_cast<const int32_t *>(work), static_cast<const uint8_t *>(bad),
      static_cast<uint8_t *>(st_glitch), P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void *dcr, const void *dci, const void *dce,
             const void *orbit, void *st_dzr, void *st_dzi, void *st_dze,
             void *st_j, void *st_it, void *st_done, const void *work,
             int32_t n_work, int64_t max_ref, int64_t max_iter,
             int64_t chunk_steps, int32_t flags, void *stream) {
  if (n_work <= 0) return 0;
  const auto go = (flags & 2) ? launch<T, true, false> : launch<T, false, false>;
  // a handoff resumes a state: never with the zero state
  if ((flags & 1) && (flags & 4))
    return static_cast<int>(cudaErrorInvalidValue);
  return go(dcr, dci, dce, orbit, st_dzr, st_dzi, st_dze, st_j, st_it,
            st_done, work, nullptr, nullptr, n_work, max_ref, max_iter,
            chunk_steps, flags & 1, (flags >> 2) & 1,
            static_cast<cudaStream_t>(stream));
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
// (flags bit 0) or resumed, plus per pixel the OR of bad[j] over the
// orbit positions j of the steps it ran (bad: uint8, one an orbit
// position; glitch: uint8 [pixels], state like the others).
extern "C" int fs_perturb_scaled(const void *dcr, const void *dci,
                                 const void *orbit, void *st_dzr,
                                 void *st_dzi, void *st_dze, void *st_j,
                                 void *st_it, void *st_done, const void *work,
                                 const void *bad, void *st_glitch,
                                 int32_t n_work, int64_t max_ref,
                                 int64_t max_iter, int64_t chunk_steps,
                                 int32_t flags, void *stream) {
  if (n_work <= 0) return 0;
  if (flags & ~1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, false, true>(
      dcr, dci, nullptr, orbit, st_dzr, st_dzi, st_dze, st_j, st_it, st_done,
      work, bad, st_glitch, n_work, max_ref, max_iter, chunk_steps, flags & 1,
      0, static_cast<cudaStream_t>(stream));
}
