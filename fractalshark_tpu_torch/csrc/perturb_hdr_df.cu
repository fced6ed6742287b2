// K16: perturbation-only rendering with HDR double-float deltas (the 2x32
// and hdr2x32 LAv2 names in PO mode or without a valid LA table), one lane
// per pixel.
//
// Replaces: fractalshark_tpu/ops/hdr_df.py:170 _perturb_hdrdf_impl (XLA,
// no Pallas kernel): each complex value a pair of double-float (hi, lo)
// f32 mantissas with one shared int32 exponent (HDC2, ~48 bits).
//
// Per pixel, op for op as the plain twin (ops/hdr_df.py
// perturb_hdr_df_plain), from dz = 0 (exponent MIN_BIG_EXPONENT) at orbit
// position j = 0:
//   dz <- reduce((2 Z[j] + dz) dz + dc);  z = reduce(Z[j+1] + dz)
//   |z|^2 > 256 (the reduced HDR compare of the hi parts): escaped, the
//   count stays;
//   else count += 1, and dz <- z, j <- 0 if |z|^2 < |dz|^2 (hi parts) or
//   j+1 reaches max_ref, else j <- j+1.
// The HDC2 add aligns the smaller exponent's operand by an exact power of
// two on both halves (gaps clamped to 126, hdrfloat.py's threshold), the
// double-float sums and products are csrc/df32.cuh's (-fmad=false: every
// * and + rounds on its own; -ftz=true: f32 results flush, as XLA:CPU
// flushes them), and the reduce and pow2 are csrc/hdr.cuh's.
//
// Design: K6's (csrc/perturb.cu).  The TPU reference steps every pixel in
// lockstep over one orbit position per pixel per step (an XLA gather);
// here each lane runs its own pixel and reads its own orbit row, f32 [M,
// 8] (Z[j] re hi, lo, im hi, lo; Z[j+1] likewise), loaded a step ahead
// with row 0, the rebase target, held for the launch (pixel_loop.cuh's
// cursor, with a row of two 16-byte loads).  What bounds a frame is one
// pixel's chain of steps, each about 300 dependent f32 operations (three
// double-float products and sums for (2Z + dz) dz, the additions'
// alignment, two reduces): between launches ops/hdr_df.py hands the
// kernel only the pixels still live, one lane each.  Counters are int64;
// the state goes to memory once per pixel per launch, a launch runs at
// most chunk_steps steps per pixel, and the first starts from the zero
// state.

#include <cuda_runtime.h>

#include <cstdint>

#include "df32.cuh"
#include "hdr.cuh"
#include "pixel_loop.cuh"

namespace {

using fs::DF;

constexpr int kBlock = 128;  // threads per block

// complex HDR with double-float mantissas and one shared exponent
struct Hdc2 {
  DF re, im;
  int32_t e;
};

__device__ __forceinline__ DF scale(DF v, float s) {
  return {fs::fmul(v.hi, s), fs::fmul(v.lo, s)};
}

// hdr_df.py add: the larger exponent's operand plus the other scaled by
// 2^-min(gap, 126)
__device__ __forceinline__ Hdc2 hdc2_add(const Hdc2 &a, const Hdc2 &b) {
  const bool a_big = a.e >= b.e;
  const int32_t e = a_big ? a.e : b.e;
  const int32_t diff =
      fs::imin(fs::wsub(e, a_big ? b.e : a.e), fs::kExpDiffClamp);
  const float s = fs::pow2i<float>(fs::wsub(0, diff));
  const Hdc2 &big = a_big ? a : b;
  const Hdc2 &small = a_big ? b : a;
  return {fs::df_add(big.re, scale(small.re, s)),
          fs::df_add(big.im, scale(small.im, s)), e};
}

__device__ __forceinline__ Hdc2 hdc2_mul(const Hdc2 &a, const Hdc2 &b) {
  return {fs::df_sub(fs::df_mul(a.re, b.re), fs::df_mul(a.im, b.im)),
          fs::df_add(fs::df_mul(a.re, b.im), fs::df_mul(a.im, b.re)),
          fs::wadd(a.e, b.e)};
}

// hdr_df.py reduce: by the frexp exponent of the larger |hi|
__device__ __forceinline__ Hdc2 hdc2_reduce(const Hdc2 &a) {
  const float big = fs::fmax_nan(fabsf(a.re.hi), fabsf(a.im.hi));
  float mm;
  int32_t fe;
  fs::frexp2(big, mm, fe);
  const bool zero = big == 0.0f;
  const float s = fs::pow2i<float>(-(zero ? 0 : fe));
  return {scale(a.re, s), scale(a.im, s),
          zero ? fs::kMinBigExponent : fs::wadd(a.e, fe)};
}

// |z|^2 of the hi parts, reduced (hdr_df.py norm_squared_hi, then
// hdrfloat.reduce)
__device__ __forceinline__ fs::Hdr norm_hi(const Hdc2 &a) {
  return fs::reduce(fs::Hdr{
      fs::fadd(fs::fmul(a.re.hi, a.re.hi), fs::fmul(a.im.hi, a.im.hi)),
      fs::wadd(a.e, a.e)});
}

// an orbit row (Z[r], Z[r+1]), two 16-byte loads (volatile: kept where the
// step starts, as pixel_loop.cuh's loads)
struct Row {
  float4 z0, z1;
};

__device__ __forceinline__ Row load_row(const float *orbit, int64_t q) {
  return {fs::load_anchor(orbit + 8 * q), fs::load_anchor(orbit + 8 * q + 4)};
}

struct Params {
  int n_work;
  int64_t max_ref;
  int64_t max_iter;
  int64_t chunk_steps;
  int init;
};

__global__ void __launch_bounds__(kBlock)
    perturb_hdr_df_kernel(const float *__restrict__ dc_rh,
                          const float *__restrict__ dc_rl,
                          const float *__restrict__ dc_ih,
                          const float *__restrict__ dc_il,
                          const int32_t *__restrict__ dc_e,
                          const float *__restrict__ orbit, float *st_rh,
                          float *st_rl, float *st_ih, float *st_il,
                          int32_t *st_e, int64_t *st_j, int64_t *st_it,
                          uint8_t *st_done,
                          const int32_t *__restrict__ work, Params P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n_work) return;
  const int p = work ? work[i] : i;
  const int64_t jmax = P.max_ref - 1 > 0 ? P.max_ref - 1 : 0;
  const Hdc2 dc = {{dc_rh[p], dc_rl[p]}, {dc_ih[p], dc_il[p]}, dc_e[p]};

  Hdc2 dz;
  int64_t j, it;
  bool done;
  if (P.init) {
    dz = {{0.0f, 0.0f}, {0.0f, 0.0f}, fs::kMinBigExponent};
    j = 0;
    it = 0;
    done = P.max_iter <= 0;
  } else {
    dz = {{st_rh[p], st_rl[p]}, {st_ih[p], st_il[p]}, st_e[p]};
    j = st_j[p];
    it = st_it[p];
    done = st_done[p] != 0;
  }

  const Row row0 = load_row(orbit, 0);  // the rebase target
  auto clamp = [jmax](int64_t q) { return q < 0 ? 0 : (q > jmax ? jmax : q); };
  Row og = clamp(j) == 0 ? row0 : load_row(orbit, clamp(j));
  const fs::Hdr two56 = {1.0f, 8};
  for (int64_t k = 0; !done && (P.chunk_steps == 0 || k < P.chunk_steps);
       ++k) {
    const Row nx = load_row(orbit, clamp(j + 1));  // the next step's row
    const Hdc2 zj = {{og.z0.x, og.z0.y}, {og.z0.z, og.z0.w}, 0};
    const Hdc2 t = hdc2_add({zj.re, zj.im, 1}, dz);
    const Hdc2 ndz = hdc2_reduce(hdc2_add(hdc2_mul(t, dz), dc));
    const Hdc2 zf = hdc2_reduce(hdc2_add(
        Hdc2{{og.z1.x, og.z1.y}, {og.z1.z, og.z1.w}, 0}, ndz));
    const fs::Hdr nsq = norm_hi(zf);
    const bool esc = fs::gt_reduced(nsq, two56);
    const bool reb = fs::lt_reduced(nsq, norm_hi(ndz)) || (j + 1) >= P.max_ref;
    og = reb ? row0 : nx;
    if (esc) {
      done = true;
    } else {
      dz = reb ? zf : ndz;
      j = reb ? 0 : j + 1;
      it += 1;
      if (it >= P.max_iter) done = true;
    }
  }

  st_rh[p] = dz.re.hi;
  st_rl[p] = dz.re.lo;
  st_ih[p] = dz.im.hi;
  st_il[p] = dz.im.lo;
  st_e[p] = dz.e;
  st_j[p] = j;
  st_it[p] = it;
  st_done[p] = done ? 1 : 0;
}

}  // namespace

// K16.  dc: re hi, re lo, im hi, im lo (f32 [P]) and the exponent (int32
// [P]); orbit: f32 [M, 8] rows; state: the four mantissas, the exponent,
// j and it (int64) and done (bool) of every pixel; work: the launch's
// pixel indices (int32 [n_work]) or null for pixels 0..n_work-1; init: 1
// = start every pixel from the zero state.
extern "C" int fs_perturb_hdr_df(const void *dc_rh, const void *dc_rl,
                                 const void *dc_ih, const void *dc_il,
                                 const void *dc_e, const void *orbit,
                                 void *st_rh, void *st_rl, void *st_ih,
                                 void *st_il, void *st_e, void *st_j,
                                 void *st_it, void *st_done,
                                 const void *work, int32_t n_work,
                                 int64_t max_ref, int64_t max_iter,
                                 int64_t chunk_steps, int32_t init,
                                 void *stream) {
  if (n_work <= 0) return 0;
  if (init && work) return static_cast<int>(cudaErrorInvalidValue);
  const Params P = {n_work, max_ref, max_iter, chunk_steps, init};
  const int grid = static_cast<int>((n_work + int64_t{kBlock} - 1) / kBlock);
  perturb_hdr_df_kernel<<<grid, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float *>(dc_rh), static_cast<const float *>(dc_rl),
      static_cast<const float *>(dc_ih), static_cast<const float *>(dc_il),
      static_cast<const int32_t *>(dc_e), static_cast<const float *>(orbit),
      static_cast<float *>(st_rh), static_cast<float *>(st_rl),
      static_cast<float *>(st_ih), static_cast<float *>(st_il),
      static_cast<int32_t *>(st_e), static_cast<int64_t *>(st_j),
      static_cast<int64_t *>(st_it), static_cast<uint8_t *>(st_done),
      static_cast<const int32_t *>(work), P);
  return static_cast<int>(cudaGetLastError());
}
