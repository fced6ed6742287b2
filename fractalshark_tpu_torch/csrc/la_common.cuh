// Device code shared by the LA kernels K2 (csrc/lav2.cu) and K7
// (csrc/la_stream.cu): the integer fields of the float tables, a node row's
// loads, the reduced Chebyshev norm and the AT head skip.  Each follows the
// plain twins in fractalshark_tpu_torch/ops/la_kernel.py operation for
// operation.
#pragma once

#include <cstdint>

#include "hdr.cuh"

namespace fs {

template <typename T>
__device__ __forceinline__ HdrT<T> cheb_r(HdrCT<T> z) {
  return reduce(chebychev_norm(z));
}

// an integer field of a float table (tables.py ibits_np)
__device__ __forceinline__ int32_t bits(float v) { return __float_as_int(v); }
__device__ __forceinline__ int32_t bits(double v) {
  return static_cast<int32_t>(v);
}

// one [16] node row: four 16-byte loads for f32, eight for f64
__device__ __forceinline__ void load_row(const float *r, float *g) {
  const float4 *v = reinterpret_cast<const float4 *>(r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 q = v[k];
    g[4 * k] = q.x;
    g[4 * k + 1] = q.y;
    g[4 * k + 2] = q.z;
    g[4 * k + 3] = q.w;
  }
}
__device__ __forceinline__ void load_row(const double *r, double *g) {
  const double2 *v = reinterpret_cast<const double2 *>(r);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const double2 q = v[k];
    g[2 * k] = q.x;
    g[2 * k + 1] = q.y;
  }
}

// AT head skip (ATInfo.h:157-188; la_kernel.py:153-216, la_stream.py:318-383)
// of one pixel: with the [13] AT row (threshold_c, sqr_escape_radius,
// ref_c, ccoeff, inv_zcoeff) and step length at_step > 0, a pixel with
// |dc| <= threshold_c iterates z <- z^2 + c_at until |z|^2 > sqr_escape or
// n / at_step steps; then dz = z * inv_zcoeff and it = steps * at_step.
// dz and it are left as they are otherwise.
template <typename T>
__device__ __forceinline__ void at_head_skip(const T *at, HdrCT<T> dc,
                                             HdrT<T> dc_cheb, int64_t n,
                                             int64_t at_step, HdrCT<T> &dz,
                                             int64_t &it) {
  if (at_step <= 0) return;
  const HdrT<T> thrc = {at[0], bits(at[1])};
  const HdrT<T> sqr_esc = {at[2], bits(at[3])};
  const HdrCT<T> refc = {at[4], at[5], bits(at[6])};
  const HdrCT<T> cc = {at[7], at[8], bits(at[9])};
  const HdrCT<T> invzc = {at[10], at[11], bits(at[12])};
  if (!lte_reduced(dc_cheb, thrc)) return;
  const HdrCT<T> c_at = reduce_complex(complex_add(complex_mul(dc, cc), refc));
  const int64_t at_max = n / at_step;
  HdrCT<T> z = {T(0), T(0), kMinBigExponent};
  int64_t cnt = 0;
  while (cnt < at_max) {
    if (gt_reduced(reduce(norm_squared(z)), sqr_esc)) break;
    z = reduce_complex(complex_add(complex_sqr(z), c_at));
    ++cnt;
  }
  dz = reduce_complex(complex_mul(z, invzc));
  it = cnt * at_step;
}

}  // namespace fs
