// HDRFloat on the device: the twin of fractalshark_tpu_torch/ops/hdrfloat.py
// (itself the port of fractalshark_tpu/ops/hdrfloat.py).
//
// value = mantissa * 2^exp, f32 or f64 mantissa (the template parameter T),
// int32 exponent; the mantissa stays unreduced between operations and is
// renormalised to +-[1, 2) at explicit reduce points.  Each function
// follows the plain PyTorch op operation for operation, so a kernel and its
// plain twin round alike.  Hdr/HdrC name the f32 instances.
//
// Floating-point mode (set by the build, fractalshark_tpu_torch/kernels.py):
//   -fmad=false  no a*b+c contraction: every * and + rounds on its own
//                (f32 and f64 alike).
//   -ftz=true    f32 subnormal results flush to zero, as on the reference's
//                CPU backend (XLA:CPU runs with FTZ/DAZ for f32 and f64).
//                The card has no flush mode for f64, so every f64 result
//                passes through ftz() below, at the places where the plain
//                twin calls hdrfloat.ftz; for f32 ftz() is the identity and
//                the hardware flushes.
// Exponent sums can wrap in the reference's int32 arithmetic; signed
// overflow is undefined in C++, so they are done in uint32_t here.  The
// exponent-gap clamp of the adds is 126 for both mantissa types
// (hdrfloat.py:162), so an aligned f64 operand never goes below 2^-126
// times its mantissa.
#pragma once

#include <cstdint>

namespace fs {

constexpr int32_t kMinBigExponent = -268435456;  // INT32_MIN >> 3
constexpr int32_t kExpDiffClamp = 120 + 6;       // EXPONENT_DIFF_IGNORED + 6

template <typename T>
struct HdrT {
  T m;
  int32_t e;
};

template <typename T>
struct HdrCT {
  T re, im;
  int32_t e;
};

using Hdr = HdrT<float>;
using HdrC = HdrCT<float>;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t imin(int32_t a, int32_t b) {
  return a < b ? a : b;
}

// flush a subnormal result to a zero of its sign (hdrfloat.ftz)
__device__ __forceinline__ float ftz(float x) { return x; }
__device__ __forceinline__ double ftz(double x) {
  return fabs(x) < 2.2250738585072014e-308 ? x * 0.0 : x;
}

// torch.maximum: NaN-propagating
__device__ __forceinline__ float fmax_nan(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7FC00000);
  return a > b ? a : b;
}
__device__ __forceinline__ double fmax_nan(double a, double b) {
  if (a != a || b != b) return __longlong_as_double(0x7FF8000000000000LL);
  return a > b ? a : b;
}

// (mantissa', exp): m == mantissa' * 2^exp with |mantissa'| in [1, 2);
// zero keeps its value and gets exponent 0 (hdrfloat.py:60-79)
__device__ __forceinline__ void frexp2(float m, float &mm, int32_t &e) {
  const int32_t bits = __float_as_int(m);
  const int32_t f_exp = ((bits >> 23) & 0xFF) - 127;
  const float norm = __int_as_float(
      (bits & static_cast<int32_t>(0x807FFFFFu)) | 0x3F800000);
  const bool zero = (m == 0.0f);
  mm = zero ? m : norm;
  e = zero ? 0 : f_exp;
}
// the f64 twin takes torch.frexp, the reference jnp.frexp: the same for
// normal numbers (the only ones the flushed arithmetic makes); inf and NaN
// come back as (2m, -1), as frexp's (m, 0) gives there
__device__ __forceinline__ void frexp2(double m, double &mm, int32_t &e) {
  const int64_t bits = __double_as_longlong(m);
  const int32_t raw = static_cast<int32_t>((bits >> 52) & 0x7FF);
  const double norm = __longlong_as_double(
      (bits & static_cast<int64_t>(0x800FFFFFFFFFFFFFull)) |
      0x3FF0000000000000LL);
  if (m == 0.0) {
    mm = m;
    e = 0;
  } else if (raw == 0x7FF) {
    mm = m * 2.0;
    e = -1;
  } else {
    mm = norm;
    e = raw - 1023;
  }
}

// 2^shift, exact; shift clamped to the normal range (hdrfloat.py:82-91)
template <typename T>
__device__ __forceinline__ T pow2i(int32_t shift);
template <>
__device__ __forceinline__ float pow2i<float>(int32_t shift) {
  const int32_t s = shift < -126 ? -126 : (shift > 127 ? 127 : shift);
  return __int_as_float((s + 127) << 23);
}
template <>
__device__ __forceinline__ double pow2i<double>(int32_t shift) {
  const int64_t s = shift < -1022 ? -1022 : (shift > 1023 ? 1023 : shift);
  return __longlong_as_double((s + 1023) << 52);
}

template <typename T>
__device__ __forceinline__ HdrT<T> reduce(HdrT<T> x) {
  T mm;
  int32_t fe;
  frexp2(x.m, mm, fe);
  return {mm, x.m == T(0) ? kMinBigExponent : wadd(x.e, fe)};
}

// the real operations of the HDR escape (K13, hdrfloat.py add/sub/mul/
// square/mul_pow2): unreduced; an add scales the smaller-exponent operand
// by 2^-min(gap, 126), so gaps past EXPONENT_DIFF_IGNORED underflow it
template <typename T>
__device__ __forceinline__ HdrT<T> hdr_add(HdrT<T> a, HdrT<T> b) {
  const bool a_big = a.e >= b.e;
  const int32_t diff = imin(wsub(a_big ? a.e : b.e, a_big ? b.e : a.e),
                            kExpDiffClamp);
  const T s = pow2i<T>(wsub(0, diff));
  return a_big ? HdrT<T>{ftz(a.m + ftz(b.m * s)), a.e}
               : HdrT<T>{ftz(b.m + ftz(a.m * s)), b.e};
}

template <typename T>
__device__ __forceinline__ HdrT<T> hdr_sub(HdrT<T> a, HdrT<T> b) {
  return hdr_add(a, HdrT<T>{-b.m, b.e});
}

template <typename T>
__device__ __forceinline__ HdrT<T> hdr_mul(HdrT<T> a, HdrT<T> b) {
  return {ftz(a.m * b.m), wadd(a.e, b.e)};
}

template <typename T>
__device__ __forceinline__ HdrT<T> hdr_square(HdrT<T> a) {
  return {ftz(a.m * a.m), wadd(a.e, a.e)};
}

template <typename T>
__device__ __forceinline__ HdrT<T> hdr_mul_pow2(HdrT<T> a, int32_t k) {
  return {a.m, wadd(a.e, k)};
}

// reduce_complex: z scaled by 2^-fe, fe the frexp exponent of
// big = fmax_nan(|re|, |im|) (0 when big is 0), the scale pow2i(-fe).  The
// forms below read fe and the scale off the bits of the larger magnitude
// without forming big, and give the same bits for every input:
//  * f32: for non-negative floats the order of the bit patterns is the
//    order of the values, and every NaN pattern lies above +inf, so the
//    integer max of |re| and |im| has big's biased exponent b (255 when
//    either is NaN, as fmax_nan's canonical NaN has) and is 0 exactly
//    when big is.  fe = b - 127 (frexp2 does not special-case 255), and
//    pow2i(-fe) = 2^(127-b) clamped to [2^-126, 2^127], which is
//    max(254 - b, 1) << 23 as bits for b in [1, 255]; for b = 0 (both
//    zero) the scale differs (2^127 for 1) but multiplies two zeros into
//    the same signed zeros, and the exponent is the zero sentinel.
//  * f64: the same on the high words (the biased exponent is in bits
//    20-30 of the high word, and |x| is 0 exactly when both words of it
//    are).  frexp2 maps b = 2047 (inf, NaN) to fe = -1 and the scale 2,
//    and every other nonzero b (a subnormal too) to fe = b - 1023 and
//    max(2046 - b, 1) << 52.
__device__ __forceinline__ HdrCT<float> reduce_complex(HdrCT<float> z) {
  const int32_t mb = max(__float_as_int(z.re) & 0x7FFFFFFF,
                         __float_as_int(z.im) & 0x7FFFFFFF);
  const int32_t b = mb >> 23;
  const float scale = __int_as_float(max(254 - b, 1) << 23);
  return {z.re * scale, z.im * scale,
          mb == 0 ? kMinBigExponent : wadd(z.e, b - 127)};
}
__device__ __forceinline__ HdrCT<double> reduce_complex(HdrCT<double> z) {
  const int32_t hr = __double2hiint(z.re) & 0x7FFFFFFF;
  const int32_t hi = __double2hiint(z.im) & 0x7FFFFFFF;
  const bool zero = (hr | hi | __double2loint(z.re) | __double2loint(z.im))
                    == 0;
  const int32_t b = max(hr, hi) >> 20;
  const bool special = b == 0x7FF;
  const double scale =
      special ? 2.0
              : __longlong_as_double(static_cast<int64_t>(max(2046 - b, 1))
                                     << 52);
  const int32_t fe = special ? -1 : b - 1023;
  return {ftz(z.re * scale), ftz(z.im * scale),
          zero ? kMinBigExponent : wadd(z.e, fe)};
}

template <typename T>
__device__ __forceinline__ HdrCT<T> complex_add(HdrCT<T> a, HdrCT<T> b) {
  const bool a_big = a.e >= b.e;
  const int32_t e = a_big ? a.e : b.e;
  const int32_t diff = imin(wsub(e, a_big ? b.e : a.e), kExpDiffClamp);
  const T s = pow2i<T>(wsub(0, diff));
  if (a_big) return {ftz(a.re + ftz(b.re * s)), ftz(a.im + ftz(b.im * s)), e};
  return {ftz(b.re + ftz(a.re * s)), ftz(b.im + ftz(a.im * s)), e};
}

template <typename T>
__device__ __forceinline__ HdrCT<T> complex_mul(HdrCT<T> a, HdrCT<T> b) {
  return {ftz(ftz(a.re * b.re) - ftz(a.im * b.im)),
          ftz(ftz(a.re * b.im) + ftz(a.im * b.re)), wadd(a.e, b.e)};
}

template <typename T>
__device__ __forceinline__ HdrCT<T> complex_sqr(HdrCT<T> a) {
  return {ftz(ftz(a.re * a.re) - ftz(a.im * a.im)),
          ftz(ftz(T(2) * a.re) * a.im), wadd(a.e, a.e)};
}

template <typename T>
__device__ __forceinline__ HdrCT<T> complex_mul_pow2(HdrCT<T> a, int32_t k) {
  return {a.re, a.im, wadd(a.e, k)};
}

template <typename T>
__device__ __forceinline__ HdrT<T> norm_squared(HdrCT<T> a) {
  return {ftz(ftz(a.re * a.re) + ftz(a.im * a.im)), wadd(a.e, a.e)};
}

template <typename T>
__device__ __forceinline__ HdrT<T> chebychev_norm(HdrCT<T> a) {
  return {fmax_nan(fabs(a.re), fabs(a.im)), a.e};
}

template <typename T>
__device__ __forceinline__ bool gt_reduced(HdrT<T> a, HdrT<T> b) {
  return (a.e > b.e) || ((a.e == b.e) && (a.m > b.m));
}

template <typename T>
__device__ __forceinline__ bool lt_reduced(HdrT<T> a, HdrT<T> b) {
  return (a.e < b.e) || ((a.e == b.e) && (a.m < b.m));
}

template <typename T>
__device__ __forceinline__ bool lte_reduced(HdrT<T> a, HdrT<T> b) {
  return !gt_reduced(a, b);
}

// unreduced compares (proof: fractalshark_tpu/ops/hdrfloat.py:220-238)
template <typename T>
__device__ __forceinline__ bool lt_unreduced(HdrT<T> a, HdrT<T> b) {
  return a.m < ftz(b.m * pow2i<T>(wsub(b.e, a.e)));
}

template <typename T>
__device__ __forceinline__ bool gt_pow2_unreduced(HdrT<T> a, int32_t k) {
  return a.m > pow2i<T>(wsub(k, a.e));
}

}  // namespace fs
