// HDRFloat on the device: the twin of fractalshark_tpu_torch/ops/hdrfloat.py
// (itself the port of fractalshark_tpu/ops/hdrfloat.py).
//
// value = mantissa * 2^exp, f32 mantissa, int32 exponent; the mantissa
// stays unreduced between operations and is renormalised to +-[1, 2) at
// explicit reduce points.  Each function follows the plain PyTorch op
// operation for operation, so a kernel and its plain twin round alike.
//
// Floating-point mode (set by the build, fractalshark_tpu_torch/kernels.py):
//   -fmad=false  no a*b+c contraction: every * and + rounds on its own.
//   -ftz=true    subnormal results flush to zero, as on the reference's
//                CPU backend (XLA:CPU runs with FTZ/DAZ); the plain twins
//                flush explicitly.
// Exponent sums can wrap in the reference's int32 arithmetic; signed
// overflow is undefined in C++, so they are done in uint32_t here.
#pragma once

#include <cstdint>

namespace fs {

constexpr int32_t kMinBigExponent = -268435456;  // INT32_MIN >> 3
constexpr int32_t kExpDiffClamp = 120 + 6;       // EXPONENT_DIFF_IGNORED + 6

struct Hdr {
  float m;
  int32_t e;
};

struct HdrC {
  float re, im;
  int32_t e;
};

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

// torch.maximum: NaN-propagating
__device__ __forceinline__ float fmax_nan(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7FC00000);
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

// 2^shift, exact; shift clamped to [-126, 127] (hdrfloat.py:82-91)
__device__ __forceinline__ float pow2i(int32_t shift) {
  const int32_t s = shift < -126 ? -126 : (shift > 127 ? 127 : shift);
  return __int_as_float((s + 127) << 23);
}

__device__ __forceinline__ Hdr reduce(Hdr x) {
  float mm;
  int32_t fe;
  frexp2(x.m, mm, fe);
  return {mm, x.m == 0.0f ? kMinBigExponent : wadd(x.e, fe)};
}

__device__ __forceinline__ HdrC reduce_complex(HdrC z) {
  const float big = fmax_nan(fabsf(z.re), fabsf(z.im));
  float unused;
  int32_t fe;
  frexp2(big, unused, fe);
  const bool zero = (big == 0.0f);
  fe = zero ? 0 : fe;
  const float scale = pow2i(wsub(0, fe));
  return {z.re * scale, z.im * scale, zero ? kMinBigExponent : wadd(z.e, fe)};
}

__device__ __forceinline__ HdrC complex_add(HdrC a, HdrC b) {
  const bool a_big = a.e >= b.e;
  const int32_t e = a_big ? a.e : b.e;
  const int32_t diff = imin(wsub(e, a_big ? b.e : a.e), kExpDiffClamp);
  const float s = pow2i(wsub(0, diff));
  if (a_big) return {a.re + b.re * s, a.im + b.im * s, e};
  return {b.re + a.re * s, b.im + a.im * s, e};
}

__device__ __forceinline__ HdrC complex_mul(HdrC a, HdrC b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re,
          wadd(a.e, b.e)};
}

__device__ __forceinline__ HdrC complex_sqr(HdrC a) {
  return {a.re * a.re - a.im * a.im, (2.0f * a.re) * a.im, wadd(a.e, a.e)};
}

__device__ __forceinline__ HdrC complex_mul_pow2(HdrC a, int32_t k) {
  return {a.re, a.im, wadd(a.e, k)};
}

__device__ __forceinline__ Hdr norm_squared(HdrC a) {
  return {a.re * a.re + a.im * a.im, wadd(a.e, a.e)};
}

__device__ __forceinline__ Hdr chebychev_norm(HdrC a) {
  return {fmax_nan(fabsf(a.re), fabsf(a.im)), a.e};
}

__device__ __forceinline__ bool gt_reduced(Hdr a, Hdr b) {
  return (a.e > b.e) || ((a.e == b.e) && (a.m > b.m));
}

__device__ __forceinline__ bool lt_reduced(Hdr a, Hdr b) {
  return (a.e < b.e) || ((a.e == b.e) && (a.m < b.m));
}

__device__ __forceinline__ bool lte_reduced(Hdr a, Hdr b) {
  return !gt_reduced(a, b);
}

// unreduced compares (proof: fractalshark_tpu/ops/hdrfloat.py:220-238)
__device__ __forceinline__ bool lt_unreduced(Hdr a, Hdr b) {
  return a.m < b.m * pow2i(wsub(b.e, a.e));
}

__device__ __forceinline__ bool gt_pow2_unreduced(Hdr a, int32_t k) {
  return a.m > pow2i(wsub(k, a.e));
}

}  // namespace fs
