// Double-float (df32) arithmetic on the device: the twin of
// fractalshark_tpu_torch/ops/dblflt.py (the subset of
// fractalshark_tpu/ops/dblflt.py:35-120 the RC tail's orbit
// reconstruction runs).
//
// The error-free transforms (Knuth two-sum, Dekker split/two-prod) are
// exact only if no multiply and add are fused.  The build passes
// -fmad=false; the _rn intrinsics below are never contracted either, so
// these functions hold even if a file is built without that flag.
#pragma once

namespace fs {

struct DF {
  float hi, lo;
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ void two_sum(float a, float b, float &s, float &err) {
  s = fadd(a, b);
  const float bb = fsub(s, a);
  err = fadd(fsub(a, fsub(s, bb)), fsub(b, bb));
}

// requires |a| >= |b| (or a == 0)
__device__ __forceinline__ void quick_two_sum(float a, float b, float &s,
                                              float &err) {
  s = fadd(a, b);
  err = fsub(b, fsub(s, a));
}

__device__ __forceinline__ void split(float a, float &hi, float &lo) {
  const float c = fmul(4097.0f, a);
  hi = fsub(c, fsub(c, a));
  lo = fsub(a, hi);
}

__device__ __forceinline__ void two_prod(float a, float b, float &p,
                                         float &err) {
  p = fmul(a, b);
  float ahi, alo, bhi, blo;
  split(a, ahi, alo);
  split(b, bhi, blo);
  err = fadd(fadd(fadd(fsub(fmul(ahi, bhi), p), fmul(ahi, blo)),
                  fmul(alo, bhi)),
             fmul(alo, blo));
}

__device__ __forceinline__ DF df_add(DF a, DF b) {
  float s1, s2, t1, t2;
  two_sum(a.hi, b.hi, s1, s2);
  two_sum(a.lo, b.lo, t1, t2);
  quick_two_sum(s1, fadd(s2, t1), s1, s2);
  quick_two_sum(s1, fadd(s2, t2), s1, s2);
  return {s1, s2};
}

__device__ __forceinline__ DF df_sub(DF a, DF b) {
  return df_add(a, {-b.hi, -b.lo});
}

__device__ __forceinline__ DF df_mul(DF a, DF b) {
  float p1, p2;
  two_prod(a.hi, b.hi, p1, p2);
  p2 = fadd(fadd(p2, fmul(a.hi, b.lo)), fmul(a.lo, b.hi));
  DF r;
  quick_two_sum(p1, p2, r.hi, r.lo);
  return r;
}

__device__ __forceinline__ DF df_sqr(DF a) {
  float p1, p2;
  two_prod(a.hi, a.hi, p1, p2);
  p2 = fadd(p2, fmul(fmul(2.0f, a.hi), a.lo));
  DF r;
  quick_two_sum(p1, p2, r.hi, r.lo);
  return r;
}

__device__ __forceinline__ DF df_mul_pow2(DF a, float s) {
  return {fmul(a.hi, s), fmul(a.lo, s)};
}

// one step of the orbit recurrence z <- z^2 + c (perturb_stream.py:482-485)
__device__ __forceinline__ void df_orbit_step(DF &zx, DF &zy, DF cx, DF cy) {
  const DF rx = df_add(df_sub(df_sqr(zx), df_sqr(zy)), cx);
  const DF ry = df_add(df_mul_pow2(df_mul(zx, zy), 2.0f), cy);
  zx = rx;
  zy = ry;
}

}  // namespace fs
