// Double-float arithmetic on the device: the twin of
// fractalshark_tpu_torch/ops/dblflt.py (itself the port of
// fractalshark_tpu/ops/dblflt.py), as (hi, lo) pairs of f32 (df32: the RC
// tail's orbit reconstruction, K3, and the 2x32 escape, K14) or of f64 (the
// 2x64 escape, K14).
//
// The error-free transforms (Knuth two-sum, Dekker split/two-prod) are
// exact only if no multiply and add are fused.  The build passes
// -fmad=false; the _rn intrinsics below are never contracted either, so
// these functions hold even if a file is built without that flag.  f32
// results flush in hardware (-ftz=true); f64 results pass through ftz()
// (hdr.cuh), at every operation, as the plain twin flushes them.  The f32
// instances are the functions K3 has always run.
#pragma once

#include "hdr.cuh"

namespace fs {

template <typename T>
struct DFT {
  T hi, lo;
};
using DF = DFT<float>;

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double fadd(double a, double b) {
  return ftz(__dadd_rn(a, b));
}
__device__ __forceinline__ double fsub(double a, double b) {
  return ftz(__dsub_rn(a, b));
}
__device__ __forceinline__ double fmul(double a, double b) {
  return ftz(__dmul_rn(a, b));
}

// Dekker's splitter 2^ceil(p/2) + 1 (dblflt.py:35-38)
template <typename T>
__device__ __forceinline__ T split_const();
template <>
__device__ __forceinline__ float split_const<float>() { return 4097.0f; }
template <>
__device__ __forceinline__ double split_const<double>() { return 134217729.0; }

template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T &s, T &err) {
  s = fadd(a, b);
  const T bb = fsub(s, a);
  err = fadd(fsub(a, fsub(s, bb)), fsub(b, bb));
}

// requires |a| >= |b| (or a == 0)
template <typename T>
__device__ __forceinline__ void quick_two_sum(T a, T b, T &s, T &err) {
  s = fadd(a, b);
  err = fsub(b, fsub(s, a));
}

template <typename T>
__device__ __forceinline__ void split(T a, T &hi, T &lo) {
  const T c = fmul(split_const<T>(), a);
  hi = fsub(c, fsub(c, a));
  lo = fsub(a, hi);
}

template <typename T>
__device__ __forceinline__ void two_prod(T a, T b, T &p, T &err) {
  p = fmul(a, b);
  T ahi, alo, bhi, blo;
  split(a, ahi, alo);
  split(b, bhi, blo);
  err = fadd(fadd(fadd(fsub(fmul(ahi, bhi), p), fmul(ahi, blo)),
                  fmul(alo, bhi)),
             fmul(alo, blo));
}

template <typename T>
__device__ __forceinline__ DFT<T> df_add(DFT<T> a, DFT<T> b) {
  T s1, s2, t1, t2;
  two_sum(a.hi, b.hi, s1, s2);
  two_sum(a.lo, b.lo, t1, t2);
  quick_two_sum(s1, fadd(s2, t1), s1, s2);
  quick_two_sum(s1, fadd(s2, t2), s1, s2);
  return {s1, s2};
}

template <typename T>
__device__ __forceinline__ DFT<T> df_sub(DFT<T> a, DFT<T> b) {
  return df_add(a, DFT<T>{-b.hi, -b.lo});
}

template <typename T>
__device__ __forceinline__ DFT<T> df_mul(DFT<T> a, DFT<T> b) {
  T p1, p2;
  two_prod(a.hi, b.hi, p1, p2);
  p2 = fadd(fadd(p2, fmul(a.hi, b.lo)), fmul(a.lo, b.hi));
  DFT<T> r;
  quick_two_sum(p1, p2, r.hi, r.lo);
  return r;
}

template <typename T>
__device__ __forceinline__ DFT<T> df_sqr(DFT<T> a) {
  T p1, p2;
  two_prod(a.hi, a.hi, p1, p2);
  p2 = fadd(p2, fmul(fmul(T(2), a.hi), a.lo));
  DFT<T> r;
  quick_two_sum(p1, p2, r.hi, r.lo);
  return r;
}

// a times a plain float s (dblflt.py:111)
template <typename T>
__device__ __forceinline__ DFT<T> df_mul_float(DFT<T> a, T s) {
  T p1, p2;
  two_prod(a.hi, s, p1, p2);
  p2 = fadd(p2, fmul(a.lo, s));
  DFT<T> r;
  quick_two_sum(p1, p2, r.hi, r.lo);
  return r;
}

template <typename T>
__device__ __forceinline__ DFT<T> df_mul_pow2(DFT<T> a, T s) {
  return {fmul(a.hi, s), fmul(a.lo, s)};
}

// one step of the orbit recurrence z <- z^2 + c (perturb_stream.py:482-485)
template <typename T>
__device__ __forceinline__ void df_orbit_step(DFT<T> &zx, DFT<T> &zy,
                                              DFT<T> cx, DFT<T> cy) {
  const DFT<T> rx = df_add(df_sub(df_sqr(zx), df_sqr(zy)), cx);
  const DFT<T> ry = df_add(df_mul_pow2(df_mul(zx, zy), T(2)), cy);
  zx = rx;
  zy = ry;
}

}  // namespace fs
