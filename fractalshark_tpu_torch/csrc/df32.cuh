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
//
// The sums and products take their arithmetic as a policy A: Flushed, the
// above (the twin's, and the default), or Exact, the f64 fast paths of K14
// 2x64 (csrc/escape_df.cu) and K17 4x64 (csrc/escape_quad.cu, through
// csrc/quad.cuh): the same operations with no ftz() and the two-product as
// one product and one FMA (two_prod_fma).  Exact gives Flushed's bits on
// the values the guard below admits; the argument is in each kernel's
// header.
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

// (p, e) = (fl(a*b), a*b - fl(a*b)) by one product and one FMA: exact
// where the product's error is representable (no operand or partial
// result below the normal range or past it), and then the same two
// values as Dekker's two_prod (Dekker 1971; Ogita, Rump and Oishi 2005,
// TwoProduct), signed zeros included (both give +0 for an exact product).
// -fmad=false forbids the compiler to contract a*b+c; this explicit
// __fma_rn inside a proven error-free transform is not a contraction.
__device__ __forceinline__ void two_prod_fma(double a, double b, double &p,
                                             double &e) {
  p = __dmul_rn(a, b);
  e = __fma_rn(a, b, -p);
}

// the reference arithmetic: every operation rounded on its own and
// flushed as the twin flushes
struct Flushed {
  template <typename T>
  static __device__ __forceinline__ T add(T a, T b) { return fadd(a, b); }
  template <typename T>
  static __device__ __forceinline__ T sub(T a, T b) { return fsub(a, b); }
  template <typename T>
  static __device__ __forceinline__ T mul(T a, T b) { return fmul(a, b); }
  template <typename T>
  static __device__ __forceinline__ void prod(T a, T b, T &p, T &e) {
    two_prod(a, b, p, e);
  }
};

// the f64 fast paths: unflushed, the FMA two-product
struct Exact {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ void prod(double a, double b, double &p,
                                              double &e) {
    two_prod_fma(a, b, p, e);
  }
};

// The guard of the Exact paths: its exponent range, unbiased (the
// arguments in escape_df.cu and escape_quad.cu take E = -459; the guard
// keeps nine binades above it), and the test of one f64 component: zero,
// or an exponent in [kGuardLo, kGuardHi], read off the biased exponent
// of the high word (0 only for a zero here: no component the kernels
// test is subnormal, as each is a flushed result or an Exact one proven
// normal).
constexpr int kGuardLo = -450;
constexpr int kGuardHi = 500;

__device__ __forceinline__ bool guard_in(double v) {
  const uint32_t e = (static_cast<uint32_t>(__double2hiint(v)) >> 20) &
                     0x7FFu;
  return (e - static_cast<uint32_t>(kGuardLo + 1023) <=
          static_cast<uint32_t>(kGuardHi - kGuardLo)) | (e == 0);
}

// every component of x zero or of an exponent in [kGuardLo, kGuardHi]
__device__ __forceinline__ bool admits(const DFT<double> &x) {
  return guard_in(x.hi) & guard_in(x.lo);
}

template <class A = Flushed, typename T>
__device__ __forceinline__ void two_sum(T a, T b, T &s, T &err) {
  s = A::add(a, b);
  const T bb = A::sub(s, a);
  err = A::add(A::sub(a, A::sub(s, bb)), A::sub(b, bb));
}

// requires |a| >= |b| (or a == 0)
template <class A = Flushed, typename T>
__device__ __forceinline__ void quick_two_sum(T a, T b, T &s, T &err) {
  s = A::add(a, b);
  err = A::sub(b, A::sub(s, a));
}

template <class A = Flushed, typename T>
__device__ __forceinline__ DFT<T> df_add(DFT<T> a, DFT<T> b) {
  T s1, s2, t1, t2;
  two_sum<A>(a.hi, b.hi, s1, s2);
  two_sum<A>(a.lo, b.lo, t1, t2);
  quick_two_sum<A>(s1, A::add(s2, t1), s1, s2);
  quick_two_sum<A>(s1, A::add(s2, t2), s1, s2);
  return {s1, s2};
}

template <class A = Flushed, typename T>
__device__ __forceinline__ DFT<T> df_sub(DFT<T> a, DFT<T> b) {
  return df_add<A>(a, DFT<T>{-b.hi, -b.lo});
}

template <class A = Flushed, typename T>
__device__ __forceinline__ DFT<T> df_mul(DFT<T> a, DFT<T> b) {
  T p1, p2;
  A::prod(a.hi, b.hi, p1, p2);
  p2 = A::add(A::add(p2, A::mul(a.hi, b.lo)), A::mul(a.lo, b.hi));
  DFT<T> r;
  quick_two_sum<A>(p1, p2, r.hi, r.lo);
  return r;
}

template <class A = Flushed, typename T>
__device__ __forceinline__ DFT<T> df_sqr(DFT<T> a) {
  T p1, p2;
  A::prod(a.hi, a.hi, p1, p2);
  p2 = A::add(p2, A::mul(A::mul(T(2), a.hi), a.lo));
  DFT<T> r;
  quick_two_sum<A>(p1, p2, r.hi, r.lo);
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

template <class A = Flushed, typename T>
__device__ __forceinline__ DFT<T> df_mul_pow2(DFT<T> a, T s) {
  return {A::mul(a.hi, s), A::mul(a.lo, s)};
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
