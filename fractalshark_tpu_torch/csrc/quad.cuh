// Four-component float arithmetic on the device, the twins of
// fractalshark_tpu_torch/ops/quadd.py (QD: renormalizing quad-double /
// quad-float, Hida-Li-Bailey's "sloppy" add and multiply with two
// quick-two-sum sweeps) and ops/quadflt.py (QF: a compensated pair of
// double-floats), each over f32 (4x32) or f64 (4x64) components.  Every
// function follows the plain twin operation for operation on df32.cuh's
// primitives: each * and + rounds on its own (-fmad=false), f32 results
// flush in hardware (-ftz=true) and f64 results through ftz(), as XLA:CPU
// flushes both.  The overloads q_add, q_sub, q_mul, q_sqr, q_mul_pow2,
// q_lead and q_from_float give both types one interface for the escape
// (csrc/escape_quad.cu).
#pragma once

#include "df32.cuh"

namespace fs {

template <typename T>
struct QDT {
  T q0, q1, q2, q3;
};

template <typename T>
struct QFT {
  DFT<T> a, b;  // value = a + b
};

// ------------------------------------------------------------------ QD

// (s, e1, e2) with a + b + c = s + e1 + e2
template <typename T>
__device__ __forceinline__ void three_sum(T a, T b, T c, T &s, T &e1,
                                          T &e2) {
  T t1, t2, t3;
  two_sum(a, b, t1, t2);
  two_sum(c, t1, s, t3);
  two_sum(t2, t3, e1, e2);
}

// (s, e) with a + b + c ~ s + e
template <typename T>
__device__ __forceinline__ void three_sum2(T a, T b, T c, T &s, T &e) {
  T t1, t2, t3;
  two_sum(a, b, t1, t2);
  two_sum(c, t1, s, t3);
  e = fadd(t2, t3);
}

// quadd.py renorm with the fifth term: one sweep folding c4 in, then the
// two downward quick-two-sum sweeps
template <typename T>
__device__ __forceinline__ QDT<T> renorm(T c0, T c1, T c2, T c3, T c4) {
  quick_two_sum(c3, c4, c3, c4);
  quick_two_sum(c2, c3, c2, c3);
  quick_two_sum(c1, c2, c1, c2);
  quick_two_sum(c0, c1, c0, c1);
  c3 = fadd(c3, c4);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    quick_two_sum(c2, c3, c2, c3);
    quick_two_sum(c1, c2, c1, c2);
    quick_two_sum(c0, c1, c0, c1);
  }
  return {c0, c1, c2, c3};
}

template <typename T>
__device__ __forceinline__ QDT<T> q_add(QDT<T> x, QDT<T> y) {
  T s0, s1, s2, s3, t0, t1, t2, t3;
  two_sum(x.q0, y.q0, s0, t0);
  two_sum(x.q1, y.q1, s1, t1);
  two_sum(x.q2, y.q2, s2, t2);
  two_sum(x.q3, y.q3, s3, t3);
  two_sum(s1, t0, s1, t0);
  three_sum(s2, t0, t1, s2, t0, t1);
  three_sum2(s3, t0, t2, s3, t0);
  t0 = fadd(fadd(t0, t1), t3);
  return renorm(s0, s1, s2, s3, t0);
}

template <typename T>
__device__ __forceinline__ QDT<T> q_sub(QDT<T> x, QDT<T> y) {
  return q_add(x, QDT<T>{-y.q0, -y.q1, -y.q2, -y.q3});
}

template <typename T>
__device__ __forceinline__ QDT<T> q_mul(QDT<T> x, QDT<T> y) {
  T p0, p1, p2, p3, p4, p5, q0, q1, q2, q3, q4, q5;
  two_prod(x.q0, y.q0, p0, q0);
  two_prod(x.q0, y.q1, p1, q1);
  two_prod(x.q1, y.q0, p2, q2);
  two_prod(x.q0, y.q2, p3, q3);
  two_prod(x.q1, y.q1, p4, q4);
  two_prod(x.q2, y.q0, p5, q5);
  three_sum(p1, p2, q0, p1, p2, q0);
  three_sum(p2, q1, q2, p2, q1, q2);
  three_sum(p3, p4, p5, p3, p4, p5);
  T s0, s1, s2, t0, t1;
  two_sum(p2, p3, s0, t0);
  two_sum(q1, p4, s1, t1);
  s2 = fadd(q2, p5);
  two_sum(s1, t0, s1, t0);
  s2 = fadd(s2, fadd(t0, t1));
  // the order-3 terms as plain products, summed left to right
  T s1b = fadd(fadd(fadd(fmul(x.q0, y.q3), fmul(x.q1, y.q2)),
                    fmul(x.q2, y.q1)),
               fmul(x.q3, y.q0));
  s1b = fadd(fadd(fadd(s1b, q3), q4), q5);
  return renorm(p0, p1, s0, fadd(s1, s1b), s2);
}

template <typename T>
__device__ __forceinline__ QDT<T> q_sqr(QDT<T> x) {
  return q_mul(x, x);
}

template <typename T>
__device__ __forceinline__ QDT<T> q_mul_pow2(QDT<T> x, T s) {
  return {fmul(x.q0, s), fmul(x.q1, s), fmul(x.q2, s), fmul(x.q3, s)};
}

template <typename T>
__device__ __forceinline__ T q_lead(QDT<T> x) {
  return x.q0;
}

// ------------------------------------------------------------------ QF

// DF-level Knuth two-sum (quadflt.py _df_two_sum)
template <typename T>
__device__ __forceinline__ void df_two_sum(DFT<T> x, DFT<T> y, DFT<T> &s,
                                           DFT<T> &e) {
  s = df_add(x, y);
  const DFT<T> bb = df_sub(s, x);
  e = df_add(df_sub(x, df_sub(s, bb)), df_sub(y, bb));
}

template <typename T>
__device__ __forceinline__ QFT<T> qf_renorm(DFT<T> a, DFT<T> b) {
  const DFT<T> s = df_add(a, b);
  return {s, df_add(df_sub(a, s), b)};
}

template <typename T>
__device__ __forceinline__ QFT<T> q_add(QFT<T> x, QFT<T> y) {
  DFT<T> s, e;
  df_two_sum(x.a, y.a, s, e);
  e = df_add(e, df_add(x.b, y.b));
  return qf_renorm(s, e);
}

template <typename T>
__device__ __forceinline__ QFT<T> q_sub(QFT<T> x, QFT<T> y) {
  return q_add(x, QFT<T>{{-y.a.hi, -y.a.lo}, {-y.b.hi, -y.b.lo}});
}

// (p, e) with p + e ~ x*y (quadflt.py _df_two_prod)
template <typename T>
__device__ __forceinline__ void df_two_prod(DFT<T> x, DFT<T> y, DFT<T> &p,
                                            DFT<T> &e) {
  DFT<T> hh, hl, lh, s, e1, e2;
  two_prod(x.hi, y.hi, hh.hi, hh.lo);
  two_prod(x.hi, y.lo, hl.hi, hl.lo);
  two_prod(x.lo, y.hi, lh.hi, lh.lo);
  const DFT<T> ll = {fmul(x.lo, y.lo), T(0)};
  df_two_sum(hh, df_add(hl, lh), s, e1);
  df_two_sum(s, ll, p, e2);
  e = df_add(e1, e2);
}

template <typename T>
__device__ __forceinline__ QFT<T> q_mul(QFT<T> x, QFT<T> y) {
  DFT<T> p, e;
  df_two_prod(x.a, y.a, p, e);
  e = df_add(e, df_add(df_mul(x.a, y.b), df_mul(x.b, y.a)));
  return qf_renorm(p, e);
}

template <typename T>
__device__ __forceinline__ QFT<T> q_sqr(QFT<T> x) {
  DFT<T> p, e;
  df_two_prod(x.a, x.a, p, e);
  e = df_add(e, df_mul_pow2(df_mul(x.a, x.b), T(2)));
  return qf_renorm(p, e);
}

template <typename T>
__device__ __forceinline__ QFT<T> q_mul_pow2(QFT<T> x, T s) {
  return {df_mul_pow2(x.a, s), df_mul_pow2(x.b, s)};
}

template <typename T>
__device__ __forceinline__ T q_lead(QFT<T> x) {
  return x.a.hi;
}

// x as a four-component value (x, 0, 0, 0) of the second argument's type
template <typename T>
__device__ __forceinline__ QDT<T> q_from_float(T x, const QDT<T> &) {
  return {x, T(0), T(0), T(0)};
}
template <typename T>
__device__ __forceinline__ QFT<T> q_from_float(T x, const QFT<T> &) {
  return {{x, T(0)}, {T(0), T(0)}};
}

}  // namespace fs
