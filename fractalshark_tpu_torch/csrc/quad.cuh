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
//
// Every function takes its arithmetic as a policy A (df32.cuh): Flushed,
// the above (the twin's, and the interface's default), or Exact, the fast
// path of K17 4x64 and K18 4x64: the same operations on f64 with no ftz()
// and the two-product as an FMA (two_prod_fma), and each square with a
// product it repeats formed once (qd_sqr, df_two_sqr; kSymmetric).  Exact
// gives Flushed's bits on the inputs escape_quad.cu's guard admits; the
// argument is there.
#pragma once

#include <type_traits>

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

// the Exact paths' guard (df32.cuh) on every component of x
__device__ __forceinline__ bool admits(const QDT<double> &x) {
  return guard_in(x.q0) & guard_in(x.q1) & guard_in(x.q2) & guard_in(x.q3);
}
__device__ __forceinline__ bool admits(const QFT<double> &x) {
  return admits(x.a) & admits(x.b);
}

// whether the policy's two-product gives (a, b) and (b, a) one value: the
// FMA's does (a rounded product commutes, and so does its exact error);
// Dekker's does not (its error sums ahi*blo and alo*bhi in the operands'
// order), so under Flushed a square keeps both two-products
template <class A>
constexpr bool kSymmetric = std::is_same<A, Exact>::value;

// ------------------------------------------------------------------ QD

// (s, e1, e2) with a + b + c = s + e1 + e2
template <class A, typename T>
__device__ __forceinline__ void three_sum(T a, T b, T c, T &s, T &e1,
                                          T &e2) {
  T t1, t2, t3;
  two_sum<A>(a, b, t1, t2);
  two_sum<A>(c, t1, s, t3);
  two_sum<A>(t2, t3, e1, e2);
}

// (s, e) with a + b + c ~ s + e
template <class A, typename T>
__device__ __forceinline__ void three_sum2(T a, T b, T c, T &s, T &e) {
  T t1, t2, t3;
  two_sum<A>(a, b, t1, t2);
  two_sum<A>(c, t1, s, t3);
  e = A::add(t2, t3);
}

// quadd.py renorm with the fifth term: one sweep folding c4 in, then the
// two downward quick-two-sum sweeps
template <class A, typename T>
__device__ __forceinline__ QDT<T> renorm(T c0, T c1, T c2, T c3, T c4) {
  quick_two_sum<A>(c3, c4, c3, c4);
  quick_two_sum<A>(c2, c3, c2, c3);
  quick_two_sum<A>(c1, c2, c1, c2);
  quick_two_sum<A>(c0, c1, c0, c1);
  c3 = A::add(c3, c4);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    quick_two_sum<A>(c2, c3, c2, c3);
    quick_two_sum<A>(c1, c2, c1, c2);
    quick_two_sum<A>(c0, c1, c0, c1);
  }
  return {c0, c1, c2, c3};
}

template <class A, typename T>
__device__ __forceinline__ QDT<T> qd_add(QDT<T> x, QDT<T> y) {
  T s0, s1, s2, s3, t0, t1, t2, t3;
  two_sum<A>(x.q0, y.q0, s0, t0);
  two_sum<A>(x.q1, y.q1, s1, t1);
  two_sum<A>(x.q2, y.q2, s2, t2);
  two_sum<A>(x.q3, y.q3, s3, t3);
  two_sum<A>(s1, t0, s1, t0);
  three_sum<A>(s2, t0, t1, s2, t0, t1);
  three_sum2<A>(s3, t0, t2, s3, t0);
  t0 = A::add(A::add(t0, t1), t3);
  return renorm<A>(s0, s1, s2, s3, t0);
}

template <class A, typename T>
__device__ __forceinline__ QDT<T> qd_sub(QDT<T> x, QDT<T> y) {
  return qd_add<A>(x, QDT<T>{-y.q0, -y.q1, -y.q2, -y.q3});
}

// the product from its six two-products (p_k, q_k) and its four order-3
// terms o_k = x.q_k * y.q_(3-k), summed as quadd.py qd_mul sums them
template <class A, typename T>
__device__ __forceinline__ QDT<T> qd_mul_sum(T p0, T p1, T p2, T p3, T p4,
                                             T p5, T q0, T q1, T q2, T q3,
                                             T q4, T q5, T o0, T o1, T o2,
                                             T o3) {
  three_sum<A>(p1, p2, q0, p1, p2, q0);
  three_sum<A>(p2, q1, q2, p2, q1, q2);
  three_sum<A>(p3, p4, p5, p3, p4, p5);
  T s0, s1, s2, t0, t1;
  two_sum<A>(p2, p3, s0, t0);
  two_sum<A>(q1, p4, s1, t1);
  s2 = A::add(q2, p5);
  two_sum<A>(s1, t0, s1, t0);
  s2 = A::add(s2, A::add(t0, t1));
  // the order-3 terms, summed left to right
  T s1b = A::add(A::add(A::add(o0, o1), o2), o3);
  s1b = A::add(A::add(A::add(s1b, q3), q4), q5);
  return renorm<A>(p0, p1, s0, A::add(s1, s1b), s2);
}

template <class A, typename T>
__device__ __forceinline__ QDT<T> qd_mul(QDT<T> x, QDT<T> y) {
  T p0, p1, p2, p3, p4, p5, q0, q1, q2, q3, q4, q5;
  A::prod(x.q0, y.q0, p0, q0);
  A::prod(x.q0, y.q1, p1, q1);
  A::prod(x.q1, y.q0, p2, q2);
  A::prod(x.q0, y.q2, p3, q3);
  A::prod(x.q1, y.q1, p4, q4);
  A::prod(x.q2, y.q0, p5, q5);
  return qd_mul_sum<A>(p0, p1, p2, p3, p4, p5, q0, q1, q2, q3, q4, q5,
                       A::mul(x.q0, y.q3), A::mul(x.q1, y.q2),
                       A::mul(x.q2, y.q1), A::mul(x.q3, y.q0));
}

// qd_mul(x, x) with each product that occurs twice computed once: the
// two-products of x.q0*x.q1 and x.q0*x.q2 and the order-3 terms
// x.q0*x.q3 and x.q1*x.q2 (a rounded product is commutative), so the same
// values enter the same sums
template <class A, typename T>
__device__ __forceinline__ QDT<T> qd_sqr(QDT<T> x) {
  T p0, p1, p3, p4, q0, q1, q3, q4;
  A::prod(x.q0, x.q0, p0, q0);
  A::prod(x.q0, x.q1, p1, q1);
  A::prod(x.q0, x.q2, p3, q3);
  A::prod(x.q1, x.q1, p4, q4);
  const T o03 = A::mul(x.q0, x.q3);
  const T o12 = A::mul(x.q1, x.q2);
  return qd_mul_sum<A>(p0, p1, p1, p3, p4, p3, q0, q1, q1, q3, q4, q3, o03,
                       o12, o12, o03);
}

template <class A, typename T>
__device__ __forceinline__ QDT<T> qd_mul_pow2(QDT<T> x, T s) {
  return {A::mul(x.q0, s), A::mul(x.q1, s), A::mul(x.q2, s),
          A::mul(x.q3, s)};
}

// ------------------------------------------------------------------ QF

// DF-level Knuth two-sum (quadflt.py _df_two_sum)
template <class A, typename T>
__device__ __forceinline__ void df_two_sum(DFT<T> x, DFT<T> y, DFT<T> &s,
                                           DFT<T> &e) {
  s = df_add<A>(x, y);
  const DFT<T> bb = df_sub<A>(s, x);
  e = df_add<A>(df_sub<A>(x, df_sub<A>(s, bb)), df_sub<A>(y, bb));
}

template <class A, typename T>
__device__ __forceinline__ QFT<T> qf_renorm(DFT<T> a, DFT<T> b) {
  const DFT<T> s = df_add<A>(a, b);
  return {s, df_add<A>(df_sub<A>(a, s), b)};
}

template <class A, typename T>
__device__ __forceinline__ QFT<T> qf_add(QFT<T> x, QFT<T> y) {
  DFT<T> s, e;
  df_two_sum<A>(x.a, y.a, s, e);
  e = df_add<A>(e, df_add<A>(x.b, y.b));
  return qf_renorm<A>(s, e);
}

template <class A, typename T>
__device__ __forceinline__ QFT<T> qf_sub(QFT<T> x, QFT<T> y) {
  return qf_add<A>(x, QFT<T>{{-y.a.hi, -y.a.lo}, {-y.b.hi, -y.b.lo}});
}

// (p, e) from the two-products hh = x.hi*y.hi, hl = x.hi*y.lo,
// lh = x.lo*y.hi and the product ll = x.lo*y.lo
template <class A, typename T>
__device__ __forceinline__ void df_prod_sum(DFT<T> hh, DFT<T> hl,
                                            DFT<T> lh, T ll, DFT<T> &p,
                                            DFT<T> &e) {
  DFT<T> s, e1, e2;
  df_two_sum<A>(hh, df_add<A>(hl, lh), s, e1);
  df_two_sum<A>(s, DFT<T>{ll, T(0)}, p, e2);
  e = df_add<A>(e1, e2);
}

// (p, e) with p + e ~ x*y (quadflt.py _df_two_prod)
template <class A, typename T>
__device__ __forceinline__ void df_two_prod(DFT<T> x, DFT<T> y, DFT<T> &p,
                                            DFT<T> &e) {
  DFT<T> hh, hl, lh;
  A::prod(x.hi, y.hi, hh.hi, hh.lo);
  A::prod(x.hi, y.lo, hl.hi, hl.lo);
  A::prod(x.lo, y.hi, lh.hi, lh.lo);
  df_prod_sum<A>(hh, hl, lh, A::mul(x.lo, y.lo), p, e);
}

// df_two_prod(x, x), with x.hi*x.lo's two-product formed once where the
// policy's is symmetric
template <class A, typename T>
__device__ __forceinline__ void df_two_sqr(DFT<T> x, DFT<T> &p, DFT<T> &e) {
  if constexpr (kSymmetric<A>) {
    DFT<T> hh, hl;
    A::prod(x.hi, x.hi, hh.hi, hh.lo);
    A::prod(x.hi, x.lo, hl.hi, hl.lo);
    df_prod_sum<A>(hh, hl, hl, A::mul(x.lo, x.lo), p, e);
  } else {
    df_two_prod<A>(x, x, p, e);
  }
}

template <class A, typename T>
__device__ __forceinline__ QFT<T> qf_mul(QFT<T> x, QFT<T> y) {
  DFT<T> p, e;
  df_two_prod<A>(x.a, y.a, p, e);
  e = df_add<A>(e, df_add<A>(df_mul<A>(x.a, y.b), df_mul<A>(x.b, y.a)));
  return qf_renorm<A>(p, e);
}

template <class A, typename T>
__device__ __forceinline__ QFT<T> qf_sqr(QFT<T> x) {
  DFT<T> p, e;
  df_two_sqr<A>(x.a, p, e);
  e = df_add<A>(e, df_mul_pow2<A>(df_mul<A>(x.a, x.b), T(2)));
  return qf_renorm<A>(p, e);
}

template <class A, typename T>
__device__ __forceinline__ QFT<T> qf_mul_pow2(QFT<T> x, T s) {
  return {df_mul_pow2<A>(x.a, s), df_mul_pow2<A>(x.b, s)};
}

// ----------------------------------------------------------- interface
//
// One interface for both types under a policy A (Flushed, the twin's
// arithmetic, unless named): the escape (csrc/escape_quad.cu) runs its
// iteration on it.  QD's square under Flushed is its product x*x, as the
// twin's qd_sqr.

template <class A = Flushed, typename T>
__device__ __forceinline__ QDT<T> q_add(QDT<T> x, QDT<T> y) {
  return qd_add<A>(x, y);
}

template <class A = Flushed, typename T>
__device__ __forceinline__ QDT<T> q_sub(QDT<T> x, QDT<T> y) {
  return qd_sub<A>(x, y);
}

template <class A = Flushed, typename T>
__device__ __forceinline__ QDT<T> q_mul(QDT<T> x, QDT<T> y) {
  return qd_mul<A>(x, y);
}

template <class A = Flushed, typename T>
__device__ __forceinline__ QDT<T> q_sqr(QDT<T> x) {
  if constexpr (kSymmetric<A>)
    return qd_sqr<A>(x);
  else
    return qd_mul<A>(x, x);
}

template <class A = Flushed, typename T>
__device__ __forceinline__ QDT<T> q_mul_pow2(QDT<T> x, T s) {
  return qd_mul_pow2<A>(x, s);
}

template <typename T>
__device__ __forceinline__ T q_lead(QDT<T> x) {
  return x.q0;
}

template <class A = Flushed, typename T>
__device__ __forceinline__ QFT<T> q_add(QFT<T> x, QFT<T> y) {
  return qf_add<A>(x, y);
}

template <class A = Flushed, typename T>
__device__ __forceinline__ QFT<T> q_sub(QFT<T> x, QFT<T> y) {
  return qf_sub<A>(x, y);
}

template <class A = Flushed, typename T>
__device__ __forceinline__ QFT<T> q_mul(QFT<T> x, QFT<T> y) {
  return qf_mul<A>(x, y);
}

template <class A = Flushed, typename T>
__device__ __forceinline__ QFT<T> q_sqr(QFT<T> x) {
  return qf_sqr<A>(x);
}

template <class A = Flushed, typename T>
__device__ __forceinline__ QFT<T> q_mul_pow2(QFT<T> x, T s) {
  return qf_mul_pow2<A>(x, s);
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
