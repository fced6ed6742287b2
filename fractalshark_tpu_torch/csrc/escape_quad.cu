// K17 and K18: plain escape time in four-component float arithmetic.
//
// Replaces: fractalshark_tpu/ops/quadd.py:152 _escape_qd_impl (XLA; K17:
// renormalizing QD, the Gpu4x32 and Gpu4x64 names) and
// fractalshark_tpu/ops/quadflt.py:140 _escape_qf_impl (XLA; K18: the
// compensated pair of double-floats, the public escape_qf), each with f32
// (4x32) or f64 (4x64) components.  The reference has no Pallas kernel for
// either; the port gives their per-pixel loops a kernel, as it did for K14.
//
// Per pixel, op for op as the plain twins (ops/quadd.py escape_qd_plain,
// ops/quadflt.py escape_qf_plain; the arithmetic in csrc/quad.cuh):
//   cx = min_x + dx*x, cy = max_y - dy*y, from the view's four-way splits
//   (x and y as (x, 0, 0, 0)); then from z = c, while the count is below
//   the budget: stop if the leading component of zx^2 + zy^2 exceeds 4;
//   else zy <- 2 zx zy + cy, zx <- zx^2 - zy^2 + cx, count += 1.  No
//   interior shortcut.
//
// What bounds it: operations.  A QD iteration is three QD products (six
// Dekker two-prods and nine two-sums each) and four QD sums, about 1,000
// dependent * and +; a QF iteration about 1,800.  Each pixel's chain is
// independent, so it takes K1's two passes (escape_passes.cuh) from one C
// call: pass 1 runs every pixel for at most `cap` iterations and lists the
// rest, pass 2 (the card's resident blocks) strides over the list.  A
// pixel's coordinate is computed in its lane from the 16 scalars (kernel
// parameters): no c grid is read.  The 4x64 state and coordinate are 16
// doubles a lane and a product keeps about 20 more live: the register
// count and spills are in ptxas's report of the build (PERF.md).
//
// The 4x64 instances, QD (fs_escape_qd_f64, K17) and QF
// (fs_escape_qf_f64, K18), have an exact fast path.  Their reference
// arithmetic flushes every f64 result through ftz() (a compare and a
// select after each operation) and forms each two-product by Dekker's
// splits (two_prod, ~16 flushed operations).  An iteration whose inputs
// the guard admits runs quad.cuh's Exact arithmetic instead: unflushed
// __dadd_rn/__dsub_rn/__dmul_rn, the two-product as one product and one
// FMA (two_prod_fma), and each square with the products it repeats
// computed once (qd_sqr; QF's df_two_sqr, x.hi*x.lo's two-product).  It
// gives the reference arithmetic's bits:
//   Let every nonzero component of zx, zy, cx and cy have an exponent in
//   [E, 500], E = -459.  A component is then an integer multiple of
//   2^(E-52); so are Dekker's split halves (2^27 + 1 is an integer, and a
//   rounded multiple of 2^k is one again).  Every product the iteration
//   forms is of two such values, a multiple of 2^(2E-104) = 2^-1022, or
//   such a product doubled: in QD the six two-products and four order-3
//   terms of each qd_mul; in QF the three two-products and x.lo*y.lo of
//   each df_two_prod, the two-product and two cross products of each
//   df_mul (A and B are the state's own pairs), and the doublings of
//   qf_sqr's cross term and of q_mul_pow2.  Sums, differences, roundings
//   and doublings keep that lattice, and the sums with c's components
//   (multiples of 2^(E-52)) too.  So every value the iteration computes,
//   each two-product's error included, is zero or at least 2^-1022 in
//   magnitude: normal, and ftz() is the identity on it (on a signed zero
//   as well).  With no underflow, and no overflow below 2^1023 (products
//   stay below 2^1002, splits below 2^529), Dekker's two-product is exact,
//   so it equals the FMA's (p, e), exactly a*b - fl(a*b), signed zeros
//   included (both give +0 for an exact product).  The FMA's two-product
//   is symmetric in its operands (fl(a*b) = fl(b*a), and the same exact
//   error is rounded once), so a square's two equal two-products are one
//   value; Dekker's error sums ahi*blo and alo*bhi in the operands' order,
//   so the refused iteration keeps both.  Both paths then run the same
//   rounded operations on the same values.
// Where QF differs from QD: qf_renorm is one double-float sum, not two
// renormalizing sweeps, so B is not held within an ulp of A.  After a
// cancellation, or where z sits at an exact value plus a small offset (z
// near 2 at c near -2: B holds the offset's square), B can sit far below
// A's last bit, or be zero.  A zero is admitted; a component below 2^-450
// is refused.  So on one frame the share of refused iterations differs
// from K17's (chip_smoke.py QF_GUARD_SCALARS); the bits do not.
// The guard (df32.cuh: kGuardLo, kGuardHi, guard_in; quad.cuh: admits)
// takes E = -450, nine binades above the bound, and tests the exponent
// bits of zx's and zy's components every iteration and cx's and cy's
// (constant) once a pixel, a few integer operations each.  A biased
// exponent of 0 is admitted as zero: no component is ever subnormal,
// since each is the result of a flushed operation or of an Exact one
// proven normal (the coordinate comes from the reference arithmetic,
// QuadFrame::at).
// An iteration the guard refuses runs the reference arithmetic, whose bits
// are then today's by construction.  The 4x32 instances keep the reference
// arithmetic: -ftz=true flushes f32 partials at 2^-126, which their low
// components reach.
// Output: int64 [H, W]; budgets below 2^31, counted in int32 as the
// reference counts.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "escape_passes.cuh"
#include "quad.cuh"

namespace {

template <class V>
struct QuadPixel {
  V cx, cy;
  int32_t budget;
  bool fast;  // the guard admits cx and cy (the 4x64 instances only)
};

// the 4x64 instances, QD and QF, have the exact fast path
template <class V>
constexpr bool kFast = std::is_same<V, fs::QDT<double>>::value ||
                       std::is_same<V, fs::QFT<double>>::value;

// V: fs::QDT<T> or fs::QFT<T>
template <class V, typename T>
struct QuadFrame {
  using Count = int32_t;
  V min_x, max_y, dx, dy;
  int32_t budget;
  __device__ __forceinline__ QuadPixel<V> at(int, int x, int y) const {
    QuadPixel<V> c = {
        fs::q_add(min_x, fs::q_mul(dx, fs::q_from_float(T(x), dx))),
        fs::q_sub(max_y, fs::q_mul(dy, fs::q_from_float(T(y), dy))), budget,
        false};
    if constexpr (kFast<V>) c.fast = fs::admits(c.cx) && fs::admits(c.cy);
    return c;
  }
};

template <class V, typename T>
struct QuadRule {
  static constexpr bool kShortcut = false;
  static __device__ __forceinline__ bool interior(const QuadPixel<V> &) {
    return false;
  }
  // one iteration in the arithmetic A: false (z kept) once lead(|z|^2) > 4
  template <class A>
  static __device__ __forceinline__ bool iterate(V &zx, V &zy,
                                                 const QuadPixel<V> &c) {
    const V zx2 = fs::q_sqr<A>(zx);
    const V zy2 = fs::q_sqr<A>(zy);
    if (fs::q_lead(fs::q_add<A>(zx2, zy2)) > T(4)) return false;
    const V nzy =
        fs::q_add<A>(fs::q_mul_pow2<A>(fs::q_mul<A>(zx, zy), T(2)), c.cy);
    zx = fs::q_add<A>(fs::q_sub<A>(zx2, zy2), c.cx);
    zy = nzy;
    return true;
  }
  static __device__ __forceinline__ bool step(V &zx, V &zy,
                                              const QuadPixel<V> &c) {
    if constexpr (kFast<V>) {
      // the exact fast path: the same values as the reference arithmetic
      if (c.fast && fs::admits(zx) && fs::admits(zy))
        return iterate<fs::Exact>(zx, zy, c);
    }
    return iterate<fs::Flushed>(zx, zy, c);
  }
  template <typename L>
  static __device__ __forceinline__ L run(const QuadPixel<V> &c, L limit) {
    V zx = c.cx, zy = c.cy;
    L it = 0;
    while (it < limit && step(zx, zy, c)) ++it;
    return it;
  }
  static __device__ __forceinline__ int32_t run_long(const QuadPixel<V> &c,
                                                     int32_t limit) {
    return run(c, limit);
  }
};

// the 16 scalars s (min_x, max_y, dx, dy; four components each, in the
// twin's order) as the frame's four values
template <typename T>
fs::QDT<T> value(const fs::QDT<T> &, const T *s) {
  return {s[0], s[1], s[2], s[3]};
}
template <typename T>
fs::QFT<T> value(const fs::QFT<T> &, const T *s) {
  return {{s[0], s[1]}, {s[2], s[3]}};
}

template <class V, typename T>
int launch(void *out, int width, int height, const T *s, int32_t max_iter,
           int32_t cap, void *later, void *counters, int parity,
           void *stream) {
  const V v{};
  const QuadFrame<V, T> f = {value(v, s), value(v, s + 4), value(v, s + 8),
                             value(v, s + 12), max_iter};
  return launch_passes<QuadRule<V, T>>(static_cast<int64_t *>(out), f, 1,
                                       width, height, max_iter, cap, later,
                                       counters, parity, stream);
}

}  // namespace

// K17 (fs_escape_qd_*) and K18 (fs_escape_qf_*).  out: int64 [height,
// width]; the 16 scalars s0..s15 (min_x, max_y, dx, dy, four components
// each) passed one by one; max_iter below 2^31; cap, later, counters,
// parity as K1's (escape.cu).
#define FS_QUAD_ENTRY(NAME, V, T)                                           \
  extern "C" int NAME(void *out, int32_t width, int32_t height, T s0, T s1,  \
                      T s2, T s3, T s4, T s5, T s6, T s7, T s8, T s9, T s10, \
                      T s11, T s12, T s13, T s14, T s15, int32_t max_iter,   \
                      int32_t cap, void *later, void *counters,              \
                      int32_t parity, void *stream) {                        \
    const T s[16] = {s0, s1, s2,  s3,  s4,  s5,  s6,  s7,                    \
                     s8, s9, s10, s11, s12, s13, s14, s15};                  \
    return launch<V, T>(out, width, height, s, max_iter, cap, later,         \
                        counters, parity, stream);                           \
  }

FS_QUAD_ENTRY(fs_escape_qd_f32, fs::QDT<float>, float)
FS_QUAD_ENTRY(fs_escape_qd_f64, fs::QDT<double>, double)
FS_QUAD_ENTRY(fs_escape_qf_f32, fs::QFT<float>, float)
FS_QUAD_ENTRY(fs_escape_qf_f64, fs::QFT<double>, double)
