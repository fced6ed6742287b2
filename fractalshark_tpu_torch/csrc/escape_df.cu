// K14: plain escape time in double-float arithmetic (Gpu2x32, Gpu2x64).
//
// Replaces: fractalshark_tpu/ops/dblflt.py:143 _escape_df_impl (XLA), z and
// c as unevaluated (hi, lo) sums of two f32 (2x32, ~48 mantissa bits) or
// two f64 (2x64, ~106).  The reference has no Pallas kernel for it; the
// port gives its per-pixel loop a kernel, as it did for escape_jax (K1).
//
// Per pixel, op for op as the plain twin (ops/dblflt.py escape_df_plain):
//   cx = min_x + dx*x, cy = max_y - dy*y (df_mul_float, df_add, df_sub),
//   from the view's exact (hi, lo) splits; then from z = c, while the
//   count is below the budget: stop if (zx^2 + zy^2).hi > 4; else
//   zy <- 2 zx zy + cy, zx <- zx^2 - zy^2 + cx, count += 1.  No interior
//   shortcut.  The error-free transforms need every * and + rounded on its
//   own (csrc/df32.cuh, -fmad=false); f64 results are flushed in code, as
//   XLA:CPU flushes them.
//
// What bounds it: the iterations of the pixels inside or near the set,
// each a chain of dependent operations (two squares and a product, four
// double-float sums), while most other pixels end in a few.  So it takes
// K1's two passes (escape_passes.cuh) from one C call: pass 1 runs every
// pixel for at most `cap` iterations and lists the rest; pass 2, the
// card's resident blocks, strides over the list, so its warps hold only
// long pixels.  A pixel's coordinate is computed in its lane from the
// four splits: no c grid is read.
//
// The 2x64 instance (fs_escape_df_f64) has an exact fast path.  Its
// reference arithmetic flushes every f64 result through ftz() (a compare
// and a select after each operation) and forms each two-product by
// Dekker's splits (two_prod, ~17 flushed operations), ~150 operations an
// iteration.  An iteration whose inputs the guard admits runs df32.cuh's
// Exact arithmetic instead: unflushed __dadd_rn/__dsub_rn/__dmul_rn and
// the two-product as one product and one FMA (two_prod_fma), ~107
// operations (squares of 8, a product of 9, four double-float sums of
// 20, the doubling).  It gives the reference arithmetic's bits:
//   Let every nonzero component of zx, zy, cx and cy have an exponent in
//   [E, 500], E = -459.  A component is then an integer multiple of
//   2^(E-52); so are Dekker's split halves of one (2^27 + 1 is an
//   integer, and a rounded multiple of 2^k is one again) and its double
//   (2 a.hi in the square's cross term).  Every product the iteration
//   forms is of two such values: the two-products a.hi*b.hi and
//   a.hi*a.hi and their split partials, the cross terms a.hi*b.lo,
//   a.lo*b.hi and (2 a.hi)*a.lo, so each is a multiple of 2^(2E-104) =
//   2^-1022, as is the doubling of such a sum.  The rest are sums and
//   differences: the two-sums and quick-two-sums of the four double-float
//   sums, the error terms they fold in, and the sums with c's components
//   (multiples of 2^(E-52), so of 2^-1022 too); they and their roundings
//   keep that lattice.  So every value the iteration computes, each
//   two-product's error included, is zero or at least 2^-1022 in
//   magnitude: normal, and ftz() is the identity on it (on a signed zero
//   as well).  Nothing overflows: components are below 2^501, products
//   below 2^1002, a split's scaled operand below 2^529, and the few-term
//   sums below 2^1006.  With no underflow and no overflow Dekker's
//   two-product is exact, so it equals the FMA's (p, e), exactly
//   a*b - fl(a*b) (+0 from both when the product is exact).  Both paths
//   then run the same rounded operations on the same values.
// The guard (df32.cuh: kGuardLo, kGuardHi, admits; K17 4x64's) takes
// E = -450, nine binades above the bound, and tests the exponent bits of
// zx's and zy's components every iteration and cx's and cy's (constant)
// once a pixel.  A biased exponent of 0 is admitted as zero: no component
// is ever subnormal, since each is the result of a flushed operation or
// of an Exact one proven normal (the coordinate comes from the reference
// arithmetic, DfFrame::at).  An iteration the guard refuses runs the
// reference arithmetic, whose bits are then today's by construction.
// The 2x32 instance keeps the reference arithmetic: -ftz=true flushes f32
// partials at 2^-126, which its low components reach.
// Output: int64 [H, W]; budgets below 2^31, counted in int32, as the
// reference counts (its int32 budget refuses 2^31).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "df32.cuh"
#include "escape_passes.cuh"

namespace {

template <typename T>
using DF = fs::DFT<T>;

template <typename T>
struct DfPixel {
  DF<T> cx, cy;
  int32_t budget;
  bool fast;  // the guard admits cx and cy (fs_escape_df_f64 only)
};

// only the 2x64 instance has the exact fast path
template <typename T>
constexpr bool kFast = std::is_same<T, double>::value;

template <typename T>
struct DfFrame {
  using Count = int32_t;
  DF<T> min_x, max_y, dx, dy;
  int32_t budget;
  __device__ __forceinline__ DfPixel<T> at(int, int x, int y) const {
    DfPixel<T> c = {
        fs::df_add(min_x, fs::df_mul_float(dx, static_cast<T>(x))),
        fs::df_sub(max_y, fs::df_mul_float(dy, static_cast<T>(y))), budget,
        false};
    if constexpr (kFast<T>) c.fast = fs::admits(c.cx) && fs::admits(c.cy);
    return c;
  }
};

template <typename T>
struct DfRule {
  static constexpr bool kShortcut = false;
  static __device__ __forceinline__ bool interior(const DfPixel<T> &) {
    return false;
  }
  // one iteration (_escape_df_impl's step): false (z kept) once
  // (|z|^2).hi > 4
  static __device__ __forceinline__ bool step(DF<T> &zx, DF<T> &zy,
                                              const DfPixel<T> &c) {
    if constexpr (kFast<T>) {
      if (c.fast && fs::admits(zx) && fs::admits(zy)) {
        // the exact fast path: the same values as below
        using A = fs::Exact;
        const DF<T> zx2 = fs::df_sqr<A>(zx);
        const DF<T> zy2 = fs::df_sqr<A>(zy);
        if (fs::df_add<A>(zx2, zy2).hi > T(4)) return false;
        const DF<T> nzy = fs::df_add<A>(
            fs::df_mul_pow2<A>(fs::df_mul<A>(zx, zy), T(2)), c.cy);
        zx = fs::df_add<A>(fs::df_sub<A>(zx2, zy2), c.cx);
        zy = nzy;
        return true;
      }
    }
    const DF<T> zx2 = fs::df_sqr(zx);
    const DF<T> zy2 = fs::df_sqr(zy);
    if (fs::df_add(zx2, zy2).hi > T(4)) return false;
    const DF<T> nzy =
        fs::df_add(fs::df_mul_pow2(fs::df_mul(zx, zy), T(2)), c.cy);
    zx = fs::df_add(fs::df_sub(zx2, zy2), c.cx);
    zy = nzy;
    return true;
  }
  template <typename L>
  static __device__ __forceinline__ L run(const DfPixel<T> &c, L limit) {
    DF<T> zx = c.cx, zy = c.cy;
    L it = 0;
    while (it < limit && step(zx, zy, c)) ++it;
    return it;
  }
  static __device__ __forceinline__ int32_t run_long(const DfPixel<T> &c,
                                                     int32_t limit) {
    return run(c, limit);
  }
};

template <typename T>
int launch(void *out, int width, int height, const T *s, int32_t max_iter,
           int32_t cap, void *later, void *counters, int parity,
           void *stream) {
  const DfFrame<T> f = {{s[0], s[1]}, {s[2], s[3]}, {s[4], s[5]},
                        {s[6], s[7]}, max_iter};
  return launch_passes<DfRule<T>>(static_cast<int64_t *>(out), f, 1, width,
                                  height, max_iter, cap, later, counters,
                                  parity, stream);
}

}  // namespace

// K14.  out: int64 [height, width]; min_x, max_y, dx, dy as (hi, lo)
// pairs, passed one by one (min_x_hi, min_x_lo, ..., dy_lo); max_iter
// below 2^31; cap, later, counters, parity as K1's (escape.cu).
extern "C" int fs_escape_df_f32(void *out, int32_t width, int32_t height,
                                float s0, float s1, float s2, float s3,
                                float s4, float s5, float s6, float s7,
                                int32_t max_iter, int32_t cap, void *later,
                                void *counters, int32_t parity,
                                void *stream) {
  const float s[8] = {s0, s1, s2, s3, s4, s5, s6, s7};
  return launch<float>(out, width, height, s, max_iter, cap, later, counters,
                       parity, stream);
}

extern "C" int fs_escape_df_f64(void *out, int32_t width, int32_t height,
                                double s0, double s1, double s2, double s3,
                                double s4, double s5, double s6, double s7,
                                int32_t max_iter, int32_t cap, void *later,
                                void *counters, int32_t parity,
                                void *stream) {
  const double s[8] = {s0, s1, s2, s3, s4, s5, s6, s7};
  return launch<double>(out, width, height, s, max_iter, cap, later,
                        counters, parity, stream);
}
