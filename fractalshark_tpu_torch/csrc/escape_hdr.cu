// K13: plain escape time in HDR arithmetic (CpuHDR32, CpuHDR64, GpuHDRx32).
//
// Replaces: fractalshark_tpu/ops/hdr_escape.py:93 _escape_hdr_impl (XLA,
// its loop hdr_escape_tile :47), f32 or f64 mantissas with int32
// exponents.  The reference has no Pallas kernel for it; the port gives
// its per-pixel loop a kernel, as it did for escape_jax (K1).
//
// Per pixel, op for op as the plain twin (ops/hdr_escape.py):
//   c = (reduce(min_x + reduce(x*dx_m, dx_e)), reduce(max_y - reduce(y*dy_m,
//   dy_e))), the view's exact (mantissa, exponent) splits, the product
//   x*dx_m in the mantissa type; then from z = c, while the count is below
//   the budget: |z|^2 = reduce(zx^2 + zy^2); stop if it is above HDR(1, 2)
//   = 4; else zy <- reduce(2 zx zy + cy), zx <- reduce(zx^2 - zy^2 + cx),
//   count += 1.  No interior shortcut (the reference has none here).  f64
//   results are flushed in code (hdr.cuh ftz), as XLA:CPU flushes them.
//
// What bounds it: the iterations of the pixels inside or near the set,
// which run the whole budget while most others end in a few.  So it takes
// K1's two passes (escape_passes.cuh) from one C call: pass 1 runs every
// pixel for at most `cap` iterations and lists the rest; pass 2, the
// card's resident blocks, strides over the list, so its warps hold only
// long pixels.  A pixel's coordinate is computed in its lane from the four
// splits: no c grid is read.
//
// Its first form ran every iteration in HDR arithmetic: three aligned adds
// (an exponent compare, a clamp, a power of two and a scaling product
// each), three reductions off the bits, and in f64 a flush of every
// result; about 80 operations an iteration, most of them integer work.
// On the frames users render almost every value is far from both ends of
// the mantissa type, and there an HDR operation's mantissa is the plain
// operation's result scaled by a power of two.  So an iteration whose zx
// and zy are each zero or of a (reduced) exponent in the window W =
// [kWinLo, kWinHi] = [-30, 30], in a pixel whose cx and cy are zero or of
// an exponent in [kWinLo, kCHi] = [-30, 28] (tested once, after
// HdrFrame::at), runs on the values v = m 2^e in the
// mantissa type T, K1's iteration with the twin's operations in its order:
// stop when zx zx + zy zy > 4, else zy <- (2 zx) zy + cy, zx <- (zx zx -
// zy zy) + cx (no FMA: -fmad=false; no ftz() in f64: no result there is
// subnormal, below).  An iteration the window refuses runs HdrRule::step,
// the reference arithmetic, unchanged.  The state passes between the forms
// by reduce() one way and m 2^e the other, both exact in W; the HDR state
// is reduced after every step, so its (m, e) is a function of its value
// (m in +-[1, 2), or a signed zero with the sentinel exponent).
//
// Why the value form gives the HDR step's bits, for operands in W (p = 24
// mantissa bits in f32, 53 in f64; every nonzero mantissa of a reduced
// operand in [1, 2), a multiple of 2^(1-p)):
//  * every value is zero or in [2^-30, 2^31), so every product of two
//    nonzero values lies in [2^-60, 2^62] and every sum below 2^64: no
//    value-form result is subnormal or infinite (the results below are
//    multiples of 2^(-60+1-p), nonzero ones at least that);
//  * the HDR squares and product have mantissas in [1, 4), multiples of
//    2^(1-p), and exponents in [-60, 61];
//  * the HDR magnitude sum and difference align two squares, a gap of at
//    most 120; the scaled mantissa (at least 2^-120) is normal and exact,
//    and the difference's mantissa ms is a multiple of 2^(-1-p) (a gap of
//    at most 2: the exact difference, a multiple of 2^(-1-p), rounds to
//    one; of 3 and more |ms| > 1/2, a multiple of its ulp);
//  * the sums with cx and cy align an operand of exponent in [-60, 61]
//    with one in [-30, 30]: a gap of at most 91, so no clamp at
//    kExpDiffClamp = 126, the scaled operand (at least 2^(-1-p-91) when
//    nonzero) is normal, and the exact sum, a multiple of 2^(-1-p-91),
//    is zero or normal (f32: 2^-116 > 2^-126);
//  * so every HDR operation's mantissa is the value operation's result
//    times a power of two, rounded alike; reduce() then gives the value
//    form's (m, e).  Zeros: an exact 0 from zx^2 - zy^2 keeps the
//    exponent max(2 ex, 2 ey) <= 60, within 91 of cx's (the case a wider
//    window breaks: past a gap of 126 hdr_add(0 2^e, cx) gives cx
//    2^(e - 126)); a zero operand (the sentinel kMinBigExponent, or a
//    product with one) meets a nonzero one only as the smaller operand,
//    scaled to a zero; and signed zeros add as in the value form (-0 only
//    when both are -0; a product's sign is the product of the signs).
// The escape compare gt_reduced(mag, HDR(1, 2)) is mag > 4 on the value.
// The window's upper end needs no test in the value form's loop: z enters
// it below 2^31 (c, or an HDR value the window admitted), and an iteration
// runs only when |z|^2 <= 4, so it leaves |z| <= 4 + |c| < 2^30 with |c| <
// 2^29; the loop tests the lower end alone (above_floor), and the HDR form
// both ends before it hands z back.
// tests/test_torch_hdr_fast.py mirrors both forms and the window on the
// CPU against the twin and the JAX package.
// Output: int64 [H, W]; budgets below 2^31, counted in int32, as the
// reference counts (its int32 budget refuses 2^31).

#include <cuda_runtime.h>

#include <cstdint>

#include "escape_passes.cuh"
#include "hdr.cuh"

namespace {

template <typename T>
using Hdr = fs::HdrT<T>;

// the window W on reduced exponents (the argument above); a pixel's c is
// admitted below kCHi, so that z stays below 2^30 by itself
constexpr int32_t kWinLo = -30;
constexpr int32_t kWinHi = 30;
constexpr int32_t kCHi = 28;

template <typename T>
struct HdrPixel {
  Hdr<T> cx, cy;
  int32_t budget;
  bool fast;  // cx and cy in [kWinLo, kCHi] or zero: the value form may run
};

// a reduced HDR value zero or of an exponent in [kWinLo, hi]
template <typename T>
__device__ __forceinline__ bool in_window(Hdr<T> h, int32_t hi = kWinHi) {
  return (h.m == T(0)) |
         (static_cast<uint32_t>(h.e - kWinLo) <=
          static_cast<uint32_t>(hi - kWinLo));
}

// a value of the value form zero or at least 2^kWinLo in magnitude (its
// upper end holds by itself: the header): f32 by float compares, f64 by
// the high word (the f64 pipe is the scarcer one; a zero is the only
// value here whose high word is 0, none is subnormal)
__device__ __forceinline__ bool above_floor(float v) {
  return (fabsf(v) >= 0x1p-30f) | (v == 0.0f);
}
__device__ __forceinline__ bool above_floor(double v) {
  const uint32_t h = static_cast<uint32_t>(__double2hiint(v)) & 0x7FFFFFFFu;
  return h - 1u >= (static_cast<uint32_t>(1023 + kWinLo) << 20) - 1u;
}

// the frame: the four splits (hdr_escape.py view_to_hdr_params)
template <typename T>
struct HdrFrame {
  using Count = int32_t;
  Hdr<T> min_x, max_y, dx, dy;
  int32_t budget;
  __device__ __forceinline__ HdrPixel<T> at(int, int x, int y) const {
    const Hdr<T> xdx = fs::reduce(Hdr<T>{fs::ftz(static_cast<T>(x) * dx.m),
                                         dx.e});
    const Hdr<T> ydy = fs::reduce(Hdr<T>{fs::ftz(static_cast<T>(y) * dy.m),
                                         dy.e});
    const Hdr<T> cx = fs::reduce(fs::hdr_add(min_x, xdx));
    const Hdr<T> cy = fs::reduce(fs::hdr_sub(max_y, ydy));
    return {cx, cy, budget, in_window(cx, kCHi) && in_window(cy, kCHi)};
  }
};

template <typename T>
struct HdrRule {
  static constexpr bool kShortcut = false;
  static __device__ __forceinline__ bool interior(const HdrPixel<T> &) {
    return false;
  }
  // one iteration (hdr_escape_tile's step): false (z kept) once |z|^2 > 4
  static __device__ __forceinline__ bool step(Hdr<T> &zx, Hdr<T> &zy,
                                              const HdrPixel<T> &c) {
    const Hdr<T> zx2 = fs::hdr_square(zx);
    const Hdr<T> zy2 = fs::hdr_square(zy);
    const Hdr<T> mag = fs::reduce(fs::hdr_add(zx2, zy2));
    if (fs::gt_reduced(mag, Hdr<T>{T(1), 2})) return false;
    const Hdr<T> nzy = fs::reduce(
        fs::hdr_add(fs::hdr_mul_pow2(fs::hdr_mul(zx, zy), 1), c.cy));
    zx = fs::reduce(fs::hdr_add(fs::hdr_sub(zx2, zy2), c.cx));
    zy = nzy;
    return true;
  }
  // the value of a reduced HDR number in W (exact), and back
  static __device__ __forceinline__ T value(Hdr<T> h) {
    return h.m * fs::pow2i<T>(h.e);
  }
  static __device__ __forceinline__ Hdr<T> hdr(T v) {
    return fs::reduce(Hdr<T>{v, 0});
  }
  // the count of at most `limit` iterations from z = c: the value form
  // while the window admits z (and c), the HDR form while it does not
  template <typename L>
  static __device__ __forceinline__ L run(const HdrPixel<T> &c, L limit) {
    Hdr<T> zx = c.cx, zy = c.cy;
    L it = 0;
    if (c.fast) {
      const T cx = value(c.cx), cy = value(c.cy);
      T vx = cx, vy = cy;
      for (;;) {
        // the value form, one exit: the budget, the window or the escape
        for (;;) {
          const T x2 = vx * vx;
          const T y2 = vy * vy;
          const bool go = (it < limit) & above_floor(vx) & above_floor(vy) &
                          !(x2 + y2 > T(4));
          if (!go) break;
          const T ny = (T(2) * vx) * vy + cy;
          vx = (x2 - y2) + cx;
          vy = ny;
          ++it;
        }
        if (it >= limit || (above_floor(vx) && above_floor(vy))) return it;
        zx = hdr(vx);
        zy = hdr(vy);
        do {
          if (!step(zx, zy, c)) return it;
          ++it;
        } while (it < limit && !(in_window(zx) && in_window(zy)));
        if (it >= limit) return it;
        vx = value(zx);
        vy = value(zy);
      }
    }
    while (it < limit && step(zx, zy, c)) ++it;
    return it;
  }
  static __device__ __forceinline__ int32_t run_long(const HdrPixel<T> &c,
                                                     int32_t limit) {
    return run(c, limit);
  }
};

template <typename T>
int launch(void *out, int width, int height, T min_x_m, int32_t min_x_e,
           T max_y_m, int32_t max_y_e, T dx_m, int32_t dx_e, T dy_m,
           int32_t dy_e, int32_t max_iter, int32_t cap, void *later,
           void *counters, int parity, void *stream) {
  const HdrFrame<T> f = {{min_x_m, min_x_e}, {max_y_m, max_y_e},
                         {dx_m, dx_e},       {dy_m, dy_e},
                         max_iter};
  return launch_passes<HdrRule<T>>(static_cast<int64_t *>(out), f, 1, width,
                                   height, max_iter, cap, later, counters,
                                   parity, stream);
}

}  // namespace

// K13.  out: int64 [height, width]; the splits (mantissa, exponent) of
// min_x, max_y, dx, dy; max_iter below 2^31; cap, later, counters, parity
// as K1's (escape.cu).
extern "C" int fs_escape_hdr_f32(void *out, int32_t width, int32_t height,
                                 float min_x_m, int32_t min_x_e,
                                 float max_y_m, int32_t max_y_e, float dx_m,
                                 int32_t dx_e, float dy_m, int32_t dy_e,
                                 int32_t max_iter, int32_t cap, void *later,
                                 void *counters, int32_t parity,
                                 void *stream) {
  return launch<float>(out, width, height, min_x_m, min_x_e, max_y_m,
                       max_y_e, dx_m, dx_e, dy_m, dy_e, max_iter, cap, later,
                       counters, parity, stream);
}

extern "C" int fs_escape_hdr_f64(void *out, int32_t width, int32_t height,
                                 double min_x_m, int32_t min_x_e,
                                 double max_y_m, int32_t max_y_e, double dx_m,
                                 int32_t dx_e, double dy_m, int32_t dy_e,
                                 int32_t max_iter, int32_t cap, void *later,
                                 void *counters, int32_t parity,
                                 void *stream) {
  return launch<double>(out, width, height, min_x_m, min_x_e, max_y_m,
                        max_y_e, dx_m, dx_e, dy_m, dy_e, max_iter, cap, later,
                        counters, parity, stream);
}
