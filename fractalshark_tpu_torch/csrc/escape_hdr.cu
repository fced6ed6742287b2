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
// What bounds it: the iterations, each a chain of about 40 dependent
// operations (three aligned adds, each with its exponent compare and
// scale, three reductions), of the pixels inside or near the set, which
// run the whole budget while most others end in a few.  So it takes K1's
// two passes (escape_passes.cuh) from one C call: pass 1 runs every pixel
// for at most `cap` iterations and lists the rest; pass 2, the card's
// resident blocks, strides over the list, so its warps hold only long
// pixels.  A pixel's coordinate is computed in its lane from the four
// splits: no c grid is read.
// Output: int64 [H, W]; budgets below 2^31, counted in int32, as the
// reference counts (its int32 budget refuses 2^31).

#include <cuda_runtime.h>

#include <cstdint>

#include "escape_passes.cuh"
#include "hdr.cuh"

namespace {

template <typename T>
using Hdr = fs::HdrT<T>;

template <typename T>
struct HdrPixel {
  Hdr<T> cx, cy;
  int32_t budget;
};

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
    return {fs::reduce(fs::hdr_add(min_x, xdx)),
            fs::reduce(fs::hdr_sub(max_y, ydy)), budget};
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
  template <typename L>
  static __device__ __forceinline__ L run(const HdrPixel<T> &c, L limit) {
    Hdr<T> zx = c.cx, zy = c.cy;
    L it = 0;
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
