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
// Output: int64 [H, W]; budgets below 2^31, counted in int32 as the
// reference counts.

#include <cuda_runtime.h>

#include <cstdint>

#include "escape_passes.cuh"
#include "quad.cuh"

namespace {

template <class V>
struct QuadPixel {
  V cx, cy;
  int32_t budget;
};

// V: fs::QDT<T> or fs::QFT<T>
template <class V, typename T>
struct QuadFrame {
  using Count = int32_t;
  V min_x, max_y, dx, dy;
  int32_t budget;
  __device__ __forceinline__ QuadPixel<V> at(int, int x, int y) const {
    return {fs::q_add(min_x, fs::q_mul(dx, fs::q_from_float(T(x), dx))),
            fs::q_sub(max_y, fs::q_mul(dy, fs::q_from_float(T(y), dy))),
            budget};
  }
};

template <class V, typename T>
struct QuadRule {
  static constexpr bool kShortcut = false;
  static __device__ __forceinline__ bool interior(const QuadPixel<V> &) {
    return false;
  }
  // one iteration: false (z kept) once lead(|z|^2) > 4
  static __device__ __forceinline__ bool step(V &zx, V &zy,
                                              const QuadPixel<V> &c) {
    const V zx2 = fs::q_sqr(zx);
    const V zy2 = fs::q_sqr(zy);
    if (fs::q_lead(fs::q_add(zx2, zy2)) > T(4)) return false;
    const V nzy = fs::q_add(fs::q_mul_pow2(fs::q_mul(zx, zy), T(2)), c.cy);
    zx = fs::q_add(fs::q_sub(zx2, zy2), c.cx);
    zy = nzy;
    return true;
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
