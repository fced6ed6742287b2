// K1 and K1-seq: plain escape time, in two passes of one shared source.
//
// K1, one frame.  Replaces: fractalshark_tpu/ops/escape.py:211
// _escape_kernel (Pallas, B1; launch _escape_pallas_impl :236) for the f32
// instance, and the XLA lockstep loop escape_jax (escape.py:120) that the
// reference runs for f64 (engine/fractal.py:180-184).
// K1-seq, a sequence of K frames in one call.  Replaces:
// fractalshark_tpu/ops/escape.py:220 _escape_seq_kernel (Pallas, B13;
// launch _escape_seq_impl :285, API escape_pallas_sequence :310).
//
// Two semantics (Rule below), each the reference route's:
//   tile (kTile): _escape_tile's (escape.py:144-208), the f32 single frame
//     below a budget of 2^31 and every frame of a sequence, f32 or f64:
//     pixels inside the main cardioid or the period-2 bulb get the budget
//     without iterating (:166-178); the others count while |z|^2 <= 4
//     (:193), at most the budget (the reference clamps, :208); every
//     result flushed (hdr.cuh ftz), as XLA:CPU flushes the reference's f32
//     and f64 tile.  The budget is the frame type's value converted to
//     int32 (f32: 2^24 + 1 runs as 2^24, as the reference's table gives it;
//     the single frame's wrapper passes it so, a sequence's table holds it
//     in the frame type and the conversion here saturates).
//   loop: escape_jax's, the f64 single frame and f32 at budgets of 2^31 or
//     more (the reference sends both there): "if |z|^2 > 4 break" before
//     each update, no interior shortcut (escape_jax has none; the golden
//     CRC of tests/test_escape.py is taken on it), int64 budgets and
//     counts, f64 results unflushed (f32 flushes in hardware, -ftz=true).
// Counting stops at the first |z|^2 > 4: past it z diverges monotonically
// (escape.py:149-153), so no later step counts, as in the reference.
// Pixel coordinates: cx = min_x + x*dx, cy = max_y - y*dy in the frame
// type, so no input is read but the frame's five numbers.
//
// What bounds it: the iterations (7 operations each) of the pixels the
// shortcut leaves, most of them a few, a few hundredths the whole budget.
// With one lane a pixel a warp holding one long pixel runs the budget while
// its other lanes idle (on View 0 1024² x 256 the lanes' iterations are
// 2.96x the pixels' own).  So both run in two passes, launched by one C
// entry call with no sync between them (the schedule of
// escape_passes.cuh, which K13 and K14 share): pass 1, one lane a pixel,
// runs at most `cap` iterations and lists the pixels still running; pass
// 2, the card's resident blocks, strides over the list and runs each from
// its coordinate to the end in rounds of kRound iterations with no branch
// (Rule::run_long): with few warps on the card a pixel's chain of
// dependent operations paces pass 2, and a test and branch after every
// iteration lengthened it.
// Output: int64 [H, W] for a frame (the engine's grid), int32 [K, H, W]
// for a sequence (its public form is uint32).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "escape_passes.cuh"
#include "hdr.cuh"

namespace {

constexpr int32_t kSeqCap = 64;   // pass 1's iterations in a sequence
constexpr int kRound = 8;         // iterations a round of pass 2

template <typename T, typename C>
struct Pixel {
  T cx, cy;
  C budget;
};

// the arithmetic of one semantics
template <typename T, bool kTile>
struct Rule {
  static constexpr bool kShortcut = kTile;
  static __device__ __forceinline__ T fl(T v) {
    return kTile ? fs::ftz(v) : v;
  }
  // _escape_tile's shortcut: c in the main cardioid or the period-2 bulb
  static __device__ __forceinline__ bool interior(T cx, T cy) {
    const T xq = fl(cx - static_cast<T>(0.25));
    const T cy2 = fl(cy * cy);
    const T q = fl(fl(xq * xq) + cy2);
    const T cx1 = fl(cx + static_cast<T>(1.0));
    return fl(q * fl(q + xq)) <= fl(static_cast<T>(0.25) * cy2) ||
           fl(fl(cx1 * cx1) + cy2) <= static_cast<T>(0.0625);
  }
  // whether an iteration counts: |z|^2 <= 4 (tile), not |z|^2 > 4 (loop)
  static __device__ __forceinline__ bool counts(T mag) {
    return kTile ? mag <= static_cast<T>(4.0) : !(mag > static_cast<T>(4.0));
  }
  // one iteration: false (z kept) once |z|^2 > 4
  static __device__ __forceinline__ bool step(T &zx, T &zy, T cx, T cy) {
    const T zx2 = fl(zx * zx);
    const T zy2 = fl(zy * zy);
    if (!counts(fl(zx2 + zy2))) return false;
    const T nzy = fl(fl(fl(zx + zx) * zy) + cy);
    zx = fl(fl(zx2 - zy2) + cx);
    zy = nzy;
    return true;
  }
  // the loop from z = c for at most `limit` iterations: the count (below
  // `limit` only if z escaped).  Pass 1's form, for pixels most of which
  // escape within a few iterations: a test after every iteration, one
  // budget test for four.
  template <typename C>
  static __device__ __forceinline__ C run(T cx, T cy, C limit) {
    T zx = cx, zy = cy;
    C it = 0;
    while (it <= limit - 4) {
      if (!step(zx, zy, cx, cy)) return it;
      if (!step(zx, zy, cx, cy)) return it + 1;
      if (!step(zx, zy, cx, cy)) return it + 2;
      if (!step(zx, zy, cx, cy)) return it + 3;
      it += 4;
    }
    while (it < limit && step(zx, zy, cx, cy)) ++it;
    return it;
  }
  // the same count, pass 2's form, for pixels that run long: kRound
  // iterations a round with no branch, their tests folded into one
  // predicate, so only the chain of z's update paces an iteration; the
  // round in which z escapes is run again from its start one iteration
  // at a time, and so is the rest below kRound.
  template <typename C>
  static __device__ __forceinline__ C run_long(T cx, T cy, C limit) {
    T zx = cx, zy = cy;
    C it = 0;
    while (it <= limit - kRound) {
      const T sx = zx, sy = zy;
      bool alive = true;
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const T zx2 = fl(zx * zx);
        const T zy2 = fl(zy * zy);
        alive &= counts(fl(zx2 + zy2));
        const T nzy = fl(fl(fl(zx + zx) * zy) + cy);
        zx = fl(fl(zx2 - zy2) + cx);
        zy = nzy;
      }
      if (!alive) {
        zx = sx;
        zy = sy;
        break;
      }
      it += kRound;
    }
    while (it < limit && step(zx, zy, cx, cy)) ++it;
    return it;
  }
  // the schedule's interface (escape_passes.cuh)
  template <typename C>
  static __device__ __forceinline__ bool interior(const Pixel<T, C> &c) {
    return interior(c.cx, c.cy);
  }
  template <typename C, typename L>
  static __device__ __forceinline__ L run(const Pixel<T, C> &c, L limit) {
    return run(c.cx, c.cy, limit);
  }
  template <typename C>
  static __device__ __forceinline__ C run_long(const Pixel<T, C> &c,
                                               C limit) {
    return run_long(c.cx, c.cy, limit);
  }
};

// one frame, passed by value: an int64 budget, counted in int64 by the
// loop and in int32 by the tile (whose frames pass the f32 value of
// theirs, below 2^31); y0, the frame's first row in a taller image: cy =
// max_y - (y0 + y)*dy, escape_jax's row offset (escape.py:120-128), so
// that a band equals those rows of the whole image bit for bit
template <typename T, bool kTile>
struct OneFrame {
  using Count = std::conditional_t<kTile, int32_t, int64_t>;
  T min_x, max_y, dx, dy;
  int32_t y0;
  int64_t budget;
  __device__ __forceinline__ Pixel<T, Count> at(int, int x, int y) const {
    using R = Rule<T, kTile>;
    return {R::fl(min_x + R::fl(static_cast<T>(x) * dx)),
            R::fl(max_y - R::fl(static_cast<T>(y0 + y) * dy)),
            static_cast<Count>(budget)};
  }
};

// frame k of a sequence from the [K, 5] table (min_x, max_y, dx, dy,
// budget) in the frame type in device memory, as the reference's SMEM
// table; tile semantics
template <typename T>
struct FrameTable {
  using Count = int32_t;
  const T *params;
  __device__ __forceinline__ Pixel<T, int32_t> at(int k, int x, int y) const {
    using R = Rule<T, true>;
    const T *p = params + 5 * k;
    return {R::fl(p[0] + R::fl(static_cast<T>(x) * p[2])),
            R::fl(p[1] - R::fl(static_cast<T>(y) * p[3])),
            static_cast<int32_t>(p[4])};
  }
};

template <typename T, bool kTile>
int launch_frame(void *out, int width, int height, T min_x, T max_y, T dx,
                 T dy, int32_t y0, int64_t max_iter, int32_t cap,
                 void *later, void *counters, int parity, void *stream) {
  if (y0 < 0 || int64_t{y0} + height > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const OneFrame<T, kTile> f = {min_x, max_y, dx, dy, y0, max_iter};
  return launch_passes<Rule<T, kTile>>(static_cast<int64_t *>(out), f, 1,
                                       width, height, max_iter, cap, later,
                                       counters, parity, stream);
}

template <typename T>
int launch_seq(void *out, const void *params, int frames, int width,
               int height, void *later, void *counters, int parity,
               void *stream) {
  const FrameTable<T> f = {static_cast<const T *>(params)};
  // the budgets are on the card: pass 2 always runs
  return launch_passes<Rule<T, true>>(static_cast<int32_t *>(out), f,
                                      frames, width, height, INT64_MAX,
                                      kSeqCap, later, counters, parity,
                                      stream);
}

}  // namespace

extern "C" {

const char *fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1.  out: int64 [height, width]; later: device scratch of one uint32 a
// pixel (the pass-2 list); counters: uint32 [2] on the card, the one at
// `parity` zero on entry (pass 1 zeroes the other); cap: pass 1's
// iterations (>= max_iter: one pass).  Fewer than 2^32 pixels.  y0: the
// frame's first row (0 <= y0, y0 + height < 2^31).
// f32 tile: max_iter is the f32 value of the budget, below 2^31.
int fs_escape_f32(void *out, int32_t width, int32_t height, float min_x,
                  float max_y, float dx, float dy, int32_t y0,
                  int64_t max_iter, int32_t cap, void *later, void *counters,
                  int32_t parity, void *stream) {
  return launch_frame<float, true>(out, width, height, min_x, max_y, dx, dy,
                                   y0, max_iter, cap, later, counters,
                                   parity, stream);
}

int fs_escape_f32_loop(void *out, int32_t width, int32_t height, float min_x,
                       float max_y, float dx, float dy, int32_t y0,
                       int64_t max_iter, int32_t cap, void *later,
                       void *counters, int32_t parity, void *stream) {
  return launch_frame<float, false>(out, width, height, min_x, max_y, dx, dy,
                                    y0, max_iter, cap, later, counters,
                                    parity, stream);
}

int fs_escape_f64(void *out, int32_t width, int32_t height, double min_x,
                  double max_y, double dx, double dy, int32_t y0,
                  int64_t max_iter, int32_t cap, void *later, void *counters,
                  int32_t parity, void *stream) {
  return launch_frame<double, false>(out, width, height, min_x, max_y, dx,
                                     dy, y0, max_iter, cap, later, counters,
                                     parity, stream);
}

// K1-seq.  out: int32 [frames, height, width]; params: [frames, 5] in the
// frame type on the card; later, counters, parity as K1's.
int fs_escape_seq_f32(void *out, const void *params, int32_t frames,
                      int32_t width, int32_t height, void *later,
                      void *counters, int32_t parity, void *stream) {
  return launch_seq<float>(out, params, frames, width, height, later,
                           counters, parity, stream);
}

int fs_escape_seq_f64(void *out, const void *params, int32_t frames,
                      int32_t width, int32_t height, void *later,
                      void *counters, int32_t parity, void *stream) {
  return launch_seq<double>(out, params, frames, width, height, later,
                            counters, parity, stream);
}

}  // extern "C"
