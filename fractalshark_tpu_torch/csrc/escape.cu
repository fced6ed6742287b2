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
// entry call with no sync between them:
//   pass 1, one lane a pixel (a warp is 32 pixels of a row), runs at most
//     `cap` iterations and writes every pixel that ends there (the
//     shortcut's, the escaped, those at a budget <= cap); a warp appends
//     its other pixels to a list with one atomicAdd;
//   pass 2, a grid of the card's resident blocks, strides over the list,
//     so its warps hold only long pixels, and runs each from its
//     coordinate to the end in rounds of kRound iterations with no branch
//     (Rule::run_long): with few warps on the card a pixel's chain of
//     dependent operations paces pass 2, and a test and branch after
//     every iteration lengthened it.
// Each pixel's count depends on its own coordinate alone, so neither the
// list's order nor the restart changes a count.  With cap >= the budget
// pass 1 finishes every pixel and pass 2 is not launched (the one-pass
// form).  The list's counter is one of two (`parity`, alternated by the
// caller): pass 1 zeroes the other, which the next call counts in, so no
// memset or host sync is needed between calls.
// Output: int64 [H, W] for a frame (the engine's grid), int32 [K, H, W]
// for a sequence (its public form is uint32).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hdr.cuh"

namespace {

constexpr int32_t kSeqCap = 64;   // pass 1's iterations in a sequence
constexpr int kPass2Block = 256;  // threads of a pass-2 block
constexpr int kRound = 8;         // iterations a round of pass 2

// the arithmetic of one semantics
template <typename T, bool kTile>
struct Rule {
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
};

template <typename T, typename C>
struct Pixel {
  T cx, cy;
  C budget;
};

// one frame, passed by value: an int64 budget, counted in int64 by the
// loop and in int32 by the tile (whose frames pass the f32 value of
// theirs, below 2^31)
template <typename T, bool kTile>
struct OneFrame {
  using Count = std::conditional_t<kTile, int32_t, int64_t>;
  T min_x, max_y, dx, dy;
  int64_t budget;
  __device__ __forceinline__ Pixel<T, Count> at(int, int x, int y) const {
    using R = Rule<T, kTile>;
    return {R::fl(min_x + R::fl(static_cast<T>(x) * dx)),
            R::fl(max_y - R::fl(static_cast<T>(y) * dy)),
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

// pass 1: pixel (x, y) of frame blockIdx.z, one lane each (blockDim.x is
// 32: a warp is one block row); the pixels still running after `cap`
// iterations go to the list `later`, counted in counters[parity]
template <typename T, bool kTile, class Frames, typename Out>
__global__ void escape_pass1(Out *__restrict__ out, Frames f, int width,
                             int height, int32_t cap,
                             uint32_t *__restrict__ later, uint32_t *counters,
                             int parity) {
  using C = typename Frames::Count;
  using R = Rule<T, kTile>;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y) ==
      0)
    counters[parity ^ 1] = 0;   // the next call's list counter
  const uint32_t at = (static_cast<uint32_t>(k) * height + y) * width + x;
  bool keep = false;
  if (x < width && y < height) {
    const Pixel<T, C> c = f.at(k, x, y);
    if (kTile && R::interior(c.cx, c.cy)) {
      out[at] = static_cast<Out>(c.budget);
    } else {
      // pass 1 counts in int32: at most cap iterations
      const bool whole = c.budget <= cap;
      const int32_t limit = whole ? static_cast<int32_t>(c.budget) : cap;
      const int32_t it = R::run(c.cx, c.cy, limit);
      if (it < limit || whole)
        out[at] = static_cast<Out>(it);
      else
        keep = true;
    }
  }
  // one atomicAdd a warp
  const unsigned m = __ballot_sync(~0u, keep);
  if (m) {
    const int lead = __ffs(m) - 1;
    uint32_t base = 0;
    if (static_cast<int>(threadIdx.x) == lead)
      base = atomicAdd(counters + parity, static_cast<uint32_t>(__popc(m)));
    base = __shfl_sync(~0u, base, lead);
    if (keep) later[base + __popc(m & ((1u << threadIdx.x) - 1u))] = at;
  }
}

// pass 2: the listed pixels, a lane each in turn, from z = c to the end
template <typename T, bool kTile, class Frames, typename Out>
__global__ void __launch_bounds__(kPass2Block)
    escape_pass2(Out *__restrict__ out, Frames f, int width, int height,
                 const uint32_t *__restrict__ later,
                 const uint32_t *__restrict__ n_later) {
  using C = typename Frames::Count;
  const uint32_t n = *n_later;
  const uint32_t plane = static_cast<uint32_t>(width) * height;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const uint32_t at = later[i];
    const uint32_t k = at / plane;
    const uint32_t r = at - k * plane;
    const uint32_t y = r / width;
    const Pixel<T, C> c = f.at(static_cast<int>(k),
                               static_cast<int>(r - y * width),
                               static_cast<int>(y));
    out[at] =
        static_cast<Out>(Rule<T, kTile>::run_long(c.cx, c.cy, c.budget));
  }
}

// the resident blocks of pass 2 on the current device (cached per device)
template <typename T, bool kTile, class Frames, typename Out>
int pass2_grid(int *grid) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && cached[dev]) {
    *grid = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, escape_pass2<T, kTile, Frames, Out>, kPass2Block, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = per_sm * sms;
  if (dev < 64) cached[dev] = *grid;
  return 0;
}

// both passes on the stream; pass 2 only if a pixel can outlast `cap`
template <typename T, bool kTile, class Frames, typename Out>
int launch(Out *out, const Frames &f, int frames, int width, int height,
           int64_t max_budget, int32_t cap, void *later, void *counters,
           int parity, void *stream) {
  if (width < 1 || height < 1 || frames < 1 || cap < 0 ||
      static_cast<uint64_t>(frames) * width * height >= (uint64_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  int grid2 = 0;
  const int rc = pass2_grid<T, kTile, Frames, Out>(&grid2);
  if (rc) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto ctr = static_cast<uint32_t *>(counters);
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y, frames);
  escape_pass1<T, kTile, Frames, Out><<<grid, block, 0, st>>>(
      out, f, width, height, cap, static_cast<uint32_t *>(later), ctr,
      parity);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || cap >= max_budget) return static_cast<int>(err);
  escape_pass2<T, kTile, Frames, Out><<<grid2, kPass2Block, 0, st>>>(
      out, f, width, height, static_cast<const uint32_t *>(later),
      ctr + parity);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTile>
int launch_frame(void *out, int width, int height, T min_x, T max_y, T dx,
                 T dy, int64_t max_iter, int32_t cap, void *later,
                 void *counters, int parity, void *stream) {
  const OneFrame<T, kTile> f = {min_x, max_y, dx, dy, max_iter};
  return launch<T, kTile>(static_cast<int64_t *>(out), f, 1, width, height,
                          max_iter, cap, later, counters, parity, stream);
}

template <typename T>
int launch_seq(void *out, const void *params, int frames, int width,
               int height, void *later, void *counters, int parity,
               void *stream) {
  const FrameTable<T> f = {static_cast<const T *>(params)};
  // the budgets are on the card: pass 2 always runs
  return launch<T, true>(static_cast<int32_t *>(out), f, frames, width,
                         height, INT64_MAX, kSeqCap, later, counters, parity,
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
// iterations (>= max_iter: one pass).  Fewer than 2^32 pixels.
// f32 tile: max_iter is the f32 value of the budget, below 2^31.
int fs_escape_f32(void *out, int32_t width, int32_t height, float min_x,
                  float max_y, float dx, float dy, int64_t max_iter,
                  int32_t cap, void *later, void *counters, int32_t parity,
                  void *stream) {
  return launch_frame<float, true>(out, width, height, min_x, max_y, dx, dy,
                                   max_iter, cap, later, counters, parity,
                                   stream);
}

int fs_escape_f32_loop(void *out, int32_t width, int32_t height, float min_x,
                       float max_y, float dx, float dy, int64_t max_iter,
                       int32_t cap, void *later, void *counters,
                       int32_t parity, void *stream) {
  return launch_frame<float, false>(out, width, height, min_x, max_y, dx, dy,
                                    max_iter, cap, later, counters, parity,
                                    stream);
}

int fs_escape_f64(void *out, int32_t width, int32_t height, double min_x,
                  double max_y, double dx, double dy, int64_t max_iter,
                  int32_t cap, void *later, void *counters, int32_t parity,
                  void *stream) {
  return launch_frame<double, false>(out, width, height, min_x, max_y, dx,
                                     dy, max_iter, cap, later, counters,
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
