// K1: plain escape time, one thread per pixel.
//
// Replaces: fractalshark_tpu/ops/escape.py:211 _escape_kernel (Pallas, B1;
// launch _escape_pallas_impl :236) for the f32 instance, and the XLA
// lockstep loop escape_jax (escape.py:120) that the reference runs for
// f64 (engine/fractal.py:180-184).
//
// Design: each thread derives its coordinate from four scalars
// (cx = min_x + x*dx, cy = max_y - y*dy in the working type), so the
// kernel reads no input at all and writes one int64 per pixel.
//   f32 (kInterior): pixels inside the main cardioid or the period-2 bulb
//     get the budget without iterating (escape.py:166-178); the others
//     count while |z|^2 <= 4 (:193); the count never exceeds the budget
//     (the reference clamps, :208).
//   f64: escape_jax's loop, "if |z|^2 > 4 break" before each update, and
//     no interior shortcut (escape_jax has none; the golden CRC of
//     tests/test_escape.py is taken on it).  f32 at budgets of 2^31 or
//     more runs the same loop (fs_escape_f32_loop), as the reference
//     sends them to escape_jax (engine/fractal.py:182-184); below that the
//     wrapper passes the f32 value of the budget (2^24 + 1 runs as 2^24),
//     as _escape_kernel reads it from its f32 table (escape.py:216).
// Bound: pure FP32/FP64 arithmetic, about 7 flops per iteration; the
// write is 8 bytes per pixel.  Warps diverge where neighbouring pixels
// escape at different counts, as on any SIMT machine; the early exit
// per thread replaces the reference's per-tile "all resolved" check.
//
// K1-seq: a sequence of K frames in one launch.
// Replaces: fractalshark_tpu/ops/escape.py:220 _escape_seq_kernel (Pallas,
// B13; launch _escape_seq_impl :285, API escape_pallas_sequence :310).
// Every frame has _escape_tile's semantics (escape.py:144-208) in BOTH
// types: the interior shortcut, counting while |z|^2 <= 4, the clamp.
// The [K,5] table (min_x, max_y, dx, dy, budget) is in the frame type in
// device memory, as the reference's SMEM table; the budget is converted
// to int32 in the kernel (f32: 2^24 + 1 reads as 2^24, as the reference's
// .astype(int32) does; the conversion saturates).  Counting stops at the
// first |z|^2 > 4: past it z diverges monotonically (escape.py:149-153),
// so no later step counts, as in the reference.  f64 results are flushed
// (hdr.cuh ftz), as XLA:CPU flushes the reference's f64 tile.  Output
// int32 [K,H,W], 4 bytes per pixel.
// What bounds it: the iterations (7 operations each) of the pixels the
// shortcut leaves, most of them a few iterations, a few hundredths the
// whole budget (in the set outside the cardioid and the bulb).  With one
// lane per pixel a warp holding one such pixel runs the budget while its
// other lanes idle (on the View 0 sequence the lanes' iterations are 2.7x
// the pixels' own).  So the kernel runs in two passes, both launched by
// the C entry with no sync between them: pass 1, one lane per pixel, runs
// at most kSeqCap iterations and writes every pixel that ends there (the
// shortcut's, the escaped, those at a budget <= kSeqCap); a warp appends
// its other pixels to a list with one atomicAdd.  Pass 2, a grid of the
// card's resident blocks, strides over the list, so its warps hold only
// long pixels, and runs each from its coordinate to the end.  Each
// pixel's count depends on its own coordinate alone, so neither the list's
// order nor the restart changes a count.

#include <cuda_runtime.h>

#include <cstdint>

#include "hdr.cuh"

namespace {

template <typename T, bool kInterior>
__global__ void escape_kernel(int64_t *__restrict__ out, int width, int height,
                              T min_x, T max_y, T dx, T dy, int64_t max_iter) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  const T cx = min_x + static_cast<T>(x) * dx;
  const T cy = max_y - static_cast<T>(y) * dy;
  int64_t it = 0;
  if (kInterior) {
    const T xq = cx - static_cast<T>(0.25);
    const T cy2 = cy * cy;
    const T q = xq * xq + cy2;
    const T cx1 = cx + static_cast<T>(1.0);
    if (q * (q + xq) <= static_cast<T>(0.25) * cy2 ||
        cx1 * cx1 + cy2 <= static_cast<T>(0.0625)) {
      out[static_cast<int64_t>(y) * width + x] = max_iter;
      return;
    }
  }
  T zx = cx, zy = cy;
  while (it < max_iter) {
    const T zx2 = zx * zx;
    const T zy2 = zy * zy;
    const T mag = zx2 + zy2;
    if (kInterior ? !(mag <= static_cast<T>(4.0)) : (mag > static_cast<T>(4.0)))
      break;
    const T nzy = (static_cast<T>(2.0) * zx) * zy + cy;
    zx = (zx2 - zy2) + cx;
    zy = nzy;
    ++it;
  }
  out[static_cast<int64_t>(y) * width + x] = it;
}

template <typename T, bool kInterior>
int launch(void *out, int width, int height, T min_x, T max_y, T dx, T dy,
           int64_t max_iter, void *stream) {
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  escape_kernel<T, kInterior><<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t *>(out), width, height, min_x, max_y, dx, dy,
      max_iter);
  return static_cast<int>(cudaGetLastError());
}

// K1-seq: iterations of pass 1, threads of a pass-2 block
constexpr int32_t kSeqCap = 64;
constexpr int kSeqBlock = 256;

// frame k's coordinate of pixel (x, y) and budget, from the [K, 5] table
template <typename T>
struct SeqPixel {
  T cx, cy;
  int32_t budget;
};

template <typename T>
__device__ __forceinline__ SeqPixel<T> seq_pixel(const T *params, int k,
                                                 int x, int y) {
  const T *p = params + 5 * k;
  return {fs::ftz(p[0] + fs::ftz(static_cast<T>(x) * p[2])),
          fs::ftz(p[1] - fs::ftz(static_cast<T>(y) * p[3])),
          static_cast<int32_t>(p[4])};
}

// _escape_tile's shortcut: c in the main cardioid or the period-2 bulb;
// every result passes ftz (the identity for float: -ftz=true flushes f32
// in hardware)
template <typename T>
__device__ __forceinline__ bool seq_interior(T cx, T cy) {
  const T xq = fs::ftz(cx - static_cast<T>(0.25));
  const T cy2 = fs::ftz(cy * cy);
  const T q = fs::ftz(fs::ftz(xq * xq) + cy2);
  const T cx1 = fs::ftz(cx + static_cast<T>(1.0));
  return fs::ftz(q * fs::ftz(q + xq)) <= fs::ftz(static_cast<T>(0.25) * cy2) ||
         fs::ftz(fs::ftz(cx1 * cx1) + cy2) <= static_cast<T>(0.0625);
}

// one iteration of _escape_tile's loop: false (z kept) once |z|^2 > 4
template <typename T>
__device__ __forceinline__ bool seq_step(T &zx, T &zy, T cx, T cy) {
  const T zx2 = fs::ftz(zx * zx);
  const T zy2 = fs::ftz(zy * zy);
  if (!(fs::ftz(zx2 + zy2) <= static_cast<T>(4.0))) return false;
  const T nzy = fs::ftz(fs::ftz(fs::ftz(zx + zx) * zy) + cy);
  zx = fs::ftz(fs::ftz(zx2 - zy2) + cx);
  zy = nzy;
  return true;
}

// _escape_tile's loop from z = c for at most `limit` iterations: the
// count (below `limit` only if z escaped).  Four iterations a round while
// four are left: one budget test for four.
template <typename T>
__device__ __forceinline__ int32_t seq_loop(T cx, T cy, int32_t limit) {
  T zx = cx, zy = cy;
  int32_t it = 0;
  while (it <= limit - 4) {
    if (!seq_step(zx, zy, cx, cy)) return it;
    if (!seq_step(zx, zy, cx, cy)) return it + 1;
    if (!seq_step(zx, zy, cx, cy)) return it + 2;
    if (!seq_step(zx, zy, cx, cy)) return it + 3;
    it += 4;
  }
  while (it < limit && seq_step(zx, zy, cx, cy)) ++it;
  return it;
}

// pass 1: pixel (x, y) of frame blockIdx.z, one lane each (a warp is 32
// pixels of a row); the pixels still running after kSeqCap iterations go
// to the list `later`
template <typename T>
__global__ void escape_seq_pass1(int32_t *__restrict__ out,
                                 const T *__restrict__ params, int width,
                                 int height, uint32_t *__restrict__ later,
                                 uint32_t *n_later) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  const uint32_t at = (static_cast<uint32_t>(k) * height + y) * width + x;
  bool keep = false;
  if (x < width && y < height) {
    const SeqPixel<T> c = seq_pixel(params, k, x, y);
    if (seq_interior(c.cx, c.cy)) {
      out[at] = c.budget;
    } else {
      const int32_t limit = c.budget < kSeqCap ? c.budget : kSeqCap;
      const int32_t it = seq_loop(c.cx, c.cy, limit);
      if (it < limit || it == c.budget)
        out[at] = it;
      else
        keep = true;
    }
  }
  // one atomicAdd a warp (blockDim.x is 32: a warp is one block row)
  const unsigned m = __ballot_sync(~0u, keep);
  if (m) {
    const int lead = __ffs(m) - 1;
    uint32_t base = 0;
    if (static_cast<int>(threadIdx.x) == lead)
      base = atomicAdd(n_later, static_cast<uint32_t>(__popc(m)));
    base = __shfl_sync(~0u, base, lead);
    if (keep) later[base + __popc(m & ((1u << threadIdx.x) - 1u))] = at;
  }
}

// pass 2: the listed pixels, a lane each in turn, from z = c to the end
template <typename T>
__global__ void __launch_bounds__(kSeqBlock)
    escape_seq_pass2(int32_t *__restrict__ out, const T *__restrict__ params,
                     int width, int height,
                     const uint32_t *__restrict__ later,
                     const uint32_t *__restrict__ n_later) {
  const uint32_t n = *n_later;
  const uint32_t plane = static_cast<uint32_t>(width) * height;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const uint32_t at = later[i];
    const uint32_t k = at / plane;
    const uint32_t r = at - k * plane;
    const uint32_t y = r / width;
    const SeqPixel<T> c = seq_pixel(params, static_cast<int>(k),
                                    static_cast<int>(r - y * width),
                                    static_cast<int>(y));
    out[at] = seq_loop(c.cx, c.cy, c.budget);
  }
}

template <typename T>
int launch_seq(void *out, const void *params, int frames, int width,
               int height, void *later, void *counter, void *stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, escape_seq_pass2<T>, kSeqBlock, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<uint64_t>(frames) * width * height >= (uint64_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counter, 0, sizeof(uint32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y, frames);
  escape_seq_pass1<T><<<grid, block, 0, st>>>(
      static_cast<int32_t *>(out), static_cast<const T *>(params), width,
      height, static_cast<uint32_t *>(later),
      static_cast<uint32_t *>(counter));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  escape_seq_pass2<T><<<per_sm * sms, kSeqBlock, 0, st>>>(
      static_cast<int32_t *>(out), static_cast<const T *>(params), width,
      height, static_cast<const uint32_t *>(later),
      static_cast<const uint32_t *>(counter));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char *fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int fs_escape_f32(void *out, int32_t width, int32_t height, float min_x,
                  float max_y, float dx, float dy, int64_t max_iter,
                  void *stream) {
  return launch<float, true>(out, width, height, min_x, max_y, dx, dy,
                             max_iter, stream);
}

int fs_escape_f32_loop(void *out, int32_t width, int32_t height, float min_x,
                       float max_y, float dx, float dy, int64_t max_iter,
                       void *stream) {
  return launch<float, false>(out, width, height, min_x, max_y, dx, dy,
                              max_iter, stream);
}

int fs_escape_f64(void *out, int32_t width, int32_t height, double min_x,
                  double max_y, double dx, double dy, int64_t max_iter,
                  void *stream) {
  return launch<double, false>(out, width, height, min_x, max_y, dx, dy,
                               max_iter, stream);
}

// later: device scratch of one uint32 a pixel (the pass-2 list);
// counter: four bytes of device scratch, zeroed here on the stream; at
// most 2^32 - 1 pixels
int fs_escape_seq_f32(void *out, const void *params, int32_t frames,
                      int32_t width, int32_t height, void *later,
                      void *counter, void *stream) {
  return launch_seq<float>(out, params, frames, width, height, later,
                           counter, stream);
}

int fs_escape_seq_f64(void *out, const void *params, int32_t frames,
                      int32_t width, int32_t height, void *later,
                      void *counter, void *stream) {
  return launch_seq<double>(out, params, frames, width, height, later,
                            counter, stream);
}

}  // extern "C"
