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
// K1-seq: a sequence of K frames in one launch, frame k = blockIdx.z.
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

// _escape_tile for pixel (x, y) of frame k; every result passes ftz
// (the identity for float: -ftz=true flushes f32 in hardware)
template <typename T>
__global__ void escape_seq_kernel(int32_t *__restrict__ out,
                                  const T *__restrict__ params, int width,
                                  int height) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  const T *p = params + 5 * blockIdx.z;
  const int32_t budget = static_cast<int32_t>(p[4]);
  const T cx = fs::ftz(p[0] + fs::ftz(static_cast<T>(x) * p[2]));
  const T cy = fs::ftz(p[1] - fs::ftz(static_cast<T>(y) * p[3]));
  const int64_t at =
      (static_cast<int64_t>(blockIdx.z) * height + y) * width + x;
  const T xq = fs::ftz(cx - static_cast<T>(0.25));
  const T cy2 = fs::ftz(cy * cy);
  const T q = fs::ftz(fs::ftz(xq * xq) + cy2);
  const T cx1 = fs::ftz(cx + static_cast<T>(1.0));
  if (fs::ftz(q * fs::ftz(q + xq)) <= fs::ftz(static_cast<T>(0.25) * cy2) ||
      fs::ftz(fs::ftz(cx1 * cx1) + cy2) <= static_cast<T>(0.0625)) {
    out[at] = budget;
    return;
  }
  T zx = cx, zy = cy;
  int32_t it = 0;
  while (it < budget) {
    const T zx2 = fs::ftz(zx * zx);
    const T zy2 = fs::ftz(zy * zy);
    if (!(fs::ftz(zx2 + zy2) <= static_cast<T>(4.0))) break;
    const T nzy = fs::ftz(fs::ftz(fs::ftz(zx + zx) * zy) + cy);
    zx = fs::ftz(fs::ftz(zx2 - zy2) + cx);
    zy = nzy;
    ++it;
  }
  out[at] = it;
}

template <typename T>
int launch_seq(void *out, const void *params, int frames, int width,
               int height, void *stream) {
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y, frames);
  escape_seq_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t *>(out), static_cast<const T *>(params), width,
      height);
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

int fs_escape_seq_f32(void *out, const void *params, int32_t frames,
                      int32_t width, int32_t height, void *stream) {
  return launch_seq<float>(out, params, frames, width, height, stream);
}

int fs_escape_seq_f64(void *out, const void *params, int32_t frames,
                      int32_t width, int32_t height, void *stream) {
  return launch_seq<double>(out, params, frames, width, height, stream);
}

}  // extern "C"
