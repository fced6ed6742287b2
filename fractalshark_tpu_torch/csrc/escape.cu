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
//     tests/test_escape.py is taken on it).
// Bound: pure FP32/FP64 arithmetic, about 7 flops per iteration; the
// write is 8 bytes per pixel.  Warps diverge where neighbouring pixels
// escape at different counts, as on any SIMT machine; the early exit
// per thread replaces the reference's per-tile "all resolved" check.

#include <cuda_runtime.h>

#include <cstdint>

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

int fs_escape_f64(void *out, int32_t width, int32_t height, double min_x,
                  double max_y, double dx, double dy, int64_t max_iter,
                  void *stream) {
  return launch<double, false>(out, width, height, min_x, max_y, dx, dy,
                               max_iter, stream);
}

}  // extern "C"
