// The two-pass schedule of the escape-time kernels, shared by K1 and K1-seq
// (escape.cu), K13 (escape_hdr.cu) and K14 (escape_df.cu); each source
// supplies the arithmetic (a Rule) and the frames' pixels (a Frames).
//
//   pass 1, one lane a pixel (a warp is 32 pixels of a row), runs at most
//     `cap` iterations and writes every pixel that ends there (the
//     shortcut's, the escaped, those at a budget <= cap); a warp appends
//     its other pixels to a list with one atomicAdd;
//   pass 2, a grid of the card's resident blocks, strides over the list,
//     so its warps hold only long pixels, and runs each from its
//     coordinate to the end (Rule::run_long).
// Each pixel's count depends on its own coordinate alone, so neither the
// list's order nor the restart changes a count.  With cap >= the budget
// pass 1 finishes every pixel and pass 2 is not launched (the one-pass
// form).  The list's counter is one of two (`parity`, alternated by the
// caller): pass 1 zeroes the other, which the next call counts in, so no
// memset or host sync is needed between calls.
//
// A Rule R has: kShortcut (pixels resolved without iterating, at their
// budget, where R::interior(pixel) holds); R::run(pixel, limit), the count
// of at most `limit` iterations from the pixel's coordinate (int32, pass
// 1); R::run_long(pixel, budget), the same in the budget's type (pass 2).
// A Frames f has a type Count (the budget's) and f.at(k, x, y), the pixel
// (x, y) of frame k: its coordinate and its `budget`.
// The kernels sit in an anonymous namespace: each source instantiates its
// own, under the names escape_pass1 and escape_pass2.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPass2Block = 256;  // threads of a pass-2 block

// pass 1: pixel (x, y) of frame blockIdx.z, one lane each (blockDim.x is
// 32: a warp is one block row); the pixels still running after `cap`
// iterations go to the list `later`, counted in counters[parity]
template <class R, class Frames, typename Out>
__global__ void escape_pass1(Out *__restrict__ out, Frames f, int width,
                             int height, int32_t cap,
                             uint32_t *__restrict__ later, uint32_t *counters,
                             int parity) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y) ==
      0)
    counters[parity ^ 1] = 0;   // the next call's list counter
  const uint32_t at = (static_cast<uint32_t>(k) * height + y) * width + x;
  bool keep = false;
  if (x < width && y < height) {
    const auto c = f.at(k, x, y);
    if (R::kShortcut && R::interior(c)) {
      out[at] = static_cast<Out>(c.budget);
    } else {
      // pass 1 counts in int32: at most cap iterations
      const bool whole = c.budget <= cap;
      const int32_t limit = whole ? static_cast<int32_t>(c.budget) : cap;
      const int32_t it = R::run(c, limit);
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
template <class R, class Frames, typename Out>
__global__ void __launch_bounds__(kPass2Block)
    escape_pass2(Out *__restrict__ out, Frames f, int width, int height,
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
    const auto c = f.at(static_cast<int>(k), static_cast<int>(r - y * width),
                        static_cast<int>(y));
    out[at] = static_cast<Out>(R::run_long(c, c.budget));
  }
}

// the resident blocks of pass 2 on the current device (cached per device)
template <class R, class Frames, typename Out>
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
        &per_sm, escape_pass2<R, Frames, Out>, kPass2Block, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = per_sm * sms;
  if (dev < 64) cached[dev] = *grid;
  return 0;
}

// both passes on the stream; pass 2 only if a pixel can outlast `cap`
template <class R, class Frames, typename Out>
int launch_passes(Out *out, const Frames &f, int frames, int width,
                  int height, int64_t max_budget, int32_t cap, void *later,
                  void *counters, int parity, void *stream) {
  if (width < 1 || height < 1 || frames < 1 || cap < 0 ||
      static_cast<uint64_t>(frames) * width * height >= (uint64_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  int grid2 = 0;
  const int rc = pass2_grid<R, Frames, Out>(&grid2);
  if (rc) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto ctr = static_cast<uint32_t *>(counters);
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y, frames);
  escape_pass1<R, Frames, Out><<<grid, block, 0, st>>>(
      out, f, width, height, cap, static_cast<uint32_t *>(later), ctr,
      parity);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || cap >= max_budget) return static_cast<int>(err);
  escape_pass2<R, Frames, Out><<<grid2, kPass2Block, 0, st>>>(
      out, f, width, height, static_cast<const uint32_t *>(later),
      ctr + parity);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
