// K3: the RC perturbation tail, one thread per pixel with its own
// orbit-reconstruction cursor.
//
// Replaces: fractalshark_tpu/ops/perturb_stream.py:395 _rc_kernel (B3,
// Pallas; launch _rc_launch :607, API perturb_render_stream_rc :773).
//
// The TPU kernel sweeps one serial reconstruction cursor over the orbit
// for a whole tile in lockstep, because Mosaic has no vector gather.  A
// GPU thread can gather, so each pixel keeps its own cursor (orbit
// position, anchor pointer, df32 value), the design of the reference's
// gather tail ops/rc_tail.py (df32 mode), which tests/test_rc_tail.py
// pins bit-identical to the sweep.  The cost is then proportional to
// each pixel's own work, not to the orbit length.
//
// Init launch (the handoff, perturb_stream.py:671-716): a pixel handed
// over at jwait >= max_ref rebases there (dz <- Z[max_ref] + dz,
// position 0) without spending an iteration; others are clipped to
// [0, max_ref-1].  Each thread binary-searches its last anchor <= its
// position and catches up with the df32 recurrence (:480-489).
// Tail (:492-520): HDR-f32 step against Z[pos] and Z[pos+1] (hi parts),
// unreduced compares, escape at |z|^2 > 2^8, rebase on |z|^2 < |dz|^2 or
// at the orbit's end, which restarts the pixel at position 0 / anchor 0.
// The remaining budget and positions are int64 (the reference's
// (hi, lo) i32 pairs are a Mosaic workaround).
// Bound: the dependent 16-byte anchor loads and ~60 FP32 ops per step
// (the df32 recurrence runs only between anchors); launches are bounded
// by chunk_steps tail steps per pixel and resume from the state arrays.

#include <cuda_runtime.h>

#include <cstdint>

#include "df32.cuh"
#include "hdr.cuh"

namespace {

using fs::DF;
using fs::Hdr;
using fs::HdrC;

struct RcParams {
  int n_pixels;
  int64_t n_anchor;
  int64_t max_ref;
  DF cx, cy;
  float zx_mr, zy_mr;
  int64_t max_iter;
  int64_t chunk_steps;
  int init;
};

__global__ void rc_tail_kernel(const float *__restrict__ dcr,
                               const float *__restrict__ dci,
                               const int32_t *__restrict__ dce,
                               const int64_t *__restrict__ aidx,
                               const float4 *__restrict__ aval, float *st_dzr,
                               float *st_dzi, int32_t *st_dze, int64_t *st_rem,
                               int64_t *st_pos, int64_t *st_aptr, float4 *st_z,
                               uint8_t *st_done, RcParams P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P.n_pixels) return;
  const HdrC dc = {dcr[p], dci[p], dce[p]};
  HdrC dz = {st_dzr[p], st_dzi[p], st_dze[p]};
  int64_t rem = st_rem[p];
  int64_t pos = st_pos[p];
  int64_t aptr = st_aptr[p];
  float4 z = st_z[p];
  bool done = st_done[p] != 0;

  if (P.init) {
    // on entry rem holds the completed iterations and pos the jwait
    const int64_t it = rem, jw = pos;
    if (jw >= P.max_ref && !done) {
      dz = fs::reduce_complex(
          fs::complex_add(HdrC{P.zx_mr, P.zy_mr, 0}, dz));
      pos = 0;
    } else {
      const int64_t hi = P.max_ref - 1 > 0 ? P.max_ref - 1 : 0;
      pos = jw < 0 ? 0 : (jw > hi ? hi : jw);
    }
    rem = P.max_iter - it > 0 ? P.max_iter - it : 0;
    if (rem == 0) done = true;
    if (!done) {
      // last anchor <= pos (anchor 0 is position 0)
      int64_t lo = 0, up = P.n_anchor;
      while (lo < up) {
        const int64_t mid = lo + (up - lo) / 2;
        if (aidx[mid] <= pos) lo = mid + 1; else up = mid;
      }
      aptr = lo - 1;
      z = aval[aptr];
      DF zx = {z.x, z.y}, zy = {z.z, z.w};
      for (int64_t c = pos - aidx[aptr]; c > 0; --c)
        fs::df_orbit_step(zx, zy, P.cx, P.cy);
      z = make_float4(zx.hi, zx.lo, zy.hi, zy.lo);
    }
  }

  for (int64_t k = 0; !done && (P.chunk_steps == 0 || k < P.chunk_steps);
       ++k) {
    // Z[pos+1]: the next anchor if it sits there, else the recurrence
    const bool hit = (aptr + 1 < P.n_anchor) && aidx[aptr + 1] == pos + 1;
    float4 zn;
    if (hit) {
      zn = aval[aptr + 1];
    } else {
      DF zx = {z.x, z.y}, zy = {z.z, z.w};
      fs::df_orbit_step(zx, zy, P.cx, P.cy);
      zn = make_float4(zx.hi, zx.lo, zy.hi, zy.lo);
    }
    const HdrC zj = {z.x, z.z, 0};
    const HdrC t = fs::complex_add(fs::complex_mul_pow2(zj, 1), dz);
    const HdrC ndz =
        fs::reduce_complex(fs::complex_add(fs::complex_mul(t, dz), dc));
    const HdrC zf =
        fs::reduce_complex(fs::complex_add(HdrC{zn.x, zn.z, 0}, ndz));
    const Hdr nsq = fs::norm_squared(zf);
    const Hdr dsq = fs::norm_squared(ndz);
    if (fs::gt_pow2_unreduced(nsq, 8)) {
      done = true;
      break;
    }
    rem -= 1;
    if (fs::lt_unreduced(nsq, dsq) || pos + 1 >= P.max_ref) {
      dz = zf;
      pos = 0;
      aptr = 0;
      z = aval[0];
    } else {
      dz = ndz;
      pos += 1;
      if (hit) aptr += 1;
      z = zn;
    }
    if (rem == 0) done = true;
  }

  st_dzr[p] = dz.re;
  st_dzi[p] = dz.im;
  st_dze[p] = dz.e;
  st_rem[p] = rem;
  st_pos[p] = pos;
  st_aptr[p] = aptr;
  st_z[p] = z;
  st_done[p] = done ? 1 : 0;
}

}  // namespace

extern "C" int fs_rc_tail(const void *dcr, const void *dci, const void *dce,
                          const void *aidx, const void *aval, void *st_dzr,
                          void *st_dzi, void *st_dze, void *st_rem,
                          void *st_pos, void *st_aptr, void *st_z,
                          void *st_done, int32_t n_pixels, int64_t n_anchor,
                          int64_t max_ref, float cxh, float cxl, float cyh,
                          float cyl, float zx_mr, float zy_mr,
                          int64_t max_iter, int64_t chunk_steps, int32_t init,
                          void *stream) {
  const RcParams P = {n_pixels, n_anchor, max_ref,  DF{cxh, cxl},
                      DF{cyh, cyl}, zx_mr, zy_mr, max_iter,
                      chunk_steps, init};
  const int block = 128;
  const int grid = (n_pixels + block - 1) / block;
  rc_tail_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float *>(dcr), static_cast<const float *>(dci),
      static_cast<const int32_t *>(dce), static_cast<const int64_t *>(aidx),
      static_cast<const float4 *>(aval), static_cast<float *>(st_dzr),
      static_cast<float *>(st_dzi), static_cast<int32_t *>(st_dze),
      static_cast<int64_t *>(st_rem), static_cast<int64_t *>(st_pos),
      static_cast<int64_t *>(st_aptr), static_cast<float4 *>(st_z),
      static_cast<uint8_t *>(st_done), P);
  return static_cast<int>(cudaGetLastError());
}
