// Device code shared by the per-pixel loops K6 (csrc/perturb.cu), K2
// (csrc/lav2.cu) and K3/K19 (csrc/rc_tail.cu): the orbit row and its load,
// the orbit cursor (K6), which has the row a step needs in registers when
// the step starts, the HDR perturbation step (K6, K3 and K19), K3's
// anchor cursor, which has the next anchor's position and value in
// registers before a step needs them, and K19's anchor row loads.  K7
// (csrc/la_stream.cu) loads its node rows with the anchor loads.  The
// work queues of K15 and K6's glitch instance size their grids with
// resident_blocks (host code).
//
// Orbit rows: the packed [M, 4] table of ops/tables.py pack_orbit_np,
// row r = (Z[r], Z[r+1]).  A step at position j reads row j; the next step
// reads row j+1, or row 0 after a rebase.  Row 0 never changes, so each
// thread holds it in registers for the whole launch; row j+1 is loaded when
// step j starts, where its address is known.  Every address is clamped to
// [0, last], the caller's clamp of the position (K6: max_ref - 1), which
// the table holds; a speculative row past the end is never used, since
// the step that would use it rebases.  The compiler gives the loaded row
// the registers of the row in use, so the load issues after that row's
// last use in the step (about its middle) and has the rest of the step to
// arrive: two buffers in turns, a cp.async copy into shared memory, only
// the new half row, and L1 prefetches were each measured and were slower
// (PERF.md §6).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "df32.cuh"
#include "hdr.cuh"

namespace fs {

template <typename T>
struct Row {
  T z0r, z0i, z1r, z1i;
};

// The loads are volatile asm so that the compiler keeps them where the
// step starts: a plain load whose value is only used on the step's
// non-escaping branch is sunk into that branch, next to its use, and the
// load's latency lands on the chain again.
__device__ __forceinline__ Row<float> load_orbit_row(const float *r) {
  Row<float> o;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(o.z0r), "=f"(o.z0i), "=f"(o.z1r), "=f"(o.z1i)
               : "l"(r));
  return o;
}
__device__ __forceinline__ Row<double> load_orbit_row(const double *r) {
  Row<double> o;
  asm volatile("ld.global.nc.v2.f64 {%0, %1}, [%2];"
               : "=d"(o.z0r), "=d"(o.z0i)
               : "l"(r));
  asm volatile("ld.global.nc.v2.f64 {%0, %1}, [%2];"
               : "=d"(o.z1r), "=d"(o.z1i)
               : "l"(r + 2));
  return o;
}
template <typename T>
struct OrbitCursor {
  const T *orbit;
  int64_t last;
  Row<T> row0;  // the rebase target, loaded once per launch

  __device__ __forceinline__ OrbitCursor(const T *orbit_, int64_t last_)
      : orbit(orbit_), last(last_ < 0 ? 0 : last_) {
    row0 = load_orbit_row(orbit);
  }
  __device__ __forceinline__ int64_t clamp(int64_t q) const {
    return q < 0 ? 0 : (q > last ? last : q);
  }
  // row p with no row in flight: a resumed pixel, K2's entry into its tail
  __device__ __forceinline__ Row<T> at(int64_t p) const {
    const int64_t q = clamp(p);
    return q == 0 ? row0 : load_orbit_row(orbit + 4 * q);
  }
  // row p+1, loaded when the step at position p starts
  __device__ __forceinline__ Row<T> ahead(int64_t p) const {
    return load_orbit_row(orbit + 4 * clamp(p + 1));
  }
  // the next step's row: row 0 on a rebase, else the row loaded ahead
  __device__ __forceinline__ Row<T> pick(bool rebase, Row<T> next) const {
    return rebase ? row0 : next;
  }
};

// One HDR perturbation step from Z[j] = (z0r, z0i) and Z[j+1] = (z1r, z1i)
// (perturb.py:6-11): ndz = dz(2Z[j] + dz) + dc, zf = Z[j+1] + ndz, escape
// at |zf|^2 > 2^8, lower = |zf|^2 < |ndz|^2.  The compares: reduced, as
// _perturb_hdr_impl (K6), or unreduced, as B11 and B3 (kUnreduced: K3);
// the two are boolean-identical (fractalshark_tpu/ops/hdrfloat.py:220-238),
// and each kernel takes the form it measured faster with (PERF.md §6).
template <typename T>
struct HdrStep {
  HdrCT<T> ndz, zf;
  bool esc, lower;
};

template <bool kUnreduced, typename T>
__device__ __forceinline__ HdrStep<T> hdr_step(T z0r, T z0i, T z1r, T z1i,
                                               HdrCT<T> dz, HdrCT<T> dc) {
  const HdrCT<T> zj = {z0r, z0i, 0};
  const HdrCT<T> t = complex_add(complex_mul_pow2(zj, 1), dz);
  HdrStep<T> o;
  o.ndz = reduce_complex(complex_add(complex_mul(t, dz), dc));
  o.zf = reduce_complex(complex_add(HdrCT<T>{z1r, z1i, 0}, o.ndz));
  if (kUnreduced) {
    const HdrT<T> nsq = norm_squared(o.zf);
    const HdrT<T> dsq = norm_squared(o.ndz);
    o.esc = gt_pow2_unreduced(nsq, 8);
    o.lower = lt_unreduced(nsq, dsq);
  } else {
    const HdrT<T> two56 = {T(1), 8};
    const HdrT<T> nsq = reduce(norm_squared(o.zf));
    const HdrT<T> dsq = reduce(norm_squared(o.ndz));
    o.esc = gt_reduced(nsq, two56);
    o.lower = lt_reduced(nsq, dsq);
  }
  return o;
}

// An anchor of a compressed orbit: Z at the anchor's position as df32
// pairs (x hi, x lo, y hi, y lo), and the load of its position.
__device__ __forceinline__ float4 load_anchor(const float *r) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(r));
  return v;
}
__device__ __forceinline__ int32_t load_position(const int32_t *r) {
  int32_t v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(r));
  return v;
}
__device__ __forceinline__ int64_t load_position(const int64_t *r) {
  int64_t v;
  asm volatile("ld.global.nc.s64 %0, [%1];" : "=l"(v) : "l"(r));
  return v;
}

// K3's cursor over a compressed orbit: m anchors at ascending positions
// aidx[0..m-1] (aidx[0] = 0) with values aval[4a..4a+3].  A pixel at
// anchor pointer a (the last anchor at or before its position) holds the
// positions of anchors a+1 and a+2 and the value of anchor a+1.  A step
// whose next position is anchor a+1 takes its value from registers and, when
// it starts, loads the position of anchor a+3 and the value of anchor a+2:
// the loads are a step ahead of their use, and no position load sits on a
// step's chain.  Anchor 0's value, the rebase target, is held for the
// launch; a rebase reloads what follows it (holding that too took more
// registers and measured slower where many warps share an SM, PERF.md §6).
// I is int32_t where every position fits (max_ref < 2^31 - 1), else
// int64_t.
template <typename I>
struct NoAnchor;  // the position of the anchor past the last: never reached
template <>
struct NoAnchor<int32_t> {
  static constexpr int32_t value = INT32_MAX;
};
template <>
struct NoAnchor<int64_t> {
  static constexpr int64_t value = INT64_MAX;
};

template <typename I>
struct AnchorCursor {
  static constexpr I kNone = NoAnchor<I>::value;
  const I *aidx;
  const float *aval;
  I m;
  float4 v0;  // anchor 0's value

  __device__ __forceinline__ AnchorCursor(const I *aidx_, const float *aval_,
                                          I m_)
      : aidx(aidx_), aval(aval_), m(m_) {
    v0 = load_anchor(aval);
  }
  __device__ __forceinline__ I position(I a) const {
    return a < m ? load_position(aidx + a) : kNone;
  }
  __device__ __forceinline__ float4 value(I a) const {
    return load_anchor(aval + 4 * (a < m ? a : m - 1));
  }
};

// K19's anchor rows (ops/tables.py anchor_table_f64): row a, f64 [m, 4],
// is anchor a's value (x, y), the int64 bits of its position and a zero
// pad, 32 bytes: the value's one vector load (below) and the position's
// load_position of the row's third word, asm volatile as load_orbit_row,
// so that they issue where they are written (csrc/rc_tail.cu
// rc_gather_kernel).
__device__ __forceinline__ double2 load_value64(const double *r) {
  double2 v;
  asm volatile("ld.global.nc.v2.f64 {%0, %1}, [%2];"
               : "=d"(v.x), "=d"(v.y)
               : "l"(r));
  return v;
}

// an f64 value as the f32 the HDR step reads: rounded to nearest, then a
// subnormal result flushed to a zero of its sign by its bits (hdrfloat.ftz
// after .float() in the twin), whatever the conversion's own mode
__device__ __forceinline__ float f32_of(double v) {
  const uint32_t b = __float_as_uint(__double2float_rn(v));
  return __uint_as_float((b & 0x7F800000u) ? b : (b & 0x80000000u));
}

// blocks of `kernel` (`block` threads each) the card holds at once, for
// the work queues of K15 and K6's glitch instance (0 on a CUDA error, in
// *err)
template <typename K>
int64_t resident_blocks(K kernel, int block, cudaError_t *err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         block, 0);
  return *err == cudaSuccess ? int64_t{per_sm} * sms : 0;
}

}  // namespace fs
