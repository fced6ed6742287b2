// Device code shared by the per-pixel loops K6 (csrc/perturb.cu) and K2
// (csrc/lav2.cu): the orbit row and its load, and the orbit cursor (K6),
// which has the row a step needs in registers when the step starts.
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

#include <cstdint>

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

}  // namespace fs
