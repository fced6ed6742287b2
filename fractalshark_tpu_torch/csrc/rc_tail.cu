// K3: the RC perturbation tail over a compressed orbit, one lane per pixel
// with its own orbit-reconstruction cursor.
//
// Replaces: fractalshark_tpu/ops/perturb_stream.py:395 _rc_kernel (B3,
// Pallas; launch _rc_launch :607, API perturb_render_stream_rc :773).
// The reference also runs B3 over identity anchors (every orbit position an
// anchor) as the two-phase tail of an uncompressed orbit; that tail never
// reconstructs and its step is K6's, so the port runs it on K6 resumed from
// the handoff (engine/renderers.py _identity_tail) and K3 takes only real
// compressed orbits.
//
// The TPU kernel sweeps one serial reconstruction cursor over the orbit
// for a whole tile in lockstep, because Mosaic has no vector gather.  A
// GPU lane can gather, so each pixel keeps its own cursor (orbit position,
// anchor pointer, df32 value), the design of the reference's gather tail
// ops/rc_tail.py (df32 mode), which tests/test_rc_tail.py pins
// bit-identical to the sweep.  The cost is then proportional to each
// pixel's own work, not to the orbit length.
//
// Init launch (the handoff, perturb_stream.py:671-716): a pixel handed
// over at jwait >= max_ref rebases there (dz <- Z[max_ref] + dz, position
// 0) without spending an iteration; others are clipped to [0, max_ref-1].
// Each lane binary-searches its last anchor <= its position and catches up
// with the df32 recurrence (:480-489).
// Tail (:492-520): the HDR-f32 step against Z[pos] and Z[pos+1] (hi parts;
// csrc/pixel_loop.cuh hdr_step, K6's step with unreduced compares), escape
// at |z|^2 > 2^8, rebase on |z|^2 < |dz|^2 or at the orbit's end, which
// restarts the pixel at position 0 / anchor 0.  Z[pos+1] is the next anchor's value when an
// anchor sits there, else one df32 step from Z[pos].
//
// What bounds it: one pixel's chain of steps, each the HDR step (~60 f32
// operations) plus, between anchors, the df32 step (~40 more).  So:
//  * the anchor cursor (pixel_loop.cuh AnchorCursor) holds the positions of
//    the next two anchors and the next one's value in registers, and loads
//    the ones after a step ahead, when a step that reaches an anchor starts:
//    no index load decides a step;
//  * anchor 0's value (the rebase target) is held for the launch;
//  * the step's compares are B3's unreduced ones (pixel_loop.cuh hdr_step),
//    which measured faster here than K6's reduced ones;
//  * positions and anchor pointers are int32 where the orbit allows it
//    (I = int32_t, max_ref < 2^31 - 1), and the remaining budget stays int64
//    (64-bit budgets);
//  * between launches ops/perturb_stream.py hands the kernel only the pixels
//    still live, one lane each; with more pixels than the card holds lanes,
//    lanes take further pixels from a work queue (kQueue, K2's form).
// The order in which pixels run changes nothing: each pixel's steps depend
// on its own state alone.
//
// K19 (rc_gather_kernel): the gather tail of fractalshark_tpu/ops/
// rc_tail.py in its exact mode (mode="f64", :77 _init_state and :119
// _tail_impl, XLA), which two_phase_render takes for orbits of 64M
// positions and more (engine/renderers.py:261-267) and
// FRACTALSHARK_RC_TAIL=gather.  The card has native f64, so the
// reconstruction is the reference's own: z <- z^2 + c_low in f64 (rx =
// zx*zx - zy*zy + cx, ry = 2*zx*zy + cy, each result rounded on its own
// and flushed as XLA:CPU flushes), the step against f32(zx), f32(zy)
// (flushed), and Z[pos+1] the next anchor's value when one sits there.
// The reference spends a loop pass per catch-up step without counting an
// iteration; here the init launch catches up, as K3's does, which changes
// no count.
//
// What bounds it: one pixel's chain of steps, and on full frames the
// instructions each step issues.  The chain is the HDR step's (dz -> ndz
// -> zf -> compares -> the select of dz): the recurrence that forms
// Z[pos+1] depends only on Z[pos], known when the step starts, and runs
// beside the HDR step's first half.  So the step is made cheaper, not
// reordered (a form that formed Z[pos+2] a step ahead, with Z[0] and Z[1]
// held for the launch, issued more instructions, held 88 registers and
// measured no faster, PERF.md §6):
//  * the recurrence runs without a per-result flush where a guard admits
//    it (below), the flushed form only on a refused step;
//  * Z[pos]'s f32 pair is carried from the step that formed it: one
//    conversion a step (Z[pos+1]'s), not two;
//  * anchor rows are 32 bytes (x, y, the position's int64 bits, a pad), so
//    a position is read as an integer (no f64 conversion on a step) and a
//    value with one vector load (pixel_loop.cuh load_value64);
//  * positions and anchor pointers are int64 (View #27's period is
//    28.3e9; int32 ones where the orbit allows measured no faster);
//  * the cursor is K3's: the positions of anchors a+1 and a+2 and the value
//    of anchor a+1 in registers, the next ones loaded when a step that
//    reaches an anchor starts; the rebase target (Z[0], its f32 pair,
//    anchor 1's value and the positions of anchors 1 and 2) is held for
//    the launch, so a rebase loads nothing.
//
// The guard and why it gives the flushed recurrence's bits.  A step is
// admitted when zx and zy (of Z[pos]) are each zero or of an exponent
// in [kGuardLo, kGuardHi] = [-450, 500] (csrc/df32.cuh guard_in, read off
// the high word; every value here is an anchor flushed on the host, a
// flushed result or an admitted one, never subnormal), and cx and cy (c
// low, flushed on the host) likewise, tested once a launch.  Then, with
// E = -450:
//  * every nonzero operand is a multiple of 2^(E-52) of magnitude at
//    least 2^E and below 2^501;
//  * a product of two nonzero operands (zx*zx, zy*zy, (2 zx)*zy; 2 zx is
//    exact) lies in [2^(2E), 2^1003]: normal, and, rounded to 53 bits, a
//    multiple of its ulp, which is at least 2^(2E-52) = 2^-952; a product
//    with a zero factor is a zero;
//  * so zx*zx - zy*zy, and its sum with cx (a multiple of 2^(E-52), so of
//    2^-952), and (2 zx)*zy + cy are exact sums of multiples of 2^-952:
//    zero or at least 2^-952 in magnitude before rounding, hence after
//    (2^-952 is representable and rounding is monotone), and below 2^1004:
//    no result is subnormal or infinite.
// ftz() is the identity on zeros (signed ones too) and on normal numbers,
// so the unflushed __dmul_rn / __dsub_rn / __dadd_rn give the flushed
// operations' bits, operation by operation.  There is no FMA: the
// reference rounds each product (rc_tail.py:136-137), and -fmad=false
// keeps the compiler from fusing them.

#include <cuda_runtime.h>

#include <cstdint>

#include "df32.cuh"
#include "hdr.cuh"
#include "pixel_loop.cuh"

namespace {

using fs::DF;
using fs::HdrC;

// threads per block
constexpr int kBlock = 128;
// steps a queue lane runs before it looks at the queue again (lav2.cu)
constexpr int kRound = 32;

struct RcParams {
  int n_work;
  int64_t max_ref;
  float zx_mr, zy_mr;
  int64_t max_iter;
  int64_t chunk_steps;
  int init;
};

// K3's reconstruction: df32 values (x hi, x lo, y hi, y lo), positions I
template <typename I>
struct DfRecon {
  using Pos = I;
  using Z = float4;
  using Cursor = fs::AnchorCursor<I>;
  const I *aidx;
  const float *aval;
  I m;
  DF cx, cy;

  __device__ __forceinline__ Cursor cursor() const {
    return Cursor(aidx, aval, m);
  }
  __device__ __forceinline__ I position(I a) const { return aidx[a]; }
  __device__ __forceinline__ Z value(I a) const {
    return fs::load_anchor(aval + 4 * a);
  }
  __device__ __forceinline__ Z step(Z z) const {
    DF zx = {z.x, z.y}, zy = {z.z, z.w};
    fs::df_orbit_step(zx, zy, cx, cy);
    return make_float4(zx.hi, zx.lo, zy.hi, zy.lo);
  }
  // the values the HDR step reads: the hi parts
  static __device__ __forceinline__ float re(Z z) { return z.x; }
  static __device__ __forceinline__ float im(Z z) { return z.z; }
};

template <typename R, bool kQueue>
__global__ void __launch_bounds__(kBlock)
    rc_tail_kernel(const float *__restrict__ dcr,
                   const float *__restrict__ dci,
                   const int32_t *__restrict__ dce, R rc, float *st_dzr,
                   float *st_dzi, int32_t *st_dze, int64_t *st_rem,
                   typename R::Pos *st_pos, typename R::Pos *st_aptr,
                   typename R::Z *st_z, uint8_t *st_done,
                   const int32_t *__restrict__ work, int32_t *counter,
                   RcParams P) {
  using I = typename R::Pos;
  using Z = typename R::Z;
  const typename R::Cursor cur = rc.cursor();
  const I n_anchor = rc.m;
  const I max_ref = static_cast<I>(P.max_ref);
  // steps a pixel may run in this launch (chunk_steps 0: no bound)
  const int64_t chunk = P.chunk_steps > 0 ? P.chunk_steps : INT64_MAX;
  const int lanes = gridDim.x * blockDim.x;
  int item = blockIdx.x * blockDim.x + threadIdx.x;  // this lane's first
  int p = -1;  // this lane's pixel, -1 while it has none

  HdrC dc{}, dz{};
  int64_t rem = 0, k = 0;
  I pos = 0, a = 0;  // orbit position, last anchor at or before it
  I n1 = 0, n2 = 0;  // positions of anchors a+1 and a+2
  Z z{}, nv{};       // Z[pos] and anchor a+1's value
  bool done = true;

  for (;;) {
    if (p < 0) {
      if (item < 0) item = kQueue ? lanes + atomicAdd(counter, 1) : P.n_work;
      if (item >= P.n_work) break;
      p = work ? work[item] : item;
      item = -1;
      dc = {dcr[p], dci[p], dce[p]};
      dz = {st_dzr[p], st_dzi[p], st_dze[p]};
      rem = st_rem[p];
      pos = st_pos[p];
      a = st_aptr[p];
      z = st_z[p];
      done = st_done[p] != 0;
      if (P.init) {
        // on entry rem holds the completed iterations and pos the jwait
        const int64_t it = rem;
        const I jw = pos;
        if (jw >= max_ref && !done) {
          dz = fs::reduce_complex(
              fs::complex_add(HdrC{P.zx_mr, P.zy_mr, 0}, dz));
          pos = 0;
        } else {
          const I hi = max_ref - 1 > 0 ? max_ref - 1 : 0;
          pos = jw < 0 ? 0 : (jw > hi ? hi : jw);
        }
        rem = P.max_iter - it > 0 ? P.max_iter - it : 0;
        if (rem == 0) done = true;
        if (!done) {
          // last anchor <= pos (anchor 0 is position 0), then catch up
          I lo = 0, up = n_anchor;
          while (lo < up) {
            const I mid = lo + (up - lo) / 2;
            if (rc.position(mid) <= pos) lo = mid + 1; else up = mid;
          }
          a = lo - 1;
          z = rc.value(a);
          for (I c = pos - rc.position(a); c > 0; --c) z = rc.step(z);
        }
      }
      if (!done) {
        n1 = cur.position(a + 1);
        n2 = cur.position(a + 2);
        nv = cur.value(a + 1);
      }
      k = 0;
    }

    // a round of up to kRound steps (the queue), or all of the launch's
    const int64_t stop = kQueue && chunk - k > kRound ? k + kRound : chunk;
    for (; !done && k < stop; ++k) {
      // Z[pos+1]: anchor a+1's value if it sits there (then the next
      // anchor's position and value are loaded now, for the steps after),
      // else the recurrence
      const bool hit = n1 == pos + 1;
      I n3 = n2;
      Z nv2 = nv, zn = nv;
      if (hit) {
        n3 = cur.position(a + 3);
        nv2 = cur.value(a + 2);
      } else {
        zn = rc.step(z);
      }
      const fs::HdrStep<float> o =
          fs::hdr_step<true>(R::re(z), R::im(z), R::re(zn), R::im(zn), dz,
                             dc);
      if (o.esc) {
        done = true;
        break;
      }
      rem -= 1;
      if (o.lower || pos + 1 >= max_ref) {
        dz = o.zf;
        pos = 0;
        a = 0;
        z = cur.v0;
        n1 = cur.position(1);
        n2 = cur.position(2);
        nv = cur.value(1);
      } else {
        dz = o.ndz;
        pos += 1;
        z = zn;
        if (hit) {
          a += 1;
          n1 = n2;
          n2 = n3;
          nv = nv2;
        }
      }
      if (rem == 0) done = true;
    }

    if (done || k >= chunk) {
      st_dzr[p] = dz.re;
      st_dzi[p] = dz.im;
      st_dze[p] = dz.e;
      st_rem[p] = rem;
      st_pos[p] = pos;
      st_aptr[p] = a;
      st_z[p] = z;
      st_done[p] = done ? 1 : 0;
      p = -1;
    }
  }
}

// ---------------------------------------------------------------- K19

// K19's anchor table and c low: rows f64 [m, 4] (pixel_loop.cuh
// load_value64), cx and cy flushed on the host
struct GatherTable {
  const double *rows;
  int64_t m;
  double cx, cy;
};

// the recurrence z <- z^2 + c (rc_tail.py:136-137) with every result
// flushed, as the twin computes it (perturb_stream.py _f64_step)
__device__ __forceinline__ double2 recur_flushed(double2 z, double cx,
                                                 double cy) {
  using fs::fadd;
  using fs::fmul;
  using fs::fsub;
  return make_double2(fadd(fsub(fmul(z.x, z.x), fmul(z.y, z.y)), cx),
                      fadd(fmul(fmul(2.0, z.x), z.y), cy));
}

// the same operations unflushed: its bits where the guard admits z and c
// (the argument in this file's header)
__device__ __forceinline__ double2 recur_exact(double2 z, double cx,
                                               double cy) {
  return make_double2(
      __dadd_rn(__dsub_rn(__dmul_rn(z.x, z.x), __dmul_rn(z.y, z.y)), cx),
      __dadd_rn(__dmul_rn(__dmul_rn(2.0, z.x), z.y), cy));
}

// a value as the f32 pair the HDR step reads (pixel_loop.cuh f32_of)
__device__ __forceinline__ float2 f32_pair(double2 z) {
  return make_float2(fs::f32_of(z.x), fs::f32_of(z.y));
}

struct Cursor64 {
  static constexpr int64_t kNone = INT64_MAX;  // past the last anchor
  GatherTable T;
  bool c_in;  // cx and cy admitted (the guard's once-a-launch half)

  // anchor a's position (kNone past the last anchor: never reached) and
  // value (the last row's past it: never used)
  __device__ __forceinline__ int64_t position(int64_t a) const {
    return a < T.m ? fs::load_position(reinterpret_cast<const int64_t *>(
                         T.rows + 4 * a + 2))
                   : kNone;
  }
  __device__ __forceinline__ double2 value(int64_t a) const {
    return fs::load_value64(T.rows + 4 * (a < T.m ? a : T.m - 1));
  }
  __device__ __forceinline__ bool admits(double2 z) const {
    return c_in & fs::guard_in(z.x) & fs::guard_in(z.y);
  }
  // one recurrence step, guarded
  __device__ __forceinline__ double2 recur(double2 z) const {
    if (admits(z)) return recur_exact(z, T.cx, T.cy);
    return recur_flushed(z, T.cx, T.cy);
  }
};

template <bool kQueue>
__global__ void __launch_bounds__(kBlock)
    rc_gather_kernel(const float *__restrict__ dcr,
                     const float *__restrict__ dci,
                     const int32_t *__restrict__ dce, GatherTable T,
                     float *st_dzr, float *st_dzi, int32_t *st_dze,
                     int64_t *st_rem, int64_t *st_pos, int64_t *st_aptr,
                     double2 *st_z, uint8_t *st_done,
                     const int32_t *__restrict__ work, int32_t *counter,
                     RcParams P) {
  const Cursor64 cur = {T, fs::guard_in(T.cx) && fs::guard_in(T.cy)};
  const int64_t max_ref = P.max_ref;
  // the rebase target, held for the launch: Z[0] (f64 and its f32 pair),
  // the positions of anchors 1 and 2 and anchor 1's value
  const double2 v0 = cur.value(0), v1 = cur.value(1);
  const float2 g0 = f32_pair(v0);
  const int64_t p1 = cur.position(1), p2 = cur.position(2);
  // steps a pixel may run in this launch (chunk_steps 0: no bound)
  const int64_t chunk = P.chunk_steps > 0 ? P.chunk_steps : INT64_MAX;
  const int lanes = gridDim.x * blockDim.x;
  int item = blockIdx.x * blockDim.x + threadIdx.x;  // this lane's first
  int p = -1;  // this lane's pixel, -1 while it has none

  HdrC dc{}, dz{};
  int64_t rem = 0, k = 0;
  int64_t pos = 0, a = 0;  // orbit position, last anchor at or before it
  int64_t n1 = 0, n2 = 0;  // positions of anchors a+1 and a+2
  double2 z{}, nv{};       // Z[pos] and anchor a+1's value
  float2 f0{};             // Z[pos]'s f32 pair
  bool done = true;

  for (;;) {
    if (p < 0) {
      if (item < 0) item = kQueue ? lanes + atomicAdd(counter, 1) : P.n_work;
      if (item >= P.n_work) break;
      p = work ? work[item] : item;
      item = -1;
      dc = {dcr[p], dci[p], dce[p]};
      dz = {st_dzr[p], st_dzi[p], st_dze[p]};
      rem = st_rem[p];
      pos = st_pos[p];
      a = st_aptr[p];
      z = st_z[p];
      done = st_done[p] != 0;
      if (P.init) {
        // on entry rem holds the completed iterations and pos the jwait
        const int64_t it = rem;
        const int64_t jw = pos;
        if (jw >= max_ref && !done) {
          dz = fs::reduce_complex(
              fs::complex_add(HdrC{P.zx_mr, P.zy_mr, 0}, dz));
          pos = 0;
        } else {
          const int64_t hi = max_ref - 1 > 0 ? max_ref - 1 : 0;
          pos = jw < 0 ? 0 : (jw > hi ? hi : jw);
        }
        rem = P.max_iter - it > 0 ? P.max_iter - it : 0;
        if (rem == 0) done = true;
        if (!done) {
          // last anchor <= pos (anchor 0 is position 0), then catch up
          int64_t lo = 0, up = T.m;
          while (lo < up) {
            const int64_t mid = lo + (up - lo) / 2;
            if (cur.position(mid) <= pos) lo = mid + 1; else up = mid;
          }
          a = lo - 1;
          z = cur.value(a);
          for (int64_t c = pos - cur.position(a); c > 0; --c)
            z = cur.recur(z);
        }
      }
      if (!done) {
        n1 = cur.position(a + 1);
        n2 = cur.position(a + 2);
        nv = cur.value(a + 1);
        f0 = f32_pair(z);
      }
      k = 0;
    }

    // a round of up to kRound steps (the queue), or all of the launch's
    const int64_t stop = kQueue && chunk - k > kRound ? k + kRound : chunk;
    for (; !done && k < stop; ++k) {
      // Z[pos+1]: anchor a+1's value if it sits there (then the next
      // anchor's position and value are loaded now, for the steps after),
      // else the recurrence from Z[pos], unflushed where the guard admits
      const bool hit = n1 == pos + 1;
      int64_t n3 = n2;
      double2 nv2 = nv, zn = nv;
      if (hit) {
        n3 = cur.position(a + 3);
        nv2 = cur.value(a + 2);
      } else {
        zn = cur.recur(z);
      }
      const float2 f1 = f32_pair(zn);
      const fs::HdrStep<float> o =
          fs::hdr_step<true>(f0.x, f0.y, f1.x, f1.y, dz, dc);
      if (o.esc) {
        done = true;
        break;
      }
      rem -= 1;
      if (o.lower || pos + 1 >= max_ref) {
        dz = o.zf;
        pos = 0;
        a = 0;
        z = v0;
        f0 = g0;
        n1 = p1;
        n2 = p2;
        nv = v1;
      } else {
        dz = o.ndz;
        pos += 1;
        z = zn;
        f0 = f1;
        if (hit) {
          a += 1;
          n1 = n2;
          n2 = n3;
          nv = nv2;
        }
      }
      if (rem == 0) done = true;
    }

    if (done || k >= chunk) {
      st_dzr[p] = dz.re;
      st_dzi[p] = dz.im;
      st_dze[p] = dz.e;
      st_rem[p] = rem;
      st_pos[p] = pos;
      st_aptr[p] = a;
      st_z[p] = z;
      st_done[p] = done ? 1 : 0;
      p = -1;
    }
  }
}

// blocks of `kernel` the card holds at once (0 on a CUDA error, in *err)
template <typename K>
int64_t resident_blocks(K kernel, cudaError_t *err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kBlock, 0);
  return *err == cudaSuccess ? int64_t{per_sm} * sms : 0;
}

// a kernel pair of K3 or K19 on the stream: the queue form kq only when
// some lane must take a second pixel, else k1, a lane a pixel
template <typename K, typename... A>
int launch(K kq, K k1, int32_t n_work, void *counter, cudaStream_t stream,
           A... args) {
  cudaError_t err;
  const int64_t resident = resident_blocks(kq, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t want = (n_work + int64_t{kBlock} - 1) / kBlock;
  const bool queue = want > resident;
  err = cudaMemsetAsync(counter, 0, sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const K kernel = queue ? kq : k1;
  kernel<<<static_cast<int>(queue ? resident : want), kBlock, 0, stream>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch_rc(const void *dcr, const void *dci, const void *dce, const R &rc,
              void *st_dzr, void *st_dzi, void *st_dze, void *st_rem,
              void *st_pos, void *st_aptr, void *st_z, void *st_done,
              const void *work, void *counter, int32_t n_work,
              const RcParams &P, cudaStream_t stream) {
  using I = typename R::Pos;
  return launch(
      rc_tail_kernel<R, true>, rc_tail_kernel<R, false>, n_work, counter,
      stream, static_cast<const float *>(dcr),
      static_cast<const float *>(dci), static_cast<const int32_t *>(dce), rc,
      static_cast<float *>(st_dzr), static_cast<float *>(st_dzi),
      static_cast<int32_t *>(st_dze), static_cast<int64_t *>(st_rem),
      static_cast<I *>(st_pos), static_cast<I *>(st_aptr),
      static_cast<typename R::Z *>(st_z), static_cast<uint8_t *>(st_done),
      static_cast<const int32_t *>(work), static_cast<int32_t *>(counter), P);
}

}  // namespace

// K3.  work: the launch's pixel indices (int32 [n_work]), or null for
// pixels 0..n_work-1; counter: one int32 of device scratch for the work
// queue.  aidx, st_pos and st_aptr are int32 (flags bit 1 clear; max_ref <
// 2^31 - 1) or int64 (bit 1 set).  flags bit 0: the init launch (the
// handoff).
extern "C" int fs_rc_tail(const void *dcr, const void *dci, const void *dce,
                          const void *aidx, const void *aval, void *st_dzr,
                          void *st_dzi, void *st_dze, void *st_rem,
                          void *st_pos, void *st_aptr, void *st_z,
                          void *st_done, const void *work, void *counter,
                          int32_t n_work, int64_t n_anchor, int64_t max_ref,
                          float cxh, float cxl, float cyh, float cyl,
                          float zx_mr, float zy_mr, int64_t max_iter,
                          int64_t chunk_steps, int32_t flags, void *stream) {
  if (n_work <= 0) return 0;
  const bool wide = (flags & 2) != 0;
  if (n_anchor < 1 || (!wide && max_ref >= INT32_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  const RcParams P = {n_work, max_ref, zx_mr, zy_mr, max_iter, chunk_steps,
                      flags & 1};
  const auto st = static_cast<cudaStream_t>(stream);
  if (wide) {
    const DfRecon<int64_t> rc = {static_cast<const int64_t *>(aidx),
                                 static_cast<const float *>(aval), n_anchor,
                                 DF{cxh, cxl}, DF{cyh, cyl}};
    return launch_rc(dcr, dci, dce, rc, st_dzr, st_dzi, st_dze, st_rem,
                     st_pos, st_aptr, st_z, st_done, work, counter, n_work, P,
                     st);
  }
  const DfRecon<int32_t> rc = {static_cast<const int32_t *>(aidx),
                               static_cast<const float *>(aval),
                               static_cast<int32_t>(n_anchor), DF{cxh, cxl},
                               DF{cyh, cyl}};
  return launch_rc(dcr, dci, dce, rc, st_dzr, st_dzi, st_dze, st_rem,
                   st_pos, st_aptr, st_z, st_done, work, counter, n_work, P,
                   st);
}

// K19.  rows: the anchors, f64 [n_anchor, 4] (x, y, the position's int64
// bits, a pad); st_pos and st_aptr int64, st_z f64 [P, 2]; work, counter
// and flags bit 0 as K3's.
extern "C" int fs_rc_tail_f64(const void *dcr, const void *dci,
                              const void *dce, const void *rows,
                              void *st_dzr, void *st_dzi, void *st_dze,
                              void *st_rem, void *st_pos, void *st_aptr,
                              void *st_z, void *st_done, const void *work,
                              void *counter, int32_t n_work,
                              int64_t n_anchor, int64_t max_ref, double cx,
                              double cy, float zx_mr, float zy_mr,
                              int64_t max_iter, int64_t chunk_steps,
                              int32_t flags, void *stream) {
  if (n_work <= 0) return 0;
  if (n_anchor < 1) return static_cast<int>(cudaErrorInvalidValue);
  const RcParams P = {n_work, max_ref, zx_mr, zy_mr, max_iter, chunk_steps,
                      flags & 1};
  const GatherTable T = {static_cast<const double *>(rows), n_anchor, cx, cy};
  return launch(
      rc_gather_kernel<true>, rc_gather_kernel<false>, n_work, counter,
      static_cast<cudaStream_t>(stream), static_cast<const float *>(dcr),
      static_cast<const float *>(dci), static_cast<const int32_t *>(dce), T,
      static_cast<float *>(st_dzr), static_cast<float *>(st_dzi),
      static_cast<int32_t *>(st_dze), static_cast<int64_t *>(st_rem),
      static_cast<int64_t *>(st_pos), static_cast<int64_t *>(st_aptr),
      static_cast<double2 *>(st_z), static_cast<uint8_t *>(st_done),
      static_cast<const int32_t *>(work), static_cast<int32_t *>(counter), P);
}
