// K2: the LAv2 per-pixel machine, one pixel per lane at a time.
//
// Replaces: fractalshark_tpu/ops/la_kernel.py:97 _lav2_impl (B2, XLA: the
// hot loop of every deep frame's phase 1) and, in full mode,
// fractalshark_tpu/ops/la_pallas.py:45 _kernel (B4, Pallas: LA stepping
// plus the tail in one kernel, AT skip outside it).
//
// The body follows _lav2_impl step for step (la_kernel.py line numbers):
//   per-stage validity |dc| < LAThresholdC(first node)     :142-151
//   AT head skip (init launch only)                        :153-216
//   stage walk, j = -1 entering sentinel                   :249-253
//   newdz, usable, the two drops                           :271-287
//   LA step and rebase                                     :289-304
//   tail with the orbit gather                             :306-325
//   merge and done                                         :327-343
// Mantissas: one template over T = float (fs_lav2: the HDRx32 family) and
// T = double (fs_lav2_f64: the reference's sub_dtype=np.float64 instance
// of _lav2_impl, la_kernel.py:374-376, which AUTO runs for every zoom from
// 2^46 to 2^200 as Gpu1x64PerturbedLAv2).  The float tables are of T; their
// integer fields are bit-cast (f32) or exactly converted (f64), the
// reference's _pack_nodes convention (ibits below).  f64 subnormals: see
// hdr.cuh; every f64 result is flushed as the plain twin flushes it.
// Modes: full (run to escape or budget) and la_only (done on leaving
// stage 0; the state is the phase-2 handoff, or the LAO render).
// Counters and positions are int64; the node table's integer fields come
// from the int64 side table, so nothing wraps at 2^31.
//
// Design: the reference runs every pixel in lockstep and pays one
// gather of a packed [N,16] node row per body step; here each lane walks
// its own pixel and reads its own node row (64 B, 128 B in f64) and orbit
// row (16 B, 32 B in f64) per step.  A pixel runs a few LA steps (about a
// hundred on View #5) and then thousands of tail steps, so:
//  * between launches ops/la_kernel.py hands the kernel only the pixels
//    still live, one lane each;
//  * when a launch has more pixels than the card has lanes, it runs one
//    phase: the LA steps of the pixels in the LA stages (a pixel stops
//    when it leaves them), or the tail steps of those in the tail
//    (ops/la_kernel.py next_work); in full mode a lane whose pixel is
//    done, or has run its chunk, then takes the next pixel of the launch
//    from a work queue (kQueue below), and the phases apart keep a
//    newcomer's LA steps from making a warp whose other lanes are in
//    their tails run the LA branch again.  On View #5 at 1024² (a million
//    pixels, four to eight a lane) this is 7 % faster than one lane per
//    pixel.  la_only there and any launch with fewer pixels than lanes
//    were slower with the queue (20 %, 3-5 %) and run without it; with
//    fewer pixels than lanes a launch runs both phases, one after the
//    other per pixel, and a pixel's tail need not wait for the others' LA
//    steps;
//  * each block keeps the stage table in shared memory;
//  * reduce_complex reads its scale off the bits (csrc/hdr.cuh).
// Measured and not kept (PERF.md §6): each stage's first node row in
// shared memory (slower: registers), K6's row cursor in the tail (no
// faster, 18 more registers in f64), a warp vote each step to run its LA
// lanes before its tail lanes, the phases apart with one lane per pixel
// (no queue), shorter chunks.  The order in which pixels and steps of
// different pixels run changes nothing: each pixel runs its own steps in
// its own order.  The state goes back to memory once per pixel per launch:
// launches are bounded by chunk_steps body steps per pixel and resume from
// it.

#include <cuda_runtime.h>

#include <cstdint>

#include "hdr.cuh"
#include "la_common.cuh"
#include "pixel_loop.cuh"

namespace {

template <typename T>
using Hdr = fs::HdrT<T>;
template <typename T>
using HdrC = fs::HdrCT<T>;

constexpr int kBlock = 128;

struct Lav2Params {
  int n_work;
  int n_nodes;
  int stage_count;
  int64_t max_ref;
  int64_t max_iter;
  int64_t chunk_steps;
  int64_t at_step;
  int la_only;
  int init;
  int phase;
};

// which steps a launch runs: a pixel's LA steps (it stops when it leaves
// the LA stages), its tail steps, or both, one after the other
constexpr int kPhaseBoth = 0;
constexpr int kPhaseLa = 1;
constexpr int kPhaseTail = 2;

using fs::bits;
using fs::cheb_r;
using fs::load_row;

// shared memory of a block: the stages table, [4] T a stage, at most the
// 48 KB a launch may take without opting in
template <typename T>
constexpr int kStageBytes = 4 * sizeof(T);
constexpr int kSmemLimit = 48 * 1024;

// The work queue (kQueue, when a full-mode launch has more pixels than the
// card has lanes): lane i of a grid of L lanes first takes item i, then items
// L, L+1, ... one at a time from a counter that the launch zeroes
// (atomicAdd; the compiler merges the atomics of a warp's asking lanes
// into one).  A lane runs up to kRound steps of its pixel before it looks
// at the queue again: a lane whose pixel ends inside a round idles for the
// rest of it, and the loop of steps holds no warp-wide operation (a vote
// every step cost more than the queue saved, PERF.md §6).  Without the
// queue a lane runs its one pixel to the end of the launch.
constexpr int kRound = 32;

template <typename T, bool kQueue>
__global__ void __launch_bounds__(kBlock) lav2_kernel(
    const T *__restrict__ dcr, const T *__restrict__ dci,
    const int32_t *__restrict__ dce, const T *__restrict__ nodes,
    const int64_t *__restrict__ side, const T *__restrict__ orbit,
    const T *__restrict__ stages, const T *__restrict__ at, int32_t *st_s,
    int32_t *st_j, int64_t *st_ref, T *st_dzr, T *st_dzi, int32_t *st_dze,
    int64_t *st_it, uint8_t *st_done, const int32_t *__restrict__ work,
    int32_t *counter, Lav2Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = P.stage_count;
  T *s_st = reinterpret_cast<T *>(smem);
  for (int i = threadIdx.x; i < 4 * S; i += blockDim.x) s_st[i] = stages[i];
  __syncthreads();

  const Hdr<T> two56 = {T(1), 8};
  const int64_t n = P.max_iter;
  // steps a pixel may run in this launch (chunk_steps 0: no bound)
  const int64_t chunk = P.chunk_steps > 0 ? P.chunk_steps : INT64_MAX;

  const int lanes = gridDim.x * blockDim.x;
  int item = blockIdx.x * blockDim.x + threadIdx.x;  // this lane's first
  int p = -1;  // this lane's pixel, -1 while it has none
  HdrC<T> dc{}, dz{};
  Hdr<T> dc_cheb{};
  int32_t s = 0, j = 0;
  int64_t ref_iter = 0, it = 0, k = 0;
  bool done = false;

  // one LA body step (s >= 0)
  auto la_step = [&]() {
    const T *st = s_st + 4 * s;
    const Hdr<T> thrc0 = {st[2], bits(st[3])};
    const bool valid = fs::lt_reduced(dc_cheb, thrc0);
    const int32_t j_eff = (j < 0) ? static_cast<int32_t>(ref_iter) : j;
    if (!valid) {
      s -= 1;
      j = -1;
    } else {
      int64_t node = static_cast<int64_t>(bits(st[0])) + j_eff;
      node = node < 0 ? 0 : (node > P.n_nodes - 1 ? P.n_nodes - 1 : node);
      T g[16];
      load_row(nodes + 16 * node, g);
      const int64_t l = side[2 * node];
      const HdrC<T> ref = {g[0], g[1], bits(g[2])};
      const Hdr<T> thr = {g[9], bits(g[10])};
      const HdrC<T> t = fs::complex_add(fs::complex_mul_pow2(ref, 1), dz);
      const HdrC<T> newdz = fs::reduce_complex(fs::complex_mul(t, dz));
      const bool usable = (it + l) <= n && fs::lt_reduced(cheb_r(newdz), thr);
      if (!usable) {
        ref_iter = side[2 * node + 1];
        s -= 1;
        j = -1;
      } else {
        const HdrC<T> zc = {g[3], g[4], bits(g[5])};
        const HdrC<T> cc = {g[6], g[7], bits(g[8])};
        const HdrC<T> dz_ev = fs::reduce_complex(fs::complex_add(
            fs::complex_mul(newdz, zc), fs::complex_mul(dc, cc)));
        const HdrC<T> refp1 = {g[13], g[14], bits(g[15])};
        const HdrC<T> z_full =
            fs::reduce_complex(fs::complex_add(refp1, dz_ev));
        const int32_t j_next = j_eff + 1;
        const bool reb = fs::lt_reduced(cheb_r(z_full), cheb_r(dz_ev)) ||
                         j_next >= bits(st[1]);
        dz = reb ? z_full : dz_ev;
        j = reb ? 0 : j_next;
        it += l;
      }
    }
    if (it >= n) done = true;
    if (P.la_only && s < 0) done = true;
    ++k;
  };

  // one tail step (s < 0); false once the pixel stops for this launch
  auto tail_step = [&]() -> bool {
    const int64_t oj =
        ref_iter < 0 ? 0 : (ref_iter > P.max_ref ? P.max_ref : ref_iter);
    const fs::Row<T> og = fs::load_orbit_row(orbit + 4 * oj);
    const HdrC<T> zj = {og.z0r, og.z0i, 0};
    const HdrC<T> t2 = fs::complex_add(fs::complex_mul_pow2(zj, 1), dz);
    const HdrC<T> ndz =
        fs::reduce_complex(fs::complex_add(fs::complex_mul(t2, dz), dc));
    const HdrC<T> zf = fs::reduce_complex(
        fs::complex_add(HdrC<T>{og.z1r, og.z1i, 0}, ndz));
    const Hdr<T> nsq = fs::reduce(fs::norm_squared(zf));
    const Hdr<T> dsq = fs::reduce(fs::norm_squared(ndz));
    if (fs::gt_reduced(nsq, two56)) {
      done = true;
    } else {
      const bool treb =
          fs::lt_reduced(nsq, dsq) || (ref_iter + 1) >= P.max_ref;
      dz = treb ? zf : ndz;
      ref_iter = treb ? 0 : ref_iter + 1;
      it += 1;
    }
    if (it >= n) done = true;
    if (P.la_only) done = true;
    ++k;
    return !done && k < chunk;
  };

  for (;;) {
    if (p < 0) {
      if (item < 0) item = kQueue ? lanes + atomicAdd(counter, 1) : P.n_work;
      if (item >= P.n_work) break;
      p = work ? work[item] : item;
      dc = {dcr[p], dci[p], dce[p]};
      dc_cheb = cheb_r(dc);
      if (P.init) {
        // ---------------- AT head skip (ATInfo.h:157-188) ---------------
        it = 0;
        dz = {T(0), T(0), fs::kMinBigExponent};
        fs::at_head_skip(at, dc, dc_cheb, n, P.at_step, dz, it);
        s = S - 1;
        j = 0;  // the top stage is entered with j = 0
        ref_iter = 0;
        done = it >= n;
      } else {
        s = st_s[p];
        j = st_j[p];
        ref_iter = st_ref[p];
        dz = {st_dzr[p], st_dzi[p], st_dze[p]};
        it = st_it[p];
        done = st_done[p] != 0;
      }
      k = 0;
      item = -1;
    }
    // a round of up to kRound steps of the launch's phase (or, without the
    // queue, all of them)
    const int64_t round_steps = kQueue ? kRound : INT64_MAX;
    if (P.phase == kPhaseLa) {
      for (int64_t r = 0; r < round_steps && !done && s >= 0 && k < chunk; ++r)
        la_step();
    } else if (P.phase == kPhaseTail) {
      if (!done && s < 0 && k < chunk)
        for (int64_t r = 0; r < round_steps && tail_step(); ++r) {
        }
    } else {
      for (int64_t r = 0; r < round_steps && !done && k < chunk; ++r) {
        if (s >= 0)
          la_step();
        else
          tail_step();
      }
    }
    const bool left = P.phase == kPhaseLa     ? s < 0
                      : P.phase == kPhaseTail ? s >= 0
                                              : false;
    if (done || k >= chunk || left) {
      st_s[p] = s;
      st_j[p] = j;
      st_ref[p] = ref_iter;
      st_dzr[p] = dz.re;
      st_dzi[p] = dz.im;
      st_dze[p] = dz.e;
      st_it[p] = it;
      st_done[p] = done ? 1 : 0;
      p = -1;
    }
  }
}

// blocks of kBlock threads of lav2_kernel<T> with smem bytes of shared
// memory that the card holds at once (0 on a CUDA error, in *err)
template <typename T>
int64_t resident_blocks(int smem, cudaError_t *err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lav2_kernel<T, true>, kBlock, smem);
  return *err == cudaSuccess ? int64_t{per_sm} * sms : 0;
}

template <typename T>
int launch(const void *dcr, const void *dci, const void *dce,
           const void *nodes, const void *side, const void *orbit,
           const void *stages, const void *at, void *st_s, void *st_j,
           void *st_ref, void *st_dzr, void *st_dzi, void *st_dze,
           void *st_it, void *st_done, const void *work, void *counter,
           int32_t n_work, int32_t n_nodes, int32_t stage_count,
           int64_t max_ref, int64_t max_iter, int64_t chunk_steps,
           int64_t at_step, int32_t flags, void *stream) {
  if (n_work <= 0) return 0;
  const int64_t smem = int64_t{stage_count} * kStageBytes<T>;
  if (stage_count < 0 || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const int64_t resident = resident_blocks<T>(static_cast<int>(smem), &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the queue only when some lane must take a second pixel, and in full
  // mode: a la_only pixel runs its LA steps alone, and there the queue
  // was slower (PERF.md §6)
  const int64_t want = (n_work + int64_t{kBlock} - 1) / kBlock;
  const bool queue = want > resident && !(flags & 1);
  const int grid = static_cast<int>(queue ? resident : want);
  const Lav2Params P = {n_work,    n_nodes,        stage_count,
                        max_ref,   max_iter,       chunk_steps,
                        at_step,   flags & 1,      (flags >> 1) & 1,
                        (flags >> 2) & 3};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counter, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = queue ? lav2_kernel<T, true> : lav2_kernel<T, false>;
  kernel<<<grid, kBlock, static_cast<int>(smem), st>>>(
      static_cast<const T *>(dcr), static_cast<const T *>(dci),
      static_cast<const int32_t *>(dce), static_cast<const T *>(nodes),
      static_cast<const int64_t *>(side), static_cast<const T *>(orbit),
      static_cast<const T *>(stages), static_cast<const T *>(at),
      static_cast<int32_t *>(st_s), static_cast<int32_t *>(st_j),
      static_cast<int64_t *>(st_ref), static_cast<T *>(st_dzr),
      static_cast<T *>(st_dzi), static_cast<int32_t *>(st_dze),
      static_cast<int64_t *>(st_it), static_cast<uint8_t *>(st_done),
      static_cast<const int32_t *>(work), static_cast<int32_t *>(counter),
      P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// work: the launch's pixel indices (int32 [n_work]), or null for pixels
// 0..n_work-1; counter: one int32 of device scratch for the work queue.
// The grid is one lane per pixel, at most what fits on the card; the
// block's shared memory holds the stage table, and a table past
// kSmemLimit is refused.  flags: bit 0 = la_only, bit 1 = start from the
// zero state (AT skip), bits 2-3 = the phase (kPhaseBoth, kPhaseLa,
// kPhaseTail).
#define FS_LAV2_ARGS                                                         \
  const void *dcr, const void *dci, const void *dce, const void *nodes,      \
      const void *side, const void *orbit, const void *stages,               \
      const void *at, void *st_s, void *st_j, void *st_ref, void *st_dzr,    \
      void *st_dzi, void *st_dze, void *st_it, void *st_done,                \
      const void *work, void *counter, int32_t n_work, int32_t n_nodes,      \
      int32_t stage_count, int64_t max_ref, int64_t max_iter,                \
      int64_t chunk_steps, int64_t at_step, int32_t flags, void *stream
#define FS_LAV2_PASS                                                         \
  dcr, dci, dce, nodes, side, orbit, stages, at, st_s, st_j, st_ref, st_dzr, \
      st_dzi, st_dze, st_it, st_done, work, counter, n_work, n_nodes,        \
      stage_count, max_ref, max_iter, chunk_steps, at_step, flags, stream

extern "C" int fs_lav2(FS_LAV2_ARGS) { return launch<float>(FS_LAV2_PASS); }

extern "C" int fs_lav2_f64(FS_LAV2_ARGS) {
  return launch<double>(FS_LAV2_PASS);
}

// lanes of K2 the card holds at once for a table of stage_count stages
// (resident blocks times kBlock), which decides whether a run splits its
// phases (ops/la_kernel.py split_phases); negative: a CUDA error
extern "C" int fs_lav2_lanes(int32_t stage_count, int32_t f64) {
  cudaError_t err;
  const int64_t blocks =
      f64 ? resident_blocks<double>(stage_count * kStageBytes<double>, &err)
          : resident_blocks<float>(stage_count * kStageBytes<float>, &err);
  return err == cudaSuccess ? static_cast<int>(blocks * kBlock)
                            : -static_cast<int>(err);
}
