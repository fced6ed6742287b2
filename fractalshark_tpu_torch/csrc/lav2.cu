// K2: the LAv2 per-pixel machine, one thread per pixel.
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
// stage 0; the state is the phase-2 handoff, or the LAO render).  Counters and positions
// are int64; the node table's integer fields come from the int64 side
// table, so nothing wraps at 2^31.
//
// Design: the reference runs every pixel in lockstep and pays one
// gather of a packed [N,16] node row per body step; here each thread
// walks its own pixel and reads its own row (64 B) and orbit row (16 B)
// per step from device memory through L1/L2 (the tables are small
// enough to stay cache-resident: ~270k nodes = 17 MB at View #6).
// Bound: latency of those dependent loads plus ~100 FP32 (or FP64) ops per
// step;
// divergence between the LA and tail branches within a warp.  The state
// lives in registers and goes back to memory once per launch: launches
// are bounded by chunk_steps body steps per pixel and resume from it.

#include <cuda_runtime.h>

#include <cstdint>

#include "hdr.cuh"
#include "la_common.cuh"

namespace {

template <typename T>
using Hdr = fs::HdrT<T>;
template <typename T>
using HdrC = fs::HdrCT<T>;

struct Lav2Params {
  int n_pixels;
  int n_nodes;
  int stage_count;
  int64_t max_ref;
  int64_t max_iter;
  int64_t chunk_steps;
  int64_t at_step;
  int la_only;
  int init;
};

using fs::bits;
using fs::cheb_r;
using fs::load_row;

template <typename T>
__global__ void lav2_kernel(
    const T *__restrict__ dcr, const T *__restrict__ dci,
    const int32_t *__restrict__ dce, const T *__restrict__ nodes,
    const int64_t *__restrict__ side, const T *__restrict__ orbit,
    const T *__restrict__ stages, const T *__restrict__ at, int32_t *st_s,
    int32_t *st_j, int64_t *st_ref, T *st_dzr, T *st_dzi, int32_t *st_dze,
    int64_t *st_it, uint8_t *st_done, Lav2Params P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P.n_pixels) return;
  const HdrC<T> dc = {dcr[p], dci[p], dce[p]};
  const Hdr<T> dc_cheb = cheb_r(dc);
  const int64_t n = P.max_iter;

  int32_t s, j;
  int64_t ref_iter, it;
  HdrC<T> dz;
  bool done;
  if (P.init) {
    // ---------------- AT head skip (ATInfo.h:157-188) -------------------
    it = 0;
    dz = {T(0), T(0), fs::kMinBigExponent};
    fs::at_head_skip(at, dc, dc_cheb, n, P.at_step, dz, it);
    s = P.stage_count - 1;
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

  const Hdr<T> two56 = {T(1), 8};
  for (int64_t k = 0; !done && (P.chunk_steps == 0 || k < P.chunk_steps);
       ++k) {
    if (s >= 0) {
      // ---------------- LA branch ---------------------------------------
      const T *st = stages + 4 * s;
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
        const bool usable =
            (it + l) <= n && fs::lt_reduced(cheb_r(newdz), thr);
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
    } else {
      // ---------------- tail branch -------------------------------------
      const int64_t oj =
          ref_iter < 0 ? 0 : (ref_iter > P.max_ref ? P.max_ref : ref_iter);
      const T *og = orbit + 4 * oj;
      const HdrC<T> zj = {og[0], og[1], 0};
      const HdrC<T> t2 = fs::complex_add(fs::complex_mul_pow2(zj, 1), dz);
      const HdrC<T> ndz =
          fs::reduce_complex(fs::complex_add(fs::complex_mul(t2, dz), dc));
      const HdrC<T> zf =
          fs::reduce_complex(fs::complex_add(HdrC<T>{og[2], og[3], 0}, ndz));
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
    }
    if (it >= n) done = true;
    if (P.la_only && s < 0) done = true;
  }

  st_s[p] = s;
  st_j[p] = j;
  st_ref[p] = ref_iter;
  st_dzr[p] = dz.re;
  st_dzi[p] = dz.im;
  st_dze[p] = dz.e;
  st_it[p] = it;
  st_done[p] = done ? 1 : 0;
}

template <typename T>
int launch(const void *dcr, const void *dci, const void *dce,
           const void *nodes, const void *side, const void *orbit,
           const void *stages, const void *at, void *st_s, void *st_j,
           void *st_ref, void *st_dzr, void *st_dzi, void *st_dze,
           void *st_it, void *st_done, int32_t n_pixels, int32_t n_nodes,
           int32_t stage_count, int64_t max_ref, int64_t max_iter,
           int64_t chunk_steps, int64_t at_step, int32_t flags,
           void *stream) {
  const Lav2Params P = {n_pixels, n_nodes,    stage_count, max_ref,
                        max_iter, chunk_steps, at_step,     flags & 1,
                        (flags >> 1) & 1};
  const int block = 128;
  const int grid = (n_pixels + block - 1) / block;
  lav2_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T *>(dcr), static_cast<const T *>(dci),
      static_cast<const int32_t *>(dce), static_cast<const T *>(nodes),
      static_cast<const int64_t *>(side), static_cast<const T *>(orbit),
      static_cast<const T *>(stages), static_cast<const T *>(at),
      static_cast<int32_t *>(st_s), static_cast<int32_t *>(st_j),
      static_cast<int64_t *>(st_ref), static_cast<T *>(st_dzr),
      static_cast<T *>(st_dzi), static_cast<int32_t *>(st_dze),
      static_cast<int64_t *>(st_it), static_cast<uint8_t *>(st_done), P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FS_LAV2_ARGS                                                         \
  const void *dcr, const void *dci, const void *dce, const void *nodes,      \
      const void *side, const void *orbit, const void *stages,               \
      const void *at, void *st_s, void *st_j, void *st_ref, void *st_dzr,    \
      void *st_dzi, void *st_dze, void *st_it, void *st_done,                \
      int32_t n_pixels, int32_t n_nodes, int32_t stage_count,                \
      int64_t max_ref, int64_t max_iter, int64_t chunk_steps,                \
      int64_t at_step, int32_t flags, void *stream
#define FS_LAV2_PASS                                                         \
  dcr, dci, dce, nodes, side, orbit, stages, at, st_s, st_j, st_ref, st_dzr, \
      st_dzi, st_dze, st_it, st_done, n_pixels, n_nodes, stage_count,        \
      max_ref, max_iter, chunk_steps, at_step, flags, stream

extern "C" int fs_lav2(FS_LAV2_ARGS) { return launch<float>(FS_LAV2_PASS); }

extern "C" int fs_lav2_f64(FS_LAV2_ARGS) {
  return launch<double>(FS_LAV2_PASS);
}
