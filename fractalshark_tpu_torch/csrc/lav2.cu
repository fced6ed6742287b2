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
// Modes: full (run to escape or budget) and la_only (done on leaving
// stage 0; the state is the phase-2 handoff).  Counters and positions
// are int64; the node table's integer fields come from the int64 side
// table, so nothing wraps at 2^31.
//
// Design: the reference runs every pixel in lockstep and pays one
// gather of a packed [N,16] node row per body step; here each thread
// walks its own pixel and reads its own row (64 B) and orbit row (16 B)
// per step from device memory through L1/L2 (the tables are small
// enough to stay cache-resident: ~270k nodes = 17 MB at View #6).
// Bound: latency of those dependent loads plus ~100 FP32 ops per step;
// divergence between the LA and tail branches within a warp.  The state
// lives in registers and goes back to memory once per launch: launches
// are bounded by chunk_steps body steps per pixel and resume from it.

#include <cuda_runtime.h>

#include <cstdint>

#include "hdr.cuh"

namespace {

using fs::Hdr;
using fs::HdrC;

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

__device__ __forceinline__ Hdr cheb_r(HdrC z) {
  return fs::reduce(fs::chebychev_norm(z));
}

__device__ __forceinline__ int32_t bits(float v) { return __float_as_int(v); }

__global__ void lav2_kernel(
    const float *__restrict__ dcr, const float *__restrict__ dci,
    const int32_t *__restrict__ dce, const float *__restrict__ nodes,
    const int64_t *__restrict__ side, const float *__restrict__ orbit,
    const int32_t *__restrict__ stages, const float *__restrict__ at,
    int32_t *st_s, int32_t *st_j, int64_t *st_ref, float *st_dzr,
    float *st_dzi, int32_t *st_dze, int64_t *st_it, uint8_t *st_done,
    Lav2Params P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P.n_pixels) return;
  const HdrC dc = {dcr[p], dci[p], dce[p]};
  const Hdr dc_cheb = cheb_r(dc);
  const int64_t n = P.max_iter;

  int32_t s, j;
  int64_t ref_iter, it;
  HdrC dz;
  bool done;
  if (P.init) {
    // ---------------- AT head skip (ATInfo.h:157-188) -------------------
    it = 0;
    dz = {0.0f, 0.0f, fs::kMinBigExponent};
    if (P.at_step > 0) {
      const Hdr thrc = {at[0], bits(at[1])};
      const Hdr sqr_esc = {at[2], bits(at[3])};
      const HdrC refc = {at[4], at[5], bits(at[6])};
      const HdrC cc = {at[7], at[8], bits(at[9])};
      const HdrC invzc = {at[10], at[11], bits(at[12])};
      if (fs::lte_reduced(dc_cheb, thrc)) {
        const HdrC c_at =
            fs::reduce_complex(fs::complex_add(fs::complex_mul(dc, cc), refc));
        const int64_t at_max = n / P.at_step;
        HdrC z = {0.0f, 0.0f, fs::kMinBigExponent};
        int64_t cnt = 0;
        while (cnt < at_max) {
          if (fs::gt_reduced(fs::reduce(fs::norm_squared(z)), sqr_esc)) break;
          z = fs::reduce_complex(fs::complex_add(fs::complex_sqr(z), c_at));
          ++cnt;
        }
        dz = fs::reduce_complex(fs::complex_mul(z, invzc));
        it = cnt * P.at_step;
      }
    }
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

  const Hdr two56 = {1.0f, 8};
  for (int64_t k = 0; !done && (P.chunk_steps == 0 || k < P.chunk_steps);
       ++k) {
    if (s >= 0) {
      // ---------------- LA branch ---------------------------------------
      const int32_t *st = stages + 4 * s;
      const Hdr thrc0 = {__int_as_float(st[2]), st[3]};
      const bool valid = fs::lt_reduced(dc_cheb, thrc0);
      const int32_t j_eff = (j < 0) ? static_cast<int32_t>(ref_iter) : j;
      if (!valid) {
        s -= 1;
        j = -1;
      } else {
        int64_t node = static_cast<int64_t>(st[0]) + j_eff;
        node = node < 0 ? 0 : (node > P.n_nodes - 1 ? P.n_nodes - 1 : node);
        const float4 *row = reinterpret_cast<const float4 *>(nodes + 16 * node);
        const float4 g0 = row[0], g1 = row[1], g2 = row[2], g3 = row[3];
        const int64_t l = side[2 * node];
        const HdrC ref = {g0.x, g0.y, bits(g0.z)};
        const Hdr thr = {g2.y, bits(g2.z)};
        const HdrC t = fs::complex_add(fs::complex_mul_pow2(ref, 1), dz);
        const HdrC newdz = fs::reduce_complex(fs::complex_mul(t, dz));
        const bool usable =
            (it + l) <= n && fs::lt_reduced(cheb_r(newdz), thr);
        if (!usable) {
          ref_iter = side[2 * node + 1];
          s -= 1;
          j = -1;
        } else {
          const HdrC zc = {g0.w, g1.x, bits(g1.y)};
          const HdrC cc = {g1.z, g1.w, bits(g2.x)};
          const HdrC dz_ev = fs::reduce_complex(fs::complex_add(
              fs::complex_mul(newdz, zc), fs::complex_mul(dc, cc)));
          const HdrC refp1 = {g3.y, g3.z, bits(g3.w)};
          const HdrC z_full = fs::reduce_complex(fs::complex_add(refp1, dz_ev));
          const int32_t j_next = j_eff + 1;
          const bool reb = fs::lt_reduced(cheb_r(z_full), cheb_r(dz_ev)) ||
                           j_next >= st[1];
          dz = reb ? z_full : dz_ev;
          j = reb ? 0 : j_next;
          it += l;
        }
      }
    } else {
      // ---------------- tail branch -------------------------------------
      const int64_t oj =
          ref_iter < 0 ? 0 : (ref_iter > P.max_ref ? P.max_ref : ref_iter);
      const float4 og = reinterpret_cast<const float4 *>(orbit)[oj];
      const HdrC zj = {og.x, og.y, 0};
      const HdrC t2 = fs::complex_add(fs::complex_mul_pow2(zj, 1), dz);
      const HdrC ndz =
          fs::reduce_complex(fs::complex_add(fs::complex_mul(t2, dz), dc));
      const HdrC zf =
          fs::reduce_complex(fs::complex_add(HdrC{og.z, og.w, 0}, ndz));
      const Hdr nsq = fs::reduce(fs::norm_squared(zf));
      const Hdr dsq = fs::reduce(fs::norm_squared(ndz));
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

}  // namespace

extern "C" int fs_lav2(const void *dcr, const void *dci, const void *dce,
                       const void *nodes, const void *side, const void *orbit,
                       const void *stages, const void *at, void *st_s,
                       void *st_j, void *st_ref, void *st_dzr, void *st_dzi,
                       void *st_dze, void *st_it, void *st_done,
                       int32_t n_pixels, int32_t n_nodes, int32_t stage_count,
                       int64_t max_ref, int64_t max_iter, int64_t chunk_steps,
                       int64_t at_step, int32_t flags, void *stream) {
  const Lav2Params P = {n_pixels, n_nodes,    stage_count, max_ref,
                        max_iter, chunk_steps, at_step,     flags & 1,
                        (flags >> 1) & 1};
  const int block = 128;
  const int grid = (n_pixels + block - 1) / block;
  lav2_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float *>(dcr), static_cast<const float *>(dci),
      static_cast<const int32_t *>(dce), static_cast<const float *>(nodes),
      static_cast<const int64_t *>(side), static_cast<const float *>(orbit),
      static_cast<const int32_t *>(stages), static_cast<const float *>(at),
      static_cast<int32_t *>(st_s), static_cast<int32_t *>(st_j),
      static_cast<int64_t *>(st_ref), static_cast<float *>(st_dzr),
      static_cast<float *>(st_dzi), static_cast<int32_t *>(st_dze),
      static_cast<int64_t *>(st_it), static_cast<uint8_t *>(st_done), P);
  return static_cast<int>(cudaGetLastError());
}
