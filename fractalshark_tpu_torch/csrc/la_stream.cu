// K7: the streaming LA phase, one LA stage per launch sequence, one thread
// per pixel.
//
// Replaces: fractalshark_tpu/ops/la_stream.py:69 _kernel (B12, Pallas;
// launch _launch :227, API la_phase_stream :386), the phase 1 that
// FRACTALSHARK_LA_PHASE=stream selects (engine/renderers.py:215-240).
//
// The reference sweeps one stage's nodes in lockstep windows: every
// stepping pixel advances its node offset j by one per sweep position, a
// rebase resets j to 0, a pixel enters the stage at j = ref_iter, and
// pixels whose j is elsewhere stall until the sweep reaches it.  The
// sweep only schedules: each pixel's trajectory depends on its own state
// and its own node.  Here each pixel steps its own j from its entry
// offset, which gives the same state with no stalls (la_stream.py:99-181):
//   newdz = dz*(2*Ref[j] + dz)                   (LAInfoDeep::Prepare)
//   usable: step_length <= remaining budget and |newdz|_cheb < LAThreshold
//   not usable: ref_iter = NextStageLAIndex[j], the pixel leaves the stage
//   dz_ev = newdz*ZCoeff + dc*CCoeff, z = Ref[j+1] + dz_ev (Evaluate)
//   rebase (dz = z, j = 0) on |z|_cheb < |dz_ev|_cheb or j+1 = macro,
//   else dz = dz_ev, j += 1; remaining -= step_length, done at 0,
// with the reference's HDR-f32 operations and unreduced compares.  The
// node rows are K2's (ops/tables.py, la_kernel._pack_nodes layout), so
// Ref[j+1] is the row's columns 13-15 and the integer fields come from the
// int64 side table.  Budgets and positions are int64 (the reference's
// (hi, lo) i32 pairs work around Mosaic); entry offsets are clipped to
// [0, macro-1] (la_stream.py:462).
//
// Modes: 0 = init (the AT head skip, la_common.cuh, shared with K2);
// 1 = enter stage s (a pixel takes part iff it is not done, the stage has
// nodes and |dc|_cheb < the stage's first LAThresholdC) and step; 2 = step
// on.  Each launch runs at most chunk_steps steps a pixel; a pixel's act
// flag says it still steps in this stage, and the host relaunches until no
// flag is set (chunk_steps 0: no bound).
// Bound on the H100: the dependent node-row loads (64 B + 16 B a step,
// L2-resident) and about 100 FP32 operations a step; the reference's
// window DMAs have no counterpart.

#include <cuda_runtime.h>

#include <cstdint>

#include "hdr.cuh"
#include "la_common.cuh"

namespace {

using Hdr = fs::HdrT<float>;
using HdrC = fs::HdrCT<float>;

struct StreamParams {
  int n_pixels;
  int n_nodes;
  int stage;
  int64_t max_iter;
  int64_t chunk_steps;
  int64_t at_step;
  int mode;
};

__global__ void la_stream_kernel(
    const float *__restrict__ dcr, const float *__restrict__ dci,
    const int32_t *__restrict__ dce, const float *__restrict__ nodes,
    const int64_t *__restrict__ side, const float *__restrict__ stages,
    const float *__restrict__ at, float *st_dzr, float *st_dzi,
    int32_t *st_dze, int64_t *st_rem, int64_t *st_ref, int32_t *st_j,
    uint8_t *st_act, uint8_t *st_done, StreamParams P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P.n_pixels) return;
  const HdrC dc = {dcr[p], dci[p], dce[p]};
  const Hdr dc_cheb = fs::cheb_r(dc);

  if (P.mode == 0) {
    int64_t it = 0;
    HdrC dz = {0.0f, 0.0f, fs::kMinBigExponent};
    fs::at_head_skip(at, dc, dc_cheb, P.max_iter, P.at_step, dz, it);
    st_dzr[p] = dz.re;
    st_dzi[p] = dz.im;
    st_dze[p] = dz.e;
    st_rem[p] = it < P.max_iter ? P.max_iter - it : 0;
    st_ref[p] = 0;
    st_j[p] = 0;
    st_act[p] = 0;
    st_done[p] = it >= P.max_iter ? 1 : 0;
    return;
  }

  const float *st = stages + 4 * P.stage;
  const int64_t head = fs::bits(st[0]);
  const int32_t macro = fs::bits(st[1]);
  int64_t ref_iter = st_ref[p];
  bool act;
  int32_t j;
  if (P.mode == 1) {
    const Hdr thrc0 = {st[2], fs::bits(st[3])};
    act = !st_done[p] && macro > 0 && fs::lt_reduced(dc_cheb, thrc0);
    j = static_cast<int32_t>(
        ref_iter < 0 ? 0 : (ref_iter > macro - 1 ? macro - 1 : ref_iter));
  } else {
    act = st_act[p] != 0;
    j = st_j[p];
  }
  if (!act) {
    st_act[p] = 0;
    return;
  }

  HdrC dz = {st_dzr[p], st_dzi[p], st_dze[p]};
  int64_t rem = st_rem[p];
  bool done = false;
  for (int64_t k = 0; P.chunk_steps == 0 || k < P.chunk_steps; ++k) {
    int64_t node = head + j;
    node = node > P.n_nodes - 1 ? P.n_nodes - 1 : node;
    float g[16];
    fs::load_row(nodes + 16 * node, g);
    const int64_t l = side[2 * node];
    const HdrC ref = {g[0], g[1], fs::bits(g[2])};
    const Hdr thr = {g[9], fs::bits(g[10])};
    const HdrC t = fs::complex_add(fs::complex_mul_pow2(ref, 1), dz);
    const HdrC newdz = fs::reduce_complex(fs::complex_mul(t, dz));
    if (!(l <= rem && fs::lt_unreduced(fs::chebychev_norm(newdz), thr))) {
      ref_iter = side[2 * node + 1];
      act = false;
      break;
    }
    const HdrC zc = {g[3], g[4], fs::bits(g[5])};
    const HdrC cc = {g[6], g[7], fs::bits(g[8])};
    const HdrC dz_ev = fs::reduce_complex(fs::complex_add(
        fs::complex_mul(newdz, zc), fs::complex_mul(dc, cc)));
    const HdrC rp1 = {g[13], g[14], fs::bits(g[15])};
    const HdrC z_full = fs::reduce_complex(fs::complex_add(rp1, dz_ev));
    const bool reb = fs::lt_unreduced(fs::chebychev_norm(z_full),
                                      fs::chebychev_norm(dz_ev)) ||
                     j + 1 >= macro;
    dz = reb ? z_full : dz_ev;
    rem -= l;
    if (rem == 0) {
      done = true;
      act = false;
      break;
    }
    j = reb ? 0 : j + 1;
  }
  st_dzr[p] = dz.re;
  st_dzi[p] = dz.im;
  st_dze[p] = dz.e;
  st_rem[p] = rem;
  st_ref[p] = ref_iter;
  st_j[p] = j;
  st_act[p] = act ? 1 : 0;
  if (done) st_done[p] = 1;
}

}  // namespace

extern "C" int fs_la_stream(const void *dcr, const void *dci, const void *dce,
                            const void *nodes, const void *side,
                            const void *stages, const void *at, void *st_dzr,
                            void *st_dzi, void *st_dze, void *st_rem,
                            void *st_ref, void *st_j, void *st_act,
                            void *st_done, int32_t n_pixels, int32_t n_nodes,
                            int32_t stage, int64_t max_iter,
                            int64_t chunk_steps, int64_t at_step, int32_t mode,
                            void *stream) {
  const StreamParams P = {n_pixels,    n_nodes, stage, max_iter,
                          chunk_steps, at_step, mode};
  const int block = 128;
  const int grid = (n_pixels + block - 1) / block;
  la_stream_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float *>(dcr), static_cast<const float *>(dci),
      static_cast<const int32_t *>(dce), static_cast<const float *>(nodes),
      static_cast<const int64_t *>(side), static_cast<const float *>(stages),
      static_cast<const float *>(at), static_cast<float *>(st_dzr),
      static_cast<float *>(st_dzi), static_cast<int32_t *>(st_dze),
      static_cast<int64_t *>(st_rem), static_cast<int64_t *>(st_ref),
      static_cast<int32_t *>(st_j), static_cast<uint8_t *>(st_act),
      static_cast<uint8_t *>(st_done), P);
  return static_cast<int>(cudaGetLastError());
}
