// K7: the streaming LA phase, one launch that carries each pixel through
// the AT head skip and every LA stage, one lane per pixel.
//
// Replaces: fractalshark_tpu/ops/la_stream.py:69 _kernel (B12, Pallas;
// launch _launch :227, API la_phase_stream :386), the phase 1 that
// FRACTALSHARK_LA_PHASE=stream selects (engine/renderers.py:215-240).
//
// The reference sweeps one stage's nodes in lockstep windows, stage after
// stage from coarse to fine: every stepping pixel advances its node offset
// j by one per sweep position, a rebase resets j to 0, a pixel enters the
// stage at j = ref_iter, and pixels whose j is elsewhere stall until the
// sweep reaches it.  The sweep and the stage loop only schedule: whether a
// pixel enters stage s, where it enters and how it steps depend only on its
// own dc, done and ref_iter (la_stream.py:386-499).  So here one lane takes
// its pixel from the AT skip through every stage in order and gives the
// same state (la_stream.py:99-181):
//   entry: the pixel is not done, the stage has nodes (macro > 0) and
//          |dc|_cheb < the stage's first LAThresholdC; j = ref_iter
//          clipped to [0, macro-1] (la_stream.py:462); else the next stage
//   newdz = dz*(2*Ref[j] + dz)                   (LAInfoDeep::Prepare)
//   usable: step_length <= remaining budget and |newdz|_cheb < LAThreshold
//   not usable: ref_iter = NextStageLAIndex[j], the pixel leaves the stage
//   dz_ev = newdz*ZCoeff + dc*CCoeff, z = Ref[j+1] + dz_ev (Evaluate)
//   rebase (dz = z, j = 0) on |z|_cheb < |dz_ev|_cheb or j+1 = macro,
//   else dz = dz_ev, j += 1; remaining -= step_length, done at 0,
// with the reference's HDR-f32 operations and unreduced compares (B12's,
// not K2's reduced ones: boolean-identical, hdrfloat.py:220-238).  The node
// rows are K2's (ops/tables.py, la_kernel._pack_nodes layout), so Ref[j+1]
// is the row's columns 13-15 and the integer fields come from the int64
// side table.  Budgets and positions are int64 (the reference's (hi, lo)
// i32 pairs work around Mosaic).
//
// State per pixel between launches: dz, the remaining budget, ref_iter,
// j and the stage s it is stepping in (s = -1: it has left the LA stages,
// or is done).  A launch runs at most chunk_steps steps a pixel, counted
// across stages (0: no bound); a pixel that reaches the bound is stored
// with its next stage entered, so the next launch resumes it stepping.
// The host launches once over every pixel (with the AT skip), then over
// the pixels with s >= 0 (ops/la_stream.py run_stages); a frame whose
// pixels finish within the bound takes one launch.
//
// Bound on the H100: one pixel's chain of dependent steps, each a node row
// (64 B) and its step length (8 B), L2-resident, and about 100 FP32
// operations; the deepest pixel's chain sets a launch's time.  The design
// runs that chain once, in one launch: the state stays in registers from
// the AT skip to the last stage and goes to memory once, the stage table
// sits in shared memory, and no lane waits for a stage sweep or a host
// sync between stages.  The node row is loaded when the step starts, with
// pixel_loop.cuh's asm volatile loads.  Measured and not kept (PERF.md
// §6): the next step's row loaded a step ahead with the stage's row 0 held
// (a cursor as K6's: 72 registers against 47, no faster at 256², 10 %
// slower at 1024²), and a work queue past the card's lanes (13 % slower at
// 1024²).

#include <cuda_runtime.h>

#include <cstdint>

#include "hdr.cuh"
#include "la_common.cuh"
#include "pixel_loop.cuh"

namespace {

using Hdr = fs::HdrT<float>;
using HdrC = fs::HdrCT<float>;
using fs::bits;

constexpr int kBlock = 128;
constexpr int kSmemLimit = 48 * 1024;  // the stage table, 16 B a stage

struct StreamParams {
  int n_work;
  int n_nodes;
  int stage_count;
  int64_t max_iter;
  int64_t chunk_steps;
  int64_t at_step;
  int first;
};

// one node row and its step length, loaded when the step starts
struct Node {
  float4 a, b, c, d;
  int64_t l;
};

__device__ __forceinline__ Node load_node(const float *nodes,
                                          const int64_t *side, int64_t q) {
  const float *r = nodes + 16 * q;
  Node o;
  o.a = fs::load_anchor(r);
  o.b = fs::load_anchor(r + 4);
  o.c = fs::load_anchor(r + 8);
  o.d = fs::load_anchor(r + 12);
  o.l = fs::load_position(side + 2 * q);
  return o;
}

__global__ void __launch_bounds__(kBlock) la_stream_kernel(
    const float *__restrict__ dcr, const float *__restrict__ dci,
    const int32_t *__restrict__ dce, const float *__restrict__ nodes,
    const int64_t *__restrict__ side, const float *__restrict__ stages,
    const float *__restrict__ at, float *st_dzr, float *st_dzi,
    int32_t *st_dze, int64_t *st_rem, int64_t *st_ref, int32_t *st_j,
    int32_t *st_s, uint8_t *st_done, const int32_t *__restrict__ work,
    StreamParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  float *s_st = reinterpret_cast<float *>(smem);
  for (int i = threadIdx.x; i < 4 * P.stage_count; i += blockDim.x)
    s_st[i] = stages[i];
  __syncthreads();

  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= P.n_work) return;
  const int p = work ? work[item] : item;
  const int64_t chunk = P.chunk_steps > 0 ? P.chunk_steps : INT64_MAX;
  const int64_t last = P.n_nodes - 1;
  const HdrC dc = {dcr[p], dci[p], dce[p]};
  const Hdr dc_cheb = fs::cheb_r(dc);
  HdrC dz;
  int64_t rem, ref_iter, head = 0;
  int32_t j, s, macro = 0;
  bool act, done;
  if (P.first) {
    int64_t it = 0;
    dz = {0.0f, 0.0f, fs::kMinBigExponent};
    fs::at_head_skip(at, dc, dc_cheb, P.max_iter, P.at_step, dz, it);
    rem = it < P.max_iter ? P.max_iter - it : 0;
    ref_iter = 0;
    j = 0;
    done = it >= P.max_iter;
    s = done ? -1 : P.stage_count - 1;
    act = false;
  } else {
    dz = {st_dzr[p], st_dzi[p], st_dze[p]};
    rem = st_rem[p];
    ref_iter = st_ref[p];
    j = st_j[p];
    s = st_s[p];
    done = st_done[p] != 0;
    act = s >= 0;  // a stored pixel with s >= 0 is stepping in stage s
    if (act) {
      head = bits(s_st[4 * s]);
      macro = bits(s_st[4 * s + 1]);
    }
  }

  // each pass enters the next stage or runs one step
  for (int64_t k = 0; s >= 0;) {
    if (!act) {
      const float *st = s_st + 4 * s;
      const Hdr thrc0 = {st[2], bits(st[3])};
      macro = bits(st[1]);
      if (!(macro > 0 && fs::lt_reduced(dc_cheb, thrc0))) {
        s -= 1;
        continue;
      }
      act = true;
      head = bits(st[0]);
      j = static_cast<int32_t>(
          ref_iter < 0 ? 0 : (ref_iter > macro - 1 ? macro - 1 : ref_iter));
    }
    if (k >= chunk) break;
    ++k;
    const int64_t q = head + j > last ? last : head + j;
    const Node g = load_node(nodes, side, q);
    const HdrC ref = {g.a.x, g.a.y, bits(g.a.z)};
    const Hdr thr = {g.c.y, bits(g.c.z)};
    const HdrC t = fs::complex_add(fs::complex_mul_pow2(ref, 1), dz);
    const HdrC newdz = fs::reduce_complex(fs::complex_mul(t, dz));
    if (!(g.l <= rem && fs::lt_unreduced(fs::chebychev_norm(newdz), thr))) {
      ref_iter = side[2 * q + 1];
      act = false;
      s -= 1;
      continue;
    }
    const HdrC zc = {g.a.w, g.b.x, bits(g.b.y)};
    const HdrC cc = {g.b.z, g.b.w, bits(g.c.x)};
    const HdrC dz_ev = fs::reduce_complex(fs::complex_add(
        fs::complex_mul(newdz, zc), fs::complex_mul(dc, cc)));
    const HdrC rp1 = {g.d.y, g.d.z, bits(g.d.w)};
    const HdrC z_full = fs::reduce_complex(fs::complex_add(rp1, dz_ev));
    const bool reb = fs::lt_unreduced(fs::chebychev_norm(z_full),
                                      fs::chebychev_norm(dz_ev)) ||
                     j + 1 >= macro;
    dz = reb ? z_full : dz_ev;
    rem -= g.l;
    if (rem == 0) {
      done = true;
      s = -1;
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
  st_s[p] = s;
  st_done[p] = done ? 1 : 0;
}

}  // namespace

// work: the launch's pixel indices (int32 [n_work]), or null for pixels
// 0..n_work-1; first: the first launch (AT skip, state from zero; work must
// be null).  One lane a pixel; a stage table past kSmemLimit is refused.
extern "C" int fs_la_stream(const void *dcr, const void *dci, const void *dce,
                            const void *nodes, const void *side,
                            const void *stages, const void *at, void *st_dzr,
                            void *st_dzi, void *st_dze, void *st_rem,
                            void *st_ref, void *st_j, void *st_s,
                            void *st_done, const void *work, int32_t n_work,
                            int32_t n_nodes, int32_t stage_count,
                            int64_t max_iter, int64_t chunk_steps,
                            int64_t at_step, int32_t first, void *stream) {
  if (n_work <= 0) return 0;
  const int64_t smem = int64_t{stage_count} * 16;
  if (stage_count < 0 || smem > kSmemLimit || n_nodes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamParams P = {n_work,      n_nodes, stage_count, max_iter,
                          chunk_steps, at_step, first};
  const int grid = (n_work + kBlock - 1) / kBlock;
  la_stream_kernel<<<grid, kBlock, static_cast<int>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float *>(dcr), static_cast<const float *>(dci),
      static_cast<const int32_t *>(dce), static_cast<const float *>(nodes),
      static_cast<const int64_t *>(side), static_cast<const float *>(stages),
      static_cast<const float *>(at), static_cast<float *>(st_dzr),
      static_cast<float *>(st_dzi), static_cast<int32_t *>(st_dze),
      static_cast<int64_t *>(st_rem), static_cast<int64_t *>(st_ref),
      static_cast<int32_t *>(st_j), static_cast<int32_t *>(st_s),
      static_cast<uint8_t *>(st_done), static_cast<const int32_t *>(work), P);
  return static_cast<int>(cudaGetLastError());
}
