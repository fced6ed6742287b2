// K9: one whole bignum multiply, from V values (V = 2 or 4, each below
// both primes) to K frequency-domain combinations of their pointwise
// products, int32 [K][2][n] residue rows: the forward NTT modulo both
// primes, the optional sign fold NTT(-a) = p - NTT(a), Montgomery
// pointwise products summed per combination (+-), the inverse NTT and
// the scale.  The rows are the canonical residues of the exact cyclic
// convolutions, the reference's rows word for word.
//
// Replaces: fractalshark_tpu/ops/bignum/ntt_pallas.py:308 _make_kernel
// (B-f1; pallas_call :384 in _ntt_products :365; 2,048 <= n <= 16,384),
// the split trio :593 _fwd_split_kernel, :612 _mid_split_kernel, :650
// _inv_split_kernel (B-f2; pallas_calls :693/:717/:726 in
// _ntt_products_split :671; 16,384 < n <= 131,072) and :764
// _whole_aligned_kernel (B-f3; pallas_call :832 in _ntt_products_whole
// :814, the trio fused back into one kernel).  All three compute one
// function; the reference routes them by size and its WHOLE_ALIGNED flag
// (_products :401).  The TPU's "rollstep" layout (sublane DIF, a lane
// pass by rolls, no transpose) exists for Mosaic and is not copied: K9
// keeps K4's four-step layout (ntt_products.cuh).
//
// Two launch forms of the same device functions (ntt_products.cuh):
//   whole  one cooperative launch (cudaLaunchCooperativeKernel), the
//          forward, row and inverse phases separated by grid-wide
//          barriers (cooperative_groups grid sync), each block looping
//          over its phase's items.  V*2*n words exceed one block's shared
//          memory at these sizes (the NR plan at n = 16,384: 512 KB), so
//          one launch needs the grid barrier; the grid is what can be
//          co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
//          queried once and cached) and a refused launch returns its
//          error, never a fallback.  Serves B-f1 and B-f3.
//   split  three launches, one block per item.  Serves B-f2.
//
// Bound on the H100: at n = 16,384 with the iteration plan a multiply
// reads 128 KB of values and writes 256 KB of rows; its 4 transforms a
// prime of n/2 * 14 butterflies, the twiddle matrices, the pointwise
// products and the scale are about 8.5 M integer operations, 0.5 us at
// the int32 rate (chip_smoke.py products_ops); at n = 131,072 with the
// signed NR-iteration plan 9.8 us.  That work is a few thousand threads'
// worth (8 points a thread), so latency sets the time: a launch, one load
// and one store a phase, a barrier a round, two grid barriers.  Design:
//  * radix-8 register rounds with Shoup twiddles (ntt_rounds.cuh, K8's):
//    3 rounds for a length-128 transform against 7 radix-2 passes, each
//    prime its own instance, the columns bank-swizzled;
//  * T threads a block, halved from 512 until the forward phase has two
//    blocks an SM, then raised until a row block loads its rows in one
//    batch (products_threads), so each phase spreads over the card: at
//    n = 16,384 a block is two warps and a column tile 4 columns; the
//    row phase has one block a (row, prime);
//  * every phase loads its twiddles and data in one batch of up to 8
//    loads a thread in flight (stage_in), one memory latency a phase;
//  * the four-step twiddles are read coalesced from [2 primes][n1][n2]
//    matrices in the row item's order (ntt.k9_tables, cached per size
//    and device), not gathered with a stride of k1 words;
//  * the host side sets and queries each kernel's launch attributes once
//    (launch_info), so a step of the chunk loops does no occupancy query.
// The whole form takes a grid barrier where the split form takes a
// launch; which is faster at each size is in PERF.md.

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_products.cuh"

namespace {

template <int kE1>
__global__ void __launch_bounds__(kProductsMaxThreads)
fwd_kernel(Products P) {
  extern __shared__ uint32_t sm[];
  fwd_item<kE1>(P, blockIdx.x, sm);
}

template <int kE2>
__global__ void __launch_bounds__(kProductsMaxThreads)
row_kernel(Products P) {
  extern __shared__ uint32_t sm[];
  row_item<kE2>(P, blockIdx.x, sm);
}

template <int kE1>
__global__ void __launch_bounds__(kProductsMaxThreads)
inv_kernel(Products P) {
  extern __shared__ uint32_t sm[];
  inv_item<kE1>(P, blockIdx.x, sm);
}

template <int kE1, int kE2>
__global__ void __launch_bounds__(kProductsMaxThreads)
whole_kernel(Products P) {
  extern __shared__ uint32_t sm[];
  products_whole<kE1, kE2>(P, sm);
}

template <int kE1, int kE2>
int launch_split(const Products &P, cudaStream_t st) {
  const void *fns[3] = {reinterpret_cast<const void *>(fwd_kernel<kE1>),
                        reinterpret_cast<const void *>(row_kernel<kE2>),
                        reinterpret_cast<const void *>(inv_kernel<kE1>)};
  const size_t smem[3] = {col_smem(P), row_smem(P), col_smem(P)};
  int rc, per_sm, sms;
  for (int i = 0; i < 3; ++i)
    if ((rc = launch_info(fns[i], P.threads, smem[i], &per_sm, &sms)))
      return rc;
  fwd_kernel<kE1><<<fwd_items(P), P.threads, smem[0], st>>>(P);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  row_kernel<kE2><<<row_items(P), P.threads, smem[1], st>>>(P);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  inv_kernel<kE1><<<inv_items(P), P.threads, smem[2], st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <int kE1, int kE2>
int launch_whole(Products P, cudaStream_t st) {
  int items = fwd_items(P);
  if (row_items(P) > items) items = row_items(P);
  if (inv_items(P) > items) items = inv_items(P);
  void *args[] = {&P};
  return coop_launch(reinterpret_cast<const void *>(whole_kernel<kE1, kE2>),
                     P.threads, items, max_smem(P), args, st);
}

template <int kE1, int kE2>
int launch_form(const Products &P, bool whole, cudaStream_t st) {
  return whole ? launch_whole<kE1, kE2>(P, st) : launch_split<kE1, kE2>(P, st);
}

}  // namespace

// vN: up to 4 value vectors (uint32, din entries each, zero beyond; the
// unused ones null); signs: int32 [V] on the card or null; plan: int32
// host words (ntt_pallas.plan_words); out: uint32 [K][2][n]; work: uint32
// [2(V + K) n]; tables: ntt.k9_tables(n) on the card.  whole: 1 for the
// cooperative form, 0 for the split form.  n = 2^log2n, 4 <= n <= 2^17.
extern "C" int fs_ntt_products(const void *v0, const void *v1, const void *v2,
                               const void *v3, int V, int din,
                               const void *signs, const void *plan, void *out,
                               void *work, const void *tables, int log2n,
                               int whole, void *stream) {
  const void *vals[4] = {v0, v1, v2, v3};
  Products P;
  const int rc = make_products(
      &P, vals, V, din, static_cast<const int32_t *>(signs),
      static_cast<const int32_t *>(plan), static_cast<uint32_t *>(out),
      static_cast<uint32_t *>(work), static_cast<const uint32_t *>(tables),
      log2n);
  if (rc) return rc;
  const auto st = static_cast<cudaStream_t>(stream);
  // the points a thread of the column and row transforms (8 from n = 64)
  switch (log2n) {
    case 2: return launch_form<2, 2>(P, whole, st);
    case 3: return launch_form<2, 4>(P, whole, st);
    case 4: return launch_form<4, 4>(P, whole, st);
    case 5: return launch_form<4, 8>(P, whole, st);
    default: return launch_form<8, 8>(P, whole, st);
  }
}

// K9's block size T for V values at n = 2^log2n (make_products'), or
// cudaErrorInvalidValue's code negated outside K9's limits
extern "C" int fs_ntt_products_threads(int V, int log2n) {
  if (log2n < 2 || log2n > 17 || V < 1 || V > kMaxValues)
    return -static_cast<int>(cudaErrorInvalidValue);
  return products_threads(V, log2n);
}
