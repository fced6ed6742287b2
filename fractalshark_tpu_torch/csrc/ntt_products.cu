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
//          co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
//          a refused launch returns its error, never a fallback.  Serves
//          B-f1 and B-f3.
//   split  three launches, one block per item.  Serves B-f2.
//
// Bound on the H100: at n = 131,072 with the 3-way plan a multiply reads
// 1 MB of values and writes 3 MB of rows, and runs 5 transforms of
// 2 x 2^16 x 17 butterflies (about 90 M integer operations, 5 us at the
// int32 rate); the intermediate rows (2(V + K) n words) stay in L2.  The
// work is a few microseconds; launch and barrier latency and the column
// phases' occupancy set the time.  Making it fast is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_products.cuh"

namespace {

__global__ void __launch_bounds__(kFusedThreads)
fwd_kernel(Products P) {
  extern __shared__ uint32_t sm[];
  fwd_item(P, blockIdx.x, sm);
}

__global__ void __launch_bounds__(kFusedThreads)
row_kernel(Products P) {
  extern __shared__ uint32_t sm[];
  row_item(P, blockIdx.x, sm);
}

__global__ void __launch_bounds__(kFusedThreads)
inv_kernel(Products P) {
  extern __shared__ uint32_t sm[];
  inv_item(P, blockIdx.x, sm);
}

__global__ void __launch_bounds__(kFusedThreads)
whole_kernel(Products P) {
  extern __shared__ uint32_t sm[];
  products_whole(P, sm);
}

int launch_split(const Products &P, cudaStream_t st) {
  const int n1 = 1 << P.m1;
  const int n2 = 1 << (P.m - P.m1);
  const void *fns[3] = {reinterpret_cast<const void *>(fwd_kernel),
                        reinterpret_cast<const void *>(row_kernel),
                        reinterpret_cast<const void *>(inv_kernel)};
  const size_t smem[3] = {fwd_smem(P), row_smem(P), inv_smem(P)};
  int rc;
  for (int i = 0; i < 3; ++i)
    if ((rc = launch_smem(fns[i], smem[i]))) return rc;
  fwd_kernel<<<P.V * (n2 >> P.lgc_f), kFusedThreads, smem[0], st>>>(P);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  row_kernel<<<n1, kFusedThreads, smem[1], st>>>(P);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  inv_kernel<<<n2 >> P.lgc_i, kFusedThreads, smem[2], st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

int launch_whole(Products P, cudaStream_t st) {
  const int n1 = 1 << P.m1;
  const int n2 = 1 << (P.m - P.m1);
  int items = P.V * (n2 >> P.lgc_f);
  if (n1 > items) items = n1;
  if ((n2 >> P.lgc_i) > items) items = n2 >> P.lgc_i;
  void *args[] = {&P};
  return coop_launch(reinterpret_cast<const void *>(whole_kernel), items,
                     max_smem(P), args, st);
}

}  // namespace

// vN: up to 4 value vectors (uint32, din entries each, zero beyond; the
// unused ones null); signs: int32 [V] on the card or null; plan: int32
// host words (ntt_pallas.plan_words); out: uint32 [K][2][n]; work: uint32
// [2(V + K) n]; tables: ntt.kernel_tables(n).  whole: 1 for the
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
  return whole ? launch_whole(P, st) : launch_split(P, st);
}
