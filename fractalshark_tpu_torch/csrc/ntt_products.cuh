// K9's device functions, shared by its two launch forms (ntt_products.cu)
// and by K11 (iterate_full.cu): the three phases of one whole multiply,
// from V values to K frequency-domain combinations of their pointwise
// products, each phase a loop body over its work items so that a block
// can run any number of items (the split form launches one block per
// item, the cooperative forms loop over the items of a phase between
// grid-wide barriers).
//
// The four-step layout of K4 (ntt_orbit.cu): n = n1*n2, a[r*n2 + c].
//   forward item  (value, tile of cb columns): DIF of length n1 down each
//                 column, both primes, natural order in, bit-reversed out;
//   row item      (row r, frequency k1 = bitrev(r)): twiddle w_n^(c*k1),
//                 DIF of length n2 for the V values and both primes, the
//                 sign fold NTT(-a) = p - NTT(a) (0 stays 0), the K
//                 combinations of Montgomery products (sum of +-terms mod
//                 p), DIT of length n2, twiddle w_n^(-c*k1);
//   inverse item  (tile of cb columns): DIT of length n1 down each column,
//                 then the scale n^-1 * R^2 in Montgomery form, which leaves
//                 the exact convolution residue (the pointwise R^-1
//                 cancelled).
// Every operation yields the canonical residue, so the rows equal the
// reference's _ntt_products (ntt_pallas.py:365) word for word, whatever
// the order of its butterflies.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_common.cuh"

namespace {

constexpr int kFusedThreads = 1024;
constexpr int kMaxValues = 4;
constexpr int kMaxCombos = 8;
constexpr int kMaxTerms = 2;

struct Products {
  const uint32_t *v[kMaxValues];   // values: din entries, zero beyond
  const int32_t *signs;            // [V] or null
  uint32_t *work;                  // [2V][n] forward, then [2K][n] rows
  uint32_t *out;                   // [K][2][n]
  const uint32_t *tw;              // ntt.kernel_tables(n)
  int V, K, din, m, m1, lgc_f, lgc_i;
  int nterm[kMaxCombos];
  int tsg[kMaxCombos][kMaxTerms], tia[kMaxCombos][kMaxTerms],
      tib[kMaxCombos][kMaxTerms];
};

__device__ __forceinline__ int fwd_items(const Products &P) {
  return P.V * ((1 << (P.m - P.m1)) >> P.lgc_f);
}
__device__ __forceinline__ int row_items(const Products &P) {
  return 1 << P.m1;
}
__device__ __forceinline__ int inv_items(const Products &P) {
  return (1 << (P.m - P.m1)) >> P.lgc_i;
}

__device__ void fwd_item(const Products &P, int item, uint32_t *sm) {
  const int n = 1 << P.m;
  const int n1 = 1 << P.m1;
  const int n2 = n >> P.m1;
  const int cb = 1 << P.lgc_f;
  const int tiles = n2 / cb;
  const int input = item / tiles;
  const int c0 = (item - input * tiles) * cb;
  const int tile = n1 * cb;
  const uint32_t *src = P.v[input];
  uint32_t *tws = sm + 2 * tile;
  load_twiddles<true>(tws, P.m1, P.m, P.tw);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = i / cb;
    const int idx = r * n2 + c0 + (i - r * cb);
    const uint32_t v = idx < P.din ? src[idx] : 0u;   // v < p1
    sm[i] = v;
    sm[tile + i] = v >= kP2 ? v - kP2 : v;
  }
  __syncthreads();
  transform<true>(sm, 2, P.lgc_f, tile, cb, P.m1, tws);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = i / cb;
    const int idx = r * n2 + c0 + (i - r * cb);
    P.work[(input * 2) * n + idx] = sm[i];
    P.work[(input * 2 + 1) * n + idx] = sm[tile + i];
  }
  __syncthreads();
}

__device__ void row_item(const Products &P, int r, uint32_t *sm) {
  const int n = 1 << P.m;
  const int m2 = P.m - P.m1;
  const int n2 = 1 << m2;
  const int k1 = static_cast<int>(__brev(r) >> (32 - P.m1));
  const int V = P.V;
  const int K = P.K;
  uint32_t *fa = sm;                    // 2V arrays (value x prime)
  uint32_t *pa = sm + 2 * V * n2;       // 2K arrays (combination x prime)
  uint32_t *tws_f = pa + 2 * K * n2;
  uint32_t *tws_i = tws_f + n2;
  uint32_t *rows = P.work + 2 * V * n;  // the row pass's output
  load_twiddles<true>(tws_f, m2, P.m, P.tw);
  load_twiddles<false>(tws_i, m2, P.m, P.tw);
  for (int i = threadIdx.x; i < 2 * V * n2; i += blockDim.x) {
    const int a = i >> m2;
    const int c = i & (n2 - 1);
    const int pr = a & 1;
    fa[i] = mont_mul(P.work[a * n + r * n2 + c], P.tw[pr * n + c * k1],
                     prime(pr), pprime(pr));
  }
  __syncthreads();
  transform<true>(fa, 2 * V, 0, n2, 1, m2, tws_f);
  for (int i = threadIdx.x; i < 2 * n2; i += blockDim.x) {
    const int pr = i >> m2;
    const int c = i & (n2 - 1);
    const uint32_t p = prime(pr);
    const uint32_t pp = pprime(pr);
    uint32_t f[kMaxValues];
    for (int v = 0; v < V; ++v) {
      const uint32_t s = fa[(2 * v + pr) * n2 + c];
      f[v] = P.signs && P.signs[v] < 0 ? neg_mod(s, p) : s;
    }
    for (int k = 0; k < K; ++k) {
      uint32_t acc = mont_mul(f[P.tia[k][0]], f[P.tib[k][0]], p, pp);
      for (int t = 1; t < P.nterm[k]; ++t) {
        const uint32_t q = mont_mul(f[P.tia[k][t]], f[P.tib[k][t]], p, pp);
        acc = P.tsg[k][t] > 0 ? add_mod(acc, q, p) : sub_mod(acc, q, p);
      }
      pa[(2 * k + pr) * n2 + c] = acc;
    }
  }
  __syncthreads();
  transform<false>(pa, 2 * K, 0, n2, 1, m2, tws_i);
  for (int i = threadIdx.x; i < 2 * K * n2; i += blockDim.x) {
    const int a = i >> m2;
    const int c = i & (n2 - 1);
    const int pr = a & 1;
    rows[a * n + r * n2 + c] = mont_mul(pa[i], P.tw[(2 + pr) * n + c * k1],
                                        prime(pr), pprime(pr));
  }
  __syncthreads();
}

__device__ void inv_item(const Products &P, int item, uint32_t *sm) {
  const int n = 1 << P.m;
  const int n1 = 1 << P.m1;
  const int n2 = n >> P.m1;
  const int cb = 1 << P.lgc_i;
  const int c0 = item * cb;
  const int tile = n1 * cb;
  const int arrays = 2 * P.K;
  const uint32_t *rows = P.work + 2 * P.V * n;
  uint32_t *tws = sm + arrays * tile;
  load_twiddles<false>(tws, P.m1, P.m, P.tw);
  for (int i = threadIdx.x; i < arrays * tile; i += blockDim.x) {
    const int a = i / tile;
    const int e = i - a * tile;
    const int r = e / cb;
    sm[i] = rows[a * n + r * n2 + c0 + (e - r * cb)];
  }
  __syncthreads();
  transform<false>(sm, arrays, P.lgc_i, tile, cb, P.m1, tws);
  for (int i = threadIdx.x; i < arrays * tile; i += blockDim.x) {
    const int a = i / tile;
    const int e = i - a * tile;
    const int r = e / cb;
    const int pr = a & 1;
    P.out[a * n + r * n2 + c0 + (e - r * cb)] =
        mont_mul(sm[i], P.tw[4 * n + pr], prime(pr), pprime(pr));
  }
  __syncthreads();
}

// the three phases in one launch, grid-wide barriers between them
__device__ void products_whole(const Products &P, uint32_t *sm) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int it = blockIdx.x; it < fwd_items(P); it += gridDim.x)
    fwd_item(P, it, sm);
  grid.sync();
  for (int it = blockIdx.x; it < row_items(P); it += gridDim.x)
    row_item(P, it, sm);
  grid.sync();
  for (int it = blockIdx.x; it < inv_items(P); it += gridDim.x)
    inv_item(P, it, sm);
}

// The host side: a Products from the plan words (ntt_pallas.plan_words:
// K, then per combination its term count and (sign, ia, ib) per term);
// returns cudaErrorInvalidValue on a bad plan or size.
int make_products(Products *P, const void *const *vals, int V, int din,
                  const int32_t *signs, const int32_t *plan, uint32_t *out,
                  uint32_t *work, const uint32_t *tables, int log2n) {
  if (log2n < 2 || log2n > 17 || V < 1 || V > kMaxValues || din < 0 ||
      din > (1 << log2n) || plan[0] < 1 || plan[0] > kMaxCombos)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < V; ++i) {
    P->v[i] = static_cast<const uint32_t *>(vals[i]);
    if (!P->v[i]) return static_cast<int>(cudaErrorInvalidValue);
  }
  P->V = V;
  P->K = plan[0];
  for (int k = 0; k < P->K; ++k) {
    const int32_t *w = plan + 1 + k * (1 + 3 * kMaxTerms);
    P->nterm[k] = w[0];
    if (w[0] < 1 || w[0] > kMaxTerms)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int t = 0; t < w[0]; ++t) {
      P->tsg[k][t] = w[1 + 3 * t];
      P->tia[k][t] = w[2 + 3 * t];
      P->tib[k][t] = w[3 + 3 * t];
      if (P->tia[k][t] < 0 || P->tia[k][t] >= V || P->tib[k][t] < 0 ||
          P->tib[k][t] >= V)
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  P->signs = signs;
  P->work = work;
  P->out = out;
  P->tw = tables;
  P->din = din;
  P->m = log2n;
  P->m1 = log2n / 2;
  const int m2 = log2n - P->m1;
  const int n1 = 1 << P->m1;
  P->lgc_f = m2 < 3 ? m2 : 3;   // 8 columns a forward item
  // inverse items: up to 8 columns while 2K arrays stay within 64 KB
  int lgc = P->lgc_f;
  while (lgc > 0 && 2 * P->K * n1 * (1 << lgc) > 16384) --lgc;
  P->lgc_i = lgc;
  return 0;
}

// dynamic shared memory of each phase, and their maximum
size_t fwd_smem(const Products &P) {
  return (2ull * (1 << P.m1) * (1 << P.lgc_f) + (1 << P.m1)) * 4;
}
size_t row_smem(const Products &P) {
  return (2ull * (P.V + P.K) + 2) * (1 << (P.m - P.m1)) * 4;
}
size_t inv_smem(const Products &P) {
  return (2ull * P.K * (1 << P.m1) * (1 << P.lgc_i) + (1 << P.m1)) * 4;
}
size_t max_smem(const Products &P) {
  size_t s = fwd_smem(P);
  if (row_smem(P) > s) s = row_smem(P);
  if (inv_smem(P) > s) s = inv_smem(P);
  return s;
}

// A cooperative launch of fn over at most `items` blocks: as many as can
// be co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor, static
// shared memory included).  Returns cudaErrorCooperativeLaunchTooLarge
// when not one block fits, the launch's refusal otherwise (clearing it,
// so that no later launch reads it back), and cudaGetLastError() after
// the launch.
int coop_launch(const void *fn, int items, size_t smem, void **args,
                cudaStream_t st) {
  int rc = static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  int dev = 0, sms = 0, per_sm = 0;
  if (!rc) rc = static_cast<int>(cudaGetDevice(&dev));
  if (!rc)
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (!rc)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, kFusedThreads, smem));
  if (!rc && per_sm < 1)
    rc = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (!rc) {
    const int grid = per_sm * sms < items ? per_sm * sms : items;
    rc = static_cast<int>(cudaLaunchCooperativeKernel(
        fn, dim3(grid), dim3(kFusedThreads), args, smem, st));
  }
  const int last = static_cast<int>(cudaGetLastError());
  return rc ? rc : last;
}

}  // namespace
