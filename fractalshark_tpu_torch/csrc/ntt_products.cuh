// K9's device functions, shared by its two launch forms (ntt_products.cu)
// and by K11 (iterate_full.cu): the three phases of one whole multiply,
// from V values to K frequency-domain combinations of their pointwise
// products, each phase a loop body over its work items so that a block
// can run any number of items (the split form launches one block per
// item, the cooperative forms loop over the items of a phase between
// grid-wide barriers).
//
// The four-step layout: n = n1*n2 (n1 = 2^floor(log2(n)/2)), a[r*n2 + c].
//   forward item  (value, prime, tile of TL columns): DIF of length n1
//                 down each column, natural order in, bit-reversed out;
//   row item      (row r, prime; frequency k1 = bitrev(r)): twiddle
//                 w_n^(c*k1), DIF of length n2 for the V values, the sign
//                 fold NTT(-a) = p - NTT(a) (0 stays 0), the K
//                 combinations of Montgomery products (sum of +-terms mod
//                 p), DIT of length n2, twiddle w_n^(-c*k1);
//   inverse item  (combination, prime, tile of TL columns): DIT of length
//                 n1 down each column, then the scale n^-1 * R^2 in
//                 Montgomery form, which leaves the exact convolution
//                 residue (the pointwise R^-1 cancelled).
// Every transform runs K8's radix-8 register rounds (ntt_rounds.cuh) with
// Shoup twiddles, each prime its own instance: ceil(log2(len)/3) barriers
// a transform.  The four-step twiddles are a [2 primes, n1, n2] matrix in
// Montgomery form for each direction, read in the row item's own order
// (coalesced).  Every operation yields the canonical residue, so the rows
// equal the reference's _ntt_products (ntt_pallas.py:365) word for word,
// whatever the order of its butterflies.
//
// The block has T threads, 8 points a thread in the column phases (fewer
// only below n = 64): T is halved from 512 (not below 32) until the
// forward phase has two blocks an SM of the H100, then raised (to 256 at
// most) until a row block loads its rows in one batch of 8 words a thread
// (products_threads); a column tile is TL = 8T / n1 columns.  Every phase
// loads its twiddles and data in one batch (stage_in), so it waits for
// about one memory latency.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "ntt_rounds.cuh"

namespace {

constexpr int kMaxValues = 4;
constexpr int kMaxCombos = 8;
constexpr int kMaxTerms = 2;
constexpr int kProductsMaxThreads = 512;
constexpr int kProductsMinThreads = 32;
constexpr int kProductsBlocksWanted = 2 * 132;   // two blocks an SM
constexpr int kProductsRowThreads = 256;         // the rows' raise stops

struct Products {
  const uint32_t *v[kMaxValues];   // values: din entries, zero beyond
  const int32_t *signs;            // [V] or null
  uint32_t *work;                  // [2V][n] forward, then [2K][n] rows
  uint32_t *out;                   // [K][2][n]
  const uint32_t *tab;             // ntt.k9_tables(n)
  int V, K, din, m, m1, threads, lg_tl;
  int nterm[kMaxCombos];
  int tsg[kMaxCombos][kMaxTerms], tia[kMaxCombos][kMaxTerms],
      tib[kMaxCombos][kMaxTerms];
};

// ntt.k9_tables(n), uint32 words: the scale n^-1*R^2 of each prime and two
// pad words; the Shoup tables [2 primes][len] of (w, w') of the column
// transforms (length n1) forward then inverse, and of the row transforms
// (length n2); the twiddle matrices [2 primes][n1][n2], forward then
// inverse, Montgomery form
struct K9Tables {
  const uint32_t *scale;
  const uint2 *col_f, *col_i, *row_f, *row_i;
  const uint32_t *mat_f, *mat_i;
};

__host__ __device__ __forceinline__ K9Tables k9_tables(const uint32_t *tab,
                                                       int m, int m1) {
  const int n1 = 1 << m1;
  const int n2 = 1 << (m - m1);
  K9Tables t;
  t.scale = tab;
  t.col_f = reinterpret_cast<const uint2 *>(tab + 4);
  t.col_i = t.col_f + 2 * n1;
  t.row_f = t.col_i + 2 * n1;
  t.row_i = t.row_f + 2 * n2;
  t.mat_f = tab + 4 + 8 * n1 + 8 * n2;
  t.mat_i = t.mat_f + (2 << m);
  return t;
}

__host__ __device__ __forceinline__ int fwd_items(const Products &P) {
  return 2 * P.V * ((1 << (P.m - P.m1)) >> P.lg_tl);
}
__host__ __device__ __forceinline__ int row_items(const Products &P) {
  return 2 << P.m1;
}
__host__ __device__ __forceinline__ int inv_items(const Products &P) {
  return 2 * P.K * ((1 << (P.m - P.m1)) >> P.lg_tl);
}

// the rounds of a column tile: thread = slot (TL*n1/kE slots, one each)
template <bool kInverse, int kE>
__device__ __forceinline__ void tile_rounds(uint32_t *a, const uint2 *tws,
                                            int lg, int pitch, uint32_t p) {
  const int gpc = (1 << lg) / kE;
  const int col = threadIdx.x / gpc;
  const int u = threadIdx.x - col * gpc;
  uint32_t *c = a + col * pitch;
  for (int q = 0; q < rounds_of<kE>(lg); ++q) {
    int blo, k;
    round_bits<kInverse, kE>(lg, q, &blo, &k);
    run_round<kInverse, kE>(c, tws, blo, k, u, gpc, p);
    __syncthreads();
  }
}

// the rounds of `arrays` sequences of length 2^lg at `pitch`: the slots
// spread over the block's threads
template <bool kInverse, int kE>
__device__ __forceinline__ void array_rounds(uint32_t *a, int arrays,
                                             const uint2 *tws, int lg,
                                             int pitch, uint32_t p) {
  const int gpc = (1 << lg) / kE;
  for (int q = 0; q < rounds_of<kE>(lg); ++q) {
    int blo, k;
    round_bits<kInverse, kE>(lg, q, &blo, &k);
    for (int s = threadIdx.x; s < arrays * gpc; s += blockDim.x) {
      const int col = s / gpc;
      run_round<kInverse, kE>(a + col * pitch, tws, blo, k, s - col * gpc,
                              gpc, p);
    }
    __syncthreads();
  }
}

// Two sources into shared memory in one batch (the twiddles and the
// data): element e of a source is load(e), stored by store(e, value); the
// block's threads issue up to 8 loads of each before any store, so a
// phase waits for about one memory latency, not one a loop trip or a
// source
template <typename A, typename B, typename LoadA, typename StoreA,
          typename LoadB, typename StoreB>
__device__ __forceinline__ void stage_in(int na, LoadA load_a,
                                         StoreA store_a, int nb,
                                         LoadB load_b, StoreB store_b) {
  constexpr int kBatch = 8;
  const int count = na > nb ? na : nb;
  for (int e0 = threadIdx.x; e0 < count; e0 += kBatch * blockDim.x) {
    A ra[kBatch];
    B rb[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + q * blockDim.x;
      if (e < na) ra[q] = load_a(e);
      if (e < nb) rb[q] = load_b(e);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + q * blockDim.x;
      if (e < na) store_a(e, ra[q]);
      if (e < nb) store_b(e, rb[q]);
    }
  }
}

// words between the row arrays: a warp's slots span 32 / gpc arrays
__host__ __device__ __forceinline__ int row_pitch(int m2, int kE) {
  const int gpc = (1 << m2) / kE;
  int lg = 0;
  while (gpc << lg < 32 && lg < 4) ++lg;
  return (1 << m2) + pad_words(lg);
}

template <int kE>
__device__ void fwd_item(const Products &P, int item, uint32_t *sm) {
  const int n = 1 << P.m;
  const int n1 = 1 << P.m1;
  const int n2 = n >> P.m1;
  const int tl = 1 << P.lg_tl;
  const int tiles = n2 >> P.lg_tl;
  const int ap = item / tiles;           // value * 2 + prime
  const int pr = ap & 1;
  const uint32_t p = prime(pr);
  const int c0 = (item - ap * tiles) * tl;
  const int pitch = n1 + pad_words(P.lg_tl);
  const uint32_t *src = P.v[ap >> 1];
  uint2 *tws = reinterpret_cast<uint2 *>(sm);
  uint32_t *a = sm + 2 * n1;
  const uint2 *twp = k9_tables(P.tab, P.m, P.m1).col_f + pr * n1;
  stage_in<uint2, uint32_t>(
      n1, [&](int i) { return twp[i]; },
      [&](int i, uint2 w) { tws[i] = w; }, n1 << P.lg_tl,
      [&](int e) {
        const int idx = (e >> P.lg_tl) * n2 + c0 + (e & (tl - 1));
        return idx < P.din ? src[idx] : 0u;   // < p1
      },
      [&](int e, uint32_t v) {
        a[(e & (tl - 1)) * pitch + swz(e >> P.lg_tl)] =
            pr && v >= kP2 ? v - kP2 : v;
      });
  __syncthreads();
  tile_rounds<false, kE>(a, tws, P.m1, pitch, p);
  uint32_t *dst = P.work + static_cast<size_t>(ap) * n;
  for (int e = threadIdx.x; e < (n1 << P.lg_tl); e += blockDim.x) {
    const int l = e & (tl - 1);
    const int i = e >> P.lg_tl;
    dst[i * n2 + c0 + l] = a[l * pitch + swz(i)];
  }
  __syncthreads();
}

template <int kE>
__device__ void row_item(const Products &P, int item, uint32_t *sm) {
  const int n = 1 << P.m;
  const int m2 = P.m - P.m1;
  const int n2 = 1 << m2;
  const int r = item >> 1;
  const int pr = item & 1;
  const uint32_t p = prime(pr);
  const uint32_t pp = pprime(pr);
  const int V = P.V;
  const int K = P.K;
  const int pitch = row_pitch(m2, kE);
  const K9Tables T = k9_tables(P.tab, P.m, P.m1);
  // the twiddles of both directions, the inverse matrix's row, the V
  // arrays, the K arrays
  uint2 *tws_f = reinterpret_cast<uint2 *>(sm);
  uint2 *tws_i = tws_f + n2;
  uint32_t *mis = sm + 4 * n2;
  uint32_t *fa = mis + n2;
  uint32_t *pa = fa + V * pitch;
  const size_t off = static_cast<size_t>(r) * n2;
  bool neg[kMaxValues];
  for (int v = 0; v < V; ++v) neg[v] = P.signs && P.signs[v] < 0;
  // in one batch: the twiddles, 16 bytes a load (row_i follows row_f in
  // shared memory), and the values' rows times the forward matrix, then
  // the inverse matrix's row
  const uint4 *twf = reinterpret_cast<const uint4 *>(T.row_f + pr * n2);
  const uint4 *twi = reinterpret_cast<const uint4 *>(T.row_i + pr * n2);
  const uint32_t *mf = T.mat_f + static_cast<size_t>(pr) * n + off;
  const uint32_t *mi = T.mat_i + static_cast<size_t>(pr) * n + off;
  const int vals = V << m2;
  stage_in<uint4, uint32_t>(
      n2, [&](int i) { return i < n2 / 2 ? twf[i] : twi[i - n2 / 2]; },
      [&](int i, uint4 w) { reinterpret_cast<uint4 *>(sm)[i] = w; },
      vals + n2,
      [&](int e) {
        const int c = e & (n2 - 1);
        return e < vals
                   ? mont_mul(P.work[static_cast<size_t>(2 * (e >> m2) + pr) *
                                         n + off + c],
                              mf[c], p, pp)
                   : mi[c];
      },
      [&](int e, uint32_t v) {
        if (e < vals)
          fa[(e >> m2) * pitch + swz(e & (n2 - 1))] = v;
        else
          mis[e - vals] = v;
      });
  __syncthreads();
  array_rounds<false, kE>(fa, V, tws_f, m2, pitch, p);
  for (int c = threadIdx.x; c < n2; c += blockDim.x) {
    uint32_t f[kMaxValues];
    for (int v = 0; v < V; ++v) {
      const uint32_t s = fa[v * pitch + swz(c)];
      f[v] = neg[v] ? neg_mod(s, p) : s;
    }
    for (int k = 0; k < K; ++k) {
      uint32_t acc = mont_mul(f[P.tia[k][0]], f[P.tib[k][0]], p, pp);
      for (int t = 1; t < P.nterm[k]; ++t) {
        const uint32_t q = mont_mul(f[P.tia[k][t]], f[P.tib[k][t]], p, pp);
        acc = P.tsg[k][t] > 0 ? add_mod(acc, q, p) : sub_mod(acc, q, p);
      }
      pa[k * pitch + swz(c)] = acc;
    }
  }
  __syncthreads();
  array_rounds<true, kE>(pa, K, tws_i, m2, pitch, p);
  uint32_t *rows = P.work + static_cast<size_t>(2 * V) * n;
  for (int e = threadIdx.x; e < (K << m2); e += blockDim.x) {
    const int k = e >> m2;
    const int c = e & (n2 - 1);
    rows[static_cast<size_t>(2 * k + pr) * n + off + c] =
        mont_mul(pa[k * pitch + swz(c)], mis[c], p, pp);
  }
  __syncthreads();
}

template <int kE>
__device__ void inv_item(const Products &P, int item, uint32_t *sm) {
  const int n = 1 << P.m;
  const int n1 = 1 << P.m1;
  const int n2 = n >> P.m1;
  const int tl = 1 << P.lg_tl;
  const int tiles = n2 >> P.lg_tl;
  const int ap = item / tiles;           // combination * 2 + prime
  const int pr = ap & 1;
  const uint32_t p = prime(pr);
  const int c0 = (item - ap * tiles) * tl;
  const int pitch = n1 + pad_words(P.lg_tl);
  const K9Tables T = k9_tables(P.tab, P.m, P.m1);
  const uint32_t *src = P.work + static_cast<size_t>(2 * P.V + ap) * n;
  uint2 *tws = reinterpret_cast<uint2 *>(sm);
  uint32_t *a = sm + 2 * n1;
  stage_in<uint2, uint32_t>(
      n1, [&](int i) { return T.col_i[pr * n1 + i]; },
      [&](int i, uint2 w) { tws[i] = w; }, n1 << P.lg_tl,
      [&](int e) { return src[(e >> P.lg_tl) * n2 + c0 + (e & (tl - 1))]; },
      [&](int e, uint32_t v) {
        a[(e & (tl - 1)) * pitch + swz(e >> P.lg_tl)] = v;
      });
  __syncthreads();
  tile_rounds<true, kE>(a, tws, P.m1, pitch, p);
  const uint32_t sc = T.scale[pr];
  uint32_t *dst = P.out + static_cast<size_t>(ap) * n;
  for (int e = threadIdx.x; e < (n1 << P.lg_tl); e += blockDim.x) {
    const int l = e & (tl - 1);
    const int i = e >> P.lg_tl;
    dst[i * n2 + c0 + l] = mont_mul(a[l * pitch + swz(i)], sc, p, pprime(pr));
  }
  __syncthreads();
}

// the three phases in one launch, grid-wide barriers between them
template <int kE1, int kE2>
__device__ void products_whole(const Products &P, uint32_t *sm) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int it = blockIdx.x; it < fwd_items(P); it += gridDim.x)
    fwd_item<kE1>(P, it, sm);
  grid.sync();
  for (int it = blockIdx.x; it < row_items(P); it += gridDim.x)
    row_item<kE2>(P, it, sm);
  grid.sync();
  for (int it = blockIdx.x; it < inv_items(P); it += gridDim.x)
    inv_item<kE1>(P, it, sm);
}

// points a thread in the column and row transforms: 8, or the length
int col_points(const Products &P) { return P.m1 >= 3 ? 8 : 1 << P.m1; }
int row_points(const Products &P) {
  return P.m - P.m1 >= 3 ? 8 : 1 << (P.m - P.m1);
}

// The block size T of V values at n = 2^log2n: from kProductsMaxThreads
// halved while the forward phase has fewer than two blocks an SM (not
// below a warp), then raised until a row block loads its V rows and the
// inverse matrix's row in one batch of 8 words a thread (not past 256:
// 512 measured slower at n = 131,072), at most one (value, prime) a
// column block.  A column tile is TL = T * kE
// / n1 columns (ntt_pallas.block_threads mirrors it).
int products_threads(int V, int log2n) {
  const int m1 = log2n / 2;
  const int e1 = m1 >= 3 ? 8 : 1 << m1;
  int t = kProductsMaxThreads;
  while (t > kProductsMinThreads &&
         (2LL * V << log2n) / (static_cast<int64_t>(t) * e1) <
             kProductsBlocksWanted)
    t >>= 1;
  const int words = (V + 1) << (log2n - m1);
  while (t < kProductsRowThreads && 8 * t < words) t <<= 1;
  return t > (1 << log2n) / e1 ? (1 << log2n) / e1 : t;
}

// The host side: a Products from the plan words (ntt_pallas.plan_words:
// K, then per combination its term count and (sign, ia, ib) per term) and
// the block size (products_threads, or min_threads where that is more and
// the size allows it); returns cudaErrorInvalidValue on a bad plan or
// size.
int make_products(Products *P, const void *const *vals, int V, int din,
                  const int32_t *signs, const int32_t *plan, uint32_t *out,
                  uint32_t *work, const uint32_t *tables, int log2n,
                  int min_threads = kProductsMinThreads) {
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
  P->tab = tables;
  P->din = din;
  P->m = log2n;
  P->m1 = log2n / 2;
  const int e1 = col_points(*P);
  int t = products_threads(V, log2n);
  if (t < min_threads && min_threads <= (1 << log2n) / e1) t = min_threads;
  P->threads = t;
  int lg = 0;
  while ((1 << (lg + 1)) <= t * e1 >> P->m1) ++lg;
  P->lg_tl = lg;
  return 0;
}

// dynamic shared memory of each phase, and their maximum
size_t col_smem(const Products &P) {
  return (2ull * (1 << P.m1) +
          (static_cast<size_t>((1 << P.m1) + pad_words(P.lg_tl)) << P.lg_tl)) *
         4;
}
size_t row_smem(const Products &P) {
  const int m2 = P.m - P.m1;
  return (5ull * (1 << m2) +
          static_cast<size_t>(P.V + P.K) * row_pitch(m2, row_points(P))) *
         4;
}
size_t max_smem(const Products &P) {
  const size_t a = col_smem(P);
  const size_t b = row_smem(P);
  return a > b ? a : b;
}

// A kernel's launch attributes on the current device, set and queried
// once per (kernel, threads, shared memory, device) and cached: the
// opt-in to more than 48 KB of dynamic shared memory, the co-resident
// blocks an SM and the SM count.  Returns the opt-in's or the query's
// error, cached with them.
int launch_info(const void *fn, int threads, size_t smem, int *per_sm,
                int *sms) {
  struct Entry {
    const void *fn;
    int threads, dev, per_sm, sms, rc;
    size_t smem;
  };
  static std::mutex mu;
  static Entry cache[128];
  static int used = 0;
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc) return rc;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry &e = cache[i];
    if (e.fn == fn && e.threads == threads && e.smem == smem && e.dev == dev) {
      *per_sm = e.per_sm;
      *sms = e.sms;
      return e.rc;
    }
  }
  Entry e = {fn, threads, dev, 0, 0, 0, smem};
  if (smem > 48 * 1024)
    e.rc = static_cast<int>(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  if (!e.rc)
    e.rc = static_cast<int>(cudaDeviceGetAttribute(
        &e.sms, cudaDevAttrMultiProcessorCount, dev));
  if (!e.rc)
    e.rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &e.per_sm, fn, threads, smem));
  if (used < 128) cache[used++] = e;
  *per_sm = e.per_sm;
  *sms = e.sms;
  return e.rc;
}

// A cooperative launch of fn over at most `items` blocks of `threads`: as
// many as can be co-resident (launch_info).  Returns
// cudaErrorCooperativeLaunchTooLarge when not one block fits, the
// launch's refusal otherwise (clearing it, so that no later launch reads
// it back), and cudaGetLastError() after the launch.
int coop_launch(const void *fn, int threads, int items, size_t smem,
                void **args, cudaStream_t st) {
  int per_sm = 0, sms = 0;
  int rc = launch_info(fn, threads, smem, &per_sm, &sms);
  if (!rc && per_sm < 1)
    rc = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (!rc) {
    const int grid = per_sm * sms < items ? per_sm * sms : items;
    rc = static_cast<int>(cudaLaunchCooperativeKernel(
        fn, dim3(grid), dim3(threads), args, smem, st));
  }
  const int last = static_cast<int>(cudaGetLastError());
  return rc ? rc : last;
}

}  // namespace
