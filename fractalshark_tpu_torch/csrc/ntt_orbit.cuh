// K4's device functions, shared by its three launches (ntt_orbit.cu) and
// by K12's grid form (orbit_chunk.cu): the three passes of one step's
// products as loop bodies over work items, so that a block can run any
// number of items (K4 launches one block per item; K12 loops over the
// items of a pass between grid-wide barriers).  The layout and the
// exactness argument are ntt_orbit.cu's.
//
// No pointer that a pass writes is declared __restrict__ here: K12 writes
// the digits, the work array, the coefficients and the sign row inside
// the same launch that reads them, so none of them may be read through
// the non-coherent read-only path.  Only the root tables are.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_common.cuh"

namespace {

constexpr int kOrbitThreads = 256;
constexpr int kLogColBlock = 3;   // 8 columns a block in the column passes

// the digit vectors of one instance: x, y (K4) or x, y, dx, dy (K4-NR)
struct Values {
  const uint32_t *v[4];
};

// The four-step split of n = 2^m: n1 = 2^m1 rows, n2 = 2^(m - m1)
// columns, column tiles of 2^lgc columns (at most 2^log_cols).
struct Split {
  int m, m1, lgc;
};

__host__ __device__ inline Split split_of(int m,
                                          int log_cols = kLogColBlock) {
  const int m1 = m / 2;
  return {m, m1, (m - m1) < log_cols ? (m - m1) : log_cols};
}

__host__ __device__ inline int col_tiles(const Split &s) {
  return (1 << (s.m - s.m1)) >> s.lgc;
}

// shared memory of each pass: data tiles, then the twiddles of the
// length-n1 column transforms; 2V row arrays, then the forward and the
// inverse twiddles of length n2
inline size_t fwd_bytes(const Split &s) {
  return (2ull * (1 << s.m1) * (1 << s.lgc) + (1 << s.m1)) * 4;
}
inline size_t row_bytes(const Split &s, int V) {
  return (2ull * V + 2) * (1 << (s.m - s.m1)) * 4;
}
inline size_t inv_bytes(const Split &s, int V) {
  return (2ull * V * (1 << s.m1) * (1 << s.lgc) + (1 << s.m1)) * 4;
}

// forward column item (value `input`, column tile `tile_idx`): work[(value
// *2 + prime)*n + i]
__device__ void col_fwd_item(const Values &in, uint32_t *work,
                             const uint32_t *__restrict__ tw, int D,
                             const Split &s, int tile_idx, int input,
                             uint32_t *sm) {
  const int n = 1 << s.m;
  const int n1 = 1 << s.m1;
  const int n2 = n >> s.m1;
  const int cb = 1 << s.lgc;
  const uint32_t *src = in.v[input];
  const int c0 = tile_idx * cb;
  const int tile = n1 * cb;
  uint32_t *tws = sm + 2 * tile;
  load_twiddles<true>(tws, s.m1, s.m, tw);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = i / cb;
    const int idx = r * n2 + c0 + (i - r * cb);
    const uint32_t v = idx < D ? src[idx] : 0u;
    sm[i] = v;          // digits < 2^16 are already reduced mod both primes
    sm[tile + i] = v;
  }
  __syncthreads();
  transform<true>(sm, 2, s.lgc, tile, cb, s.m1, tws);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = i / cb;
    const int idx = r * n2 + c0 + (i - r * cb);
    work[(input * 2) * n + idx] = sm[i];
    work[(input * 2 + 1) * n + idx] = sm[tile + i];
  }
}

// The pointwise products of a row's spectra, in place: value k of prime
// pr at sm[(2k + pr)*n2 + c], product q written where value q was.
// V = 2: X^2 - Y^2, X*Y.  V = 4: X^2 - Y^2, sx*sy*X*Y,
// sx*sdx*X*DX - sy*sdy*Y*DY, sx*sdy*X*DY + sy*sdx*Y*DX.
template <int V>
__device__ void pointwise(uint32_t *sm, int n2, const int32_t *signs) {
  int sx = 1, sy = 1, sdx = 1, sdy = 1;
  if (V == 4) {
    sx = signs[0];
    sy = signs[1];
    sdx = signs[2];
    sdy = signs[3];
  }
  for (int i = threadIdx.x; i < 2 * n2; i += blockDim.x) {
    const int pr = i / n2;
    const uint32_t p = prime(pr);
    const uint32_t pp = pprime(pr);
    const uint32_t X = sm[i];
    const uint32_t Y = sm[2 * n2 + i];
    sm[i] = sub_mod(mont_mul(X, X, p, pp), mont_mul(Y, Y, p, pp), p);
    if (V == 2) {
      sm[2 * n2 + i] = mont_mul(X, Y, p, pp);
    } else {
      const uint32_t DX = sm[4 * n2 + i];
      const uint32_t DY = sm[6 * n2 + i];
      sm[2 * n2 + i] = signed_mod(sx * sy, mont_mul(X, Y, p, pp), p);
      sm[4 * n2 + i] =
          sub_mod(signed_mod(sx * sdx, mont_mul(X, DX, p, pp), p),
                  signed_mod(sy * sdy, mont_mul(Y, DY, p, pp), p), p);
      sm[6 * n2 + i] =
          add_mod(signed_mod(sx * sdy, mont_mul(X, DY, p, pp), p),
                  signed_mod(sy * sdx, mont_mul(Y, DX, p, pp), p), p);
    }
  }
}

// row item r: one row of all 2V arrays (value x prime)
template <int V>
__device__ void row_item(uint32_t *work, const uint32_t *__restrict__ tw,
                         const int32_t *signs, const Split &s, int r,
                         uint32_t *sm) {
  const int n = 1 << s.m;
  const int m2 = s.m - s.m1;
  const int n2 = 1 << m2;
  const int k1 = s.m1 ? static_cast<int>(__brev(r) >> (32 - s.m1)) : 0;
  uint32_t *tws_f = sm + 2 * V * n2;
  uint32_t *tws_i = tws_f + n2;
  load_twiddles<true>(tws_f, m2, s.m, tw);
  load_twiddles<false>(tws_i, m2, s.m, tw);
  for (int i = threadIdx.x; i < 2 * V * n2; i += blockDim.x) {
    const int a = i >> m2;
    const int c = i & (n2 - 1);
    const int pr = a & 1;
    sm[i] = mont_mul(work[a * n + r * n2 + c], tw[pr * n + c * k1], prime(pr),
                     pprime(pr));
  }
  __syncthreads();
  transform<true>(sm, 2 * V, 0, n2, 1, m2, tws_f);
  pointwise<V>(sm, n2, signs);
  __syncthreads();
  transform<false>(sm, 2 * V, 0, n2, 1, m2, tws_i);
  for (int i = threadIdx.x; i < 2 * V * n2; i += blockDim.x) {
    const int a = i >> m2;
    const int c = i & (n2 - 1);
    const int pr = a & 1;
    work[a * n + r * n2 + c] = mont_mul(sm[i], tw[(2 + pr) * n + c * k1],
                                        prime(pr), pprime(pr));
  }
}

// inverse column item (column tile `tile_idx`): the 2V product arrays
// (product x prime) of its columns; coef[q][i] the signed integer of
// product q
template <int V>
__device__ void col_inv_item(const uint32_t *work, int64_t *coef,
                             const uint32_t *__restrict__ tw, const Split &s,
                             int tile_idx, uint32_t *sm) {
  const int n = 1 << s.m;
  const int n1 = 1 << s.m1;
  const int n2 = n >> s.m1;
  const int cb = 1 << s.lgc;
  const int c0 = tile_idx * cb;
  const int tile = n1 * cb;
  uint32_t *tws = sm + 2 * V * tile;
  load_twiddles<false>(tws, s.m1, s.m, tw);
  for (int i = threadIdx.x; i < 2 * V * tile; i += blockDim.x) {
    const int a = i / tile;
    const int e = i - a * tile;
    const int r = e / cb;
    sm[i] = work[a * n + r * n2 + c0 + (e - r * cb)];
  }
  __syncthreads();
  transform<false>(sm, 2 * V, s.lgc, tile, cb, s.m1, tws);
  const uint32_t scale1 = tw[4 * n];
  const uint32_t scale2 = tw[4 * n + 1];
  const uint32_t crt = tw[4 * n + 2];   // p1^-1 * R mod p2
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = i / cb;
    const int idx = r * n2 + c0 + (i - r * cb);
    for (int q = 0; q < V; ++q) {
      const uint32_t r1 = mont_mul(sm[(2 * q) * tile + i], scale1, kP1, kPp1);
      const uint32_t r2 =
          mont_mul(sm[(2 * q + 1) * tile + i], scale2, kP2, kPp2);
      coef[q * n + idx] = crt_signed(crt_rec(r1, r2, crt));
    }
  }
}

}  // namespace
