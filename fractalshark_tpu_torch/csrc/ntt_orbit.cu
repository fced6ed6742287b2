// K4: the products of one orbit step, exactly.  From the digit vectors
// x and y (D digits below 2^16) it computes the integer coefficient
// sequences of x^2 - y^2 (signed) and x*y, int64 [2][n], n >= 2D.
//
// K4-NR, the same kernels over four values: from x, y, dx, dy and the
// signs (sx, sy, sdx, sdy) in a device row it computes the signed
// coefficient sequences of d = x^2 - y^2, sx*sy*x*y,
//   u = sx*sdx*x*dx - sy*sdy*y*dy  and  v = sx*sdy*x*dy + sy*sdx*y*dx,
// int64 [4][n]: the products of one Newton-Raphson step (z and dz/dc).
// Replaces fractalshark_tpu/ops/bignum/ntt_mxu.py:557 _nr_kernel (B8b;
// call :589, API mxu_nr_products :567; nfft 8192-16384) and :812
// _nr_paired_kernel (B7; API mxu_nr_products_paired :897), and the XLA
// chain of fixedpoint.py:771-795.  A sign multiplies its product by +-1
// mod p in the frequency domain, which equals the reference's negated
// spectra (fixedpoint.py:777-780) residue for residue; the signs are read
// on the card, so a chunk of steps never waits on the host.
//
// Replaces: fractalshark_tpu/ops/bignum/ntt_mxu.py:800 _iter_paired_kernel
// (B5; call :863, API mxu_iter_products_paired :879; nfft >= 32768) and
// ntt_mxu.py:618 _iter_kernel (B8a; call :660, API mxu_iter_products :636;
// nfft 8192-16384).  Both compute this one function on the TPU
// (routing fixedpoint.py:399-423); this kernel computes it at every size.
// The TPU's balanced-int8 phase matrices exist for Mosaic's matrix unit
// and are not copied.
//
// Method: cyclic convolution of length n by NTT modulo the two 31-bit
// primes of ntt.py (p1 = 15*2^27+1, p2 = 27*2^26+1), Montgomery products
// (R = 2^32), CRT.  Exactness: a coefficient of x^2, y^2 or x*y is a sum
// of at most D products below 2^32, so below 2^48 for D <= 2^16; x^2 - y^2
// lies in (-2^48, 2^48) and x*y in [0, 2^48), far inside p1*p2/2 ~ 2^60.7,
// and n >= 2D means no coefficient wraps.  The CRT value, read as negative
// above p1*p2/2, is therefore the exact integer.  For NR, u and v are sums
// of two such products: |u|, |v| < 2D*2^32 < 2^49 for D < 2^16.
//
// Layout: a four-step NTT of n = n1*n2 points, a[r*n2 + c] with
// n1 = 2^floor(m/2) rows and n2 = 2^ceil(m/2) columns:
//   col_fwd   per column, a DIF NTT of length n1 in shared memory (natural
//             order in, bit-reversed out), for each value and both primes;
//   row_pass  per row r, holding frequency k1 = bitrev(r): the twiddle
//             w_n^(c*k1), a DIF NTT of length n2, the pointwise products
//             (X^2 - Y^2 and X*Y; for NR also the signed X*DX - Y*DY and
//             X*DY + Y*DX), the inverse DIT of length n2 (bit-reversed in,
//             natural out) and the inverse twiddle w_n^(-c*k1);
//   col_inv   per column, the inverse DIT of length n1, the scale
//             n^-1 * R^2 (which also cancels the R^-1 of the pointwise
//             Montgomery products) and the CRT to int64.
// Frequency-domain values stay in bit-reversed order, so there is no
// permutation pass.  Twiddles of every sub-transform are read from the
// n-point root tables, copied per block into shared memory with the data
// (w_(2h)^j = w_n^(j*n/(2h))).
//
// Bound on the H100: at 16,384 limbs (n = 65,536) one step moves about
// 3.3 MB, all of it L2-resident, and runs 8 transforms of 2^19 butterflies
// (about 34 M integer operations, 2 us at the int32 rate); launch and
// __syncthreads latency set the time.  The design keeps every transform
// row or column in shared memory so that a step is three launches; the
// column passes fill a quarter of the card or less.  Reading the twiddles
// from the global tables at every butterfly cost 40% of the time there.
// K4-NR moves twice the bytes and runs 16 transforms instead of 8; its
// inverse column pass holds 8 arrays, 64 KB of shared memory a block at
// n = 2^16, which caps it at n <= 2^17.
//
// The primes, Montgomery products, twiddle loads and shared-memory
// transforms are in ntt_common.cuh, which K9 and K11 share.

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLogColBlock = 3;   // 8 columns a block in the column passes

// the digit vectors of one instance: x, y (K4) or x, y, dx, dy (K4-NR)
struct Values {
  const uint32_t *v[4];
};

// grid (n2 / cb, V): blockIdx.y picks the value; work[(value*2 + prime)*n
// + i]
__global__ void __launch_bounds__(kThreads)
col_fwd(Values in, uint32_t *__restrict__ work,
        const uint32_t *__restrict__ tw, int D, int m, int m1, int lgc) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << m;
  const int n1 = 1 << m1;
  const int n2 = n >> m1;
  const int cb = 1 << lgc;
  const int input = blockIdx.y;
  const uint32_t *src = in.v[input];
  const int c0 = blockIdx.x * cb;
  const int tile = n1 * cb;
  uint32_t *tws = sm + 2 * tile;
  load_twiddles<true>(tws, m1, m, tw);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = i / cb;
    const int idx = r * n2 + c0 + (i - r * cb);
    const uint32_t v = idx < D ? src[idx] : 0u;
    sm[i] = v;          // digits < 2^16 are already reduced mod both primes
    sm[tile + i] = v;
  }
  __syncthreads();
  transform<true>(sm, 2, lgc, tile, cb, m1, tws);
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
__device__ void pointwise(uint32_t *sm, int n2,
                          const int32_t *__restrict__ signs) {
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

// grid n1: one row of all 2V arrays (value x prime) per block
template <int V>
__global__ void __launch_bounds__(kThreads)
row_pass(uint32_t *__restrict__ work, const uint32_t *__restrict__ tw,
         const int32_t *__restrict__ signs, int m, int m1) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << m;
  const int m2 = m - m1;
  const int n2 = 1 << m2;
  const int r = blockIdx.x;
  const int k1 = m1 ? static_cast<int>(__brev(r) >> (32 - m1)) : 0;
  uint32_t *tws_f = sm + 2 * V * n2;
  uint32_t *tws_i = tws_f + n2;
  load_twiddles<true>(tws_f, m2, m, tw);
  load_twiddles<false>(tws_i, m2, m, tw);
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

// grid n2 / cb: the 2V product arrays (product x prime) of cb columns per
// block; coef[q][i] the signed integer of product q
template <int V>
__global__ void __launch_bounds__(kThreads)
col_inv(const uint32_t *__restrict__ work, int64_t *__restrict__ coef,
        const uint32_t *__restrict__ tw, int m, int m1, int lgc) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << m;
  const int n1 = 1 << m1;
  const int n2 = n >> m1;
  const int cb = 1 << lgc;
  const int c0 = blockIdx.x * cb;
  const int tile = n1 * cb;
  uint32_t *tws = sm + 2 * V * tile;
  load_twiddles<false>(tws, m1, m, tw);
  for (int i = threadIdx.x; i < 2 * V * tile; i += blockDim.x) {
    const int a = i / tile;
    const int e = i - a * tile;
    const int r = e / cb;
    sm[i] = work[a * n + r * n2 + c0 + (e - r * cb)];
  }
  __syncthreads();
  transform<false>(sm, 2 * V, lgc, tile, cb, m1, tws);
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

// The three launches of one instance.  tables: uint32 [4n + 4]
// (ntt.kernel_tables); work: uint32 [2Vn]; signs: int32 [4] (V = 4 only).
template <int V>
int products(Values in, const int32_t *signs, void *coef, void *work,
             const void *tables, int D, int m, cudaStream_t st) {
  const int m1 = m / 2;
  const int n2 = 1 << (m - m1);
  const int n1 = 1 << m1;
  const int lgc = (m - m1) < kLogColBlock ? (m - m1) : kLogColBlock;
  const int cb = 1 << lgc;
  auto xw = static_cast<uint32_t *>(work);
  auto tw = static_cast<const uint32_t *>(tables);
  // data tiles, then the twiddles of the length-n1 column transforms
  const size_t fwd_bytes = (2ull * n1 * cb + n1) * sizeof(uint32_t);
  const size_t inv_bytes = (2ull * V * n1 * cb + n1) * sizeof(uint32_t);
  int rc = launch_smem(reinterpret_cast<const void *>(col_fwd), fwd_bytes);
  if (!rc)
    rc = launch_smem(reinterpret_cast<const void *>(col_inv<V>), inv_bytes);
  if (rc) return rc;
  col_fwd<<<dim3(n2 / cb, V), kThreads, fwd_bytes, st>>>(in, xw, tw, D, m, m1,
                                                         lgc);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  // 2V row arrays, then forward and inverse twiddles of length n2
  row_pass<V><<<n1, kThreads, (2ull * V + 2) * n2 * sizeof(uint32_t), st>>>(
      xw, tw, signs, m, m1);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  col_inv<V><<<n2 / cb, kThreads, inv_bytes, st>>>(
      xw, static_cast<int64_t *>(coef), tw, m, m1, lgc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: uint32 [D]; coef: int64 [2][n]; work: uint32 [4n] scratch;
// tables: uint32 [4n + 4] (ntt.kernel_tables).  n = 2^log2n, 2 <= n <= 2^20.
extern "C" int fs_ntt_orbit(const void *x, const void *y, void *coef,
                            void *work, const void *tables, int D, int log2n,
                            void *stream) {
  if (log2n < 2 || log2n > 20 || D < 1 || 2 * D > (1 << log2n))
    return static_cast<int>(cudaErrorInvalidValue);
  const Values in = {{static_cast<const uint32_t *>(x),
                      static_cast<const uint32_t *>(y), nullptr, nullptr}};
  return products<2>(in, nullptr, coef, work, tables, D, log2n,
                     static_cast<cudaStream_t>(stream));
}

// K4-NR.  x, y, dx, dy: uint32 [D]; signs: int32 [4] (sx, sy, sdx, sdy);
// coef: int64 [4][n]; work: uint32 [8n] scratch; tables as above.
// n = 2^log2n >= 2D, 2 <= n <= 2^17, D < 2^16.
extern "C" int fs_ntt_nr(const void *x, const void *y, const void *dx,
                         const void *dy, const void *signs, void *coef,
                         void *work, const void *tables, int D, int log2n,
                         void *stream) {
  if (log2n < 2 || log2n > 17 || D < 1 || D >= (1 << 16) ||
      2 * D > (1 << log2n))
    return static_cast<int>(cudaErrorInvalidValue);
  const Values in = {{static_cast<const uint32_t *>(x),
                      static_cast<const uint32_t *>(y),
                      static_cast<const uint32_t *>(dx),
                      static_cast<const uint32_t *>(dy)}};
  return products<4>(in, static_cast<const int32_t *>(signs), coef, work,
                     tables, D, log2n, static_cast<cudaStream_t>(stream));
}
