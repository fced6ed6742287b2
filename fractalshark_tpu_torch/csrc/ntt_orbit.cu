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
// of two such products: |u|, |v| < 2D*2^32 <= 2^49 for D <= 2^16.
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
// transforms are in ntt_common.cuh, which K9 and K11 share; the three
// passes' bodies are in ntt_orbit.cuh, which K12 (orbit_chunk.cu) shares.

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_common.cuh"
#include "ntt_orbit.cuh"

namespace {

// grid (n2 / cb, V): blockIdx.y picks the value
__global__ void __launch_bounds__(kOrbitThreads)
col_fwd(Values in, uint32_t *__restrict__ work,
        const uint32_t *__restrict__ tw, int D, Split s) {
  extern __shared__ uint32_t sm[];
  col_fwd_item(in, work, tw, D, s, blockIdx.x, blockIdx.y, sm);
}

// grid n1: one row of all 2V arrays (value x prime) per block
template <int V>
__global__ void __launch_bounds__(kOrbitThreads)
row_pass(uint32_t *__restrict__ work, const uint32_t *__restrict__ tw,
         const int32_t *__restrict__ signs, Split s) {
  extern __shared__ uint32_t sm[];
  row_item<V>(work, tw, signs, s, blockIdx.x, sm);
}

// grid n2 / cb: the 2V product arrays (product x prime) of cb columns per
// block; coef[q][i] the signed integer of product q
template <int V>
__global__ void __launch_bounds__(kOrbitThreads)
col_inv(const uint32_t *__restrict__ work, int64_t *__restrict__ coef,
        const uint32_t *__restrict__ tw, Split s) {
  extern __shared__ uint32_t sm[];
  col_inv_item<V>(work, coef, tw, s, blockIdx.x, sm);
}

// The three launches of one instance.  tables: uint32 [4n + 4]
// (ntt.kernel_tables); work: uint32 [2Vn]; signs: int32 [4] (V = 4 only).
template <int V>
int products(Values in, const int32_t *signs, void *coef, void *work,
             const void *tables, int D, int m, cudaStream_t st) {
  const Split s = split_of(m);
  auto xw = static_cast<uint32_t *>(work);
  auto tw = static_cast<const uint32_t *>(tables);
  int rc = launch_smem(reinterpret_cast<const void *>(col_fwd), fwd_bytes(s));
  if (!rc)
    rc = launch_smem(reinterpret_cast<const void *>(col_inv<V>),
                     inv_bytes(s, V));
  if (rc) return rc;
  col_fwd<<<dim3(col_tiles(s), V), kOrbitThreads, fwd_bytes(s), st>>>(
      in, xw, tw, D, s);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  row_pass<V><<<1 << s.m1, kOrbitThreads, row_bytes(s, V), st>>>(
      xw, tw, signs, s);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  col_inv<V><<<col_tiles(s), kOrbitThreads, inv_bytes(s, V), st>>>(
      xw, static_cast<int64_t *>(coef), tw, s);
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
// n = 2^log2n >= 2D, 2 <= n <= 2^17, D <= 2^16.
extern "C" int fs_ntt_nr(const void *x, const void *y, const void *dx,
                         const void *dy, const void *signs, void *coef,
                         void *work, const void *tables, int D, int log2n,
                         void *stream) {
  if (log2n < 2 || log2n > 17 || D < 1 || D > (1 << 16) ||
      2 * D > (1 << log2n))
    return static_cast<int>(cudaErrorInvalidValue);
  const Values in = {{static_cast<const uint32_t *>(x),
                      static_cast<const uint32_t *>(y),
                      static_cast<const uint32_t *>(dx),
                      static_cast<const uint32_t *>(dy)}};
  return products<4>(in, static_cast<const int32_t *>(signs), coef, work,
                     tables, D, log2n, static_cast<cudaStream_t>(stream));
}
