// K8: one phase of the generic four-step NTT.  For y uint32 [R, m, L] it
// runs a length-m radix-2 NTT along axis 1 for every (row r, lane l), row
// r modulo p1 if r is even and p2 if r is odd (the primes of ntt.py):
//   forward: DIF, natural order in, bit-reversed out;
//   inverse: DIT, bit-reversed in, natural out, unscaled.
// Stage s of the forward pass pairs i0 = blk*2h + j with i0 + h,
// h = m >> (s+1), twiddle w_m^(j << s) after the difference; stage s of
// the inverse pass has h = 2^s and twiddle w_m^-(j << (lg-1-s)) before the
// butterfly (ntt.py:598-632 _axis0_dif/_axis0_dit).  Outputs are canonical
// residues in [0, p).
//
// Replaces: fractalshark_tpu/ops/bignum/ntt_pallas.py:1661 _phase_kernel
// (B9b; call :1717, API sublane_transform :1698) and
// fractalshark_tpu/ops/bignum/ntt_mxu.py:243 _mxu_phase_kernel (B9a; call
// :291, API mxu_transform_pallas :273).  Both compute this one function on
// the TPU, bit for bit (the MXU form as balanced int8 matrix products, a
// layout for Mosaic's matrix unit that is not copied); the generic
// multiplies reach them through fourstep_forward/fourstep_inverse_scaled
// (ntt.py:658-718) at nfft >= 8,192, and the flat route below it is the
// same transform with m = n, L = 1.
//
// Design: one block per (row, tile of TL lanes); the tile (m*TL words,
// at most 32 KB) and the row prime's m/2 twiddles (Montgomery form, R =
// 2^32, at most 8 KB) stay in shared memory through all log2(m) stages,
// so the data is read once and written once.  A butterfly's twiddle
// product is a Montgomery product with the twiddle w*R mod p, which gives
// the canonical residue of x*w exactly, as the reference's Shoup product.
// Bound on the H100: bytes for the phase alone (8 bytes a point against
// about 4*log2(m) integer operations a point); the stages' __syncthreads
// and the blocks per row (L / TL) set the time at these sizes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kP1 = 2013265921u;   // ntt.P1
constexpr uint32_t kP2 = 1811939329u;   // ntt.P2
constexpr uint32_t kPp1 = 2013265919u;  // -p1^-1 mod 2^32 (ntt.mont_const)
constexpr uint32_t kPp2 = 1811939327u;  // -p2^-1 mod 2^32
constexpr int kThreads = 256;
constexpr int kTileWords = 8192;        // m * TL words of data a block

// a*b*R^-1 mod p for a, b < p < 2^31, canonical
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t pp) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(t) * pp;
  const uint32_t u =
      static_cast<uint32_t>((t + static_cast<uint64_t>(m) * p) >> 32);
  return u >= p ? u - p : u;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  return a >= b ? a - b : a + p - b;
}

// tw: uint32 [2 primes][m/2], w_m^k * R mod p (forward) or w_m^-k * R mod p
// (inverse)
template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
    phase_kernel(const uint32_t *__restrict__ y, uint32_t *__restrict__ out,
                 const uint32_t *__restrict__ tw, int lg, int lanes,
                 int lg_tl) {
  extern __shared__ uint32_t sm[];
  const int m = 1 << lg;
  const int half = m >> 1;
  const int tl = 1 << lg_tl;
  uint32_t *tws = sm;
  uint32_t *a = sm + half;
  const int r = blockIdx.y;
  const int pr = r & 1;
  const uint32_t p = pr ? kP2 : kP1;
  const uint32_t pp = pr ? kPp2 : kPp1;
  const int l0 = blockIdx.x * tl;
  const int64_t base = static_cast<int64_t>(r) * m * lanes + l0;

  for (int i = threadIdx.x; i < half; i += blockDim.x)
    tws[i] = tw[pr * half + i];
  for (int e = threadIdx.x; e < (m << lg_tl); e += blockDim.x) {
    const int l = e & (tl - 1);
    const int i = e >> lg_tl;
    a[e] = l0 + l < lanes ? y[base + static_cast<int64_t>(i) * lanes + l] : 0u;
  }
  __syncthreads();

  for (int s = 0; s < lg; ++s) {
    const int sh = kInverse ? s : lg - 1 - s;   // log2 of the half-span
    const int tsh = kInverse ? lg - 1 - s : s;  // twiddle index shift
    const int h = 1 << sh;
    for (int b = threadIdx.x; b < (half << lg_tl); b += blockDim.x) {
      const int l = b & (tl - 1);
      const int k = b >> lg_tl;
      const int j = k & (h - 1);
      uint32_t *x0 = a + ((((k - j) << 1) + j) << lg_tl) + l;
      uint32_t *x1 = x0 + (h << lg_tl);
      const uint32_t w = tws[j << tsh];
      const uint32_t u0 = *x0;
      if (kInverse) {
        const uint32_t u1 = mont_mul(*x1, w, p, pp);
        *x0 = add_mod(u0, u1, p);
        *x1 = sub_mod(u0, u1, p);
      } else {
        const uint32_t u1 = *x1;
        *x0 = add_mod(u0, u1, p);
        *x1 = mont_mul(sub_mod(u0, u1, p), w, p, pp);
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < (m << lg_tl); e += blockDim.x) {
    const int l = e & (tl - 1);
    const int i = e >> lg_tl;
    if (l0 + l < lanes) out[base + static_cast<int64_t>(i) * lanes + l] = a[e];
  }
}

}  // namespace

extern "C" int fs_ntt_phase(const void *y, void *out, const void *tw,
                            int32_t rows, int32_t m, int32_t lanes,
                            int32_t inverse, void *stream) {
  int lg = 0;
  while ((1 << lg) < m) ++lg;
  // TL: a power of two, at most kTileWords / m and no wider than L needs
  int lg_tl = 0;
  while ((2 << lg_tl) * m <= kTileWords && (1 << lg_tl) < lanes) ++lg_tl;
  const dim3 grid((lanes + (1 << lg_tl) - 1) >> lg_tl, rows);
  const size_t smem = (static_cast<size_t>(m / 2) + (m << lg_tl)) * 4;
  const auto *yy = static_cast<const uint32_t *>(y);
  auto *oo = static_cast<uint32_t *>(out);
  const auto *tt = static_cast<const uint32_t *>(tw);
  auto st = static_cast<cudaStream_t>(stream);
  if (inverse)
    phase_kernel<true><<<grid, kThreads, smem, st>>>(yy, oo, tt, lg, lanes,
                                                     lg_tl);
  else
    phase_kernel<false><<<grid, kThreads, smem, st>>>(yy, oo, tt, lg, lanes,
                                                      lg_tl);
  return static_cast<int>(cudaGetLastError());
}
