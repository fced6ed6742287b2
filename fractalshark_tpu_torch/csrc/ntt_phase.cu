// K8: one phase of the generic four-step NTT, with the glue between the
// phases in its epilogue.  For y uint32 [R, m, L] it runs a length-m
// radix-2 NTT along axis 1 for every (row r, lane l), row r modulo p1 if r
// is even and p2 if r is odd (the primes of ntt.py):
//   forward: DIF, natural order in, bit-reversed out;
//   inverse: DIT, bit-reversed in, natural out, unscaled.
// Stage s of the forward pass pairs i0 = blk*2h + j with i0 + h,
// h = m >> (s+1), twiddle w_m^(j << s) after the difference; stage s of
// the inverse pass has h = 2^s and twiddle w_m^-(j << (lg-1-s)) before the
// butterfly (ntt.py:598-632 _axis0_dif/_axis0_dit).  Outputs are canonical
// residues in [0, p).  Epilogues (ops/bignum/ntt.py fourstep_head/_tail):
//   kEpiNone:    out [R, m, L], the phase;
//   kEpiTwiddle: out [R, L, m] = the phase transposed, times the matrix
//                mat [2 primes, L, m] (Montgomery form): the four-step's
//                twiddle matrix between its phases;
//   kEpiScale:   out [R, m, L] = the phase times n^-1 (·R), the inverse's
//                scale (Montgomery form, one word a prime).
// So a four-step transform is two launches with nothing between them.
//
// Replaces: fractalshark_tpu/ops/bignum/ntt_pallas.py:1661 _phase_kernel
// (B9b; call :1717, API sublane_transform :1698) and
// fractalshark_tpu/ops/bignum/ntt_mxu.py:243 _mxu_phase_kernel (B9a; call
// :291, API mxu_transform_pallas :273).  Both compute this one function on
// the TPU, bit for bit (the MXU form as balanced int8 matrix products, a
// layout for Mosaic's matrix unit that is not copied); the generic
// multiplies reach them through fourstep_forward/fourstep_inverse_scaled
// (ntt.py:658-718) at nfft >= 8,192, whose twiddle matrix, transpose and
// scale XLA runs between the phases there, and the flat route below it is
// the same transform with m = n, L = 1.
//
// Bound on the H100: a phase reads and writes 8 bytes a point (plus 4 for
// the twiddle matrix) against about 4*log2(m) integer operations a point
// (a Montgomery product of six, an add and a subtract for every other
// point a stage): at m = 256-512 the two are within a factor of two, so
// neither memory nor the ALUs may idle.  Design:
//  * one block per (row, tile of TL lanes); the tile's columns (TL*m <=
//    4,096 words) and the row prime's per-stage twiddles stay in shared
//    memory, so the data is read once and written once;
//  * TL is cut (down to 4 lanes, 16 bytes a row) until the grid has two
//    blocks an SM, so a transform of 4 rows fills the card;
//  * each thread takes 8 points of a column and runs three radix-2 stages
//    in registers (a radix-8 round) between two trips through shared
//    memory: ceil(log2(m)/3) rounds and as many __syncthreads, against
//    log2(m) before; the twiddles of stage b sit at [2^b - 1, 2^(b+1) - 1)
//    so that neighbouring lanes read neighbouring words (the rounds are
//    ntt_rounds.cuh's, which K9 and K11 run too);
//  * a column is padded and its word i stored at i ^ ((i >> 5) & 31), so
//    a warp's 32 points of one column fall in 32 banks in every round and
//    in the transposed epilogue, and the coalesced load of TL-word rows
//    does too;
//  * the epilogue reads the matrix in the output's own order ([L, m]), so
//    the transposed store and the matrix read are both coalesced.
// A butterfly's twiddle product is the reference's Shoup product (the
// twiddle w beside floor(w * 2^32 / p): five integer operations, against
// seven for a Montgomery product); the epilogue's matrix and scale are
// Montgomery products with w*R mod p, one word a point.  Each gives the
// canonical residue of x*w exactly.

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_rounds.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kTileWords = 4096;        // m * TL words of data a block
constexpr int kBlocksWanted = 2 * 132;  // two blocks an SM of the H100
constexpr int kMinLgTl = 2;             // rows of at least 16 bytes
constexpr size_t kDefaultSmem = 48 * 1024;  // more needs an opt-in

constexpr int kEpiNone = 0;
constexpr int kEpiTwiddle = 1;
constexpr int kEpiScale = 2;

// tw: uint32 [2 primes][m][2], the twiddles of the stage of half-span 2^b
// at [2^b - 1, 2^(b+1) - 1), each (w, floor(w * 2^32 / p)) for the Shoup
// product (ntt.py _k8_table); mat: uint32
// [2 primes][L][m] (kEpiTwiddle); sc1, sc2: the scale of each prime
// (kEpiScale), Montgomery form.  kE points a thread: 8, or m if m < 8.
template <bool kInverse, int kE>
__global__ void __launch_bounds__(kMaxThreads)
    phase_kernel(const uint32_t *__restrict__ y, uint32_t *__restrict__ out,
                 const uint32_t *__restrict__ tw,
                 const uint32_t *__restrict__ mat, uint32_t sc1, uint32_t sc2,
                 int lg, int lanes, int lg_tl, int epi) {
  extern __shared__ uint32_t sm[];
  const int m = 1 << lg;
  const int tl = 1 << lg_tl;
  const int pitch = m + pad_words(lg_tl);
  uint2 *tws = reinterpret_cast<uint2 *>(sm);
  uint32_t *a = sm + 2 * m;
  const int r = blockIdx.y;
  const int pr = r & 1;
  const uint32_t p = pr ? kP2 : kP1;
  const uint32_t pp = pr ? kPp2 : kPp1;
  const int l0 = blockIdx.x * tl;
  const int64_t base = static_cast<int64_t>(r) * m * lanes + l0;
  const int nt = blockDim.x;

  const uint2 *twp = reinterpret_cast<const uint2 *>(tw) + pr * m;
  for (int i = threadIdx.x; i < m; i += nt) tws[i] = twp[i];
  for (int e = threadIdx.x; e < (m << lg_tl); e += nt) {
    const int l = e & (tl - 1);
    const int i = e >> lg_tl;
    a[l * pitch + swz(i)] =
        l0 + l < lanes ? y[base + static_cast<int64_t>(i) * lanes + l] : 0u;
  }
  __syncthreads();

  // thread -> (column, slot): the m / kE threads of a column are adjacent
  const int gpc = m / kE;
  const int col = threadIdx.x / gpc;
  const int u = threadIdx.x - col * gpc;
  uint32_t *c = a + col * pitch;
  for (int q = 0; q < rounds_of<kE>(lg); ++q) {
    int blo, k;
    round_bits<kInverse, kE>(lg, q, &blo, &k);
    run_round<kInverse, kE>(c, tws, blo, k, u, gpc, p);
    __syncthreads();
  }

  if (epi == kEpiTwiddle) {
    // out [R, L, m], word i of lane l0 + l, times mat[pr][l0 + l][i]
    const int64_t obase = (static_cast<int64_t>(r) * lanes + l0) * m;
    const int64_t mbase = (static_cast<int64_t>(pr) * lanes + l0) * m;
    for (int e = threadIdx.x; e < (m << lg_tl); e += nt) {
      const int i = e & (m - 1);
      const int l = e >> lg;
      if (l0 + l < lanes)
        out[obase + e] = mont_mul(a[l * pitch + swz(i)], mat[mbase + e], p, pp);
    }
  } else {
    const uint32_t sc = pr ? sc2 : sc1;
    for (int e = threadIdx.x; e < (m << lg_tl); e += nt) {
      const int l = e & (tl - 1);
      const int i = e >> lg_tl;
      if (l0 + l < lanes) {
        const uint32_t v = a[l * pitch + swz(i)];
        out[base + static_cast<int64_t>(i) * lanes + l] =
            epi == kEpiScale ? mont_mul(v, sc, p, pp) : v;
      }
    }
  }
}

template <bool kInverse>
int launch(const uint32_t *y, uint32_t *out, const uint32_t *tw,
           const uint32_t *mat, uint32_t sc1, uint32_t sc2, int rows, int lg,
           int lanes, int epi, cudaStream_t st) {
  const int m = 1 << lg;
  // TL: a power of two, m*TL <= kTileWords, at most kMaxThreads threads and
  // no wider than L needs; then halved (not below 4 lanes) until the grid has kBlocksWanted blocks
  const int e = m < 8 ? m : 8;  // points a thread
  int lg_tl = 0;
  while ((2 << lg_tl) * m <= kTileWords && (2 << lg_tl) * m / e <= kMaxThreads
         && (1 << lg_tl) < lanes)
    ++lg_tl;
  const auto blocks = [&](int t) {
    return static_cast<int64_t>(rows) * ((lanes + (1 << t) - 1) >> t);
  };
  while (lg_tl > kMinLgTl && blocks(lg_tl) < kBlocksWanted) --lg_tl;
  const dim3 grid((lanes + (1 << lg_tl) - 1) >> lg_tl, rows);
  const int pitch = m + pad_words(lg_tl);
  const size_t smem = (2 * static_cast<size_t>(m) + (pitch << lg_tl)) * 4;
  const int threads = (m << lg_tl) / e;
  const auto kernel = e == 8   ? phase_kernel<kInverse, 8>
                      : e == 4 ? phase_kernel<kInverse, 4>
                               : phase_kernel<kInverse, 2>;
  if (smem > kDefaultSmem) {  // m = 4,096: 48 KB of data and twiddles
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, st>>>(y, out, tw, mat, sc1, sc2, lg, lanes,
                                      lg_tl, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [rows, m, lanes] -> out ([rows, lanes, m] with epi = kEpiTwiddle, else
// [rows, m, lanes]); tw uint32 [2][m][2]; mat uint32 [2][lanes][m] (read only
// with kEpiTwiddle); sc1, sc2 the scale words (read only with kEpiScale).
// m is a power of two in [2, 4,096]; 1 <= rows < 65,536.
extern "C" int fs_ntt_phase(const void *y, void *out, const void *tw,
                            const void *mat, int32_t rows, int32_t m,
                            int32_t lanes, int32_t inverse, int32_t epi,
                            int64_t sc1, int64_t sc2, void *stream) {
  int lg = 0;
  while ((1 << lg) < m) ++lg;
  if (m < 2 || m > kTileWords || (1 << lg) != m || rows < 1 ||
      rows >= (1 << 16) || lanes < 1 || epi < kEpiNone || epi > kEpiScale ||
      (epi == kEpiTwiddle && mat == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto *yy = static_cast<const uint32_t *>(y);
  auto *oo = static_cast<uint32_t *>(out);
  const auto *tt = static_cast<const uint32_t *>(tw);
  const auto *mm = static_cast<const uint32_t *>(mat);
  const auto s1 = static_cast<uint32_t>(sc1);
  const auto s2 = static_cast<uint32_t>(sc2);
  auto st = static_cast<cudaStream_t>(stream);
  return inverse ? launch<true>(yy, oo, tt, mm, s1, s2, rows, lg, lanes, epi,
                                st)
                 : launch<false>(yy, oo, tt, mm, s1, s2, rows, lg, lanes, epi,
                                 st);
}
