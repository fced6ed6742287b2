// K10: the CRT + carry tail from residue rows, over the whole card.
//
// Replaces: fractalshark_tpu/ops/bignum/ntt_pallas.py:1265
// _tail_batched_kernel (B-f4, BATCHED_TAIL) and :1134 _tail_split_kernel
// run on residue rows (B8c's fused_tail, :1326, the route with the flag
// off).  Both compute one function (fused_tail.cuh's header says which);
// both flags reach these two launches, counted apart by the wrapper.
//
// What bounds it: the bytes.  At nfft 65,536 and two components it reads
// 1 MB of residue rows and 768 KB of addend planes and writes 512 KB of
// digits (0.7 us at 3.35 TB/s); the arithmetic is tens of integer
// operations a digit.  A tail on one block per component (its parent)
// used 2-4 of 132 SMs, a thread walking 64 consecutive digits, so every
// warp access touched 32 sectors, and passed the digits through device
// memory five times.
//
// Design: launch 1, tail_tiles, has a block of 256 threads for each tile
// of 1,024 consecutive digits of a component (grid (tiles, K): the
// components on blockIdx.y, all in one launch), which runs the tile body
// of fused_tail.cuh (tail_tile: the CRT into shared memory once, segments
// of 4 digits rippled, the carry maps scanned, the carry into the tile by
// decoupled look-back); the tiles take their index from a ticket in the
// order they start, so a tile waits only on tiles that are running.
// Launch 2, tail_finish, on the same grid, runs the finishing body
// (finish_tile: the sign, the negation from the lowest nonzero digit, the
// shadow row from the highest of the slice).  K11 runs the same two
// bodies as phases of its one launch.  No host sync: component 1's gswap
// (zsign) is read on the card.  The two launches' state (tickets,
// published words, the atomics) is device scratch that is zero between
// calls: launch 2 clears what launch 1 set, and a refused launch 2 is
// cleared here with a memset.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "fused_tail.cuh"

namespace {

constexpr int kGridThreads = 256;
constexpr int kGridTile = kGridThreads * kSeg;   // digits a block

// launch 1: grid (tiles, K), kGridThreads threads; the tile from a ticket
__global__ void __launch_bounds__(kGridThreads)
    tail_tiles(FusedTail t, TailState *st) {
  __shared__ TileShared<kGridThreads> sh;
  __shared__ int tile_s;
  const int c = blockIdx.y;
  if (threadIdx.x == 0)
    tile_s = static_cast<int>(atomicAdd(&st->ticket[c], 1u));
  __syncthreads();
  tail_tile<kGridThreads>(t, st, c, tile_s, sh);
}

// launch 2: grid (tiles, K), kGridThreads threads
__global__ void __launch_bounds__(kGridThreads)
    tail_finish(FusedTail t, TailState *st) {
  __shared__ int red[33];
  finish_tile<kGridThreads>(t, st, blockIdx.y, blockIdx.x, gridDim.x, red);
}

}  // namespace

// K10.  inv: uint32 [K][2][n] residue rows; cadd: uint32 [K][L]; rnd:
// uint32 [L]; cfg: int32 host [4K] (double, gswap, csign, 0); zsign: int32
// [2] on the card or null (component 1's gswap = zsign[0]*zsign[1]); dig:
// uint32 [K][L] out; sgn: int32 [K] out; shw: int32 [K][5] out or null
// (the slice [F, F+D)); state: fs_fused_tail_state_bytes() of device
// scratch, zero on entry and on return.  n = 2^log2n <= 2^17, L <= n a
// multiple of 4; cadd, rnd and dig 16-byte aligned.  Two launches on the
// stream.
extern "C" int fs_fused_tail(const void *inv, const void *cadd,
                             const void *rnd, const void *cfg,
                             const void *zsign, void *dig, void *sgn,
                             void *shw, void *state, int K, int log2n, int L,
                             int F, int D, void *stream) {
  FusedTail t;
  int rc = make_tail(&t, inv, cadd, rnd, static_cast<const int32_t *>(cfg),
                     zsign, dig, sgn, shw, K, log2n, L, F, D);
  if (rc) return rc;
  // the planes and digits are read and written 16 bytes a thread
  if ((reinterpret_cast<uintptr_t>(cadd) | reinterpret_cast<uintptr_t>(rnd) |
       reinterpret_cast<uintptr_t>(dig)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<TailState *>(state);
  const dim3 grid((L + kGridTile - 1) / kGridTile, K);
  tail_tiles<<<grid, kGridThreads, 0, st>>>(t, s);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  tail_finish<<<grid, kGridThreads, 0, st>>>(t, s);
  if ((rc = static_cast<int>(cudaGetLastError())))
    cudaMemsetAsync(state, 0, sizeof(TailState), st);
  return rc;
}

extern "C" int fs_fused_tail_state_bytes() {
  return static_cast<int>(sizeof(TailState));
}
