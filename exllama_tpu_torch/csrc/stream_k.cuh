// Stream-K's work division and its tile combine, shared by the streaming
// GEMVs: dense_stream.cuh (K4, K5: bf16 weights) and q4_stream.cuh (K1, K6
// and K7 at one row: 4-bit weights). Each keeps its own ring, weight
// loader, x forming and products; this header is what they have in common.
//
// A weight is cut into tiles of BN columns and each tile's K into KU units;
// the U = tiles * KU units, tile after tile, are shared out as contiguous
// ranges among the grid, so every block gets the same bytes (to within one
// unit) whatever the number of tiles. A grid larger than U is capped at U:
// a block with no unit would leave a split tile's ticket waiting. A tile
// cut between blocks leaves each block's partial sums in a scratch slot
// (slot 0: the block's first range, slot 1: its last); the last block to
// finish the tile, found by an atomic ticket that it resets to 0, adds them
// in the order of k. No f32 atomics: the sums do not change from run to
// run. ops/quant.py:stream_k_ranges writes the same plan out.
#pragma once

#include "common.cuh"

namespace streamk {

// The first of block b's units when U units are shared among G blocks.
__device__ __forceinline__ int unit_begin(long long b, long long U, int G) {
  return (int)(b * U / G);
}

// The block whose range holds unit u: the largest b with unit_begin(b) <= u.
__device__ __forceinline__ int block_of(long long u, long long U, int G) {
  return (int)(((u + 1) * G + U - 1) / U - 1);
}

// This block's range [u0, u1) of the tiles * KU units, among the first
// `grid` = min(gridDim.x, U) blocks; empty for the blocks past them.
struct Range {
  int KU, grid, u0, u1;
  long long U;
  __device__ __forceinline__ Range(int tiles, int ku) {
    KU = ku;
    U = (long long)tiles * ku;
    grid = (int)min((long long)gridDim.x, U);
    u0 = unit_begin(blockIdx.x, U, grid);
    u1 = unit_begin(blockIdx.x + 1, U, grid);
    if ((int)blockIdx.x >= grid) u0 = u1 = 0;
  }
};

// The end of this block's range of tile t (its last unit u): thread tid
// holds v[m], m < M, the range's sums of the tile's column tid. Returns
// whether the block emits the tile: the whole tile was its own, or it is
// the last of the tile's blocks to finish, and then v holds the partials
// added in the order of k and the tile's ticket is reset. part: [grid][2]
// [MB][BN] f32 scratch; ticket: one zero a tile; answer: an int of shared
// memory. Every thread of the block calls it, BN of them (a guard on tid
// cost K4 up to 5%: scripts/ring_ablation.py sk_tid_guard).
template <int MB, int BN>
__device__ __forceinline__ bool finish_tile(const Range& r, int t, int u, float (&v)[MB], int M,
                                            float* part, unsigned int* ticket, int* answer,
                                            int tid) {
  const int KU = r.KU, seg0 = max(r.u0, t * KU);
  if (seg0 == t * KU && u + 1 == (t + 1) * KU) return true;  // the whole tile
  // a part of tile t: this block's first (slot 0) or last (slot 1) range,
  // published as a grid barrier does it: the block's stores, a barrier,
  // then one fence and the ticket by thread 0
  float* mine = part + (size_t)(2 * blockIdx.x + (seg0 == r.u0 ? 0 : 1)) * MB * BN + tid;
#pragma unroll
  for (int m = 0; m < MB; ++m)
    if (m < M) mine[m * BN] = v[m];
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *answer = (int)atomicAdd(ticket + t, 1u);
    __threadfence();
  }
  __syncthreads();
  const int first = block_of((long long)t * KU, r.U, r.grid);
  const int last = block_of((long long)(t + 1) * KU - 1, r.U, r.grid);
  if (*answer != last - first) return false;  // another block finishes tile t
  // every partial is loaded before the caller stores an output (a store
  // could alias them and would hold each load back behind it)
#pragma unroll
  for (int m = 0; m < MB; ++m) v[m] = 0.f;
  for (int blk = first; blk <= last; ++blk) {  // in the order of k
    const float* src =
        part + (size_t)(2 * blk + (unit_begin(blk, r.U, r.grid) >= t * KU ? 0 : 1)) * MB * BN +
        tid;
#pragma unroll
    for (int m = 0; m < MB; ++m)
      if (m < M) v[m] += __ldcg(src + m * BN);
  }
  if (tid == 0) ticket[t] = 0u;  // ready for the next launch or phase
  return true;
}

}  // namespace streamk
