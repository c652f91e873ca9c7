// The bytes-bound bf16 GEMV loop of the lm_head, x [M <= 32, K] @ w [K, V]
// with f32 sums (K4, dense_gemv.cu), written so that a kernel gives it what
// to do with each finished f32 sum (the Emit functor): K4 stores it.
//
// Bound on the H100: bytes. The K*V*2 bytes of w are read once for 2*M*K*V
// flops, so at decode M the card can do no better than K*V*2 / 3.35 TB/s
// (78 us for Llama-7B's 4096 x 32000). Reaching that takes every SM
// streaming with ~25 KB or more of loads in flight (HBM's latency times its
// rate, spread over 132 SMs). Design:
//
//   * Work: the weight is cut into tiles of 256 columns and each tile's K
//     into units of 32 rows; the units, tile after tile, are shared out as
//     contiguous ranges among a grid of one block an SM ("stream-K": every
//     SM gets the same bytes, to within one unit, whatever the number of
//     tiles -- 125 at V = 32000, fewer than the SMs).
//   * Loads: a ring of STAGES slabs in shared memory, each one unit of w
//     (32 rows x 512 contiguous bytes) and the unit's 32 columns of x,
//     filled by 16-byte cp.async, STAGES - 1 slabs (~70 KB) in flight a
//     block. Where V is not a multiple of 8 (an odd vocabulary: rows of w
//     not 16-byte aligned) each row's segment is copied from its address
//     rounded down to 16 bytes, one chunk more, and read at its offset by
//     2-byte loads (the ALIGNED = false instantiation); columns past V are
//     masked from the output.
//   * Products: on tensor cores at every M (mma.sync.m16n8k16, bf16 in,
//     f32 sums; x padded to 16 rows): warp w owns the tile's columns
//     32w..32w+31 for all rows of x, B comes from the row-major slab by
//     ldmatrix.trans. f32 FMAs on CUDA cores cost the same at 1-2 rows but
//     outran the bytes from 8 rows on (2*M*K*V flops at 67 TFLOP/s).
//   * Combine: a tile cut between blocks leaves each block's partial sums in
//     a scratch slot; the last block to finish the tile, found by an atomic
//     ticket that it resets to 0, adds them in the order of k. The sums
//     then do not change from run to run.
#pragma once

#include "async_mma.cuh"

namespace dstream {

constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int BN = 256;               // columns of a tile: eight a lane
constexpr int ROWS = 32;              // rows of k in a unit (a ring slab)
constexpr int STAGES = 5;             // slabs in the ring, STAGES - 1 in flight
constexpr int W_LD = BN + 8;          // elements of a staged row of w: 16 bytes to spare
constexpr int W_SLAB = ROWS * W_LD * 2;  // bytes of w in a slab
constexpr int X_LD = ROWS + 8;        // elements of a staged row of x (80 bytes)
static_assert(BN == THREADS, "thread t combines column t of a tile");

struct Args {
  const bf16* x;  // [M, K]
  const bf16* w;  // [K, V]
  float* part;    // [gridDim.x][2][MB][BN]: a block's first and last partial sums
  int* ticket;    // [tiles], 0 between launches
  int M, K, V;
};

// Per row count MB (a power of two >= M): MT m16 tiles of x.
template <int MB>
struct Geo {
  static constexpr int MT = (MB + 15) / 16;
  static constexpr int XROWS = MT * 16;  // staged rows of x, zero past M
  static constexpr int SLAB = W_SLAB + XROWS * X_LD * 2;
  static constexpr int RED_OFF = STAGES * SLAB;
  static constexpr int SMEM = RED_OFF + MB * BN * 4 + 16;  // + the ticket's answer
};

__host__ __device__ inline int tiles_of(int V) { return (V + BN - 1) / BN; }
__host__ __device__ inline int units_of(int K) { return (K + ROWS - 1) / ROWS; }

// The first of block b's units when U units are shared among G blocks.
__device__ __forceinline__ int unit_begin(long long b, long long U, int G) {
  return (int)(b * U / G);
}

// The block whose range holds unit u: the largest b with unit_begin(b) <= u.
__device__ __forceinline__ int block_of(long long u, long long U, int G) {
  return (int)(((u + 1) * G + U - 1) / U - 1);
}

// The elements by which row k of tile t's segment of w starts past a
// 16-byte boundary (0 where V % 8 == 0 and w is aligned).
__device__ __forceinline__ int row_shift(const Args& p, int k, int n0) {
  return (int)(((uintptr_t)(p.w + (size_t)k * p.V + n0) & 15) >> 1);
}

// Copy unit u (tile u / KU, rows (u % KU) * ROWS ..) of w and its columns
// of x into a slab by 16-byte cp.async. ALIGNED: w's rows start on 16
// bytes; else each row's segment is copied from its start rounded down to
// 16 bytes, 33 chunks (the bytes around it are w's own or in the same
// 16-byte block of its allocation, and feed only columns that are masked).
// x by cp.async where K % 8 == 0 and x is aligned, else by 2-byte loads.
template <int MB, bool ALIGNED>
__device__ __forceinline__ void load_unit(unsigned char* slab, const Args& p, int u, int KU,
                                          int tid) {
  bf16* ws = reinterpret_cast<bf16*>(slab);
  bf16* xs = reinterpret_cast<bf16*>(slab + W_SLAB);
  const int n0 = (u / KU) * BN, k0 = (u % KU) * ROWS;
  constexpr int CHUNKS = ALIGNED ? BN / 8 : BN / 8 + 1;  // 16-byte chunks of a row
#pragma unroll
  for (int it = 0; it < (ROWS * CHUNKS + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    if (ROWS * CHUNKS % THREADS && i >= ROWS * CHUNKS) break;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bf16* row = p.w + (size_t)(k0 + r) * p.V + n0;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
                                   (uintptr_t)row & ~(uintptr_t)15) + c * 16;
    const bool ok = k0 + r < p.K &&
                    src < reinterpret_cast<const unsigned char*>(row + min(BN, p.V - n0));
    tc::cp_async16(ws + r * W_LD + c * 8, ok ? src : (const void*)p.w, ok ? 16 : 0);
  }
  constexpr int XROWS = Geo<MB>::XROWS;
  if (p.K % 8 == 0 && (uintptr_t)p.x % 16 == 0) {
    for (int i = tid; i < XROWS * (ROWS / 8); i += THREADS) {
      const int m = i / (ROWS / 8), c = (i % (ROWS / 8)) * 8;
      const bool ok = m < p.M && k0 + c < p.K;
      tc::cp_async16(xs + m * X_LD + c, ok ? p.x + (size_t)m * p.K + k0 + c : p.x, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < XROWS * ROWS; i += THREADS) {
      const int m = i / ROWS, c = i % ROWS;
      const bool ok = m < p.M && k0 + c < p.K;
      xs[m * X_LD + c] = ok ? p.x[(size_t)m * p.K + k0 + c] : f2bf(0.f);
    }
  }
}

// Warp w's 32 columns (four n8 tiles) times every row of x on tensor cores,
// two 16-deep steps a unit. B from the row-major w slab by ldmatrix.trans
// (ALIGNED), else built by 2-byte loads at each row's offset.
template <int MB, bool ALIGNED>
__device__ __forceinline__ void tc_unit(float (&c)[Geo<MB>::MT][4][4], const bf16* ws,
                                        const bf16* xs, const Args& p, int k0, int n0, int warp,
                                        int lane) {
  using G = Geo<MB>;
  const int nb = warp * 32;
#pragma unroll
  for (int ks = 0; ks < ROWS / 16; ++ks) {
    uint32_t a[G::MT][4];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
      tc::ldmatrix_x4(a[mt], xs + (mt * 16 + (lane & 15)) * X_LD + ks * 16 + (lane >> 4) * 8);
    uint32_t b[2][4];  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if constexpr (ALIGNED) {
        tc::ldmatrix_x4_trans(b[np], ws + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * W_LD +
                                         nb + np * 16 + (lane >> 4) * 8);
      } else {
        const int g = lane >> 2, q = lane & 3;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ks * 16 + (j & 1) * 8 + 2 * q, n = nb + np * 16 + (j >> 1) * 8 + g;
          const bf16 lo = ws[r * W_LD + row_shift(p, k0 + r, n0) + n];
          const bf16 hi = ws[(r + 1) * W_LD + row_shift(p, k0 + r + 1, n0) + n];
          b[np][j] = (uint32_t)__bfloat16_as_ushort(lo) | (uint32_t)__bfloat16_as_ushort(hi) << 16;
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        tc::mma_bf16(c[mt][nt], a[mt], b[nt >> 1][2 * (nt & 1)], b[nt >> 1][2 * (nt & 1) + 1]);
  }
}

// The sums of every tile, handed to emit(m, n, value) once each for m < M,
// n < V by the thread that holds them. Every thread of the block calls it.
template <int MB, bool ALIGNED, class Emit>
__device__ __forceinline__ void gemv_stream(const Args& p, unsigned char* smem, const Emit& emit) {
  using G = Geo<MB>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KU = units_of(p.K);
  const long long U = (long long)tiles_of(p.V) * KU;
  const int grid = gridDim.x, b = blockIdx.x;
  const int u0 = unit_begin(b, U, grid), u1 = unit_begin(b + 1, U, grid);
  float* red = reinterpret_cast<float*>(smem + G::RED_OFF);  // [MB][BN]
  int* answer = reinterpret_cast<int*>(red + MB * BN);      // the ticket's answer

  float c[G::MT][4][4];  // C fragments of the warp's four n8 tiles
  auto clear = [&] {
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j][0] = c[i][j][1] = c[i][j][2] = c[i][j][3] = 0.f;
  };
  clear();

  for (int s = 0; s < STAGES - 1; ++s) {
    if (u0 + s < u1) load_unit<MB, ALIGNED>(smem + s * G::SLAB, p, u0 + s, KU, tid);
    tc::cp_async_commit();
  }
  for (int u = u0; u < u1; ++u) {
    const int i = u - u0;
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // unit u is in, and every warp is done with unit u - 1's slab
    if (u + STAGES - 1 < u1)
      load_unit<MB, ALIGNED>(smem + ((i + STAGES - 1) % STAGES) * G::SLAB, p, u + STAGES - 1,
                             KU, tid);
    tc::cp_async_commit();

    const unsigned char* slab = smem + (i % STAGES) * G::SLAB;
    const bf16* ws = reinterpret_cast<const bf16*>(slab);
    const bf16* xs = reinterpret_cast<const bf16*>(slab + W_SLAB);
    tc_unit<MB, ALIGNED>(c, ws, xs, p, (u % KU) * ROWS, (u / KU) * BN, warp, lane);

    const int t = u / KU;
    if (u + 1 < u1 && (u + 1) % KU) continue;  // tile t's range goes on

    // tile t's range of this block ends: through shared memory, thread tid
    // takes column tid of each row
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + 8 * h;
          if (m < MB)
            *reinterpret_cast<float2*>(red + m * BN + warp * 32 + nt * 8 + 2 * q) =
                make_float2(c[mt][nt][2 * h], c[mt][nt][2 * h + 1]);
        }
    clear();
    __syncthreads();
    float v[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) v[m] = red[m * BN + tid];
    const int n = t * BN + tid;
    const int seg0 = max(u0, t * KU);
    if (seg0 == t * KU && u + 1 == (t + 1) * KU) {  // the whole tile is this block's
      if (n < p.V)
#pragma unroll
        for (int m = 0; m < MB; ++m)
          if (m < p.M) emit(m, n, v[m]);
      continue;
    }
    // a part of tile t: this block's first (slot 0) or last (slot 1) range.
    // Published as a grid barrier does it: the block's stores, a barrier,
    // then one fence and the ticket by thread 0
    float* mine = p.part + ((size_t)(2 * b + (seg0 == u0 ? 0 : 1)) * MB) * BN + tid;
#pragma unroll
    for (int m = 0; m < MB; ++m)
      if (m < p.M) mine[m * BN] = v[m];
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      *answer = atomicAdd(p.ticket + t, 1);
      __threadfence();
    }
    __syncthreads();
    const int first = block_of((long long)t * KU, U, grid);
    const int last = block_of((long long)(t + 1) * KU - 1, U, grid);
    if (*answer != last - first) continue;  // another block finishes tile t
    // every partial is loaded before the first output is stored (a store
    // could alias them and would hold each load back behind it)
#pragma unroll
    for (int m = 0; m < MB; ++m) v[m] = 0.f;
    for (int blk = first; blk <= last; ++blk) {  // in the order of k
      const float* src =
          p.part + (size_t)(2 * blk + (unit_begin(blk, U, grid) >= t * KU ? 0 : 1)) * MB * BN +
          tid;
#pragma unroll
      for (int m = 0; m < MB; ++m)
        if (m < p.M) v[m] += __ldcg(src + m * BN);
    }
    if (n < p.V)
#pragma unroll
      for (int m = 0; m < MB; ++m)
        if (m < p.M) emit(m, n, v[m]);
    if (tid == 0) p.ticket[t] = 0;
  }
  tc::cp_async_wait<0>();
}

}  // namespace dstream
