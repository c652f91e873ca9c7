// The bytes-bound bf16 GEMV loop of the lm_head, x [M <= 32, K] @ w [K, V]
// with f32 sums (K4, dense_gemv.cu; K5, head_argmax.cu), written so that a
// kernel gives it what to do with each finished f32 sum (the Emit functor):
// K4 stores it, K5 keeps a running argmax key. With NORM (K5) x is the
// pre-norm row and each staged unit becomes bf16(x * rs[m] * norm_w[k]),
// rs[m] the RMS scale of row m, which every block computes for itself
// first.
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
//     block. K5 norms x in shared memory (a load of x from global memory
//     inside the stream would queue behind the copies): at <= 8 rows the
//     whole rows once a block (WHOLE), else each unit in its slab, with its
//     32 norm weights, one unit ahead of the products. Where V is not a
//     multiple of 8 (an odd vocabulary: rows of w
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
//     a scratch slot; the last block to finish the tile adds them in the
//     order of k (stream_k.cuh, with the work division). The sums then do
//     not change from run to run.
#pragma once

#include "async_mma.cuh"
#include "stream_k.cuh"

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
  const bf16* x;       // [M, K]
  const bf16* w;       // [K, V]
  float* part;         // [gridDim.x][2][MB][BN]: a block's first and last partial sums
  unsigned int* ticket;  // [tiles], 0 between launches
  int M, K, V;
  const bf16* norm_w;  // [K] (NORM only)
  float eps;           // (NORM only)
};

// Per row count MB (a power of two >= M): MT m16 tiles of x.
template <int MB>
struct Geo {
  static constexpr int MT = (MB + 15) / 16;
  static constexpr int XROWS = MT * 16;  // staged rows of x, zero past M
  static constexpr int NW_OFF = W_SLAB + XROWS * X_LD * 2;  // NORM: the unit's norm weights
  static constexpr int SLAB = NW_OFF + ROWS * 2;
  static constexpr int RED_OFF = STAGES * SLAB;
  static constexpr int RS_OFF = RED_OFF + MB * BN * 4 + 16;  // + the ticket's answer
  static constexpr int SMEM = RS_OFF + MB * 4;                // + rs[MB] (NORM)
  // NORM at MB <= 8 (WHOLE): the rows' whole normed x after that
  static constexpr int XW_OFF = (SMEM + 15) / 16 * 16;
};

__host__ __device__ inline int tiles_of(int V) { return (V + BN - 1) / BN; }
__host__ __device__ inline int units_of(int K) { return (K + ROWS - 1) / ROWS; }

// WHOLE: the row stride of the normed x (16 bytes to spare: conflict-free
// ldmatrix rows) and the shared memory it takes with the ring.
__host__ __device__ inline int whole_ld(int K) { return units_of(K) * ROWS + 8; }
template <int MB>
__host__ __device__ inline int whole_smem(int K) {
  return Geo<MB>::XW_OFF + MB * whole_ld(K) * 2;
}

// The elements by which row k of tile t's segment of w starts past a
// 16-byte boundary (0 where V % 8 == 0 and w is aligned).
__device__ __forceinline__ int row_shift(const Args& p, int k, int n0) {
  return (int)(((uintptr_t)(p.w + (size_t)k * p.V + n0) & 15) >> 1);
}

// Copy unit u's rows of w (tile u / KU, rows (u % KU) * ROWS ..) into a
// slab by 16-byte cp.async. ALIGNED: w's rows start on 16 bytes; else each
// row's segment is copied from its start rounded down to 16 bytes, 33
// chunks (the bytes around it are w's own or in the same 16-byte block of
// its allocation, and feed only columns that are masked).
template <bool ALIGNED>
__device__ __forceinline__ void load_w(unsigned char* slab, const Args& p, int u, int KU,
                                       int tid) {
  bf16* ws = reinterpret_cast<bf16*>(slab);
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
}

// Copy unit u's 32 columns of x into the slab: by cp.async where K % 8 == 0
// and x is aligned, else by 2-byte loads.
template <int MB>
__device__ __forceinline__ void load_x(unsigned char* slab, const Args& p, int u, int KU,
                                       int tid) {
  bf16* xs = reinterpret_cast<bf16*>(slab + W_SLAB);
  const int k0 = (u % KU) * ROWS;
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

// Whether the normed x can be read 16 bytes at a time.
__device__ __forceinline__ bool norm_vec(const Args& p) {
  return p.K % 8 == 0 && (((uintptr_t)p.x | (uintptr_t)p.norm_w) & 15) == 0;
}

// rs[m] = 1 / sqrt(mean(x[m]^2) + eps) in f32 (NORM): the block on eight
// rows at a time, each thread issuing its eight rows' loads before using
// them; part [WARPS][MB] holds the warps' sums.
template <int MB>
__device__ void norm_scales(const Args& p, float* rs, float* part, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const bool vec = norm_vec(p);
  for (int m0 = 0; m0 < p.M; m0 += 8) {
    float ss[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) ss[r] = 0.f;
    if (vec) {
      for (int k = tid * 8; k < p.K; k += THREADS * 8) {
        uint4 u[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          u[r] = m0 + r < p.M
                     ? __ldg(reinterpret_cast<const uint4*>(p.x + (size_t)(m0 + r) * p.K + k))
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[r]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            ss[r] += f.x * f.x + f.y * f.y;
          }
        }
      }
    } else {
      for (int k = tid; k < p.K; k += THREADS)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float v = m0 + r < p.M ? bf2f(p.x[(size_t)(m0 + r) * p.K + k]) : 0.f;
          ss[r] += v * v;
        }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float t = warp_sum(ss[r]);
      if (lane == 0 && m0 + r < p.M) part[warp * MB + m0 + r] = t;
    }
  }
  __syncthreads();
  if (tid < p.M) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += part[w * MB + tid];
    rs[tid] = 1.0f / sqrtf(t / (float)p.K + p.eps);
  }
  __syncthreads();
}

// Copy the unit's 32 norm weights into the slab (NORM; zeros past K).
template <int MB>
__device__ __forceinline__ void load_nw(unsigned char* slab, const Args& p, int u, int KU,
                                        int tid) {
  bf16* nw = reinterpret_cast<bf16*>(slab + Geo<MB>::NW_OFF);
  const int k0 = (u % KU) * ROWS;
  if (norm_vec(p)) {
    if (tid < ROWS / 8) {
      const bool ok = k0 + tid * 8 < p.K;
      tc::cp_async16(nw + tid * 8, ok ? (const void*)(p.norm_w + k0 + tid * 8) : p.norm_w,
                     ok ? 16 : 0);
    }
  } else if (tid < ROWS) {
    nw[tid] = k0 + tid < p.K ? p.norm_w[k0 + tid] : f2bf(0.f);
  }
}

// Norm the unit's staged x in its slab (NORM): thread tid < M * 4 takes
// eight consecutive k of row tid / 4. Rows >= M stay zero.
template <int MB>
__device__ __forceinline__ void form_norm(unsigned char* slab, const Args& p, const float* rs,
                                          int tid) {
  const int m = tid / (ROWS / 8), c = (tid % (ROWS / 8)) * 8;
  if (m >= p.M) return;
  bf16* xs = reinterpret_cast<bf16*>(slab + W_SLAB) + m * X_LD + c;
  const bf16* nw = reinterpret_cast<const bf16*>(slab + Geo<MB>::NW_OFF) + c;
  const uint4 xv = *reinterpret_cast<const uint4*>(xs);
  const uint4 wv = *reinterpret_cast<const uint4*>(nw);
  const __nv_bfloat162* hx = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const __nv_bfloat162* hw = reinterpret_cast<const __nv_bfloat162*>(&wv);
  __align__(16) bf16 o[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 fx = __bfloat1622float2(hx[e]), fw = __bfloat1622float2(hw[e]);
    o[2 * e] = f2bf(fx.x * rs[m] * fw.x);
    o[2 * e + 1] = f2bf(fx.y * rs[m] * fw.y);
  }
  *reinterpret_cast<uint4*>(xs) = *reinterpret_cast<const uint4*>(o);
}

// Norm the rows' whole x into xw [M][whole_ld(K)] (WHOLE), zeros past K.
template <int MB>
__device__ void form_whole(bf16* xw, const Args& p, const float* rs, int tid) {
  const int ld = whole_ld(p.K), per = (ld - 8) / 8;
  const bool vec = norm_vec(p);
  for (int i = tid; i < p.M * per; i += THREADS) {
    const int m = i / per, k = (i % per) * 8;
    __align__(16) bf16 o[8];
    if (vec && k < p.K) {
      const uint4 xv = __ldg(reinterpret_cast<const uint4*>(p.x + (size_t)m * p.K + k));
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(p.norm_w + k));
      const __nv_bfloat162* hx = reinterpret_cast<const __nv_bfloat162*>(&xv);
      const __nv_bfloat162* hw = reinterpret_cast<const __nv_bfloat162*>(&wv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fx = __bfloat1622float2(hx[e]), fw = __bfloat1622float2(hw[e]);
        o[2 * e] = f2bf(fx.x * rs[m] * fw.x);
        o[2 * e + 1] = f2bf(fx.y * rs[m] * fw.y);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = f2bf(k + e < p.K ? bf2f(p.x[(size_t)m * p.K + k + e]) * rs[m] *
                                      bf2f(p.norm_w[k + e])
                                : 0.f);
    }
    *reinterpret_cast<uint4*>(xw + m * ld + k) = *reinterpret_cast<const uint4*>(o);
  }
}

// Warp w's 32 columns (four n8 tiles) times every row of x on tensor cores,
// two 16-deep steps a unit. B from the row-major w slab by ldmatrix.trans
// (ALIGNED), else built by 2-byte loads at each row's offset.
// x from xs (row stride xld; rows >= xrows read as row xrows - 1: they
// reach only output rows that are never emitted).
template <int MB, bool ALIGNED>
__device__ __forceinline__ void tc_unit(float (&c)[Geo<MB>::MT][4][4], const bf16* ws,
                                        const bf16* xs, int xld, int xrows, const Args& p, int k0,
                                        int n0, int warp, int lane) {
  using G = Geo<MB>;
  const int nb = warp * 32;
#pragma unroll
  for (int ks = 0; ks < ROWS / 16; ++ks) {
    uint32_t a[G::MT][4];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
      tc::ldmatrix_x4(a[mt], xs + min(mt * 16 + (lane & 15), xrows - 1) * xld + ks * 16 +
                                 (lane >> 4) * 8);
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
// WHOLE (with NORM, MB <= 8): the rows' whole x is normed once into shared
// memory (whole_smem) instead of unit by unit in the slabs.
template <int MB, bool ALIGNED, bool NORM = false, bool WHOLE = false, class Emit>
__device__ __forceinline__ void gemv_stream(const Args& p, unsigned char* smem, const Emit& emit) {
  static_assert(!WHOLE || (NORM && MB <= 8), "WHOLE: the normed x of <= 8 rows");
  using G = Geo<MB>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const streamk::Range r(tiles_of(p.V), units_of(p.K));
  const int KU = r.KU, u0 = r.u0, u1 = r.u1;
  float* red = reinterpret_cast<float*>(smem + G::RED_OFF);  // [MB][BN]
  int* answer = reinterpret_cast<int*>(red + MB * BN);      // the ticket's answer
  float* rs = reinterpret_cast<float*>(smem + G::RS_OFF);   // NORM: [MB]

  float c[G::MT][4][4];  // C fragments of the warp's four n8 tiles
  auto clear = [&] {
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j][0] = c[i][j][1] = c[i][j][2] = c[i][j][3] = 0.f;
  };
  clear();

  constexpr bool AHEAD = NORM && !WHOLE;  // x normed in the slabs, a unit ahead
  bf16* xw = reinterpret_cast<bf16*>(smem + G::XW_OFF);
  auto load_unit = [&](unsigned char* slab, int u) {
    load_w<ALIGNED>(slab, p, u, KU, tid);
    if constexpr (!WHOLE) load_x<MB>(slab, p, u, KU, tid);
    if constexpr (AHEAD) load_nw<MB>(slab, p, u, KU, tid);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (u0 + s < u1) load_unit(smem + s * G::SLAB, u0 + s);
    tc::cp_async_commit();
  }
  if constexpr (NORM) {  // the rows' scales while the first units fly
    norm_scales<MB>(p, rs, red, tid);
    if constexpr (WHOLE) {
      form_whole<MB>(xw, p, rs, tid);
    } else {  // unit u0's x normed
      tc::cp_async_wait<STAGES - 2>();
      __syncthreads();
      form_norm<MB>(smem, p, rs, tid);
    }
  }
  for (int u = u0; u < u1; ++u) {
    const int i = u - u0;
    // unit u is in (AHEAD: unit u + 1 too, to be normed after the products)
    tc::cp_async_wait<AHEAD ? STAGES - 3 : STAGES - 2>();
    __syncthreads();  // ... and every warp is done with unit u - 1's slab
    if (u + STAGES - 1 < u1)
      load_unit(smem + ((i + STAGES - 1) % STAGES) * G::SLAB, u + STAGES - 1);
    tc::cp_async_commit();

    const unsigned char* slab = smem + (i % STAGES) * G::SLAB;
    const bf16* ws = reinterpret_cast<const bf16*>(slab);
    if constexpr (WHOLE)
      tc_unit<MB, ALIGNED>(c, ws, xw + (u % KU) * ROWS, whole_ld(p.K), MB, p, (u % KU) * ROWS,
                           (u / KU) * BN, warp, lane);
    else
      tc_unit<MB, ALIGNED>(c, ws, reinterpret_cast<const bf16*>(slab + W_SLAB), X_LD, G::XROWS,
                           p, (u % KU) * ROWS, (u / KU) * BN, warp, lane);
    if constexpr (AHEAD)  // unit u + 1's x, read after the next barrier
      if (u + 1 < u1) form_norm<MB>(smem + ((i + 1) % STAGES) * G::SLAB, p, rs, tid);

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
    if (!streamk::finish_tile<MB, BN>(r, t, u, v, p.M, p.part, p.ticket, answer, tid)) continue;
    const int n = t * BN + tid;
    if (n < p.V)
#pragma unroll
      for (int m = 0; m < MB; ++m)
        if (m < p.M) emit(m, n, v[m]);
  }
  tc::cp_async_wait<0>();
}

}  // namespace dstream
