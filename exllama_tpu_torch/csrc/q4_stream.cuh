// The streaming 4-bit GPTQ GEMV at groupsize 32 / 64 / 128 and M <= 32
// rows: K1 (q4_gemv.cu) at one row, and the GEMV phases of the fused
// decode kernels K6 (q4_mlp.cu) and K7 (layer_tail.cu) at every row count:
// out[m, n] = x[m, :] @ W4[:, n], x formed by an XSrc (RMSNorm, the
// act-order gather, or silu(gate)*up), in the exact, a8 or a8x2
// arithmetic of the tensor-core GEMV (q4_gemv_tc.cuh), each finished f32
// output rounded to bf16 and stored, a residual added first where the
// phase has one (Out).
//
// At one row it took the place of a CUDA-core loop that gave each block a
// 32-column tile and all of K, so the 4096-column o and down projections
// of Llama-7B kept 128 blocks busy, each with four 4-byte loads a lane in
// flight: 0.22-0.75 TB/s. At 2..32 rows it took the place, in K6 and K7,
// of the tensor-core GEMV, which padded x to 16 or 32 rows as its A
// operand and loaded the weights by plain 16-byte loads, with no ring and
// nothing put in flight before a grid barrier.
//
// Bound on the H100: bytes (K*N/2 of nibbles and 4*(K/gs)*N of scales read
// once for 2*M*K*N operations). Design: K4's streaming loop
// (dense_stream.cuh) for packed weights:
//
//   * Work: tiles of 256 columns x units of 128 k (whole groups at gs 32,
//     64, 128), shared out stream-K among the grid (stream_k.cuh), so
//     every block gets the same bytes whatever the number of tiles or rows.
//   * Rows: a tile of MB = 1, 8, 16, 24 or 32 rows (a compile-time bound of the
//     registers); M rows are staged, padded to a multiple of 8 (M = 18: 24,
//     three n8 tiles of the mma; only the tiles that hold rows < M are
//     multiplied).
//   * Loads: a ring of STAGES slabs, each one unit: 16 packed rows of 256
//     words, the scale / zero-scale rows of its groups, and its 128 k of
//     the M rows of x with the norm weights (or up, for silu(gate)*up), all
//     by 16-byte cp.async: the stream issues no other load, which would
//     queue behind the copies. x is formed in place in the slab (norm or
//     silu(gate)*up; in the a8 modes quantized per (row, group) to int8,
//     and for a8x2 its residual), row m by warp m % 8, one unit ahead of the
//     products, once the unit is in. A phase's first weight slabs can be
//     put in flight before the grid barrier that precedes it (prefetch):
//     the weights do not depend on the phases before.
//   * Products: on tensor cores with the tensor-core GEMV's nibble tricks
//     (q4_gemv_tc.cuh: the nibble pairs as bf16 128 + q, exact; the even /
//     odd nibble bytes in the a8 modes), with the weights as the A operand
//     and x's rows as B, so that one mma gives 16 columns of 8 rows (at one
//     row x's row stands in every column of B: 16 useful columns, not 8 of
//     128 rows): lane (g, q) reads the four words of packed row q at its
//     warp's columns 4g..4g+3 from the slab and ends with those columns'
//     sums for rows 2q, 2q + 1 of each n8 tile; a group's product is
//     folded with its scales and x's (row, group) sum as the group ends.
//   * Combine: a tile cut between blocks leaves each block's partial sums
//     in a scratch slot; the last block to finish the tile adds them in the
//     order of k (stream_k.cuh). No f32 atomics: the sums do not change
//     from run to run.
#pragma once

#include "q4_gemv_tc.cuh"
#include "stream_k.cuh"

namespace q4s {

using q4::QW;
using q4::XSrc;

constexpr int WARPS = q4::WARPS, THREADS = q4::THREADS;
constexpr int BN = 256;          // columns of a tile, 32 a warp
constexpr int UR = 128;          // k of a unit: whole groups at gs 32 / 64 / 128
constexpr int SUB = UR / 32;     // 32-k steps of a unit
constexpr int PR = UR / 8;       // packed rows of a unit
constexpr int STAGES = 3;        // slabs in the ring (a 4th measured no faster)
constexpr int W_LD = BN + 8;     // words of a staged packed row (lane quads conflict-free)
constexpr int SZ_OFF = PR * W_LD * 4;                    // scale / zero rows: [SUB][2][BN]
constexpr int X_OFF = SZ_OFF + SUB * 2 * BN * SC_BYTES;  // x's rows: raw, then formed in place
static_assert(BN == THREADS, "thread t finishes column t of a one-row tile");

// Register tiles of the rows: MB = 1 (x's one row in every column of B) or
// NT n8 tiles of 8 rows, of which a lane holds rows 2q and 2q + 1.
template <int MB>
struct Tile {
  static_assert(MB == 1 || MB == 8 || MB == 16 || MB == 24 || MB == 32,
                "row tiles 1 / 8 / 16 / 24 / 32");
  static constexpr int NT = MB == 1 ? 1 : MB / 8;
  static constexpr int R = MB == 1 ? 1 : 2;
};

// A slab and the block's shared memory for M rows in row tile MB (host and
// device): x's rows of 2*UR bytes at a stride of xld (64 mod 128 bytes in
// the exact mode, 32 in the a8 ones: the fragment loads of 8 rows are free
// of bank conflicts), then the second operand (one row: the norm weights,
// or at one row up for silu(gate)*up, which the fused kernels form in a
// pass of their own at 2..32 rows), each (row, group)'s sum of x and, a8,
// its int8 scale.
// After the ring: [BN] f32 (one row: a range's sums), the norm's [WARPS][MB]
// partials, [MB] scales rs, and an int.
struct Geo {
  int mp, xld, y_off, xsum_off, sx_off, slab, red_off, norm_off, rs_off, ans_off, smem;
  __host__ __device__ Geo(int mb, int mode, int m) {
    mp = mb == 1 ? 1 : (m + 7) / 8 * 8;
    xld = mb == 1 ? 2 * UR : 2 * UR + (mode == q4::EXACT ? 64 : 32);
    y_off = X_OFF + mp * xld;
    xsum_off = y_off + 2 * UR;
    sx_off = xsum_off + mp * SUB * 4;
    slab = (sx_off + mp * SUB * 4 + 15) / 16 * 16;
    red_off = STAGES * slab;
    norm_off = red_off + (mb == 1 ? BN * 4 : 0);
    rs_off = norm_off + WARPS * mb * 4;
    ans_off = rs_off + mb * 4;
    smem = ans_off + 16;
  }
};

// The row tile of m rows: 24 rows take a tile of their own (at 32 the
// fused kernels' registers spill; ops/quant.py:stream_row_tile).
__host__ __device__ inline int row_tile(int m) {
  return m <= 1 ? 1 : m <= 8 ? 8 : m <= 16 ? 16 : m <= 24 ? 24 : 32;
}

// Blocks an SM a kernel with row tile MB is built for (__launch_bounds__):
// two, but one at 32 rows, whose registers spill at two (K6 at 32 rows 12%
// slower on an H100: scripts/ring_ablation.py rows32_two_blocks).
__host__ __device__ constexpr int min_blocks(int mb) { return mb == 32 ? 1 : 2; }

// The split tiles' scratch: part >= 2 * gridDim.x * M * BN f32 (two slots a
// block), ticket >= ceil(N / BN) zeros.
__host__ __device__ inline int tiles_of(int N) { return (N + BN - 1) / BN; }
__host__ __device__ inline int units_of(int K) { return (K + UR - 1) / UR; }

// Where a GEMV's outputs go: out[m * ld + n] = bf16(v), or with a residual
// (res != NULL) bf16(res[m * ld + n] + bf16(v)), the residual read from L2
// (it may have been written earlier in the launch).
struct Out {
  bf16* out;
  const bf16* res;
  int ld;
};

__device__ __forceinline__ bf16 out_value(const Out& o, float v, float r) {
  return o.res ? f2bf(r + bf2f(f2bf(v))) : f2bf(v);
}

// Whether an output group of 4 columns can be read and written 8 bytes at a
// time (n0 a multiple of 4 and n0 + 3 < N).
__device__ __forceinline__ bool out_vec(const Out& o) {
  return ((((uintptr_t)o.out | (uintptr_t)o.res) & 7) == 0) && (o.ld & 3) == 0;
}

// The residuals of columns n0 .. n0 + 3 of row m (zeros without one): every
// group's residuals are loaded before the first output is stored, so the
// loads do not wait behind stores that might alias them.
__device__ __forceinline__ uint2 res4(const Out& o, int m, int n0, int N, bool vec) {
  if (!o.res) return make_uint2(0u, 0u);
  const bf16* p = o.res + (size_t)m * o.ld + n0;
  if (vec && n0 + 3 < N) return __ldcg(reinterpret_cast<const uint2*>(p));
  unsigned short e[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n0 + c < N) e[c] = __ldcg(reinterpret_cast<const unsigned short*>(p + c));
  return make_uint2(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16);
}

// Store columns n0 .. n0 + 3 of row m: the f32 sums v, residuals r (res4).
__device__ __forceinline__ void store4(const Out& o, int m, int n0, int N, bool vec,
                                       const float (&v)[4], uint2 r) {
  const bf16* rb = reinterpret_cast<const bf16*>(&r);
  bf16 y[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) y[c] = out_value(o, v[c], bf2f(rb[c]));
  bf16* p = o.out + (size_t)m * o.ld + n0;
  if (vec && n0 + 3 < N) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(y);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (n0 + c < N) p[c] = y[c];
  }
}

// Whether the weight's rows can be copied 16 bytes at a time.
__device__ __forceinline__ bool w_aligned(const QW& w) {
  return (w.N & 7) == 0 &&
         (((uintptr_t)w.qweight | (uintptr_t)w.scales | (uintptr_t)w.zscale) & 15) == 0;
}

// Copy unit u's packed rows and its groups' scale / zero-scale rows into a
// slab (cp.async; plain loads where w is not aligned); zeros past K and N.
__device__ __forceinline__ void load_w(unsigned char* slab, const QW& w, int K, int gs, int u,
                                       int KU, bool aligned, int tid) {
  uint32_t* ws = reinterpret_cast<uint32_t*>(slab);
  scale_t* sz = reinterpret_cast<scale_t*>(slab + SZ_OFF);
  const int N = w.N, n0 = (u / KU) * BN, k0 = (u % KU) * UR;
  const int ng = UR / gs, g0 = k0 / gs, groups = K / gs;
  if (aligned) {
#pragma unroll
    for (int it = 0; it < PR * (BN / 4) / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4, pr = k0 / 8 + r;
      const bool ok = pr < K / 8 && n0 + c < N;
      tc::cp_async16(ws + r * W_LD + c, ok ? (const void*)(w.qweight + (size_t)pr * N + n0 + c)
                                           : (const void*)w.qweight,
                     ok ? 16 : 0);
    }
    for (int i = tid; i < ng * 2 * (BN / SC_VEC); i += THREADS) {
      const int row = i / (BN / SC_VEC), c = (i % (BN / SC_VEC)) * SC_VEC, grp = g0 + (row >> 1);
      const bool ok = grp < groups && n0 + c < N;
      const scale_t* src = (row & 1 ? w.zscale : w.scales) + (size_t)grp * N + n0 + c;
      tc::cp_async16(sz + row * BN + c, ok ? (const void*)src : (const void*)w.scales,
                     ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < PR * BN; i += THREADS) {
      const int r = i / BN, c = i % BN, pr = k0 / 8 + r;
      ws[r * W_LD + c] =
          pr < K / 8 && n0 + c < N ? (uint32_t)w.qweight[(size_t)pr * N + n0 + c] : 0u;
    }
    for (int i = tid; i < ng * 2 * BN; i += THREADS) {
      const int row = i / BN, c = i % BN, grp = g0 + (row >> 1);
      sz[row * BN + c] = grp < groups && n0 + c < N
                             ? (row & 1 ? w.zscale : w.scales)[(size_t)grp * N + n0 + c]
                             : scale_t(0.f);
    }
  }
}

// rs = 1 / sqrt(mean(x[0]^2) + eps) over the block (every thread calls it).
__device__ void norm_scale(const XSrc& src, int K, float* part, float* rs, int tid) {
  const bool vec = q4tc::x_vec(src) && (K & 7) == 0;
  float ss = 0.f;
  if (vec) {
    for (int k = tid * 8; k < K; k += THREADS * 8) {
      const uint4 u = __ldcg(reinterpret_cast<const uint4*>(src.x + k));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        ss += f.x * f.x + f.y * f.y;
      }
    }
  } else {
    for (int k = tid; k < K; k += THREADS) {
      const float v = q4::ld_cg(src.x + k);
      ss += v * v;
    }
  }
  ss = warp_sum(ss);
  if ((tid & 31) == 0) part[tid >> 5] = ss;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += part[w];
    *rs = 1.0f / sqrtf(t / (float)K + src.eps);
  }
  __syncthreads();
}

// Copy unit (k0 .. k0 + 127)'s raw x, rows m < rows, and its second
// operand (the norm weights, or at one row up for silu(gate)*up) into the slab by
// cp.async (x was written earlier in the launch: .cg reads it from L2);
// zeros past K. Only where x can be read 16 bytes at a time (vec); else
// form_rows reads global memory itself.
__device__ __forceinline__ void load_x(unsigned char* slab, const Geo& G, const XSrc& src,
                                       int rows, int K, int k0, int tid) {
  constexpr int CH = UR / 8;  // 16-byte chunks of a row
  const bool glu = src.glu_off > 0;
  if (rows == 1) {  // one row: x and its second operand, a chunk a thread
    if (tid >= 2 * CH) return;
    const bool second = tid >= CH;
    const int c = (tid % CH) * 8, k = k0 + c;
    const bf16* sp = !second ? src.x + k : glu ? src.x + src.glu_off + k : src.norm_w + k;
    const bool ok = k < K && (!second || glu || src.norm_w != nullptr);
    tc::cp_async16(slab + (second ? G.y_off : X_OFF) + 2 * c,
                   ok ? (const void*)sp : (const void*)src.x, ok ? 16 : 0);
    return;
  }
  const int nx = rows * CH, ny = src.norm_w ? CH : 0;  // no silu(gate)*up at 2..32 rows
  for (int i = tid; i < nx + ny; i += THREADS) {
    const bool second = i >= nx;
    const int j = second ? i - nx : i, m = j / CH, c = (j % CH) * 8, k = k0 + c;
    const bf16* sp = second ? src.norm_w + k : src.x + (size_t)m * src.ld + k;
    unsigned char* dst = slab + (second ? G.y_off : X_OFF + m * G.xld) + 2 * c;
    const bool ok = k < K;
    tc::cp_async16(dst, ok ? (const void*)sp : (const void*)src.x, ok ? 16 : 0);
  }
}

// Form row m of unit (slab, k0)'s x in place as the product takes it --
// lane l: k0 + 4l .. + 3, each 8 k's halves in a lane pair -- from its raw
// copy (or, where !vec, from global memory): the staged bf16 values in the
// exact mode (each 8 k in the order of q4_gemv_tc.cuh:pair_pos), in the a8
// modes q4_gemv.cuh's int8 layout (a group's xq in its first gs bytes, the
// residual in the next gs; each 8 k as four evens, then four odds) with
// the (row, group)'s scale; and each (row, group)'s sum of the staged
// values. The even lane of a pair writes the pair's 8 k. Every lane of the
// warp calls it.
template <int MODE>
__device__ __forceinline__ void form_row(unsigned char* slab, const Geo& G, const XSrc& src,
                                         int K, int gs, int k0, const float* rs, int m, int lane,
                                         bool vec) {
  const int e0 = 4 * lane, k = k0 + e0;
  unsigned char* row = slab + X_OFF + m * G.xld;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (k < K) {
    if (vec) {
      const uint2 a = *reinterpret_cast<const uint2*>(row + 2 * e0);
      const uint2 b = *reinterpret_cast<const uint2*>(slab + G.y_off + 2 * e0);
      const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 fa = __bfloat1622float2(ha[e]), fb = __bfloat1622float2(hb[e]);
        if (src.glu_off > 0) {
          v[2 * e] = silu_mul(fa.x, fb.x);
          v[2 * e + 1] = silu_mul(fa.y, fb.y);
        } else if (src.norm_w) {
          v[2 * e] = fa.x * rs[m] * fb.x;
          v[2 * e + 1] = fa.y * rs[m] * fb.y;
        } else {
          v[2 * e] = fa.x;
          v[2 * e + 1] = fa.y;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = q4tc::x_at(src, m, k + e, rs);
    }
  }
  __syncwarp();  // every lane has read its raw x before the row is overwritten
  float sum = 0.f, amax = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = bf2f(f2bf(v[e]));  // the staged bf16 value
    sum += v[e];
    amax = fmaxf(amax, fabsf(v[e]));
  }
  for (int o = 1; o < gs / 4; o <<= 1) {  // over the gs / 4 lanes of each group
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  const int gi = e0 / gs;  // the unit's group of these k
  if (e0 % gs == 0) reinterpret_cast<float*>(slab + G.xsum_off)[m * SUB + gi] = sum;
  const bool even = (lane & 1) == 0;
  if constexpr (MODE == q4::EXACT) {
    // the pair's 8 k in the order (0, 4, 1, 5, 2, 6, 3, 7): the even lane
    // holds k 0-3, its partner k 4-7
    uint32_t mine[2], other[2];
    mine[0] = (uint32_t)__bfloat16_as_ushort(f2bf(v[0])) |
              (uint32_t)__bfloat16_as_ushort(f2bf(v[1])) << 16;
    mine[1] = (uint32_t)__bfloat16_as_ushort(f2bf(v[2])) |
              (uint32_t)__bfloat16_as_ushort(f2bf(v[3])) << 16;
    other[0] = __shfl_xor_sync(0xffffffffu, mine[0], 1);
    other[1] = __shfl_xor_sync(0xffffffffu, mine[1], 1);
    if (even) {
      const uint4 o = make_uint4(__byte_perm(mine[0], other[0], 0x5410),
                                 __byte_perm(mine[0], other[0], 0x7632),
                                 __byte_perm(mine[1], other[1], 0x5410),
                                 __byte_perm(mine[1], other[1], 0x7632));
      *reinterpret_cast<uint4*>(row + 2 * e0) = o;
    }
  } else {
    const float sx = fmaxf(amax, 1e-20f) * (1.0f / 127.0f);
    if (e0 % gs == 0) reinterpret_cast<float*>(slab + G.sx_off)[m * SUB + gi] = sx;
    // this lane's 4 k as (evens, odds) byte pairs; the even lane's 8-byte
    // block is (its evens, partner's evens, its odds, partner's odds)
    auto pack = [&](const int (&qv)[4]) {
      return (uint32_t)(qv[0] & 255) | (uint32_t)(qv[2] & 255) << 8 |
             (uint32_t)(qv[1] & 255) << 16 | (uint32_t)(qv[3] & 255) << 24;
    };
    int q8[4], r8[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      q8[e] = q4::quant8(v[e], sx);
      if constexpr (MODE == q4::A8X2)
        r8[e] = q4::quant8(__fsub_rn(v[e], __fmul_rn((float)q8[e], sx)), sx * (1.0f / 254.0f));
    }
    unsigned char* base = row + gi * 2 * gs + (e0 & ~7) % gs;
    const uint32_t mq = pack(q8), oq = __shfl_xor_sync(0xffffffffu, mq, 1);
    if (even)
      *reinterpret_cast<uint2*>(base) =
          make_uint2(__byte_perm(mq, oq, 0x5410), __byte_perm(mq, oq, 0x7632));
    if constexpr (MODE == q4::A8X2) {
      const uint32_t mr = pack(r8), orr = __shfl_xor_sync(0xffffffffu, mr, 1);
      if (even)
        *reinterpret_cast<uint2*>(base + gs) =
            make_uint2(__byte_perm(mr, orr, 0x5410), __byte_perm(mr, orr, 0x7632));
    }
  }
}

// Form the rows of a unit: row m by warp m % WARPS (one row: warp 0).
template <int MB, int MODE>
__device__ __forceinline__ void form_rows(unsigned char* slab, const Geo& G, const XSrc& src,
                                          int M, int K, int gs, int k0, const float* rs,
                                          int warp, int lane, bool vec) {
  for (int m = warp; m < (MB == 1 ? 1 : M); m += WARPS)
    form_row<MODE>(slab, G, src, K, gs, k0, rs, m, lane, vec);
}

// acc[nt][r][c] += the warp's column 4g + c (g = lane / 4) for row nt * 8
// + 2q + r (q = lane % 4; at one row: row 0) over unit (slab) of k0..: the
// weights are the A operand -- rows g and g + 8 of m16 tile h are the
// columns 4g + 2h and 4g + 2h + 1, so lane (g, q)'s A registers come from
// the four words of packed row q at columns 4g..4g+3, one 16-byte read --
// and x's rows are B (row nt * 8 + g of n8 tile nt is lane (g, q)'s; at
// one row x's row is every column), so an mma yields 16 columns of 8 rows;
// a 32-k step's A fragments serve every n8 tile. Only the ntu tiles that
// hold rows < M are multiplied. A group's product is folded with its
// scales and the (row, group)'s sum of x as the group ends.
template <int MB, int MODE>
__device__ __forceinline__ void unit_products(float (&acc)[Tile<MB>::NT][Tile<MB>::R][4],
                                              const unsigned char* slab, const Geo& G, int k0,
                                              int K, int gs, int warp, int lane, int ntu) {
  constexpr int NT = Tile<MB>::NT, R = Tile<MB>::R;
  using Frag = typename std::conditional<MODE == q4::EXACT, float, int>::type;
  const int g = lane >> 2, q = lane & 3;
  const uint32_t* ws = reinterpret_cast<const uint32_t*>(slab);
  const scale_t* sz = reinterpret_cast<const scale_t*>(slab + SZ_OFF);
  const float* xsum = reinterpret_cast<const float*>(slab + G.xsum_off);
  const float* sxs = reinterpret_cast<const float*>(slab + G.sx_off);
  const unsigned char* xs = slab + X_OFF + (MB == 1 ? 0 : g * G.xld);  // row g of tile 0
  Frag d1[2][NT][4], d2[2][NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) d1[h][nt][j] = 0, d2[h][nt][j] = 0;
#pragma unroll
  for (int s = 0; s < SUB; ++s) {
    if (k0 + 32 * s >= K) break;
    const uint4 wv = *reinterpret_cast<const uint4*>(ws + (s * 4 + q) * W_LD + warp * 32 + 4 * g);
    const uint32_t wt[4] = {wv.x, wv.y, wv.z, wv.w};  // columns 4g .. 4g + 3
    if constexpr (MODE == q4::EXACT) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a0[4] = {q4tc::nib_pair(wt[2 * h], 0), q4tc::nib_pair(wt[2 * h + 1], 0),
                                q4tc::nib_pair(wt[2 * h], 1), q4tc::nib_pair(wt[2 * h + 1], 1)};
        const uint32_t a1[4] = {q4tc::nib_pair(wt[2 * h], 2), q4tc::nib_pair(wt[2 * h + 1], 2),
                                q4tc::nib_pair(wt[2 * h], 3), q4tc::nib_pair(wt[2 * h + 1], 3)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (NT > 1 && nt >= ntu) break;
          const uint4 xv = *reinterpret_cast<const uint4*>(xs + nt * 8 * G.xld +
                                                           2 * (32 * s + 8 * q));
          tc::mma_bf16(d1[h][nt], a0, xv.x, xv.y);
          tc::mma_bf16(d1[h][nt], a1, xv.z, xv.w);
        }
      }
    } else {
      const int e0 = 32 * s, gi = e0 / gs;
      int a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t w0 = wt[2 * h], w1 = wt[2 * h + 1];
        a[h][0] = (int)(w0 & 0x0F0F0F0Fu), a[h][1] = (int)(w1 & 0x0F0F0F0Fu);
        a[h][2] = (int)((w0 >> 4) & 0x0F0F0F0Fu), a[h][3] = (int)((w1 >> 4) & 0x0F0F0F0Fu);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (NT > 1 && nt >= ntu) break;
        const unsigned char* xb = xs + nt * 8 * G.xld + gi * 2 * gs + e0 % gs + 8 * q;
        const uint2 lo = *reinterpret_cast<const uint2*>(xb);
        const int b[2] = {(int)lo.x, (int)lo.y};
        int r[2] = {0, 0};
        if constexpr (MODE == q4::A8X2) {
          const uint2 rl = *reinterpret_cast<const uint2*>(xb + gs);
          r[0] = (int)rl.x;
          r[1] = (int)rl.y;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tc::mma_s8(d1[h][nt], a[h], b);
          if constexpr (MODE == q4::A8X2) tc::mma_s8(d2[h][nt], a[h], r);
        }
      }
    }
    if ((32 * (s + 1)) % gs == 0) {  // group gi of the unit ends
      const int gi = 32 * s / gs;
      const scale_t* srow = sz + 2 * gi * BN + warp * 32 + 4 * g;
      const ScaleRow<4> s4(srow), z4(srow + BN);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (NT > 1 && nt >= ntu) break;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int xr = MB == 1 ? 0 : nt * 8 + 2 * q + r;
          const float xsr = xsum[xr * SUB + gi];
          float sx = 1.f;
          if constexpr (MODE != q4::EXACT) sx = sxs[xr * SUB + gi];
#pragma unroll
          for (int c = 0; c < 4; ++c) {  // column 4g + c: tile c / 2, row g (+ 8 if c odd)
            const int h = c >> 1, j = (c & 1) * 2 + r;
            float dv;
            if constexpr (MODE == q4::EXACT) {
              dv = d1[h][nt][j];
            } else {
              dv = (float)d1[h][nt][j] * sx;
              if constexpr (MODE == q4::A8X2) dv += (float)d2[h][nt][j] * (sx * (1.0f / 254.0f));
            }
            const float sc = s4[c];
            // EXACT: d sums x * (128 + q), so 128 * s joins zs
            const float zc = MODE == q4::EXACT ? fmaf(128.f, sc, z4[c]) : z4[c];
            acc[nt][r][c] += sc * dv - zc * xsr;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) d1[h][nt][j] = 0, d2[h][nt][j] = 0;
    }
  }
}

// Put this block's first STAGES - 1 weight slabs of w in flight (one
// cp.async group); the block must be done with shared memory. A
// gemv_stream<MB, MODE>(..., M, ..., prefetched = true) of the same w, K
// and M follows.
template <int MB, int MODE>
__device__ void prefetch(const QW& w, int M, int K, int gs, unsigned char* smem) {
  const streamk::Range r(tiles_of(w.N), units_of(K));
  if (r.u0 >= r.u1) return;
  const Geo G(MB, MODE, M);
  __syncthreads();  // the caller's last use of smem is over
  const bool aligned = w_aligned(w);
  for (int s = 0; s < STAGES - 1 && r.u0 + s < r.u1; ++s)
    load_w(smem + s * G.slab, w, K, gs, r.u0 + s, r.KU, aligned, threadIdx.x);
  tc::cp_async_commit();
}

// out (Out) = x [M, K] (formed by src) @ w, M <= MB rows, each output
// stored once, by the thread that holds it when its tile is finished.
// Every thread of the block calls it. part / ticket: the split tiles'
// scratch (see tiles_of). prefetched: the block's first weight slabs are
// in flight (prefetch).
template <int MB, int MODE>
__device__ void gemv_stream(const XSrc& src, const QW& w, int M, int K, int gs, float* part,
                            unsigned int* ticket, unsigned char* smem, const Out& out,
                            bool prefetched = false) {
  constexpr int NT = Tile<MB>::NT, R = Tile<MB>::R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const streamk::Range r(tiles_of(w.N), units_of(K));
  const int KU = r.KU, u0 = r.u0, u1 = r.u1;
  if (u0 >= u1) return;  // block-uniform: fewer units than blocks
  const Geo G(MB, MODE, M);
  const int rows = MB == 1 ? 1 : M, ntu = MB == 1 ? 1 : (M + 7) / 8;
  float* rs = reinterpret_cast<float*>(smem + G.rs_off);
  int* answer = reinterpret_cast<int*>(smem + G.ans_off);
  const bool aligned = w_aligned(w);
  const bool xvec = q4tc::x_vec(src) && (K & 7) == 0;
  if (!prefetched) {
    __syncthreads();  // the caller's previous use of smem is over
    for (int s = 0; s < STAGES - 1 && u0 + s < u1; ++s)
      load_w(smem + s * G.slab, w, K, gs, u0 + s, KU, aligned, tid);
    tc::cp_async_commit();
  }
  // the first units' x (it may come from the phase before: after the
  // barrier), then the norm's scales while the copies fly
  if (xvec)
    for (int s = 0; s < STAGES - 1 && u0 + s < u1; ++s)
      load_x(smem + s * G.slab, G, src, rows, K, ((u0 + s) % KU) * UR, tid);
  tc::cp_async_commit();
  if (src.norm_w) {
    float* norm_part = reinterpret_cast<float*>(smem + G.norm_off);
    if constexpr (MB == 1)
      norm_scale(src, K, norm_part, rs, tid);
    else
      q4tc::norm_scales<MB>(src, M, K, rs, norm_part);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  form_rows<MB, MODE>(smem, G, src, M, K, gs, (u0 % KU) * UR, rs, warp, lane, xvec);

  float acc[NT][R][4];
  auto clear = [&]() {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nt][rr][c] = 0.f;
  };
  clear();
  for (int u = u0; u < u1; ++u) {
    const int i = u - u0;
    tc::cp_async_wait<STAGES - 3>();
    __syncthreads();  // units u, u + 1 are in, unit u's x is formed, unit u - 1's slab is free
    const int ahead = u + STAGES - 1;
    if (ahead < u1) {
      unsigned char* slab = smem + ((i + STAGES - 1) % STAGES) * G.slab;
      load_w(slab, w, K, gs, ahead, KU, aligned, tid);
      if (xvec) load_x(slab, G, src, rows, K, (ahead % KU) * UR, tid);
    }
    tc::cp_async_commit();

    unit_products<MB, MODE>(acc, smem + (i % STAGES) * G.slab, G, (u % KU) * UR, K, gs, warp,
                            lane, ntu);
    if (u + 1 < u1)  // unit u + 1's x, read after the next barrier
      form_rows<MB, MODE>(smem + ((i + 1) % STAGES) * G.slab, G, src, M, K, gs,
                          ((u + 1) % KU) * UR, rs, warp, lane, xvec);

    const int t = u / KU;
    if (u + 1 < u1 && (u + 1) % KU) continue;  // tile t's range goes on

    if constexpr (MB == 1) {
      // tile t's range of this block ends: every lane holds its four
      // columns (every column of B was x), lane quad q = 0 hands them to
      // thread = column
      float* red = reinterpret_cast<float*>(smem + G.red_off);
      if (lane % 4 == 0)
        *reinterpret_cast<float4*>(red + warp * 32 + lane) =
            make_float4(acc[0][0][0], acc[0][0][1], acc[0][0][2], acc[0][0][3]);
      clear();
      __syncthreads();
      float v[1] = {red[tid]};
      if (!streamk::finish_tile<1, BN>(r, t, u, v, 1, part, ticket, answer, tid)) continue;
      const int n = t * BN + tid;
      if (n < w.N)
        out.out[n] = out_value(out, v[0], out.res ? q4::ld_cg(out.res + n) : 0.f);
    } else {
      // each lane holds columns col .. col + 3 of its rows nt * 8 + 2q + rr
      const int col = warp * 32 + 4 * (lane >> 2), q = lane & 3;
      auto row_of = [&](int nt, int rr) { return nt < ntu ? nt * 8 + 2 * q + rr : M; };
      const int seg0 = max(u0, t * KU);
      if (seg0 != t * KU || u + 1 != (t + 1) * KU) {
        // a part of tile t: published to this block's [M][BN] slot from
        // registers, as float4s; the last of the tile's blocks (stream_k.cuh's
        // protocol) adds the slots into the same registers in the order of
        // k, BB blocks' loads in flight at a time
        float* mine = part + (size_t)(2 * blockIdx.x + (seg0 == u0 ? 0 : 1)) * M * BN + col;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int rr = 0; rr < R; ++rr)
            if (row_of(nt, rr) < M)
              *reinterpret_cast<float4*>(mine + row_of(nt, rr) * BN) = make_float4(
                  acc[nt][rr][0], acc[nt][rr][1], acc[nt][rr][2], acc[nt][rr][3]);
        clear();
        __syncthreads();
        if (tid == 0) {
          __threadfence();
          *answer = (int)atomicAdd(ticket + t, 1u);
          __threadfence();
        }
        __syncthreads();
        const int first = streamk::block_of((long long)t * KU, r.U, r.grid);
        const int last = streamk::block_of((long long)(t + 1) * KU - 1, r.U, r.grid);
        if (*answer != last - first) continue;  // another block finishes tile t
        // blocks' partials read at a time: one at 16+ rows in the exact
        // mode (fewer live registers; K6 at 18 / 24 rows 6% faster on an
        // H100 than at two, the a8 builds 6% slower: ring_ablation.py
        // rows_bb1)
        constexpr int BB = MODE == q4::EXACT && MB >= 16 ? 1 : MB == 32 ? 4 : MB >= 16 ? 2 : 4;
        for (int blk0 = first; blk0 <= last; blk0 += BB) {
          float4 p4[BB][NT][R];
#pragma unroll
          for (int bb = 0; bb < BB; ++bb) {
            const int blk = blk0 + bb;
            const float* src_p =
                part +
                (size_t)(2 * blk + (streamk::unit_begin(blk, r.U, r.grid) >= t * KU ? 0 : 1)) *
                    M * BN +
                col;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int rr = 0; rr < R; ++rr)
                p4[bb][nt][rr] =
                    blk <= last && row_of(nt, rr) < M
                        ? __ldcg(reinterpret_cast<const float4*>(src_p + row_of(nt, rr) * BN))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int bb = 0; bb < BB; ++bb)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int rr = 0; rr < R; ++rr) {
                acc[nt][rr][0] += p4[bb][nt][rr].x, acc[nt][rr][1] += p4[bb][nt][rr].y;
                acc[nt][rr][2] += p4[bb][nt][rr].z, acc[nt][rr][3] += p4[bb][nt][rr].w;
              }
        }
        if (tid == 0) ticket[t] = 0u;  // ready for the next launch or phase
      }
      // tile t is whole in acc: out, every residual loaded before any store
      const bool vec = out_vec(out);
      uint2 res[NT][R];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
          res[nt][rr] = row_of(nt, rr) < M ? res4(out, row_of(nt, rr), t * BN + col, w.N, vec)
                                           : make_uint2(0u, 0u);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
          if (row_of(nt, rr) < M) store4(out, row_of(nt, rr), t * BN + col, w.N, vec,
                                         acc[nt][rr], res[nt][rr]);
      clear();
    }
  }
  tc::cp_async_wait<0>();
}

}  // namespace q4s
