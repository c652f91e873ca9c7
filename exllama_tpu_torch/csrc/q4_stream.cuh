// The one-row 4-bit GPTQ GEMV at groupsize 32 / 64 / 128: K1 (q4_gemv.cu)
// at one row, and the one-row GEMV phases of the fused decode kernels K6
// (q4_mlp.cu) and K7 (layer_tail.cu): out[n] = x[0, :] @ W4[:, n], x formed
// by an XSrc (RMSNorm, the act-order gather, or silu(gate)*up), in the
// exact, a8 or a8x2 arithmetic of the tensor-core GEMV (q4_gemv_tc.cuh),
// each finished f32 output handed to an epilogue.
//
// It took the place of a CUDA-core loop that gave each block a 32-column
// tile and all of K, so the 4096-column o and down projections of
// Llama-7B kept 128 blocks busy, each with four 4-byte loads a lane in
// flight: 0.22-0.75 TB/s.
//
// Bound on the H100: bytes (K*N/2 of nibbles and 4*(K/gs)*N of scales read
// once for 2*K*N operations). Design: K4's streaming loop
// (dense_stream.cuh) for packed weights:
//
//   * Work: tiles of 256 columns x units of 128 k (whole groups at gs 32,
//     64, 128), shared out stream-K among the grid (stream_k.cuh), so
//     every block gets the same bytes whatever the number of tiles.
//   * Loads: a ring of STAGES slabs, each one unit: 16 packed rows of 256
//     words, the scale / zero-scale rows of its groups, and its 128 k of x
//     with the norm weights (or up, for silu(gate)*up), all by 16-byte
//     cp.async: the stream issues no other load, which would queue behind
//     the copies. x is formed in the slab (norm or silu(gate)*up; in the a8
//     modes quantized per group to int8, and for a8x2 its residual) by
//     warp 0 one unit ahead of the products, once the unit is in. A phase's first weight slabs
//     can be put in flight before the grid barrier that precedes it
//     (prefetch): the weights do not depend on the phases before.
//   * Products: on tensor cores with the tensor-core GEMV's nibble tricks
//     (q4_gemv_tc.cuh: the nibble pairs as bf16 128 + q, exact; the even /
//     odd nibble bytes in the a8 modes), but with the weights as the A
//     operand and x's one row in every column of B, so that one mma gives
//     16 useful columns, not 8 of 128 rows: lane (g, q) reads the four
//     words of packed row q at its warp's columns 4g..4g+3 from the slab
//     and ends with those columns' sums; a group's product is folded with
//     its scales and x's group sum as the group ends.
//   * Combine: a tile cut between blocks leaves each block's partial sums in
//     a scratch slot; the last block to finish the tile adds them in the
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
constexpr int SZ_OFF = PR * W_LD * 4;               // scale / zero rows: [SUB][2][BN] bf16
constexpr int RAW_OFF = SZ_OFF + SUB * 2 * BN * 2;  // the unit's raw x, then norm_w or up
constexpr int X_OFF = RAW_OFF + 2 * UR * 2;         // the formed x: 2*UR bytes,
constexpr int XSUM_OFF = X_OFF + 2 * UR;            // then its groups' sums of x
constexpr int SX_OFF = XSUM_OFF + SUB * 4;          // and int8 scales (a8)
constexpr int SLAB = SX_OFF + SUB * 4;
constexpr int RED_OFF = STAGES * SLAB;              // [BN] f32: a range's sums
constexpr int NORM_OFF = RED_OFF + BN * 4;          // [WARPS] f32, then rs, then the answer
constexpr int SMEM = NORM_OFF + WARPS * 4 + 16;
static_assert(SLAB % 16 == 0, "slabs on 16 bytes");
static_assert(BN == THREADS, "thread t finishes column t of a tile");

// The split tiles' scratch: part >= 2 * gridDim.x * BN f32 (two slots a
// block), ticket >= ceil(N / BN) zeros.
__host__ __device__ inline int tiles_of(int N) { return (N + BN - 1) / BN; }
__host__ __device__ inline int units_of(int K) { return (K + UR - 1) / UR; }

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
  bf16* sz = reinterpret_cast<bf16*>(slab + SZ_OFF);
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
    for (int i = tid; i < ng * 2 * (BN / 8); i += THREADS) {
      const int row = i / (BN / 8), c = (i % (BN / 8)) * 8, grp = g0 + (row >> 1);
      const bool ok = grp < groups && n0 + c < N;
      const bf16* src = (row & 1 ? w.zscale : w.scales) + (size_t)grp * N + n0 + c;
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
                             : f2bf(0.f);
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

// Copy unit u's raw x (k0 .. k0 + 127) and its second operand (the norm
// weights, or up for silu(gate)*up) into the slab by cp.async (x was
// written earlier in the launch: .cg reads it from L2); zeros past K. Only
// where x can be read 16 bytes at a time (vec); else form_x reads global
// memory itself.
__device__ __forceinline__ void load_x(unsigned char* slab, const XSrc& src, int K, int k0,
                                       int tid) {
  bf16* raw = reinterpret_cast<bf16*>(slab + RAW_OFF);
  if (tid >= 2 * UR / 8) return;
  const int which = tid / (UR / 8), k = k0 + (tid % (UR / 8)) * 8;
  const bf16* src_row = which == 0 ? src.x + k
                        : src.glu_off > 0 ? src.x + src.glu_off + k
                                          : src.norm_w + k;
  const bool ok = k < K && (which == 0 || src.glu_off > 0 || src.norm_w != nullptr);
  tc::cp_async16(raw + which * UR + (tid % (UR / 8)) * 8, ok ? (const void*)src_row
                                                             : (const void*)src.x,
                 ok ? 16 : 0);
}

// Form unit (slab, k0)'s x as the product takes it -- warp 0, lane l: k0 +
// 4l .. + 3, each 8 k's halves in a lane pair -- from its raw copy (or,
// where !vec, from global memory): the staged bf16 values in the exact
// mode (each 8 k in the order of q4_gemv_tc.cuh:pair_pos), in the a8 modes
// q4_gemv.cuh's int8 layout (a group's xq in its first gs bytes, the
// residual in the next gs; each 8 k as four evens, then four odds) with
// each group's scale; and each group's sum of the staged values. The even
// lane of a pair writes the pair's 8 k. Every lane of warp 0 calls it.
template <int MODE>
__device__ __forceinline__ void form_x(unsigned char* slab, const XSrc& src, int K, int gs,
                                       int k0, const float* rs, int lane, bool vec) {
  const int e0 = 4 * lane, k = k0 + e0;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (k < K) {
    if (vec) {
      const bf16* raw = reinterpret_cast<const bf16*>(slab + RAW_OFF) + e0;
      const uint2 a = *reinterpret_cast<const uint2*>(raw);
      const uint2 b = *reinterpret_cast<const uint2*>(raw + UR);
      const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 fa = __bfloat1622float2(ha[e]), fb = __bfloat1622float2(hb[e]);
        if (src.glu_off > 0) {
          v[2 * e] = silu_mul(fa.x, fb.x);
          v[2 * e + 1] = silu_mul(fa.y, fb.y);
        } else if (src.norm_w) {
          v[2 * e] = fa.x * rs[0] * fb.x;
          v[2 * e + 1] = fa.y * rs[0] * fb.y;
        } else {
          v[2 * e] = fa.x;
          v[2 * e + 1] = fa.y;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = q4tc::x_at(src, 0, k + e, rs);
    }
  }
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
  if (e0 % gs == 0) reinterpret_cast<float*>(slab + XSUM_OFF)[gi] = sum;
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
      *reinterpret_cast<uint4*>(slab + X_OFF + 2 * e0) = o;
    }
  } else {
    const float sx = fmaxf(amax, 1e-20f) * (1.0f / 127.0f);
    if (e0 % gs == 0) reinterpret_cast<float*>(slab + SX_OFF)[gi] = sx;
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
    unsigned char* base = slab + X_OFF + gi * 2 * gs + (e0 & ~7) % gs;
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

// acc[c] += the warp's column 4g + c (g = lane / 4) over unit (slab) of
// k0..: the weights are the A operand -- rows g and g + 8 of m16 tile h
// are the columns 4g + 2h and 4g + 2h + 1, so lane (g, q)'s A registers
// come from the four words of packed row q at columns 4g..4g+3, one
// 16-byte read -- and x's row is every column of B, so an mma yields 16
// columns (two a 32-k step in the a8 modes, four in the exact one). A
// group's product is folded with its scales and x's group sum as the group
// ends.
template <int MODE>
__device__ __forceinline__ void unit_products(float (&acc)[4], const unsigned char* slab, int k0,
                                              int K, int gs, int warp, int lane) {
  using Frag = typename std::conditional<MODE == q4::EXACT, float, int>::type;
  const int g = lane >> 2, q = lane & 3;
  const uint32_t* ws = reinterpret_cast<const uint32_t*>(slab);
  const bf16* sz = reinterpret_cast<const bf16*>(slab + SZ_OFF);
  const float* xsum = reinterpret_cast<const float*>(slab + XSUM_OFF);
  const float* sxs = reinterpret_cast<const float*>(slab + SX_OFF);
  Frag d1[2][4], d2[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) d1[h][j] = 0, d2[h][j] = 0;
#pragma unroll
  for (int s = 0; s < SUB; ++s) {
    if (k0 + 32 * s >= K) break;
    const uint4 wv = *reinterpret_cast<const uint4*>(ws + (s * 4 + q) * W_LD + warp * 32 + 4 * g);
    const uint32_t wt[4] = {wv.x, wv.y, wv.z, wv.w};  // columns 4g .. 4g + 3
    if constexpr (MODE == q4::EXACT) {
      const uint4 xv = *reinterpret_cast<const uint4*>(slab + X_OFF + 2 * (32 * s + 8 * q));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a0[4] = {q4tc::nib_pair(wt[2 * h], 0), q4tc::nib_pair(wt[2 * h + 1], 0),
                                q4tc::nib_pair(wt[2 * h], 1), q4tc::nib_pair(wt[2 * h + 1], 1)};
        const uint32_t a1[4] = {q4tc::nib_pair(wt[2 * h], 2), q4tc::nib_pair(wt[2 * h + 1], 2),
                                q4tc::nib_pair(wt[2 * h], 3), q4tc::nib_pair(wt[2 * h + 1], 3)};
        tc::mma_bf16(d1[h], a0, xv.x, xv.y);
        tc::mma_bf16(d1[h], a1, xv.z, xv.w);
      }
    } else {
      const int e0 = 32 * s, gi = e0 / gs;
      const unsigned char* xb = slab + X_OFF + gi * 2 * gs + e0 % gs + 8 * q;
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
        const uint32_t w0 = wt[2 * h], w1 = wt[2 * h + 1];
        const int a[4] = {(int)(w0 & 0x0F0F0F0Fu), (int)(w1 & 0x0F0F0F0Fu),
                          (int)((w0 >> 4) & 0x0F0F0F0Fu), (int)((w1 >> 4) & 0x0F0F0F0Fu)};
        tc::mma_s8(d1[h], a, b);
        if constexpr (MODE == q4::A8X2) tc::mma_s8(d2[h], a, r);
      }
    }
    if ((32 * (s + 1)) % gs == 0) {  // group gi of the unit ends
      const int gi = 32 * s / gs;
      const bf16* srow = sz + 2 * gi * BN + warp * 32 + 4 * g;
      const uint2 sv = *reinterpret_cast<const uint2*>(srow);
      const uint2 zv = *reinterpret_cast<const uint2*>(srow + BN);
      const bf16* s4 = reinterpret_cast<const bf16*>(&sv);
      const bf16* z4 = reinterpret_cast<const bf16*>(&zv);
      const float xs = xsum[gi];
      float sx = 1.f;
      if constexpr (MODE != q4::EXACT) sx = sxs[gi];
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // column 4g + c: tile c / 2, row g (+ 8 if c odd)
        const int h = c >> 1, j = (c & 1) * 2;
        float dv;
        if constexpr (MODE == q4::EXACT) {
          dv = d1[h][j];
        } else {
          dv = (float)d1[h][j] * sx;
          if constexpr (MODE == q4::A8X2) dv += (float)d2[h][j] * (sx * (1.0f / 254.0f));
        }
        const float sc = bf2f(s4[c]);
        // EXACT: d sums x * (128 + q), so 128 * s joins zs
        const float zc = MODE == q4::EXACT ? fmaf(128.f, sc, bf2f(z4[c])) : bf2f(z4[c]);
        acc[c] += sc * dv - zc * xs;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) d1[h][j] = 0, d2[h][j] = 0;
    }
  }
}

// Put this block's first STAGES - 1 weight slabs of w in flight (one
// cp.async group); the block must be done with shared memory. A
// gemv_stream(..., prefetched = true) of the same w and K follows.
__device__ void prefetch(const QW& w, int K, int gs, unsigned char* smem) {
  const streamk::Range r(tiles_of(w.N), units_of(K));
  if (r.u0 >= r.u1) return;
  __syncthreads();  // the caller's last use of smem is over
  const bool aligned = w_aligned(w);
  for (int s = 0; s < STAGES - 1 && r.u0 + s < r.u1; ++s)
    load_w(smem + s * SLAB, w, K, gs, r.u0 + s, r.KU, aligned, threadIdx.x);
  tc::cp_async_commit();
}

// x [1, K] (formed by src) @ w, each output to epi(0, n, value) once, by
// the thread that finishes its tile. Every thread of the block calls it.
// part / ticket: the split tiles' scratch (see tiles_of). prefetched: the
// block's first weight slabs are in flight (prefetch).
template <int MODE, class Epi>
__device__ void gemv_stream(const XSrc& src, const QW& w, int K, int gs, float* part,
                            unsigned int* ticket, unsigned char* smem, Epi epi,
                            bool prefetched = false) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const streamk::Range r(tiles_of(w.N), units_of(K));
  const int KU = r.KU, u0 = r.u0, u1 = r.u1;
  if (u0 >= u1) return;  // block-uniform: fewer units than blocks
  float* red = reinterpret_cast<float*>(smem + RED_OFF);
  float* norm_part = reinterpret_cast<float*>(smem + NORM_OFF);
  float* rs = norm_part + WARPS;
  int* answer = reinterpret_cast<int*>(rs + 1);
  const bool aligned = w_aligned(w);
  const bool xvec = q4tc::x_vec(src) && (K & 7) == 0;
  if (!prefetched) {
    __syncthreads();  // the caller's previous use of smem is over
    for (int s = 0; s < STAGES - 1 && u0 + s < u1; ++s)
      load_w(smem + s * SLAB, w, K, gs, u0 + s, KU, aligned, tid);
    tc::cp_async_commit();
  }
  // the first units' x (it may come from the phase before: after the
  // barrier), then the norm's scale while the copies fly
  if (xvec)
    for (int s = 0; s < STAGES - 1 && u0 + s < u1; ++s)
      load_x(smem + s * SLAB, src, K, ((u0 + s) % KU) * UR, tid);
  tc::cp_async_commit();
  if (src.norm_w) norm_scale(src, K, norm_part, rs, tid);
  tc::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) form_x<MODE>(smem, src, K, gs, (u0 % KU) * UR, rs, lane, xvec);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int u = u0; u < u1; ++u) {
    const int i = u - u0;
    tc::cp_async_wait<STAGES - 3>();
    __syncthreads();  // units u, u + 1 are in, unit u's x is formed, unit u - 1's slab is free
    const int ahead = u + STAGES - 1;
    if (ahead < u1) {
      unsigned char* slab = smem + ((i + STAGES - 1) % STAGES) * SLAB;
      load_w(slab, w, K, gs, ahead, KU, aligned, tid);
      if (xvec) load_x(slab, src, K, (ahead % KU) * UR, tid);
    }
    tc::cp_async_commit();

    unit_products<MODE>(acc, smem + (i % STAGES) * SLAB, (u % KU) * UR, K, gs, warp, lane);
    if (warp == 0 && u + 1 < u1)  // unit u + 1's x, read after the next barrier
      form_x<MODE>(smem + ((i + 1) % STAGES) * SLAB, src, K, gs, ((u + 1) % KU) * UR, rs, lane,
                   xvec);

    const int t = u / KU;
    if (u + 1 < u1 && (u + 1) % KU) continue;  // tile t's range goes on

    // tile t's range of this block ends: every lane holds its four columns
    // (every column of B was x), lane quad q = 0 hands them to thread = column
    if (lane % 4 == 0)
      *reinterpret_cast<float4*>(red + warp * 32 + lane) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = 0.f;
    __syncthreads();
    float v[1] = {red[tid]};
    if (!streamk::finish_tile<1, BN>(r, t, u, v, 1, part, ticket, answer, tid)) continue;
    if (t * BN + tid < w.N) epi(0, t * BN + tid, v[0]);
  }
  tc::cp_async_wait<0>();
}

}  // namespace q4s
