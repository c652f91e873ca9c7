// The 4-bit GPTQ GEMV at 2 <= M <= 32 rows on tensor cores, as a
// block-level device function shared by K1 / K9 (q4_gemv.cu), K6
// (q4_mlp.cu) and K7 (layer_tail.cu), with the staging prologues (RMSNorm,
// act-order gather, silu(gate)*up) and the arithmetic modes of
// q4_gemv.cuh:
//
//   EXACT: out = sum_g s[g,n] * (x_g . q_g) - zs[g,n] * sum(x_g)
//          the group products on mma.sync.m16n8k16 bf16 -> f32, the nibbles
//          exact in bf16;
//   A8 / A8X2: the group products of K9's int8 rows with the nibbles on
//          mma.sync.m16n8k32 s8 -> s32, rescaled by s * sx (A8X2: plus the
//          residual rows at sx / 254), minus zs * sum(x_g) in f32.
//
// Replaced, at M >= 2, a CUDA-core loop that stood for the TPU kernels
// exllama_tpu/ops/quant.py:_q4_gemv_kernel_npair (K1),
// _q4_gemv_kernel_npair_a8 (K9) and the GEMVs of ops/mlp.py:_q4_mlp_kernel
// (K6) and ops/attn_block.py:_layer_tail_kernel (K7). That loop gave each
// lane one column and ran M x 8 FMAs a packed word, so at M = 18 it was
// bound by arithmetic, 127x its byte bound.
//
// Bound on the H100: bytes. At M <= 32 the packed nibbles and their scales
// are read once (K*N/2 + 4*(K/gs)*N bytes) for 2*M*K*N operations; the
// tensor cores do those at a small fraction of their rate. Design:
//
// * Fragments. rows are padded to MP = 16 or 32 (one or two m16 tiles,
//   rows >= M are never staged: they reach only output rows that are never
//   written). A unit is 32 k, one packed row for each lane quad:
//   lane (g = lane / 4, q = lane % 4) loads one 16-byte vector, the words of
//   packed row q of the unit at the columns 4g..4g+3 of its warp's 32, and
//   these four words are its B operand of four 8-column mma tiles (tile t's
//   column c is the warp's column 4c + t). The order of k inside an mma step
//   is free as long as A and B agree, so each lane takes its k from its own
//   word: in EXACT mode `((w >> 4j) & 0x000F000F) | 0x43004300` is the pair
//   (128 + q_j, 128 + q_{j+4}) in bf16, exact (K2's exponent trick; the 128
//   leaves with the zero-point term), and two mma k16 steps use the pairs
//   j = 0, 1 and 2, 3;
//   x is staged with each 8-block in the order (0, 4, 1, 5, 2, 6, 3, 7), so
//   a lane's A operand of both steps is one 16-byte shared-memory load a
//   row. In the a8 modes `w & 0x0F0F0F0F` / `(w >> 4) & 0x0F0F0F0F` (the
//   even / odd nibbles) are the two B registers of one mma k32 step, against
//   int8 rows staged evens-then-odds (q4_gemv.cuh): 8 bytes a row.
// * Groups. Each unit's product goes into a fresh fragment (f32 or s32),
//   folded into the f32 accumulator at the end of its group, or at the end
//   of a warp's share of units, with that group's scales and this share's
//   sum of x (per-unit sums staged beside x). The fold is linear, so a group
//   may span chunks, warps and blocks: any gs % 32 == 0 dividing K works,
//   gs = K included. The a8 modes quantize each (row, group) against its
//   whole group's amax, read from global memory where the group reaches
//   beyond the staged chunk.
// * Streaming. A block of 8 warps owns a 128-column tile (4 warps across
//   columns, 2 across each staged chunk's units) and a range of K. Each
//   lane keeps two batches of 16-byte word loads in flight, the next batch
//   loading while the current one is multiplied, and the first batch of a
//   chunk is issued before the chunk is staged; the chunk's scale rows come
//   by cp.async beside the staging of x, so a fold never waits on device
//   memory. K is split across blocks (ops/quant.py:gemv_split_plan: about
//   two blocks an SM; in K6 / K7 plan_splits below, to cover their
//   persistent grid); the last block of a column tile to
//   finish (an atomic ticket, which it resets) adds the splits' partials in
//   split order -- deterministic, no f32 atomics -- and calls the epilogue.
#pragma once

#include <type_traits>

#include "async_mma.cuh"
#include "q4_gemv.cuh"

namespace q4tc {

using q4::QW;
using q4::XSrc;

constexpr int WARPS = q4::WARPS, THREADS = q4::THREADS;
constexpr int WC = 4;                  // warps across the columns of a block tile
constexpr int KW = WARPS / WC;         // warps across a chunk's units
constexpr int BN = 32 * WC;            // columns of a block tile
constexpr int UK = 32;                 // k of a unit
constexpr int MIN_SPLIT_UNITS = 8;     // least units of a K split

// K staged at once (a multiple of 64): 1024, or 512 at 32 rows in the a8
// modes, whose int8 rows come on top of the bf16 ones (two blocks an SM);
// and the row strides of the bf16 and int8 stages: 2 * XS_LD = 64 mod 128
// bytes and X8_LD = 32 mod 64 bytes keep the fragment loads free of bank
// conflicts.
__host__ __device__ constexpr int chunk_k(int mp, int mode) {
  return mode == q4::EXACT || mp == 16 ? 1024 : 512;
}
__host__ __device__ constexpr int xs_ld(int mp, int mode) { return chunk_k(mp, mode) + 32; }
__host__ __device__ constexpr int x8_ld(int mp, int mode) { return chunk_k(mp, mode) + 32; }

// Shared memory: xs [MP][XS_LD] bf16 | x8, r8 [MP][X8_LD] int8 (a8, a8x2) |
// usum [MP][KC/32] f32 | sxu [MP][KC/32] f32 (a8) | sz [KC/32 + 1][2][BN]
// bf16 (the scale and zero-scale rows of the chunk's groups) | rs [MP] f32
// | red [WARPS][MP] f32 (the norm's partial sums). The block partials
// [KW][MP][BN] f32 of the epilogue reuse xs.
struct Layout {
  int x8, r8, usum, sxu, sz, rs, red, bytes;
  __host__ __device__ Layout(int mp, int mode) {
    const int kcu = chunk_k(mp, mode) / UK;
    x8 = mp * xs_ld(mp, mode) * 2;
    r8 = x8 + (mode != q4::EXACT ? mp * x8_ld(mp, mode) : 0);
    usum = r8 + (mode == q4::A8X2 ? mp * x8_ld(mp, mode) : 0);
    sxu = usum + mp * kcu * 4;
    sz = sxu + (mode != q4::EXACT ? mp * kcu * 4 : 0);
    rs = sz + (kcu + 1) * 2 * BN * 2;
    red = rs + mp * 4;
    bytes = red + WARPS * mp * 4;
  }
};

__host__ __device__ inline size_t smem_bytes(int mp, int mode) {
  return (size_t)Layout(mp, mode).bytes;
}

// Splits of K the launch takes, and the units (of UK k) of each.
struct Splits {
  int n, ups;
};

// The caller's splits (nsplit > 0), normalised so that no split is empty;
// else (nsplit <= 0, the persistent grids of K6 / K7: `blocks` blocks) as
// many splits as keep every item in one wave of the grid, at group
// boundaries (so that each (row, group) is quantized within one split in
// the a8 modes). ops/quant.py:fused_split_plan is the same plan.
__host__ __device__ inline Splits plan_splits(int nsplit, int N, int K, int gs, int blocks) {
  const int units = K / UK, ncb = (N + BN - 1) / BN;
  const int most = max(1, units / MIN_SPLIT_UNITS);
  if (nsplit > 0) {
    nsplit = max(1, min(nsplit, most));
    const int ups = (units + nsplit - 1) / nsplit;
    return {(units + ups - 1) / ups, ups};
  }
  const int gu = max(1, gs / UK), groups = max(1, units / gu);
  const int s = max(1, min(blocks / ncb, most));
  const int ups = (groups + s - 1) / s * gu;
  return {(units + ups - 1) / ups, ups};
}

// Whether x's rows can be read as 16-byte vectors (no act-order gather).
__device__ __forceinline__ bool x_vec(const XSrc& src) {
  return src.x_map == nullptr && ((uintptr_t)src.x & 15) == 0 && (src.ld & 7) == 0 &&
         (src.glu_off & 7) == 0 && ((uintptr_t)src.norm_w & 15) == 0;
}

// rs[m] = 1 / sqrt(mean(x[m]^2) + eps), m < M: the whole block on eight
// rows at a time, each thread issuing its eight rows' loads (16 bytes each
// where x_vec) before using them. Partial sums in f32, added in warp order.
template <int MP>
__device__ void norm_scales(const XSrc& src, int M, int K, float* rs, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = x_vec(src) && (K & 7) == 0;
  for (int m0 = 0; m0 < M; m0 += 8) {
    float ss[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) ss[r] = 0.f;
    if (vec) {
      for (int k = threadIdx.x * 8; k < K; k += THREADS * 8) {
        uint4 u[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          u[r] = m0 + r < M ? __ldcg(reinterpret_cast<const uint4*>(
                                  src.x + (size_t)(m0 + r) * src.ld + k))
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
      for (int k = threadIdx.x; k < K; k += THREADS) {
        float v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          v[r] = m0 + r < M ? q4::ld_cg(src.x + (size_t)(m0 + r) * src.ld + k) : 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r) ss[r] += v[r] * v[r];
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float t = warp_sum(ss[r]);
      if (lane == 0 && m0 + r < M) red[warp * MP + m0 + r] = t;
    }
  }
  __syncthreads();
  if (threadIdx.x < M) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += red[w * MP + threadIdx.x];
    rs[threadIdx.x] = 1.0f / sqrtf(t / (float)K + src.eps);
  }
}

// x[m, k] as the product takes it (the staging prologues of q4_gemv.cuh).
__device__ __forceinline__ float x_at(const XSrc& src, int m, int kk, const float* rs) {
  const int k = src.x_map ? src.x_map[kk] : kk;
  const bf16* row = src.x + (size_t)m * src.ld;
  if (src.glu_off > 0) return silu_mul(q4::ld_cg(row + k), q4::ld_cg(row + src.glu_off + k));
  float v = q4::ld_cg(row + k);
  if (src.norm_w) v = bf2f(f2bf(v * rs[m] * bf2f(src.norm_w[k])));
  return v;
}

// Eight consecutive x[m, k..k+7] as the product takes them (the staging
// prologues of q4_gemv.cuh), by 16-byte loads where `vec`.
__device__ __forceinline__ void x_at8(const XSrc& src, int m, int k, const float* rs, bool vec,
                                      float (&v)[8]) {
  const bf16* row = src.x + (size_t)m * src.ld;
  if (!vec) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = x_at(src, m, k + e, rs);
    return;
  }
  float a[8];
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(row + k));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    a[2 * e] = f.x, a[2 * e + 1] = f.y;
  }
  if (src.glu_off > 0) {
    const uint4 w = __ldcg(reinterpret_cast<const uint4*>(row + src.glu_off + k));
    const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(g[e]);
      v[2 * e] = silu_mul(a[2 * e], f.x);
      v[2 * e + 1] = silu_mul(a[2 * e + 1], f.y);
    }
  } else if (src.norm_w) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(src.norm_w + k));
    const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(g[e]);
      v[2 * e] = bf2f(f2bf(a[2 * e] * rs[m] * f.x));
      v[2 * e + 1] = bf2f(f2bf(a[2 * e + 1] * rs[m] * f.y));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = a[e];
  }
}

// Position of element e of an 8-block in the EXACT stage: (0, 4, 1, 5, ...).
__device__ __forceinline__ int pair_pos(int e) { return 2 * (e & 3) + (e >> 2); }

// Whether the weight rows can be read as 16-byte vectors.
__device__ __forceinline__ bool w_vec(const QW& w) {
  return (w.N & 7) == 0 &&
         (((uintptr_t)w.qweight | (uintptr_t)w.scales | (uintptr_t)w.zscale) & 15) == 0;
}

// Stage x[:, k0 : k0 + klen] (klen a multiple of 32, at most the chunk) with
// its per-(row, unit) sums and, in the a8 modes, its int8 rows and the scale
// of each unit's group; and copy the scale / zero-scale rows of the chunk's
// groups at columns n_base .. n_base + BN (cp.async, in flight while x is
// staged).
template <int MP, int MODE>
__device__ void stage(const XSrc& src, const QW& w, int M, int k0, int klen, int gs, int n_base,
                      unsigned char* smem, const float* rs) {
  constexpr int KCU = chunk_k(MP, MODE) / UK, LD = xs_ld(MP, MODE), LD8 = x8_ld(MP, MODE);
  const Layout L(MP, MODE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* usum = reinterpret_cast<float*>(smem + L.usum);
  bf16* sz = reinterpret_cast<bf16*>(smem + L.sz);
  const int n8 = klen / 8, nu = klen / UK;
  const int g0 = k0 / gs, ng = (k0 + klen - 1) / gs - g0 + 1;
  __syncthreads();  // the previous chunk (or epilogue) is done with smem
  if (w_vec(w)) {
    for (int i = threadIdx.x; i < ng * 2 * (BN / 8); i += THREADS) {
      const int row = i / (BN / 8), c = (i - row * (BN / 8)) * 8;
      const bf16* p = (row & 1 ? w.zscale : w.scales) + (size_t)(g0 + (row >> 1)) * w.N + n_base + c;
      const bool ok = n_base + c < w.N;
      tc::cp_async16(sz + row * BN + c, ok ? p : w.scales, ok ? 16 : 0);
    }
    tc::cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < ng * 2 * BN; i += THREADS) {
      const int row = i / BN, c = i - row * BN;
      const bf16* p = row & 1 ? w.zscale : w.scales;
      sz[row * BN + c] =
          n_base + c < w.N ? p[(size_t)(g0 + (row >> 1)) * w.N + n_base + c] : f2bf(0.f);
    }
  }
  // x rows m < M (rows >= M are never staged: they reach only output rows
  // that are never written), SB 8-element items a thread at a time with
  // their loads issued first; a unit's four items sit in a lane quad,
  // whose shuffles give the unit's sum of the staged values
  const int items = M * n8;
  constexpr int SB = 4;                       // items a thread loads at once
  const unsigned quad = 0xFu << (lane & 28);  // lanes 4j..4j+3
  if (x_vec(src)) {
    for (int i0 = threadIdx.x; i0 < items; i0 += SB * THREADS) {
      uint4 ra[SB], rb[SB];
#pragma unroll
      for (int r = 0; r < SB; ++r) {
        const int i = i0 + r * THREADS;
        ra[r] = rb[r] = make_uint4(0u, 0u, 0u, 0u);
        if (i < items) {
          const int m = i / n8, c = (i - m * n8) * 8;
          const bf16* p = src.x + (size_t)m * src.ld + k0 + c;
          ra[r] = __ldcg(reinterpret_cast<const uint4*>(p));
          if (src.glu_off > 0)  // up, or the norm weights
            rb[r] = __ldcg(reinterpret_cast<const uint4*>(p + src.glu_off));
          else if (src.norm_w)
            rb[r] = __ldg(reinterpret_cast<const uint4*>(src.norm_w + k0 + c));
        }
      }
#pragma unroll
      for (int r = 0; r < SB; ++r) {
        const int i = i0 + r * THREADS;
        const bool ok = i < items;
        const int m = ok ? i / n8 : 0, c = ok ? (i - m * n8) * 8 : 0;
        float v[8];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&ra[r]);
        const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&rb[r]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          if (src.glu_off > 0) {
            const float2 fu = __bfloat1622float2(hb[e]);
            v[2 * e] = silu_mul(f.x, fu.x);
            v[2 * e + 1] = silu_mul(f.y, fu.y);
          } else if (src.norm_w) {
            const float2 fw = __bfloat1622float2(hb[e]);
            v[2 * e] = bf2f(f2bf(f.x * rs[m] * fw.x));
            v[2 * e + 1] = bf2f(f2bf(f.y * rs[m] * fw.y));
          } else {
            v[2 * e] = f.x;
            v[2 * e + 1] = f.y;
          }
        }
        __align__(16) bf16 o[8];
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[pair_pos(e)] = f2bf(v[e]);
          sum += bf2f(o[pair_pos(e)]);
        }
        sum += __shfl_xor_sync(quad, sum, 1);
        sum += __shfl_xor_sync(quad, sum, 2);
        if (ok) {
          *reinterpret_cast<uint4*>(xs + m * LD + c) = *reinterpret_cast<const uint4*>(o);
          if ((i & 3) == 0) usum[m * KCU + c / UK] = sum;
        }
      }
    }
  } else {  // act-order gather or unaligned rows: element by element
    for (int i = threadIdx.x; i < items; i += THREADS) {
      const int m = i / n8, c = (i - m * n8) * 8;
      __align__(16) bf16 o[8];
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o[pair_pos(e)] = f2bf(x_at(src, m, k0 + c + e, rs));
        sum += bf2f(o[pair_pos(e)]);
      }
      sum += __shfl_xor_sync(quad, sum, 1);
      sum += __shfl_xor_sync(quad, sum, 2);
      *reinterpret_cast<uint4*>(xs + m * LD + c) = *reinterpret_cast<const uint4*>(o);
      if ((i & 3) == 0) usum[m * KCU + c / UK] = sum;
    }
  }
  __syncthreads();
  if constexpr (MODE != q4::EXACT) {
    float* sxu = reinterpret_cast<float*>(smem + L.sxu);
    signed char* x8 = reinterpret_cast<signed char*>(smem + L.x8);
    signed char* r8 = reinterpret_cast<signed char*>(smem + L.r8);
    // sx of each (row, group) met in the chunk, over the whole group
    for (int i = warp; i < M * ng; i += WARPS) {
      const int m = i / ng, grp = g0 + (i - m * ng);
      const int ka = grp * gs, kb = ka + gs;
      float amax = 0.f;
      if (ka >= k0 && kb <= k0 + klen) {
        for (int k = ka + lane; k < kb; k += 32)
          amax = fmaxf(amax, fabsf(bf2f(xs[m * LD + (k - k0)])));
      } else {
        for (int k = ka + lane; k < kb; k += 32) amax = fmaxf(amax, fabsf(x_at(src, m, k, rs)));
      }
      const float sx = fmaxf(warp_max(amax), 1e-20f) * (1.0f / 127.0f);
      const int ua = max(ka, k0) - k0, ub = min(kb, k0 + klen) - k0;
      for (int u = ua / UK + lane; u < ub / UK; u += 32) sxu[m * KCU + u] = sx;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < M * klen; i += THREADS) {
      const int m = i / klen, p = i - m * klen;
      const int blk = p & ~7, e = (p & 7) >> 1 | (p & 1) << 2;  // k in the block at position p
      const float v = bf2f(xs[m * LD + p]);
      const float sx = sxu[m * KCU + p / UK];
      const int q = q4::quant8(v, sx);
      const int dst = m * LD8 + blk + ((e & 1) << 2) + (e >> 1);  // evens, then odds
      x8[dst] = (signed char)q;
      if constexpr (MODE == q4::A8X2)
        r8[dst] = (signed char)q4::quant8(__fsub_rn(v, __fmul_rn((float)q, sx)),
                                          sx * (1.0f / 254.0f));
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();
}

// The nibble pair (q_j, q_{j+4}) of word w as the two bf16 128 + q: the
// nibble enters the mantissa of 128 (ulp 1) exactly; the 128 is taken off
// with the zero-point term at the fold, sum(x * (128 + q)) - 128 * sum(x).
__device__ __forceinline__ uint32_t nib_pair(uint32_t w, int j) {
  return ((w >> (4 * j)) & 0x000F000Fu) | 0x43004300u;
}

// x [M, K] (formed by src) @ w, M <= MP rows: the work items (128-column
// tile, K split) item0, item0 + istep, ... ; nsplit > 0 the splits of K (as
// plan_splits), 0 to plan them for istep blocks. part holds the splits'
// partials (items * MP * BN f32) and ticket one zero int per column tile,
// both unused with one split. epi(m, n, value) receives each finished f32
// output, from any thread. Every thread of the block calls this together.
template <int MP, int MODE, class Epi>
__device__ void q4_gemv_tc(const XSrc& src, const QW& w, int M, int K, int gs, int item0,
                           int istep, int nsplit, float* part, unsigned int* ticket,
                           unsigned char* smem, Epi epi) {
  constexpr int MT = MP / 16;
  constexpr int KCU = chunk_k(MP, MODE) / UK, LD = xs_ld(MP, MODE), LD8 = x8_ld(MP, MODE);
  // units of words a lane loads ahead, twice over (fewer at 32 rows, whose
  // accumulators take the registers)
  constexpr int BATCH = MP == 16 ? 4 : 2;
  using Frag = typename std::conditional<MODE == q4::EXACT, float, int>::type;
  __shared__ int last_block;
  const Layout L(MP, MODE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wc = warp % WC, wk = warp / WC;
  const int N = w.N, units = K / UK, ncb = (N + BN - 1) / BN;
  const Splits plan = plan_splits(nsplit, N, K, gs, istep);
  nsplit = plan.n;
  const int ups = plan.ups;
  const int items = ncb * nsplit;
  const bool vec = w_vec(w);
  const bf16* xs = reinterpret_cast<const bf16*>(smem);
  const signed char* x8 = reinterpret_cast<const signed char*>(smem + L.x8);
  const signed char* r8 = reinterpret_cast<const signed char*>(smem + L.r8);
  const float* usum = reinterpret_cast<const float*>(smem + L.usum);
  const float* sxu = reinterpret_cast<const float*>(smem + L.sxu);
  const bf16* sz = reinterpret_cast<const bf16*>(smem + L.sz);
  float* rs = reinterpret_cast<float*>(smem + L.rs);
  if (item0 >= items) return;  // block-uniform
  __syncthreads();             // the caller's previous use of smem is over
  if (src.norm_w) norm_scales<MP>(src, M, K, rs, reinterpret_cast<float*>(smem + L.red));

  for (int item = item0; item < items; item += istep) {
    const int cb = item / nsplit, sp = item - cb * nsplit;
    const int u_begin = sp * ups, u_end = min(units, u_begin + ups);
    const int n0 = cb * BN + wc * 32;  // this warp's first column
    const int nw = n0 + 4 * g;         // this lane's word columns nw..nw+3
    float acc[MT][4][4];
    Frag d1[MT][4][4], d2[MT][4][4];
    float xsp[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      xsp[mt][0] = xsp[mt][1] = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][t][j] = 0.f, d1[mt][t][j] = 0, d2[mt][t][j] = 0;
    }
    for (int c0 = u_begin; c0 < u_end; c0 += KCU) {
      const int c1 = min(u_end, c0 + KCU);
      const int per = (c1 - c0 + KW - 1) / KW;
      const int ua = c0 + wk * per, ub = min(c1, ua + per);  // this warp's units
      const int gc0 = c0 * UK / gs;                          // the chunk's first group
      auto load = [&](uint4 (&wv)[BATCH], int u0) {
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int u = u0 + j;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (u < ub) {
            const int32_t* p = w.qweight + (size_t)(u * 4 + q) * N + nw;
            if (vec) {
              if (nw < N) v = __ldg(reinterpret_cast<const uint4*>(p));
            } else {
              uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
              for (int t = 0; t < 4; ++t)
                if (nw + t < N) e[t] = (uint32_t)__ldg(p + t);
              v = make_uint4(e[0], e[1], e[2], e[3]);
            }
          }
          wv[j] = v;
        }
      };
      auto run = [&](const uint4 (&wv)[BATCH], int u0) {
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int u = u0 + j;
          if (u >= ub) break;
          const int uc = u - c0;
          const uint32_t wt[4] = {wv[j].x, wv[j].y, wv[j].z, wv[j].w};
          if constexpr (MODE == q4::EXACT) {
            uint32_t bq[4][4];
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) bq[t][jj] = nib_pair(wt[t], jj);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const bf16* xr = xs + (mt * 16 + g) * LD + uc * UK + 8 * q;
              const uint4 lo = *reinterpret_cast<const uint4*>(xr);
              const uint4 hi = *reinterpret_cast<const uint4*>(xr + 8 * LD);
              const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y};
              const uint32_t a1[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                tc::mma_bf16(d1[mt][t], a0, bq[t][0], bq[t][1]);
                tc::mma_bf16(d1[mt][t], a1, bq[t][2], bq[t][3]);
              }
            }
          } else {
            int b[4][2];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              b[t][0] = (int)(wt[t] & 0x0F0F0F0Fu);
              b[t][1] = (int)((wt[t] >> 4) & 0x0F0F0F0Fu);
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const signed char* xr = x8 + (mt * 16 + g) * LD8 + uc * UK + 8 * q;
              const uint2 lo = *reinterpret_cast<const uint2*>(xr);
              const uint2 hi = *reinterpret_cast<const uint2*>(xr + 8 * LD8);
              const int a[4] = {(int)lo.x, (int)hi.x, (int)lo.y, (int)hi.y};
#pragma unroll
              for (int t = 0; t < 4; ++t) tc::mma_s8(d1[mt][t], a, b[t]);
              if constexpr (MODE == q4::A8X2) {
                const signed char* rr = r8 + (mt * 16 + g) * LD8 + uc * UK + 8 * q;
                const uint2 rlo = *reinterpret_cast<const uint2*>(rr);
                const uint2 rhi = *reinterpret_cast<const uint2*>(rr + 8 * LD8);
                const int ra[4] = {(int)rlo.x, (int)rhi.x, (int)rlo.y, (int)rhi.y};
#pragma unroll
                for (int t = 0; t < 4; ++t) tc::mma_s8(d2[mt][t], ra, b[t]);
              }
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            xsp[mt][0] += usum[(mt * 16 + g) * KCU + uc];
            xsp[mt][1] += usum[(mt * 16 + g + 8) * KCU + uc];
          }
          // fold at the end of a group or of this warp's share
          if (u + 1 == ub || ((u + 1) * UK) % gs == 0) {
            const bf16* srow = sz + (u * UK / gs - gc0) * 2 * BN + wc * 32 + 8 * q;
            const uint4 sv = *reinterpret_cast<const uint4*>(srow);
            const uint4 zv = *reinterpret_cast<const uint4*>(srow + BN);
            const bf16* s8 = reinterpret_cast<const bf16*>(&sv);
            const bf16* z8 = reinterpret_cast<const bf16*>(&zv);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float sx = 1.f;
                if constexpr (MODE != q4::EXACT) sx = sxu[(mt * 16 + g + 8 * h) * KCU + uc];
#pragma unroll
                for (int t = 0; t < 4; ++t)
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    const int j2 = 2 * h + e, col = 4 * e + t;
                    float d;
                    if constexpr (MODE == q4::EXACT) {
                      d = d1[mt][t][j2];
                    } else {
                      d = (float)d1[mt][t][j2] * sx;
                      if constexpr (MODE == q4::A8X2)
                        d += (float)d2[mt][t][j2] * (sx * (1.0f / 254.0f));
                    }
                    const float sc = bf2f(s8[col]);
                    // EXACT: d sums x * (128 + q), so 128 * s joins zs
                    const float zc = MODE == q4::EXACT ? fmaf(128.f, sc, bf2f(z8[col]))
                                                       : bf2f(z8[col]);
                    acc[mt][t][j2] += sc * d - zc * xsp[mt][h];
                    d1[mt][t][j2] = 0;
                    d2[mt][t][j2] = 0;
                  }
                xsp[mt][h] = 0.f;
              }
          }
        }
      };
      uint4 wa[BATCH], wb[BATCH];
      load(wa, ua);  // the stream starts before the chunk is staged
      stage<MP, MODE>(src, w, M, c0 * UK, (c1 - c0) * UK, gs, cb * BN, smem, rs);
      for (int u0 = ua; u0 < ub; u0 += 2 * BATCH) {
        load(wb, u0 + BATCH);
        run(wa, u0);
        load(wa, u0 + 2 * BATCH);
        run(wb, u0 + BATCH);
      }
    }

    // the block's partial: the KW warps of each column, then across splits
    __syncthreads();  // every warp is done with the stage, which red reuses
    float* red = reinterpret_cast<float*>(smem);  // [KW][MP][BN]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = mt * 16 + g + 8 * (j >> 1), c = wc * 32 + 8 * q + 4 * (j & 1) + t;
          red[(wk * MP + r) * BN + c] = acc[mt][t][j];
        }
    __syncthreads();
    auto block_sum = [&](int i) {
      float v = red[i];
#pragma unroll
      for (int k = 1; k < KW; ++k) v += red[k * MP * BN + i];
      return v;
    };
    if (nsplit == 1) {
      for (int i = threadIdx.x; i < M * BN; i += THREADS) {
        const int n = cb * BN + (i % BN);
        if (n < N) epi(i / BN, n, block_sum(i));
      }
      continue;
    }
    float* mine = part + (size_t)item * MP * BN;
    for (int i = threadIdx.x * 4; i < M * BN; i += THREADS * 4)
      *reinterpret_cast<float4*>(mine + i) =
          make_float4(block_sum(i), block_sum(i + 1), block_sum(i + 2), block_sum(i + 3));
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last_block = atomicAdd(ticket + cb, 1u) == (unsigned)(nsplit - 1);
    __syncthreads();
    if (!last_block) continue;
    __threadfence();
    const float* base = part + (size_t)cb * nsplit * MP * BN;
    for (int i = threadIdx.x * 4; i < M * BN; i += THREADS * 4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int s = 0; s < nsplit; ++s) {  // in split order
        const float4 p = __ldcg(reinterpret_cast<const float4*>(base + (size_t)s * MP * BN + i));
        v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
      }
      const float vv[4] = {v.x, v.y, v.z, v.w};
      const int m = i / BN;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = cb * BN + (i + e) % BN;
        if (n < N) epi(m, n, vv[e]);
      }
    }
    if (threadIdx.x == 0) ticket[cb] = 0u;  // ready for the next launch or phase
  }
}

}  // namespace q4tc
