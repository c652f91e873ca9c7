// K1's kernel at 2..32 rows on Hopper (q4_gemv.cu, entry q4_gemv_wg_launch;
// also one row at a groupsize the streaming GEMV does not take): the 4-bit
// GPTQ GEMV
//   out[m, n] = sum_g ( s[g,n] * sum_{k in g} x[m,k]*q[k,n]
//                       - zs[g,n] * sum_{k in g} x[m,k] )
// in f32 over group partial sums of exact nibbles, cast to bf16, with the
// optional RMSNorm and act-order gather of x in its prologue. x [M, K] bf16
// (M <= 32); the weight as stored: packed nibbles [K/8, N] int32 (k = 8j + i
// at bits 4i of word j), scale and zero-scale rows [K/gs, N] in bf16 or, built
// with -DSCALE_F32=1, f32; gs a multiple of 32 dividing K.
//
// Replaces the TPU kernel exllama_tpu/ops/quant.py:_q4_gemv_kernel_npair
// (:177, launched at quant.py:1217) at these row counts; its parent on this
// card is the mma.sync route of q4_gemv_tc.cuh (entry q4_gemv_tc_launch,
// chip_smoke.py's yardstick only).
//
// Bound on the H100: bytes. The nibbles and their scales (K*N/2 + 4*(K/gs)*N
// bytes at bf16 scales) are read once for all the rows; 2*M*K*N operations
// are far below the tensor cores' rate. At Llama-7B's shapes that is 4-14
// us, so the fixed cost of a launch (the ring's fill, x's forming, the
// combine of split tiles) decides the time.
//
// Design. The product is taken transposed, out^T = W^T x^T, as in K2
// (q4_wgmma.cuh), on Hopper's building blocks (hopper.cuh):
//   - A, from registers: the raw nibbles of 64 weight columns as the bf16
//     pairs (128 + q) by the exponent trick (exact; the 128 leaves with the
//     zero-point term), in the GPTQ packing's fragment order: k = 2q, 2q + 1
//     (+ 8) of each 16 are byte q of two packed words, a thread's two A rows
//     adjacent weight columns (one 8-byte load brings both words);
//   - B: x's rows, wgmma's N = 16 or 32 (M padded), from a K-major slab of
//     64 k in shared memory, 128-byte swizzled;
//   - the group fold: each 32-deep half slab lies in one group (gs % 32 ==
//     0); its two k-steps go into a fresh accumulator (scale-d 0), folded as
//     acc += s * p - (zs + 128 s) * sum(x_half) once its wgmma group is done
//     (the fold is linear, so a group may span halves, slabs and blocks);
//     the two halves of a slab alternate accumulators, so the second half's
//     products run while the first is folded.
// TMA loads each slab's packed words [8, 256] and the halves' scale and
// zero-scale rows into a ring of STAGES slots (mbarriers), issued by one
// producer warp; the weights do not depend on x, so they stream from the
// start. x's slab is staged by threads (the norm and the gather change x):
// three warps of the producer warpgroup take the slabs in turns, each
// leaving the rows in the 128-byte swizzled layout with the half sums of x
// beside them, then fence.proxy.async before it signals the slot (the async
// proxy would else see stale rows). Without a gather, TMA brings the raw
// rows (and the slab's norm weights) into the slot first and the warp
// stages them in place, so no load from device memory waits in the
// forming; with act-order, the warp gathers x from device memory itself. The norm's 1/rms is applied per
// row in the epilogue: the slab holds bf16(x * w), each slab's sum of x^2
// rides beside it, and a tile's sums over all of K are those of its pieces
// (PERF.md says why, and what it rounds). Two consumer warpgroups (128
// columns each) turn the words into A fragments, multiply and fold. The grid
// is persistent, one block an SM; the (256-column tile, slab) units are
// shared out stream-K where the tiles do not fill the card (ops/quant.py:
// q4_gemv_plan), a tile cut between blocks leaving each block's f32 partial
// sums (and its rows' sums of x^2) in a scratch slot that the tile's last
// block adds in the order of k (hopper.cuh: finish_piece): the same bits in
// every run, graphed or eager. No value of one row reaches another row's
// output. The epilogue stores bf16 pairs from the accumulators.
//
// An N that is not a multiple of 8 (a 4-bit lm_head at an odd vocab, the
// tp shards' ragged widths): the rows of the words and scales are not
// 16-byte aligned, which TMA needs, so the variant VEC = false copies them
// by 4-byte cp.async from the producer warp's 32 lanes (a scale row from
// the 4-byte boundary at or before it, read back at its shift). The
// launcher chooses it by shape.
#pragma once

#include "hopper.cuh"

namespace k1wg {
SCALE_NS_BEGIN

using namespace hop;

constexpr int BK = 64, BN = 256;
// a scale row's elements in a slot: BN, and room for the VEC = false
// copies from a 4-byte boundary; 128-byte aligned rows for TMA
constexpr int SROW = BN + 64;
// two consumer warpgroups; the producer warpgroup: one warp of TMA loads,
// three that form the x slabs in turns
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128, FORMERS = 3;
constexpr int SMEM_MAX = 232448;
// registers a thread after setmaxnreg: the producer warpgroup gives up what
// the consumers take, within the block's 168 a thread at launch (an .inc
// that the released registers cannot cover never returns)
constexpr int REGS_PRODUCER = 56, REGS_CONSUMER = 224;
static_assert(128 * REGS_PRODUCER + CONSUMERS * REGS_CONSUMER <= THREADS * 168,
              "setmaxnreg within the block's registers");

template <int BM>
struct Cfg {
  static constexpr int NW = BN / 128;           // 64-column products a consumer warpgroup
  static constexpr int NACC = BM / 2;           // f32 accumulators a thread a product
  static constexpr int X_BYTES = BM * BK * 2;   // x's slab: BM rows of 128 bytes, swizzled
  static constexpr int W_BYTES = BK / 8 * BN * 4;    // the packed words [8][BN]
  static constexpr int S_BYTES = 4 * SROW * SC_BYTES;  // the halves' scale rows, zero-scale rows
  static constexpr int N_BYTES = BK * 2;        // the slab's norm weights (x by TMA)
  static constexpr int U_BYTES = 3 * BM * 4;    // a row's sum of x in each half, sum of x^2
  static constexpr int STAGE = X_BYTES + W_BYTES + S_BYTES + N_BYTES + U_BYTES;
  static constexpr int FIT = (SMEM_MAX - 512) / STAGE;
  static constexpr int STAGES = FIT < 16 ? FIT : 16;
  static constexpr int W_OFF = STAGES * X_BYTES;  // x slots first: 1024-byte aligned
  static constexpr int S_OFF = W_OFF + STAGES * W_BYTES;
  static constexpr int N_OFF = S_OFF + STAGES * S_BYTES;
  static constexpr int U_OFF = N_OFF + STAGES * N_BYTES;
  static constexpr int BAR_OFF = U_OFF + STAGES * U_BYTES;
  static constexpr int SMEM = BAR_OFF + 3 * STAGES * 8 + 16;
  // f32 of a stream-K piece: the accumulators, then the rows' sums of x^2,
  // each in the fragment layout, thread by thread
  static constexpr int PIECE = BM * BN + BM / 4 * CONSUMERS;
  static_assert(STAGES >= 4 && SMEM <= SMEM_MAX, "shared memory of one block");
};

struct Args {
  const bf16* x;            // [M, K]
  const bf16* norm_w;       // [K] or NULL
  const int32_t* x_map;     // [K] or NULL
  const int32_t* qweight;   // [K/8, N] (read here only by the VEC = false producer)
  const scale_t* scales;    // [K/gs, N]
  const scale_t* zscale;    // [K/gs, N]
  bf16* out;                // [M, N]
  float* part;              // stream-K: [grid][2][PIECE] f32
  unsigned int* ticket;     // stream-K: one zero a tile
  int M, K, N, gs;
  float eps;
  int tiles, ktiles, stream_k;
  int xtma;                 // x's slab (and the norm weights) by TMA: no gather
};

// Columns c, c + 1 of a scale row as f32.
__device__ __forceinline__ float2 scale_pair(const scale_t* p) {
#if SCALE_F32
  return *reinterpret_cast<const float2*>(p);
#else
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
#endif
}

// The elements by which a scale row's segment starts past a 4-byte
// boundary (0 or 1 bf16; 0 for f32): the VEC = false copy of the segment
// begins that many elements early.
__device__ __forceinline__ int scale_shift(const scale_t* first) {
  return (int)(((uintptr_t)first & 3) / SC_BYTES);
}

// The nibbles of k and k + 1 (byte q of w, `pick` = q | (4 + q) << 8) as the
// bf16 pair (128 + q_k, 128 + q_k+1): the nibble enters the mantissa of 128.
__device__ __forceinline__ uint32_t nib2(uint32_t w, uint32_t pick) {
  return (prmt(w, w >> 4, pick) & 0x000F000Fu) | 0x43004300u;
}

// One producer warp: each slab's packed words and the scale / zero-scale
// rows of its two halves' groups, by TMA (VEC, lane 0) or plain loads; and,
// where x needs no gather, x's raw slab and the slab's norm weights by TMA
// (lane 0) for the former warp that stages it.
template <int BM, bool VEC>
__device__ __forceinline__ void produce(const CUtensorMap* wmap, const CUtensorMap* smap,
                                        const CUtensorMap* zmap, const CUtensorMap* xmap,
                                        const CUtensorMap* nmap, const Args& p,
                                        unsigned char* smem, uint64_t* full, uint64_t* xfull,
                                        uint64_t* empty, int lane) {
  using C = Cfg<BM>;
  Walk w(p.tiles, p.ktiles, p.stream_k);
  int tile, kb, ke, st = 0;
  uint32_t phase = 0;  // of slot st; its first wait passes at once (the slots start free)
  if (lane == 0) {  // the maps this launch encoded
    if constexpr (VEC) prefetch_map(wmap), prefetch_map(smap), prefetch_map(zmap);
    if (p.xtma) prefetch_map(xmap);
    if (p.xtma && p.norm_w != nullptr) prefetch_map(nmap);
  }
  while (w.next(tile, kb, ke)) {
    const int n0 = tile * BN;
    for (int kt = kb; kt < ke; ++kt) {
      mbar_wait(empty + st, phase ^ 1);
      unsigned char* ws = smem + C::W_OFF + st * C::W_BYTES;
      unsigned char* ss = smem + C::S_OFF + st * C::S_BYTES;
      const int k0 = kt * BK, g0 = k0 / p.gs, g1 = (k0 + BK / 2) / p.gs;
      if (p.xtma && lane == 0) {  // x's raw rows (zeros past M and K) for its former
        const bool norm = p.norm_w != nullptr;
        mbar_arrive_tx(xfull + st, C::X_BYTES + (norm ? C::N_BYTES : 0));
        tma_2d(smem + st * C::X_BYTES, xmap, k0, 0, xfull + st);
        if (norm) tma_2d(smem + C::N_OFF + st * C::N_BYTES, nmap, k0, 0, xfull + st);
      }
      if constexpr (VEC) {
        // a slab within one group (gs % 64 == 0) takes only its first half's rows
        const bool halves = p.gs % BK != 0;
        mbar_arrive_tx(full + st, C::W_BYTES + (halves ? 4 : 2) * BN * SC_BYTES);
        tma_2d(ws, wmap, n0, kt * (BK / 8), full + st);
        tma_2d(ss, smap, n0, g0, full + st);
        tma_2d(ss + 2 * SROW * SC_BYTES, zmap, n0, g0, full + st);
        if (halves) {
          tma_2d(ss + SROW * SC_BYTES, smap, n0, g1, full + st);
          tma_2d(ss + 3 * SROW * SC_BYTES, zmap, n0, g1, full + st);
        }
      } else {
        // N % 8 != 0: 4-byte cp.async copies, completing on the slot's
        // barrier. The words are 4-byte aligned; a scale row is copied from
        // the 4-byte boundary at or before its first column (scale_shift)
        int32_t* Ws = reinterpret_cast<int32_t*>(ws);
        const int kp0 = k0 / 8, ng = p.K / p.gs;
#pragma unroll 8
        for (int i = lane; i < (BK / 8) * BN; i += 32) {
          const int r = i / BN, c = i % BN;
          const bool ok = kp0 + r < p.K / 8 && n0 + c < p.N;
          tc::cp_async4(Ws + i, ok ? (const void*)(p.qweight + (size_t)(kp0 + r) * p.N + n0 + c)
                                   : (const void*)p.qweight, ok ? 4 : 0);
        }
        constexpr int WORDS = BN * SC_BYTES / 4 + 1;  // 4-byte words a scale row's copy
#pragma unroll 4
        for (int i = lane; i < 4 * WORDS; i += 32) {
          const int row = i / WORDS, wd = i % WORDS, g = (row & 1) ? g1 : g0;
          const scale_t* base = (row >> 1 ? p.zscale : p.scales) + (size_t)g * p.N;
          const int e0 = n0 - scale_shift(base + n0) + wd * (4 / SC_BYTES);  // its first element
          const int valid = min(4 / SC_BYTES, p.N - e0);
          const bool ok = g < ng && valid > 0;
          tc::cp_async4(reinterpret_cast<unsigned char*>(ss) + row * SROW * SC_BYTES + wd * 4,
                        ok ? (const void*)(base + e0) : (const void*)p.scales,
                        ok ? valid * SC_BYTES : 0);
        }
        mbar_arrive_cp_async(full + st);
      }
      if (++st == C::STAGES) st = 0, phase ^= 1;
    }
  }
}

// x[m, k0 .. k0 + 64) as the product takes it, into a slot, by loads of its
// elements from device memory (the act-order gather, or x off 16 bytes):
// bf16(x * w) with the norm (its 1/rms waits for the epilogue), else x,
// gathered by x_map;
// chunk c (8 k) of row m at sw128(m, c). Beside it, per row: the sum of the
// staged values over each half (f32) and the sum of the raw x^2. Rows M..BM
// and k >= K are zeros. One warp; lanes 8a .. 8a + 7 take a row's 8 chunks,
// lane l always chunk l % 8.
template <int BM>
__device__ __forceinline__ void form_slab(const Args& p, unsigned char* xs, float* us, int k0,
                                          int lane) {
  const bool norm = p.norm_w != nullptr;
  const int items = p.M * 8, c = lane & 7, k = k0 + 8 * c;
  const bool kin = k < p.K;
  // the chunk's norm weights: the same for every row of the lane
  uint4 wr = make_uint4(0u, 0u, 0u, 0u);
  if (norm && kin) {
    unsigned short* we = reinterpret_cast<unsigned short*>(&wr);
    const unsigned short* nw = reinterpret_cast<const unsigned short*>(p.norm_w);
#pragma unroll
    for (int e = 0; e < 8; ++e) we[e] = __ldg(nw + (p.x_map ? __ldg(p.x_map + k + e) : k + e));
  }
  const __nv_bfloat162* wh = reinterpret_cast<const __nv_bfloat162*>(&wr);
  for (int i0 = 0; i0 < items; i0 += 4 * 32) {  // four rows a lane at a time, loads first
    uint4 xr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r * 32 + lane, m = i >> 3;
      xr[r] = make_uint4(0u, 0u, 0u, 0u);
      if (i >= items || !kin) continue;
      unsigned short* xe = reinterpret_cast<unsigned short*>(&xr[r]);
      const unsigned short* xrow = reinterpret_cast<const unsigned short*>(p.x + (size_t)m * p.K);
#pragma unroll
      for (int e = 0; e < 8; ++e) xe[e] = __ldg(xrow + (p.x_map ? __ldg(p.x_map + k + e) : k + e));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r * 32 + lane, m = i >> 3;
      const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xr[r]);
      uint4 o = xr[r];
      uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(xh[e]);
        sq = fmaf(f.x, f.x, fmaf(f.y, f.y, sq));
        if (norm) {
          const float2 g = __bfloat1622float2(wh[e]);
          ow[e] = tc::pack_bf16(f.x * g.x, f.y * g.y);
        }
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
        sum += v.x + v.y;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      sq += __shfl_xor_sync(0xffffffffu, sq, 4);
      if (i < items) {
        *reinterpret_cast<uint4*>(xs + sw128(m, c)) = o;
        if ((c & 3) == 0) us[(c >> 2) * BM + m] = sum;
        if (c == 0) us[2 * BM + m] = sq;
      }
    }
  }
  for (int i = items + lane; i < BM * 8; i += 32) {  // the padding rows
    const int m = i >> 3, cc = i & 7;
    *reinterpret_cast<uint4*>(xs + sw128(m, cc)) = make_uint4(0u, 0u, 0u, 0u);
    if (cc == 0) us[m] = us[BM + m] = us[2 * BM + m] = 0.f;
  }
}

// The staging of an x slab that TMA has loaded raw (rows past M and k past
// K are zeros): in place, bf16(x * w) under the norm, with the sums of
// form_slab, for the rows below M rounded up to 4. One warp; lane l takes
// chunk l % 8 of rows l / 8, l / 8 + 4, ...
template <int BM>
__device__ __forceinline__ void stage_slab(const Args& p, unsigned char* xs, const bf16* nws,
                                           float* us, int lane) {
  const bool norm = p.norm_w != nullptr;
  const int c = lane & 7;
  const uint4 wr = norm ? *reinterpret_cast<const uint4*>(nws + 8 * c) : make_uint4(0u, 0u, 0u, 0u);
  const __nv_bfloat162* wh = reinterpret_cast<const __nv_bfloat162*>(&wr);
  // rows past M stay TMA's zeros with stale sums: they reach only output
  // rows that are never written
  const int jn = (p.M + 3) / 4;
#pragma unroll
  for (int j = 0; j < BM / 4; ++j) {
    if (j >= jn) break;  // the same for the whole warp
    const int m = (lane >> 3) + 4 * j;
    uint4* at = reinterpret_cast<uint4*>(xs + sw128(m, c));
    uint4 o = *at;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
      sq = fmaf(f.x, f.x, fmaf(f.y, f.y, sq));
      if (norm) {
        const float2 g = __bfloat1622float2(wh[e]);
        ow[e] = tc::pack_bf16(f.x * g.x, f.y * g.y);
      }
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
      sum += v.x + v.y;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    sq += __shfl_xor_sync(0xffffffffu, sq, 4);
    if (norm) *at = o;
    if ((c & 3) == 0) us[(c >> 2) * BM + m] = sum;
    if (c == 0) us[2 * BM + m] = sq;
  }
}

// Former warp f of FORMERS: the slabs f, f + FORMERS, ... of the block's walk.
template <int BM>
__device__ __forceinline__ void form(const Args& p, unsigned char* smem, uint64_t* full,
                                     uint64_t* xfull, uint64_t* empty, int f, int lane) {
  using C = Cfg<BM>;
  Walk w(p.tiles, p.ktiles, p.stream_k);
  int tile, kb, ke, st = 0, seq = 0;
  uint32_t phase = 0;
  while (w.next(tile, kb, ke)) {
    for (int kt = kb; kt < ke; ++kt, ++seq) {
      if (seq % FORMERS == f) {
        float* us = reinterpret_cast<float*>(smem + C::U_OFF + st * C::U_BYTES);
        if (p.xtma) {
          mbar_wait(xfull + st, phase);
          stage_slab<BM>(p, smem + st * C::X_BYTES,
                         reinterpret_cast<const bf16*>(smem + C::N_OFF + st * C::N_BYTES), us, lane);
        } else {
          mbar_wait(empty + st, phase ^ 1);
          form_slab<BM>(p, smem + st * C::X_BYTES, us, kt * BK, lane);
        }
        fence_proxy_async();  // the rows are read by wgmma (the async proxy)
        mbar_arrive(full + st);
      }
      if (++st == C::STAGES) st = 0, phase ^= 1;
    }
  }
}

// acc += s * p - (zs + 128 s) * sum(x) for the products p of a half slab
// (sums U) or of a whole slab in one group (sums U + U2; U2 may be NULL):
// acc[j][4i + e] is weight column r + 64j + (e >> 1), x row 8i + 2q + (e & 1).
template <int BM, bool VEC>
__device__ __forceinline__ void fold(float (&acc)[Cfg<BM>::NW][Cfg<BM>::NACC],
                                     float (&p)[Cfg<BM>::NW][Cfg<BM>::NACC], const scale_t* S,
                                     const scale_t* Z, const float* U, int r, int q,
                                     const float* U2, int sS, int sZ) {
#pragma unroll
  for (int j = 0; j < Cfg<BM>::NW; ++j) {
    float2 s, z;
    if constexpr (VEC) {
      s = scale_pair(S + r + 64 * j), z = scale_pair(Z + r + 64 * j);
    } else {  // the rows as copied, shifted by sS / sZ elements
      s = make_float2(sc2f(S[sS + r + 64 * j]), sc2f(S[sS + r + 64 * j + 1]));
      z = make_float2(sc2f(Z[sZ + r + 64 * j]), sc2f(Z[sZ + r + 64 * j + 1]));
    }
    const float z0 = fmaf(128.f, s.x, z.x), z1 = fmaf(128.f, s.y, z.y);
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      float2 u = *reinterpret_cast<const float2*>(U + 8 * i + 2 * q);
      if (U2 != nullptr) {  // the sums of a second half of the same group
        const float2 v = *reinterpret_cast<const float2*>(U2 + 8 * i + 2 * q);
        u.x += v.x, u.y += v.y;
      }
      float* a = acc[j] + 4 * i;
      const float* d = p[j] + 4 * i;
      a[0] = fmaf(-z0, u.x, fmaf(s.x, d[0], a[0]));
      a[1] = fmaf(-z0, u.y, fmaf(s.x, d[1], a[1]));
      a[2] = fmaf(-z1, u.x, fmaf(s.y, d[2], a[2]));
      a[3] = fmaf(-z1, u.y, fmaf(s.y, d[3], a[3]));
    }
  }
}

// The slab loop of one block's range [kb, ke) of a 256-column tile on the
// consumer warpgroups, K1's and (fused_wg.cuh) K6 / K7's GEMV phases':
// warpgroup wgi takes weight columns wgi * 128 .. A slab's products go out
// as one group and are folded once it is done. Where a group spans whole
// slabs (gs % 64 == 0: HALVES false) the slab's four k-steps go into one
// accumulator, folded once; where a slab holds two groups (HALVES) each
// half has an accumulator of its own, folded apart. Folding one slab while
// the next one's products run measured slower on the H100 (ptxas then
// serializes the products, C7514 / C7520: PERF.md), so the slabs take
// turns: products, fold, the next slab's fragments. The caller's ring R
// holds the slabs: R::SROW, a scale row's elements in a slot, and
//   slot(), advance()   the slot of the next slab, and past it;
//   wait(kt)            until slab kt has landed in slot() (x staged);
//   x(s), words(s), scales(s), sums(s)   slot s's parts (x's rows, the
//                       packed words [8][256], four scale rows, the halves'
//                       sums of x);
//   shifts(kt, sh)      the VEC = false scale rows' shifts;
//   folded(U, q)        after a slab's fold (its sums U);
//   release(s)          by lane 0 of each warp, once slot s is read.
template <int BM, bool VEC, bool HALVES, class R>
__device__ __forceinline__ void slab_loop(float (&acc)[Cfg<BM>::NW][Cfg<BM>::NACC], int kb,
                                          int ke, int tid, R& ring) {
  constexpr int NW = Cfg<BM>::NW, NACC = Cfg<BM>::NACC, NP = HALVES ? 2 : 1, SROW = R::SROW;
  using Frag = uint32_t[NW][4][4];
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int r0 = (warp >> 2) * (BN / 2) + (warp & 3) * 16 + 2 * g;  // A rows g, g + 8
  const uint32_t pick = q | (4 + q) << 8;
  float pr[NP][NW][NACC];
  Frag a;
#pragma unroll
  for (int h = 0; h < NP; ++h)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int i = 0; i < NACC; ++i) pr[h][j][i] = 0.f;
  // slot s's words as A fragments
  auto frags = [&](int s) {
    const uint32_t* W = ring.words(s);
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // f[0], f[1]: k 16ks + 2q, +1 (byte q of packed row 2ks) of columns
        // r (A row g) and r + 1 (A row g + 8); f[2], f[3]: k + 8
        const uint2 w0 = *reinterpret_cast<const uint2*>(W + (2 * ks) * BN + r0 + 64 * j);
        const uint2 w1 = *reinterpret_cast<const uint2*>(W + (2 * ks + 1) * BN + r0 + 64 * j);
        a[j][ks][0] = nib2(w0.x, pick), a[j][ks][1] = nib2(w0.y, pick);
        a[j][ks][2] = nib2(w1.x, pick), a[j][ks][3] = nib2(w1.y, pick);
      }
  };
  ring.wait(kb);
  frags(ring.slot());
  for (int kt = kb; kt < ke; ++kt) {
    const int cur = ring.slot();
    ring.advance();
    const uint64_t desc = kmajor_sw128(ring.x(cur));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < NW; ++j)
        Mma<BM>::run(pr[HALVES ? ks >> 1 : 0][j], a[j][ks], desc + 2 * ks, HALVES ? ks & 1 : ks);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NP; ++h)
#pragma unroll
      for (int j = 0; j < NW; ++j) fence_regs(pr[h][j]);
    const scale_t* S = ring.scales(cur);
    const float* U = ring.sums(cur);
    int sh[4] = {0, 0, 0, 0};  // VEC = false: each copied row's shift
    ring.shifts(kt, sh);
    if constexpr (HALVES) {
      fold<BM, VEC>(acc, pr[0], S, S + 2 * SROW, U, r0, q, nullptr, sh[0], sh[2]);
      fold<BM, VEC>(acc, pr[1], S + SROW, S + 3 * SROW, U + BM, r0, q, nullptr, sh[1], sh[3]);
    } else {  // both halves' sums
      fold<BM, VEC>(acc, pr[0], S, S + 2 * SROW, U, r0, q, U + BM, sh[0], sh[2]);
    }
    ring.folded(U, q);
    __syncwarp();
    if (lane == 0) ring.release(cur);
    if (kt + 1 < ke) ring.wait(kt + 1);
    frags(ring.slot());  // (where none follows: read, never used)
  }
}

// K1's ring (slab_loop's R): the slots of Cfg<BM>, taken in turn; a slab
// is ready once its TMA rows have landed and its former has staged it; the
// norm's sums of x^2 ride beside each slab.
template <int BM, bool VEC>
struct K1Ring {
  using C = Cfg<BM>;
  static constexpr int SROW = k1wg::SROW;
  unsigned char* smem;
  uint64_t *full, *xfull, *empty;
  const Args& p;
  float (&sq)[BM / 4];
  int n0 = 0, st = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ int slot() const { return st; }
  __device__ __forceinline__ void advance() {
    if (++st == C::STAGES) st = 0, phase ^= 1;
  }
  __device__ __forceinline__ void wait(int) {
    if (p.xtma) mbar_wait(xfull + st, phase);  // TMA's rows, seen here as well
    mbar_wait(full + st, phase);
  }
  __device__ __forceinline__ const unsigned char* x(int s) const { return smem + s * C::X_BYTES; }
  __device__ __forceinline__ const uint32_t* words(int s) const {
    return reinterpret_cast<const uint32_t*>(smem + C::W_OFF + s * C::W_BYTES);
  }
  __device__ __forceinline__ const scale_t* scales(int s) const {
    return reinterpret_cast<const scale_t*>(smem + C::S_OFF + s * C::S_BYTES);
  }
  __device__ __forceinline__ const float* sums(int s) const {
    return reinterpret_cast<const float*>(smem + C::U_OFF + s * C::U_BYTES);
  }
  __device__ __forceinline__ void shifts(int kt, int (&sh)[4]) const {
    if constexpr (!VEC) {
#pragma unroll
      for (int row = 0; row < 4; ++row) {
        const int g = (kt * BK + (row & 1) * (BK / 2)) / p.gs;
        sh[row] = scale_shift((row >> 1 ? p.zscale : p.scales) + (size_t)g * p.N + n0);
      }
    }
  }
  __device__ __forceinline__ void folded(const float* U, int q) {
    if (p.norm_w == nullptr) return;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      if (8 * i >= p.M) break;
      const float2 u = *reinterpret_cast<const float2*>(U + 2 * BM + 8 * i + 2 * q);
      sq[2 * i] += u.x, sq[2 * i + 1] += u.y;
    }
  }
  __device__ __forceinline__ void release(int s) { mbar_arrive(empty + s); }
};

// The consumer warpgroups: each range of the block's walk through
// slab_loop, then the stream-K combine and the epilogue.
template <int BM, bool VEC, bool HALVES>
__device__ __forceinline__ void consume(const Args& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* xfull, uint64_t* empty, int* answer,
                                        int tid) {
  using C = Cfg<BM>;
  constexpr int NW = C::NW, NACC = C::NACC;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int r0 = (warp >> 2) * (BN / 2) + (warp & 3) * 16 + 2 * g;  // A rows g, g + 8
  const bool norm = p.norm_w != nullptr;
  float acc[NW][NACC], sq[BM / 4];
  K1Ring<BM, VEC> ring{smem, full, xfull, empty, p, sq};
  Walk w(p.tiles, p.ktiles, p.stream_k);
  int tile, kb, ke;
  while (w.next(tile, kb, ke)) {
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < BM / 4; ++i) sq[i] = 0.f;
    ring.n0 = tile * BN;
    slab_loop<BM, VEC, HALVES>(acc, kb, ke, tid, ring);

    constexpr int BATCH = BM == 32 ? 2 : 4;  // pieces loaded together (registers)
    const bool emit = finish_piece<BATCH>(
        w, tile, kb, ke, p.ticket, answer, tid, CONSUMERS,
        [&](int slot) {  // the partial sums in the fragments' layout, rows < M only
          float* base = p.part + (size_t)(2 * blockIdx.x + slot) * C::PIECE;
          float4* mine = reinterpret_cast<float4*>(base) + tid;
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int i = 0; i < NACC / 4; ++i)
              if (8 * i < p.M)
                mine[(j * (NACC / 4) + i) * CONSUMERS] = make_float4(
                    acc[j][4 * i], acc[j][4 * i + 1], acc[j][4 * i + 2], acc[j][4 * i + 3]);
          float2* msq = reinterpret_cast<float2*>(base + BM * BN) + tid;
#pragma unroll
          for (int i = 0; i < BM / 8; ++i)
            if (norm && 8 * i < p.M) msq[i * CONSUMERS] = make_float2(sq[2 * i], sq[2 * i + 1]);
        },
        [&](int blk0, int n, bool first) {  // up to BATCH pieces, loaded together
          float4 v[BATCH][NW][NACC / 4];
          float2 u[BATCH][BM / 8];
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            if (b >= n) break;
            const int blk = blk0 + b;
            const float* base = p.part + (size_t)(2 * blk + w.slot_of(blk, tile)) * C::PIECE;
            const float4* src = reinterpret_cast<const float4*>(base) + tid;
            const float2* ssq = reinterpret_cast<const float2*>(base + BM * BN) + tid;
#pragma unroll
            for (int j = 0; j < NW; ++j)
#pragma unroll
              for (int i = 0; i < NACC / 4; ++i)
                if (8 * i < p.M) v[b][j][i] = __ldcg(src + (j * (NACC / 4) + i) * CONSUMERS);
#pragma unroll
            for (int i = 0; i < BM / 8; ++i)
              if (norm && 8 * i < p.M) u[b][i] = __ldcg(ssq + i * CONSUMERS);
          }
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            if (b >= n) break;
            const bool set = first && b == 0;
#pragma unroll
            for (int j = 0; j < NW; ++j)
#pragma unroll
              for (int i = 0; i < NACC / 4; ++i)
                if (8 * i < p.M) {
                  float* x = acc[j] + 4 * i;
                  const float4 t = v[b][j][i];
                  if (set) x[0] = x[1] = x[2] = x[3] = 0.f;
                  x[0] += t.x, x[1] += t.y, x[2] += t.z, x[3] += t.w;
                }
#pragma unroll
            for (int i = 0; i < BM / 8; ++i)
              if (norm && 8 * i < p.M) {
                if (set) sq[2 * i] = sq[2 * i + 1] = 0.f;
                sq[2 * i] += u[b][i].x, sq[2 * i + 1] += u[b][i].y;
              }
          }
        });
    if (!emit) continue;

    // the output: rows 8i + 2q + e of columns c, c + 1, times the rows' 1/rms
    const int n0 = tile * BN;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * i + 2 * q + e;
        if (m >= p.M) continue;
        const float rs = norm ? 1.0f / sqrtf(sq[2 * i + e] / (float)p.K + p.eps) : 1.f;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int c = n0 + r0 + 64 * j;
          const float v0 = acc[j][4 * i + e] * rs, v1 = acc[j][4 * i + 2 + e] * rs;
          bf16* o = p.out + (size_t)m * p.N + c;
          if ((p.N & 1) == 0 && c + 1 < p.N) {
            *reinterpret_cast<uint32_t*>(o) = tc::pack_bf16(v0, v1);
          } else {
            if (c < p.N) o[0] = f2bf(v0);
            if (c + 1 < p.N) o[1] = f2bf(v1);
          }
        }
      }
  }
}

template <int BM, bool VEC, bool HALVES>
__global__ void __launch_bounds__(THREADS, 1)
    q4_gemv_wg_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap smap,
                      const __grid_constant__ CUtensorMap zmap,
                      const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap nmap, const Args p) {
  using C = Cfg<BM>;
  // 1024-byte aligned (the 128-byte swizzle's atoms), used as declared so
  // that the compiler keeps the shared address space (see q4_wgmma.cuh)
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  uint64_t* xfull = empty + C::STAGES;
  int* answer = reinterpret_cast<int*>(xfull + C::STAGES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    if (tc::smem_addr(smem) & 1023) __trap();
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, (VEC ? 1 : 32) + 32);  // the weights' producer, the x slab's warp
      mbar_init(empty + s, CONSUMERS / 32);
      mbar_init(xfull + s, 1);                   // x's raw slab by TMA
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS_PRODUCER) : "memory");
    if (warp == CONSUMERS / 32) {
      if (!VEC || lane == 0)
        produce<BM, VEC>(&wmap, &smap, &zmap, &xmap, &nmap, p, smem, full, xfull, empty, lane);
    } else {
      form<BM>(p, smem, full, xfull, empty, warp - CONSUMERS / 32 - 1, lane);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS_CONSUMER) : "memory");
    consume<BM, VEC, HALVES>(p, smem, full, xfull, empty, answer, tid);
  }
}

template <int BM, bool VEC, bool HALVES>
cudaError_t launch(const CUtensorMap (&maps)[5], const Args& p, int grid, cudaStream_t st) {
  using C = Cfg<BM>;
  static const cudaError_t ok = allow_smem(q4_gemv_wg_kernel<BM, VEC, HALVES>, C::SMEM);
  if (ok != cudaSuccess) return ok;
  q4_gemv_wg_kernel<BM, VEC, HALVES><<<grid, THREADS, C::SMEM, st>>>(maps[0], maps[1], maps[2],
                                                                     maps[3], maps[4], p);
  return cudaGetLastError();
}

// The instantiations: row tile 16 or 32, TMA or plain loads of the words
// (VEC: N % 8 == 0), a fold per slab or per half slab (HALVES: gs % 64 != 0).
inline cudaError_t launch_by(int bm, bool vec, bool halves, const CUtensorMap (&maps)[5],
                             const Args& p, int grid, cudaStream_t st) {
  if (bm == 16) {
    if (vec) return halves ? launch<16, true, true>(maps, p, grid, st) : launch<16, true, false>(maps, p, grid, st);
    return halves ? launch<16, false, true>(maps, p, grid, st) : launch<16, false, false>(maps, p, grid, st);
  }
  if (vec) return halves ? launch<32, true, true>(maps, p, grid, st) : launch<32, true, false>(maps, p, grid, st);
  return halves ? launch<32, false, true>(maps, p, grid, st) : launch<32, false, false>(maps, p, grid, st);
}

SCALE_NS_END
}  // namespace k1wg
