// The pipelined, warp-specialised tensor-core GEMM over a 4-bit GPTQ weight
// (x [M, K] @ W, W given as packed nibbles [K/8, N] int32 with bf16 -- or,
// built with -DSCALE_F32=1, f32 -- scale and zero-scale rows [K/gs, N]), for
// prefill-sized M (M > 32), and the same product against a resident int8
// image of such a weight. Four modes of one kernel:
//
//   Exact (K2, q4_matmul.cu): out = bf16(x @ bf16(q*s - zs)), f32 sums.
//   Glu   (K12, q4_matmul.cu): the same product over
//         a = bf16(bf16(silu_f32(gate)) * up), gate = x[m, k] and
//         up = x[m, ou + k] of the raw fused gate|up output x [M, W].
//   Int8  (K10, q4_prefill_a8.cu): the weight re-quantized per column,
//         w8 = clip(rint((q*s - zs) * (1/ws[n])), +-127), times the
//         row-quantized activation xq (row_quant_kernel, int8_mma.cuh);
//         out = bf16(float(xq @ w8) * sx[m] * ws[n]), int32 sums.
//   W8    (K11, w8_matmul.cu): Int8's product and epilogue against the
//         resident image w8 [N, K] int8 (K-major), which needs no conversion.
//
// Bound on the H100: operations. At prefill M the 2*M*K*N products
// outweigh the K*N/2 weight bytes far beyond the ridge, so the tensor cores
// set the floor: 989 TFLOP/s bf16 (Exact, Glu), 1,979 TOP/s int8 (Int8).
// What stands between them and that floor: the conversion of the weight
// (and, in Glu, of the activation, which every column block recomputes) and
// the copies, since each of the N/128 column blocks reads its rows of x
// again from L2 (scripts/ring_ablation.py times each part alone).
//
// Design: an output tile of BM x 128 per block, warp specialised. Producer
// warps keep a ring of RING 64-deep slabs, AHEAD of them in flight, with
// 16-byte cp.async copies -- the A slab (x, or gate and up, or xq), the
// packed weight slab (8 x 128 int32, the GPTQ layout as it is) and the
// slab's scale and zero-scale rows (two group rows cover a slab at g32) --
// and convert each weight slab once into an n-major B tile Bt[n][k] (bf16
// for Exact and Glu, int8 for Int8), one producer thread per column (two in
// Glu). The conversion goes through tables: a (column, group) has only 16
// values of q*s - zs, so they are computed once, with the reference's f32
// operations and roundings, and each nibble looks its value up by prmt. In
// Glu mode the producers also form the A tile in place over the gate half
// of the slot. Eight consumer warps, a 64 x 64 (Glu: 64 x 32) sub-tile
// each, run ldmatrix + mma.sync (bf16 m16n8k16 with f32 accumulators, or s8
// m16n8k32 with s32 accumulators) on the tiles the producers filled. Named
// barriers hand the slabs over; the producers may run SLACK slabs ahead of
// the consumers, with one B tile per slab of slack. The epilogue rounds
// (Int8: rescales, then rounds) to bf16 in registers and leaves through
// shared memory in 16-byte stores. One block an SM. Ragged M and N are
// masked; for an N that is not a multiple of 8 (weight and scale rows not
// 16-byte aligned) the producers read those slabs by plain loads and the
// output is written element by element. Not yet: wgmma, TMA and cluster
// multicast of the A slab (which would halve the L2 traffic of the copies),
// which would reach all three modes from here.
//
// W8 (K11) is bound by int8 operations: 2*M*K*N at 1,979 TOP/s, far above
// the K*N image bytes at prefill M. Its image is K-major, so each ring slot
// holds a 128 x 64-byte block of it copied by 16-byte cp.async straight
// into the n-major layout ldmatrix reads (the B tile is the ring slot: no
// conversion, no tables, no separate B tiles), and the producers only keep
// the copies in flight. What is missing: TMA (the copies still cost the
// producers an instruction per 16 bytes), cluster multicast of the xq slab
// (each of the N/128 column blocks reads its rows of xq again from L2) and
// wgmma (integer wgmma reads only K-major operands, which the image now is).
//
// Per mode:
//   Exact  256-row tiles, 4 producer warps, a 4-slab ring (slack 2).
//   Glu    128-row tiles, 8 producer warps (the 64 x 32 consumer tiles
//          leave the registers for them), a 4-slab ring whose slot holds
//          the gate slab and the up slab (2 x 128 x 64 bf16, the bytes of
//          one 256-row x slab). silu(g) = h + h * tanh(h), h = g / 2, with
//          one tanh.approx: a single special-function operation where
//          g / (1 + exp(-g)) takes two; its error is far below the bf16
//          rounding that follows it.
//   Int8   256-row tiles, 4 producer warps, a 6-slab ring (slack 4) of
//          int8 xq slabs (80-byte rows). rint of the re-quantized value
//          clamped to +-127 is the low byte of v + 1.5 * 2^23 -- the same
//          byte as clip(rint(v)), since the bounds are integers, with no
//          float-to-int conversion. Each weight is still re-quantized once
//          per 256-row tile (8 times at M = 1919).
//   W8     256-row tiles, 4 producer warps, a 6-slab ring (slack 4) of xq
//          and image slabs (80-byte rows both).
#pragma once

#include <type_traits>

#include "async_mma.cuh"

namespace ring {
SCALE_NS_BEGIN

enum class Mode { Exact, Glu, Int8, W8 };

constexpr int BN = 128, BK = 64;
constexpr int CONSUMERS = 256;  // 8 warps multiply
constexpr int W_BYTES = (BK / 8) * BN * 4;  // packed weights of a slab
constexpr int SZ_BYTES = 2 * 2 * BN * SC_BYTES;  // scales, zero-scales: two group rows each
constexpr int WS_BYTES = W_BYTES + SZ_BYTES;
constexpr int C_LD = BN + 8;  // bf16 elements of an output row in the epilogue

// Per-mode geometry. A_LD / B_LD are in elements of the staged type (bf16,
// or bytes for Int8 and W8); every row stride is a multiple of 16 bytes, and
// the 144- and 80-byte strides keep ldmatrix free of bank conflicts.
template <Mode MODE>
struct Tile {
  static constexpr bool W8 = MODE == Mode::W8;  // B copied from the image, not converted
  static constexpr bool INT8 = MODE == Mode::Int8 || W8;
  static constexpr int BM = MODE == Mode::Glu ? 128 : 256;
  // RING slabs in the ring, AHEAD of them in flight ahead of the one being
  // converted (W8: handed over); the producers run at most SLACK = RING -
  // AHEAD slabs ahead of the consumers, with two named barriers and (but in
  // W8, whose B tile is its ring slot) one B tile per slab of slack
  static constexpr int RING = INT8 ? 6 : 4;
  static constexpr int AHEAD = 2;
  static constexpr int SLACK = RING - AHEAD, NB = W8 ? 0 : SLACK;
  // threads that copy and convert
  static constexpr int PRODUCERS = MODE == Mode::Glu ? 256 : 128;
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
  static constexpr int WARPS_M = BM / 64, WARPS_N = 8 / WARPS_M;
  static constexpr int WM = 64, WN = BN / WARPS_N;     // a consumer warp's tile
  static constexpr int MI = WM / 16, NP = WN / 16;      // 16-row fragments, 16-column pairs
  static constexpr int ESZ = INT8 ? 1 : 2;              // bytes of a staged element
  static constexpr int A_LD = BK + 16 / ESZ;
  static constexpr int A_BYTES = (MODE == Mode::Glu ? 2 : 1) * BM * A_LD * ESZ;
  static constexpr int B_LD = A_LD;                    // B tiles are n-major: Bt[n][k]
  static constexpr int B_BYTES = BN * B_LD * ESZ;
  // a ring slot's weight part: packed words and scale rows, or the B tile
  static constexpr int WS = W8 ? B_BYTES : WS_BYTES;
  static constexpr int W_OFF = RING * A_BYTES;
  static constexpr int B_OFF = W_OFF + RING * WS;
  static constexpr int X_OFF = B_OFF + NB * B_BYTES;  // Int8, W8: ws and 1/ws of the block's columns
  static constexpr int SMEM = X_OFF + (INT8 ? 2 * BN * 4 : 0);
  static_assert(BM * C_LD * 2 <= B_OFF, "the epilogue tile fits over the ring");
  using Acc = std::conditional_t<INT8, int, float>;
};

struct Args {
  const void* x;            // Exact: bf16 [M, K]; Glu: bf16 [M, ldx]; Int8: int8 xq [M, K]
  const int32_t* qweight;   // [K/8, N]
  const scale_t* scales;    // [K/gs, N] (bf16, or f32 under -DSCALE_F32=1)
  const scale_t* zscale;    // [K/gs, N]
  const float* sx;          // Int8: row scales [M]
  const float* ws;          // Int8: column scales [N]
  bf16* out;                // [M, N]
  int M, K, N, gs;
  int ldx, ou;              // Glu: row stride of x and the column where up starts
  const int8_t* w8 = nullptr;  // W8: the image [N, K] (qweight, scales, zscale unused)
};

// Named barriers (0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Producer thread t issues its share of the copies of slab kt (k0 = kt*BK)
// into ring slot kt % RING: the A slab (16-byte chunks, each inside or
// outside K since K % 16 == 0), then the packed weights [BK/8][BN] and the
// scale and zero-scale rows [2][BN] each, or (W8) the image's rows n0..n0 +
// 127 at k0..k0 + 63 as the n-major B tile. VEC: N % 8 == 0, so weight and
// scale rows are 16-byte aligned; else plain loads (the image's rows are
// aligned at any N: K % 16 == 0).
template <Mode MODE, bool VEC>
__device__ __forceinline__ void load_slab(unsigned char* smem, const Args& p, int m0, int n0,
                                          int kt, int t) {
  using T = Tile<MODE>;
  unsigned char* As = smem + (kt % T::RING) * T::A_BYTES;
  unsigned char* Wst = smem + T::W_OFF + (kt % T::RING) * T::WS;
  const int k0 = kt * BK;
  constexpr int CHUNKS = BK * T::ESZ / 16;  // 16-byte chunks of an A row
  constexpr int HALVES = MODE == Mode::Glu ? 2 : 1;
  const int ldx = MODE == Mode::Glu ? p.ldx : p.K;
#pragma unroll
  for (int it = 0; it < HALVES * T::BM * CHUNKS / T::PRODUCERS; ++it) {
    const int i = t + it * T::PRODUCERS;
    const int r = i / CHUNKS, c = (i % CHUNKS) * (16 / T::ESZ);  // r: row of the slot
    const int gm = m0 + r % T::BM, k = k0 + c;
    const bool ok = gm < p.M && k < p.K;
    const int col = HALVES == 2 ? (r / T::BM) * p.ou + k : k;  // Glu: gate, then up
    const unsigned char* src =
        static_cast<const unsigned char*>(p.x) + ((size_t)gm * ldx + col) * T::ESZ;
    tc::cp_async16(As + (r * T::A_LD + c) * T::ESZ, ok ? src : p.x, ok ? 16 : 0);
  }
  if constexpr (T::W8) {
#pragma unroll
    for (int it = 0; it < BN * (BK / 16) / T::PRODUCERS; ++it) {
      const int i = t + it * T::PRODUCERS;
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const bool ok = n0 + r < p.N && k0 + c < p.K;
      tc::cp_async16(Wst + r * T::B_LD + c, ok ? p.w8 + (size_t)(n0 + r) * p.K + k0 + c : p.w8,
                     ok ? 16 : 0);
    }
    return;
  }
  int32_t* Ws = reinterpret_cast<int32_t*>(Wst);
  scale_t* Ss = reinterpret_cast<scale_t*>(Wst + W_BYTES);
  const int kp0 = k0 / 8, g0 = k0 / p.gs, ng = p.K / p.gs;
  if constexpr (VEC) {
#pragma unroll
    for (int it = 0; it < (BK / 8) * (BN / 4) / T::PRODUCERS; ++it) {
      const int i = t + it * T::PRODUCERS;
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const bool ok = kp0 + r < p.K / 8 && n0 + c < p.N;
      tc::cp_async16(Ws + r * BN + c, ok ? p.qweight + (size_t)(kp0 + r) * p.N + n0 + c : p.qweight,
                     ok ? 16 : 0);
    }
    for (int i = t; i < 4 * (BN / SC_VEC); i += T::PRODUCERS) {
      const int row = i / (BN / SC_VEC), c = (i % (BN / SC_VEC)) * SC_VEC;
      const scale_t* src = row >> 1 ? p.zscale : p.scales;
      const bool ok = g0 + (row & 1) < ng && n0 + c < p.N;
      tc::cp_async16(Ss + row * BN + c, ok ? src + (size_t)(g0 + (row & 1)) * p.N + n0 + c : src,
                     ok ? 16 : 0);
    }
  } else {
    for (int i = t; i < (BK / 8) * BN; i += T::PRODUCERS) {
      const int r = i / BN, c = i - r * BN;
      const bool ok = kp0 + r < p.K / 8 && n0 + c < p.N;
      Ws[r * BN + c] = ok ? __ldg(p.qweight + (size_t)(kp0 + r) * p.N + n0 + c) : 0;
    }
    for (int i = t; i < 4 * BN; i += T::PRODUCERS) {
      const int row = i / BN, c = i - row * BN;
      const scale_t* src = row >> 1 ? p.zscale : p.scales;
      const bool ok = g0 + (row & 1) < ng && n0 + c < p.N;
      Ss[row * BN + c] = ok ? src[(size_t)(g0 + (row & 1)) * p.N + n0 + c] : scale_t(0.f);
    }
  }
}

// silu(g) = h + h * tanh(h), h = g / 2: one tanh.approx (a single
// special-function operation) where g / (1 + exp(-g)) takes two.
__device__ __forceinline__ float silu_fast(float g) {
  const float h = 0.5f * g;
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// Glu: two gate / up bf16 pairs -> bf16(bf16(silu(g)) * u) for each.
__device__ __forceinline__ uint32_t glu2(uint32_t g, uint32_t u) {
  const __nv_bfloat162 sg = __floats2bfloat162_rn(silu_fast(__uint_as_float(g << 16)),
                                                  silu_fast(__uint_as_float(g & 0xFFFF0000u)));
  // the product of two bf16 is exact in any wider type: one rounding to bf16
  const __nv_bfloat162 r = __hmul2(sg, *reinterpret_cast<const __nv_bfloat162*>(&u));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Glu: form the A tile of a slot in place over its gate half.
template <class T>
__device__ __forceinline__ void form_glu(unsigned char* slot, int t) {
  bf16* G = reinterpret_cast<bf16*>(slot);
  const bf16* U = G + T::BM * T::A_LD;
#pragma unroll
  for (int it = 0; it < T::BM * (BK / 8) / T::PRODUCERS; ++it) {
    const int i = t + it * T::PRODUCERS;
    const int off = (i >> 3) * T::A_LD + (i & 7) * 8;
    const uint4 g = *reinterpret_cast<const uint4*>(G + off);
    const uint4 u = *reinterpret_cast<const uint4*>(U + off);
    *reinterpret_cast<uint4*>(G + off) =
        make_uint4(glu2(g.x, u.x), glu2(g.y, u.y), glu2(g.z, u.z), glu2(g.w, u.w));
  }
}

// The weight tile is converted through tables: a (column, group) has only
// 16 values of q*s - zs, one for each nibble value q, so each is computed once
// per column and group -- with the f32 operations and roundings of the
// reference -- and every nibble then looks up its byte(s) with prmt.
//
// Int8: the bytes clip(rint((q*s - z) * inv), +-127), q = 0..15, as four
// words. rint of the value clamped to +-127 is the low byte of v + 1.5 *
// 2^23 -- the same byte as clip(rint(v)), since the bounds are integers,
// with no float-to-int conversion (a quarter-rate instruction).
__device__ __forceinline__ void requant_table(uint32_t (&tb)[4], float s, float z, float inv) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t by[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = __fmul_rn(__fsub_rn(__fmul_rn(float(4 * w + j), s), z), inv);
      by[j] = __float_as_uint(__fadd_rn(fminf(fmaxf(v, -127.f), 127.f), 12582912.f));
    }
    tb[w] = __byte_perm(__byte_perm(by[0], by[1], 0x0040), __byte_perm(by[2], by[3], 0x0040),
                        0x5410);
  }
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// Exact / Glu: the bf16 values q*s - z (f32, rounded once), q = 0..15, as
// their low bytes lo[4] and their high bytes hi[4].
__device__ __forceinline__ void dequant_table(uint32_t (&lo)[4], uint32_t (&hi)[4], float s,
                                              float z) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t p0 = tc::pack_bf16(__fsub_rn(__fmul_rn(float(4 * w), s), z),
                                      __fsub_rn(__fmul_rn(float(4 * w + 1), s), z));
    const uint32_t p1 = tc::pack_bf16(__fsub_rn(__fmul_rn(float(4 * w + 2), s), z),
                                      __fsub_rn(__fmul_rn(float(4 * w + 3), s), z));
    lo[w] = prmt(p0, p1, 0x6420);
    hi[w] = prmt(p0, p1, 0x7531);
  }
}

// The table bytes of a packed word's eight nibbles (k order): byte-permute
// lookups of the low three bits in the q < 8 and q >= 8 halves of the
// table, then a per-byte select by each nibble's high bit, which the
// sign-replicate mode of prmt spreads over its byte (byte b of w carries
// nibble 2b + 1's high bit as its sign bit, byte b of w << 4 nibble 2b's).
__device__ __forceinline__ uint2 lookup(uint32_t w, const uint32_t (&tb)[4]) {
  const uint32_t idx = w & 0x77777777u, ze = w << 4;
  const uint32_t m0 = prmt(ze, w, 0xD9C8), m1 = prmt(ze, w, 0xFBEA);
  const uint32_t l0 = prmt(tb[0], tb[1], idx), h0 = prmt(tb[2], tb[3], idx);
  const uint32_t l1 = prmt(tb[0], tb[1], idx >> 16), h1 = prmt(tb[2], tb[3], idx >> 16);
  return make_uint2((l0 & ~m0) | (h0 & m0), (l1 & ~m1) | (h1 & m1));
}

// Producer thread t converts its share of one column of each slab (PR of the
// eight packed words, 64 k) into the n-major B tile Bt[col][...] with 16-byte
// stores, which at the 144- and 80-byte row strides are free of bank
// conflicts. The column's table is kept while its group lasts.
template <class T>
struct ColumnConvert {
  static constexpr int PR = (BK / 8) / (T::PRODUCERS / BN);  // packed rows a thread takes
  const float* inv_ws;  // Int8: 1/ws of the block's columns, staged in shared memory
  int col, pr0, g = -1;
  uint32_t lo[4], hi[4];  // the table (Int8: lo only; Exact / Glu: low and high bytes)

  __device__ __forceinline__ ColumnConvert(int t, const float* inv_ws_)
      : inv_ws(inv_ws_), col(t % BN), pr0((t / BN) * PR) {}

  __device__ __forceinline__ void slab(unsigned char* Bt, const unsigned char* Wst, int k0,
                                       int gs) {
    const int32_t* Ws = reinterpret_cast<const int32_t*>(Wst);
    const scale_t* Ss = reinterpret_cast<const scale_t*>(Wst + W_BYTES);
    const int g0 = k0 / gs;
    const int split = ((g0 + 1) * gs - k0) / 8;  // packed rows in the slab's first group
    uint32_t b[2 * PR];
#pragma unroll
    for (int i = 0; i < PR; ++i) {
      const int pr = pr0 + i;
      const int gi = pr < split ? 0 : 1;
      if (g != g0 + gi) {  // uniform across the warp: k0 and gs are
        g = g0 + gi;
        const float s = sc2f(Ss[gi * BN + col]), z = sc2f(Ss[(2 + gi) * BN + col]);
        if constexpr (T::INT8)
          requant_table(lo, s, z, inv_ws[col]);
        else
          dequant_table(lo, hi, s, z);
      }
      const uint32_t w = static_cast<uint32_t>(Ws[pr * BN + col]);
      const uint2 l = lookup(w, lo);
      if constexpr (T::INT8) {
        b[2 * i] = l.x, b[2 * i + 1] = l.y;
      } else {
        const uint2 h = lookup(w, hi);
        *reinterpret_cast<uint4*>(Bt + (col * T::B_LD + pr * 8) * 2) =
            make_uint4(prmt(l.x, h.x, 0x5140), prmt(l.x, h.x, 0x7362), prmt(l.y, h.y, 0x5140),
                       prmt(l.y, h.y, 0x7362));
      }
    }
    if constexpr (T::INT8) {
      uint4* dst = reinterpret_cast<uint4*>(Bt + col * T::B_LD + pr0 * 8);
#pragma unroll
      for (int q = 0; q < PR / 2; ++q)
        dst[q] = make_uint4(b[4 * q], b[4 * q + 1], b[4 * q + 2], b[4 * q + 3]);
    }
  }
};

template <Mode MODE, bool VEC>
__global__ void __launch_bounds__(Tile<MODE>::THREADS, 1) q4_ring_kernel(const Args p) {
  using T = Tile<MODE>;
  constexpr int MI = T::MI, NP = T::NP, RING = T::RING, AHEAD = T::AHEAD, SLACK = T::SLACK;
  // named barriers (0 is __syncthreads): B tile of slab kt full FULL + kt %
  // SLACK, slab kt consumed FREE + kt % SLACK, PROD among the producers
  constexpr int FULL = 1, FREE = FULL + SLACK, PROD = FREE + SLACK;
  static_assert(PROD < 16, "sixteen named barriers");
  constexpr int PRODUCERS = T::PRODUCERS, THREADS = T::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * BN;
  const int ktiles = (p.K + BK - 1) / BK;
  auto b_tile = [&](int kt) -> unsigned char* {
    if constexpr (T::W8)
      return smem + T::W_OFF + (kt % RING) * T::WS;
    else
      return smem + T::B_OFF + (kt % T::NB) * T::B_BYTES;
  };
  float* ws_s = reinterpret_cast<float*>(smem + T::X_OFF);  // Int8, W8: ws, then 1/ws
  typename T::Acc c[MI][2 * NP][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) c[i][j][0] = c[i][j][1] = c[i][j][2] = c[i][j][3] = 0;

  if (tid >= CONSUMERS) {  // producers
    const int t = tid - CONSUMERS;
    if constexpr (T::INT8) {
      for (int i = t; i < BN; i += PRODUCERS) {
        const float w = n0 + i < p.N ? p.ws[n0 + i] : 0.f;
        ws_s[i] = w;
        ws_s[BN + i] = 1.0f / fmaxf(w, 1e-22f);
      }
    }
    ColumnConvert<T> cv(t, ws_s + BN);
    for (int s = 0; s < AHEAD; ++s) {
      if (s < ktiles) load_slab<MODE, VEC>(smem, p, m0, n0, s, t);
      tc::cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      // slab kt - SLACK, the last in the ring slot that slab kt + AHEAD
      // takes and in the B tile that slab kt takes, consumed
      if (kt >= SLACK) bar_sync(FREE + (kt - SLACK) % SLACK, THREADS);
      if (kt + AHEAD < ktiles) load_slab<MODE, VEC>(smem, p, m0, n0, kt + AHEAD, t);
      tc::cp_async_commit();
      tc::cp_async_wait<AHEAD>();
      bar_sync(PROD, PRODUCERS);
      const unsigned char* Wst = smem + T::W_OFF + (kt % RING) * T::WS;
      if constexpr (MODE == Mode::Glu) form_glu<T>(smem + (kt % RING) * T::A_BYTES, t);
      if constexpr (!T::W8) cv.slab(b_tile(kt), Wst, kt * BK, p.gs);
      bar_arrive(FULL + kt % SLACK, THREADS);
    }
    tc::cp_async_wait<0>();
  } else {  // consumers
    const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
    for (int kt = 0; kt < ktiles; ++kt) {
      bar_sync(FULL + kt % SLACK, THREADS);
      const unsigned char* As = smem + (kt % RING) * T::A_BYTES;
      const unsigned char* Bs = b_tile(kt);
      if constexpr (T::INT8) {
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          uint32_t a[MI][4], b[NP][4];
#pragma unroll
          for (int i = 0; i < MI; ++i)
            tc::ldmatrix_x4(a[i], As + (wm * T::WM + i * 16 + (lane & 15)) * T::A_LD + kk * 32 +
                                      (lane >> 4) * 16);
          // matrices (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, ..), (n 8-15, ..)
#pragma unroll
          for (int jp = 0; jp < NP; ++jp)
            tc::ldmatrix_x4(b[jp], Bs + (wn * T::WN + jp * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                            T::B_LD +
                                        kk * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int jp = 0; jp < NP; ++jp) {
              tc::mma_s8(c[i][2 * jp], a[i], b[jp][0], b[jp][1]);
              tc::mma_s8(c[i][2 * jp + 1], a[i], b[jp][2], b[jp][3]);
            }
        }
      } else {
        const bf16* Ab = reinterpret_cast<const bf16*>(As);
        const bf16* Bb = reinterpret_cast<const bf16*>(Bs);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t a[MI][4], b[NP][4];
#pragma unroll
          for (int i = 0; i < MI; ++i)
            tc::ldmatrix_x4(a[i], Ab + (wm * T::WM + i * 16 + (lane & 15)) * T::A_LD + kk * 16 +
                                      (lane >> 4) * 8);
          // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, ..), (n 8-15, ..)
#pragma unroll
          for (int jp = 0; jp < NP; ++jp)
            tc::ldmatrix_x4(b[jp], Bb + (wn * T::WN + jp * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                            T::B_LD +
                                        kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int jp = 0; jp < NP; ++jp) {
              tc::mma_bf16(c[i][2 * jp], a[i], b[jp][0], b[jp][1]);
              tc::mma_bf16(c[i][2 * jp + 1], a[i], b[jp][2], b[jp][3]);
            }
        }
      }
      if (kt + SLACK < ktiles) bar_arrive(FREE + kt % SLACK, THREADS);
    }
  }
  __syncthreads();  // the ring is free: the output tile goes over it
  bf16* Cs = reinterpret_cast<bf16*>(smem);
  if (tid < CONSUMERS) {
    const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
    const int gq = lane >> 2, q4 = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * T::WM + i * 16 + gq + 8 * h;
        float sxr = 0.f;
        if constexpr (T::INT8) sxr = m0 + r < p.M ? p.sx[m0 + r] : 0.f;
#pragma unroll
        for (int j = 0; j < 2 * NP; ++j) {
          const int col = wn * T::WN + j * 8 + 2 * q4;
          uint32_t v;
          if constexpr (T::INT8)
            v = tc::pack_bf16(__fmul_rn(__fmul_rn((float)c[i][j][2 * h], sxr), ws_s[col]),
                              __fmul_rn(__fmul_rn((float)c[i][j][2 * h + 1], sxr), ws_s[col + 1]));
          else
            v = tc::pack_bf16(c[i][j][2 * h], c[i][j][2 * h + 1]);
          *reinterpret_cast<uint32_t*>(Cs + r * C_LD + col) = v;
        }
      }
  }
  __syncthreads();
  for (int i = tid; i < T::BM * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8), col = (i % (BN / 8)) * 8;
    const int gm = m0 + r, gn = n0 + col;
    if (gm >= p.M || gn >= p.N) continue;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(p.out + (size_t)gm * p.N + gn) =
          *reinterpret_cast<const uint4*>(Cs + r * C_LD + col);
    } else {
      for (int e = 0; e < 8 && gn + e < p.N; ++e) p.out[(size_t)gm * p.N + gn + e] = Cs[r * C_LD + col + e];
    }
  }
}

// One launch of a mode; a refusal (shared memory, grid) comes back as the
// error, never as a fallback.
template <Mode MODE>
cudaError_t launch(const Args& p, cudaStream_t st) {
  using T = Tile<MODE>;
  auto go = [&](auto kernel) {
    dim3 grid((p.N + BN - 1) / BN, (p.M + T::BM - 1) / T::BM);
    kernel<<<grid, T::THREADS, T::SMEM, st>>>(p);
    return cudaGetLastError();
  };
  if (p.N % 8 == 0) {
    static const cudaError_t ok = allow_smem(q4_ring_kernel<MODE, true>, T::SMEM);
    return ok != cudaSuccess ? ok : go(q4_ring_kernel<MODE, true>);
  }
  static const cudaError_t ok = allow_smem(q4_ring_kernel<MODE, false>, T::SMEM);
  return ok != cudaSuccess ? ok : go(q4_ring_kernel<MODE, false>);
}

SCALE_NS_END
}  // namespace ring
