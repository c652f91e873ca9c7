// K2's kernel on Hopper (q4_matmul.cu): the 4-bit GPTQ matmul for
// prefill-sized M, out = bf16(x @ bf16(q*s - zs)) with the weight
// dequantized in f32 and rounded once to bf16, f32 sums and a bf16 output.
// x [M, K] bf16 (M > 32; act-order x gathered by the caller); the weight as
// stored: packed nibbles [K/8, N] int32 (k = 8j + i at bits 4i of word j)
// with scale and zero-scale rows [K/gs, N] in bf16 or, built with
// -DSCALE_F32=1, f32; gs a multiple of 32 dividing K.
//
// Replaces the TPU kernel exllama_tpu/ops/quant.py:_q4_deqw2_kernel_npair
// (launched at quant.py:996) and its siblings with the same math.
//
// Bound on the H100: operations at long prefill (2*M*K*N at 989 TFLOP/s
// bf16 against K*N/2 weight bytes at 3.35 TB/s; the ridge lies near M = 78
// rows), bytes at 33-64 rows (the verify step's 40 rows, the admission
// chunks' 64).
//
// Design. The product is taken transposed, out^T = W^T x^T, so that:
//   - the dequantized weight columns are wgmma's 64-row A operand, which
//     wgmma takes from registers: each consumer thread dequantizes its own
//     fragment straight from the packed words in the ring slot, and the
//     weight is never written back to shared memory. A's fragment order is
//     the GPTQ packing's: k = 2q, 2q + 1 (and + 8) of each 16 are byte q of
//     two packed words; a thread's two rows (g, g + 8) are mapped to
//     adjacent weight columns, so one 8-byte load brings both words and
//     one 4-byte load both scales;
//   - x's rows are wgmma's N, 64, 128 or 256 wide, read from shared memory
//     (K-major, 128-byte swizzle), so the row tile follows M and each
//     weight byte is read once for all the rows of a tile. Tiles (rows x
//     weight columns): 64 x 256 up to 64 rows, where the weight's bytes
//     bound the time (each x slab then serves twice the columns), 128 x
//     128 and 256 x 128 above (ops/quant.py:q4_matmul_plan).
// TMA loads each 64-deep slab (x [BM, 64], the packed words [8, BN], the
// two 32-deep halves' scale and zero-scale rows) into a ring of STAGES slots
// with completion on mbarriers; one producer warp issues them, with no
// per-16-byte copies and no address arithmetic. Two consumer warpgroups
// (BN / 2 weight columns each) dequantize slab t while slab t - 1's wgmmas
// run (A double-buffered in registers) and release a slot when the wgmmas
// that read it have finished. The grid is
// persistent, one block an SM: a block walks its output tiles (row tile
// fastest, so the blocks in flight share their weight columns in L2) and
// the producer runs on into the next tile while the consumers write one
// out. Where the tiles would leave the card partly idle (q4_matmul_plan:
// less than 90% of the last wave), the (tile, slab) units are shared out
// stream-K instead (stream_k.cuh), and a tile cut between blocks leaves
// each block's f32 partial sums, in the accumulator fragment's layout, in
// a scratch slot; the last block of the tile (an atomic ticket it resets)
// adds them in the order of k. No float atomics: the sums are the same in
// every run, graphed or eager. The epilogue rounds to bf16, transposes
// through shared memory and leaves in 16-byte stores.
//
// What bounds it now (scripts/k2_ablation.py, PERF.md section 6): at long
// prefill the consumers' dequantization and products do not overlap fully
// and the x slabs are read again for every column tile (L2 traffic); at
// 33-64 rows a fixed cost a launch (the ring's fill, stream-K's combine).
//
// An N that is not a multiple of 8 (a 4-bit lm_head at an odd vocab): the
// rows of the packed words and scales are not 16-byte aligned, which TMA
// needs, so the compile-time variant VEC = false loads those slabs with
// plain loads by 31 lanes of the producer warp (x still by TMA) and writes
// the output element by element. The launcher chooses it by shape.
// Not yet: cluster multicast of the x slab to the blocks of neighbouring
// column tiles, which would halve the L2 reads of x at long prefill.
#pragma once

#include "hopper.cuh"

namespace wg {
SCALE_NS_BEGIN

using namespace hop;

constexpr int BK = 64;
// two consumer warpgroups and a producer warpgroup, of which one warp works
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
constexpr int SMEM_MAX = 232448;

// A tile of BM rows (wgmma's N) by BN weight columns: each consumer
// warpgroup takes BN / 2 columns as NW = BN / 128 products of 64 rows.
template <int BM, int BN>
struct Cfg {
  static constexpr int NW = BN / 128;
  static constexpr int NACC = BM / 2;            // f32 accumulators a thread per product
  static constexpr int DEPTH = 1;                // groups of products in flight
  static constexpr int X_BYTES = BM * BK * 2;    // 128-byte swizzled x slab
  static constexpr int W_BYTES = BK / 8 * BN * 4;  // the packed words [8][BN]
  static constexpr int S_BYTES = 4 * BN * SC_BYTES;  // scale rows of the halves, zero-scale rows
  static constexpr int C_LD = BN + 8;            // bf16 elements of an output row in the epilogue
  static constexpr int C_BYTES = BM * C_LD * 2;
  static constexpr int STAGE = X_BYTES + W_BYTES + S_BYTES;
  static constexpr int FREE = SMEM_MAX - C_BYTES - 256;
  static constexpr int STAGES = FREE / STAGE < 12 ? FREE / STAGE : 12;
  static constexpr int W_OFF = STAGES * X_BYTES;  // x slots first: 1024-byte aligned
  static constexpr int S_OFF = W_OFF + STAGES * W_BYTES;
  static constexpr int C_OFF = S_OFF + STAGES * S_BYTES;
  static constexpr int BAR_OFF = C_OFF + C_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 16;
  static constexpr uint32_t TX = STAGE;
  static_assert(STAGES >= 4 && SMEM <= SMEM_MAX, "shared memory of one block");
};

struct Args {
  const int32_t* qweight;  // [K/8, N] (read here only by the VEC = false producer)
  const scale_t* scales;   // [K/gs, N]
  const scale_t* zscale;   // [K/gs, N]
  bf16* out;               // [M, N]
  float* part;             // stream-K: [grid][2][BM * BN] f32 partials
  unsigned int* ticket;    // stream-K: one zero a tile
  int M, K, N, gs;
  int mtiles, tiles, ktiles;  // row tiles; row tiles x column tiles; 64-deep slabs
  int stream_k;
};

// Two weights of one column, k and k + 1, from their packed word w (its
// byte q holds their nibbles, the lower k in the low one), as the bf16
// pair of a wgmma A register: q*s - z with one rounding to bf16
// (dequantize_t: q*s - zs in f32, then the cast). `pick` is the thread's
// constant for byte q.
#if SCALE_F32
// f32 scales: the reference's multiply and subtract in f32, then the cast.
struct ColumnScale {
  float s, z;
};
// Columns c and c + 1 of a scale row and a zero-scale row (c even).
__device__ __forceinline__ void load_scales(ColumnScale (&c)[2], const scale_t* s,
                                            const scale_t* z) {
  c[0] = {sc2f(s[0]), sc2f(z[0])}, c[1] = {sc2f(s[1]), sc2f(z[1])};
}
__device__ __forceinline__ uint32_t pick_of(int q) { return 8 * q; }  // a shift
__device__ __forceinline__ uint32_t dequant2(uint32_t w, uint32_t pick, const ColumnScale& c) {
  const uint32_t b = w >> pick;
  // 2^23 + q as a float is exact; subtracting 2^23 leaves q
  const float lo = __uint_as_float(0x4B000000u | (b & 0xFu)) - 8388608.f;
  const float hi = __uint_as_float(0x4B000000u | ((b >> 4) & 0xFu)) - 8388608.f;
  return tc::pack_bf16(__fsub_rn(__fmul_rn(lo, c.s), c.z), __fsub_rn(__fmul_rn(hi, c.s), c.z));
}
#else
// bf16 scales: q*s is exact in f32 (a 4-bit q times an 8-bit significand),
// and so is q*s - z wherever z is s times an integer zero point (rounded
// to bf16: the GPTQ format's zero-scales, z >= s, or 0) -- the two
// operands then lie within 2^5 of each other in scale -- so the
// reference's f32 value is exact and its one rounding to bf16 is that of a
// bf16x2 fma on the exact operands: (q + 128) - 128 from the nibbles under
// the exponent of 128 (exact), then q * s - z, two weights an instruction.
struct ColumnScale {
  __nv_bfloat162 s, nz;  // s, -z in both halves
};
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}
// Columns c and c + 1 of a scale row and a zero-scale row (c even).
__device__ __forceinline__ void load_scales(ColumnScale (&c)[2], const scale_t* s,
                                            const scale_t* z) {
  const uint32_t sv = *reinterpret_cast<const uint32_t*>(s);
  const uint32_t zv = *reinterpret_cast<const uint32_t*>(z);
  c[0] = {as_bf162(prmt(sv, sv, 0x1010)), __hneg2(as_bf162(prmt(zv, zv, 0x1010)))};
  c[1] = {as_bf162(prmt(sv, sv, 0x3232)), __hneg2(as_bf162(prmt(zv, zv, 0x3232)))};
}
// prmt's selector: byte q of w, then byte q of w >> 4, in bytes 0 and 2
__device__ __forceinline__ uint32_t pick_of(int q) { return q | (4 + q) << 8; }
__device__ __forceinline__ uint32_t dequant2(uint32_t w, uint32_t pick, const ColumnScale& c) {
  const uint32_t u = (prmt(w, w >> 4, pick) & 0x000F000Fu) | 0x43004300u;  // 128 + q
  const __nv_bfloat162 q = __hsub2(as_bf162(u), __floats2bfloat162_rn(128.f, 128.f));
  const __nv_bfloat162 r = __hfma2(q, c.s, c.nz);
  return *reinterpret_cast<const uint32_t*>(&r);
}
#endif

// A consumer thread's share of the slabs: wait for a slab's slot,
// dequantize its A fragments (NW products x 4 k-steps of 16) into one of
// DEPTH + 1 register buffers, issue the products, and once only DEPTH
// groups are in flight release the slots of the slabs whose products are
// done.
template <int BM, int BN>
struct Consumer {
  using C = Cfg<BM, BN>;
  using Frag = uint32_t[C::NW][4][4];
  unsigned char* smem;
  uint64_t *full, *empty;
  int r0;                 // the thread's weight columns r0, r0 + 1 (and + 64 j): A rows g, g + 8
  uint32_t pick;          // pick_of(q)
  int lane;
  // slots are taken and freed in order: the next slot to take and its
  // phase, the next to free, the slabs taken and not yet freed
  int st = 0, rst = 0, held = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ void slab(float (&acc)[C::NW][C::NACC], Frag& a) {
    mbar_wait(full + st, phase);
    __syncwarp();
    const uint32_t* W = reinterpret_cast<const uint32_t*>(smem + C::W_OFF + st * C::W_BYTES);
    const scale_t* S = reinterpret_cast<const scale_t*>(smem + C::S_OFF + st * C::S_BYTES);
#pragma unroll
    for (int j = 0; j < C::NW; ++j) {
      const int r = r0 + 64 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the slab's halves (k 0-31, 32-63): a group each
        ColumnScale c[2];  // columns r, r + 1
        load_scales(c, S + h * BN + r, S + (2 + h) * BN + r);
#pragma unroll
        for (int ks = 2 * h; ks < 2 * h + 2; ++ks) {
          // a[0], a[1]: k 16ks + 2q, +1 (byte q of packed row 2ks) of
          // columns r (A row g) and r + 1 (A row g + 8); a[2], a[3]: k + 8
          // (packed row 2ks + 1)
          const uint2 w0 = *reinterpret_cast<const uint2*>(W + (2 * ks) * BN + r);
          const uint2 w1 = *reinterpret_cast<const uint2*>(W + (2 * ks + 1) * BN + r);
          a[j][ks][0] = dequant2(w0.x, pick, c[0]);
          a[j][ks][1] = dequant2(w0.y, pick, c[1]);
          a[j][ks][2] = dequant2(w1.x, pick, c[0]);
          a[j][ks][3] = dequant2(w1.y, pick, c[1]);
        }
      }
    }
    const uint64_t desc = kmajor_sw128(smem + st * C::X_BYTES);
    if (++st == C::STAGES) st = 0, phase ^= 1;
    ++held;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < C::NW; ++j) Mma<BM>::run(acc[j], a[j][ks], desc + 2 * ks);
    wgmma_commit();
    wgmma_wait<C::DEPTH>();
    if (held > C::DEPTH) release();  // the oldest slab's products are done
  }
  // Free the oldest slot taken.
  __device__ __forceinline__ void release() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + rst);
    if (++rst == C::STAGES) rst = 0;
    --held;
  }
  // The products of a range: slabs [kb, ke) into acc, all of them done.
  __device__ __forceinline__ void range(float (&acc)[C::NW][C::NACC], int kb, int ke) {
    Frag a[C::DEPTH + 1];
#pragma unroll
    for (int j = 0; j < C::NW; ++j)
#pragma unroll
      for (int i = 0; i < C::NACC; ++i) acc[j][i] = 0.f;
    for (int kt = kb; kt < ke; kt += C::DEPTH + 1) {
#pragma unroll
      for (int b = 0; b <= C::DEPTH; ++b)
        if (kt + b < ke) slab(acc, a[b]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < C::NW; ++j) fence_regs(acc[j]);
#pragma unroll
    for (int d = 0; d < C::DEPTH; ++d)
      if (held > 0) release();
  }
};

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    q4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap smap,
                    const __grid_constant__ CUtensorMap zmap, const Args p) {
  using C = Cfg<BM, BN>;
  constexpr int ST = C::STAGES, NW = C::NW, NACC = C::NACC;
  // 1024-byte aligned (the 128-byte swizzle's atoms): the block has no
  // static shared memory, so its dynamic shared memory starts its window.
  // Used as declared (not rounded up through an integer), the compiler
  // keeps the shared address space: ld.shared, not generic loads.
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + ST;
  int* answer = reinterpret_cast<int*>(empty + ST);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    if (tc::smem_addr(smem) & 1023) __trap();
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, VEC ? 1 : 32);
      mbar_init(empty + s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup: its first warp works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != CONSUMERS / 32 || (VEC && lane != 0)) return;
    Walk w(p.tiles, p.ktiles, p.stream_k);
    int tile, kb, ke, st = 0;
    uint32_t phase = 0;  // of slot st; its first wait passes at once (the slots start free)
    while (w.next(tile, kb, ke)) {
      const int m0 = (tile % p.mtiles) * BM, n0 = (tile / p.mtiles) * BN;
      for (int kt = kb; kt < ke; ++kt, st = st + 1 == ST ? 0 : st + 1, phase ^= st == 0) {
        mbar_wait(empty + st, phase ^ 1);
        unsigned char* xs = smem + st * C::X_BYTES;
        unsigned char* ws = smem + C::W_OFF + st * C::W_BYTES;
        unsigned char* ss = smem + C::S_OFF + st * C::S_BYTES;
        const int k0 = kt * BK, g0 = k0 / p.gs, g1 = (k0 + BK / 2) / p.gs;
        if constexpr (VEC) {
          mbar_arrive_tx(full + st, C::TX);
          tma_2d(xs, &xmap, k0, m0, full + st);
          tma_2d(ws, &wmap, n0, kt * (BK / 8), full + st);
          tma_2d(ss, &smap, n0, g0, full + st);
          tma_2d(ss + BN * SC_BYTES, &smap, n0, g1, full + st);
          tma_2d(ss + 2 * BN * SC_BYTES, &zmap, n0, g0, full + st);
          tma_2d(ss + 3 * BN * SC_BYTES, &zmap, n0, g1, full + st);
        } else if (lane == 0) {
          mbar_arrive_tx(full + st, C::X_BYTES);
          tma_2d(xs, &xmap, k0, m0, full + st);
        } else {
          // N % 8 != 0: rows of the words and scales are not 16-byte
          // aligned; lanes 1-31 load the slab's by plain loads
          int32_t* Ws = reinterpret_cast<int32_t*>(ws);
          scale_t* Ss = reinterpret_cast<scale_t*>(ss);
          const int kp0 = k0 / 8, ng = p.K / p.gs;
#pragma unroll 4
          for (int i = lane - 1; i < (BK / 8) * BN; i += 31) {
            const int r = i / BN, c = i % BN;
            const bool ok = kp0 + r < p.K / 8 && n0 + c < p.N;
            Ws[i] = ok ? __ldg(p.qweight + (size_t)(kp0 + r) * p.N + n0 + c) : 0;
          }
#pragma unroll 4
          for (int i = lane - 1; i < 4 * BN; i += 31) {
            const int row = i / BN, c = i % BN, g = (row & 1) ? g1 : g0;
            const scale_t* src = row >> 1 ? p.zscale : p.scales;
            const bool ok = g < ng && n0 + c < p.N;
            Ss[i] = ok ? src[(size_t)g * p.N + n0 + c] : scale_t(0.f);
          }
          mbar_arrive(full + st);
        }
      }
    }
  } else {  // the consumers: warpgroup wgi takes weight columns wgi * BN / 2 ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wgi = warp >> 2, g = lane >> 2, q = lane & 3;
    Consumer<BM, BN> cs{smem, full, empty, wgi * (BN / 2) + (warp & 3) * 16 + 2 * g, pick_of(q),
                        lane};
    float acc[NW][NACC];
    bf16* Cs = reinterpret_cast<bf16*>(smem + C::C_OFF);
    Walk w(p.tiles, p.ktiles, p.stream_k);
    int tile, kb, ke;
    while (w.next(tile, kb, ke)) {
      cs.range(acc, kb, ke);
      const int m0 = (tile % p.mtiles) * BM, n0 = (tile / p.mtiles) * BN;

      // a part of the tile (stream-K): this block's first (slot 0) or last
      // (slot 1) range; the partial sums stay in the accumulators' layout,
      // thread by thread, and the tile's last block adds them
      const bool emit = finish_piece<1>(
          w, tile, kb, ke, p.ticket, answer, tid, CONSUMERS,
          [&](int slot) {
            float4* mine =
                reinterpret_cast<float4*>(p.part + (size_t)(2 * blockIdx.x + slot) * BM * BN) +
                tid;
#pragma unroll
            for (int j = 0; j < NW; ++j)
#pragma unroll
              for (int i = 0; i < NACC / 4; ++i)
                mine[(j * (NACC / 4) + i) * CONSUMERS] = make_float4(
                    acc[j][4 * i], acc[j][4 * i + 1], acc[j][4 * i + 2], acc[j][4 * i + 3]);
          },
          [&](int blk, int, bool first) {
            const float4* src = reinterpret_cast<const float4*>(
                                    p.part + (size_t)(2 * blk + w.slot_of(blk, tile)) * BM * BN) +
                                tid;
#pragma unroll
            for (int j = 0; j < NW; ++j)
#pragma unroll
              for (int i = 0; i < NACC / 4; ++i) {
                const float4 v = __ldcg(src + (j * (NACC / 4) + i) * CONSUMERS);
                float* x = acc[j] + 4 * i;
                if (first) x[0] = x[1] = x[2] = x[3] = 0.f;
                x[0] += v.x, x[1] += v.y, x[2] += v.z, x[3] += v.w;
              }
          });
      if (!emit) continue;

      // the output tile: bf16 in registers, transposed through shared memory
      // (Cs[m][n]), out in 16-byte stores
      bar_sync(1, CONSUMERS);  // the last tile's rows have left Cs
      // acc[j][4i + e]: row 8i + 2q + (e & 1) of x, column r0 + 64j + (e >> 1)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int i = 0; i < NACC / 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<uint32_t*>(Cs + (8 * i + 2 * q + e) * C::C_LD + cs.r0 + 64 * j) =
                tc::pack_bf16(acc[j][4 * i + e], acc[j][4 * i + 2 + e]);
      bar_sync(1, CONSUMERS);
      for (int i = tid; i < BM * (BN / 8); i += CONSUMERS) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const int gm = m0 + r, gn = n0 + c;
        if (gm >= p.M) break;  // rows only grow with i
        if constexpr (VEC) {
          if (gn < p.N)
            *reinterpret_cast<uint4*>(p.out + (size_t)gm * p.N + gn) =
                *reinterpret_cast<const uint4*>(Cs + r * C::C_LD + c);
        } else {
          for (int e = 0; e < 8 && gn + e < p.N; ++e)
            p.out[(size_t)gm * p.N + gn + e] = Cs[r * C::C_LD + c + e];
        }
      }
    }
  }
}

template <int BM, int BN, bool VEC>
cudaError_t launch(const CUtensorMap (&maps)[4], const Args& p, int grid, cudaStream_t st) {
  using C = Cfg<BM, BN>;
  static const cudaError_t ok = allow_smem(q4_wgmma_kernel<BM, BN, VEC>, C::SMEM);
  if (ok != cudaSuccess) return ok;
  q4_wgmma_kernel<BM, BN, VEC><<<grid, THREADS, C::SMEM, st>>>(maps[0], maps[1], maps[2],
                                                                  maps[3], p);
  return cudaGetLastError();
}

// The tile shapes q4_matmul_plan chooses from: 64 x 256, 128 x 128, 256 x 128.
template <bool VEC>
cudaError_t launch_tile(int bm, int bn, const CUtensorMap (&maps)[4], const Args& p, int grid,
                        cudaStream_t st) {
  if (bm == 64 && bn == 256) return launch<64, 256, VEC>(maps, p, grid, st);
  if (bm == 128 && bn == 128) return launch<128, 128, VEC>(maps, p, grid, st);
  if (bm == 256 && bn == 128) return launch<256, 128, VEC>(maps, p, grid, st);
  return cudaErrorInvalidValue;
}

SCALE_NS_END
}  // namespace wg
