// K4's kernel on Hopper (dense_gemv.cu, entry dense_gemv_launch): the bf16
// lm_head product out [M, V] f32 = x [M, K] bf16 @ w [K, V] bf16 with f32
// sums, at any M (decode at 1 row, the serving engine's 8-row step, a
// 40-row speculative verify step, a perplexity chunk of ~1919 rows) and any
// V (an odd vocab included).
//
// Replaces the TPU kernel exllama_tpu/ops/dense.py:_kernel (:25, launched
// at dense.py:56), and the plain product the JAX package leaves to jnp.dot
// above 32 rows (dense.py:220-221); its parent on this card is the stream-K
// loop of dense_stream.cuh (entry dense_gemv_stream_launch, chip_smoke.py's
// yardstick only; K5 keeps that loop).
//
// Bound on the H100: bytes at decode rows (K*V*2 bytes of w read once for
// 2*M*K*V operations: 78 us for Llama-7B's 4096 x 32000 head at 3.35 TB/s),
// operations at a long perplexity chunk.
//
// Design. The product is taken transposed, out^T = w^T x^T (hopper.cuh):
//   - w is wgmma's A operand: TMA loads each 64-deep slab of a 256-column
//     tile as four [64 k, 64 v] boxes, 128-byte swizzled, into a ring of
//     ~200 KB in flight an SM, issued by one producer thread; each consumer
//     warp takes its A fragment (16 v x 16 k) from the slab by
//     ldmatrix.trans (w is v-contiguous there; the swizzle makes the eight
//     rows of each 8 x 8 matrix fall in eight different banks);
//   - x's rows are wgmma's N: the row tile (8, 32 or 64) is chosen by M
//     (ops/dense.py:dense_plan), and x's [BM, 64] slab comes by TMA, K-major
//     and swizzled, with the rows past M zero-filled by TMA;
//   - a persistent grid, one block an SM, walking its output tiles (row
//     tile fastest: the blocks in flight share their w columns in L2) or,
//     where the tiles do not fill the card, its stream-K range of (tile,
//     slab) units; a tile cut between blocks leaves each block's f32
//     partial sums in a scratch slot and the tile's last block adds them in
//     the order of k (hopper.cuh: finish_piece): the same bits in every run,
//     graphed or eager, and no float atomics. The epilogue stores f32 from
//     the accumulators.
// A V that is not a multiple of 8 leaves w's rows off 16-byte boundaries,
// which TMA needs: the variant VEC = false copies each row's 256 columns by
// 16-byte cp.async from its start rounded down (33 chunks, the producer
// warpgroup's 128 threads, completion on the slot's mbarrier through
// cp.async.mbarrier.arrive) and the consumers build their A fragments from
// the copied rows at each row's offset by 2-byte loads. The launcher
// chooses it by shape.
#pragma once

#include "hopper.cuh"

namespace dwg {

using namespace hop;

constexpr int BK = 64, BV = 256;
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
constexpr int SMEM_MAX = 232448;
constexpr int W_LD = BV + 8;  // VEC = false: a copied row's elements (33 chunks of 16 bytes)

template <int BM>
struct Cfg {
  static constexpr int NW = BV / 128;          // 64-column products a consumer warpgroup
  static constexpr int NACC = BM / 2;          // f32 accumulators a thread a product
  static constexpr int W_BYTES = BK * W_LD * 2;  // a slab of w (VEC: four 8 KB boxes)
  static constexpr int X_BYTES = BM * BK * 2;    // x's slab, swizzled
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int FIT = (SMEM_MAX - 512) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int X_OFF = STAGES * W_BYTES;  // both 1024-byte aligned
  static constexpr int BAR_OFF = X_OFF + STAGES * X_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 16;
  static constexpr int PIECE = BM * BV;  // f32 of a stream-K piece
  static_assert(STAGES >= 4 && SMEM <= SMEM_MAX && W_BYTES % 1024 == 0,
                "shared memory of one block");
};

struct Args {
  const bf16* w;          // [K, V] (read here only by the VEC = false producer)
  float* out;             // [M, V]
  float* part;            // stream-K: [grid][2][PIECE] f32
  unsigned int* ticket;   // stream-K: one zero a tile
  int M, K, V;
  int mtiles, tiles, ktiles, stream_k;
};

// The producer warpgroup: w's and x's slabs into the ring. VEC: thread 0
// alone, by TMA. Else thread 0 loads x by TMA and all 128 threads copy w's
// rows by cp.async.
template <int BM, bool VEC>
__device__ __forceinline__ void produce(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                        const Args& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int pt) {
  using C = Cfg<BM>;
  Walk w(p.tiles, p.ktiles, p.stream_k);
  int tile, kb, ke, st = 0;
  uint32_t phase = 0;  // of slot st; its first wait passes at once (the slots start free)
  if (pt == 0) {  // the maps this launch encoded
    prefetch_map(xmap);
    if constexpr (VEC) prefetch_map(wmap);
  }
  while (w.next(tile, kb, ke)) {
    const int m0 = (tile % p.mtiles) * BM, n0 = (tile / p.mtiles) * BV;
    for (int kt = kb; kt < ke; ++kt) {
      mbar_wait(empty + st, phase ^ 1);
      unsigned char* ws = smem + st * C::W_BYTES;
      unsigned char* xs = smem + C::X_OFF + st * C::X_BYTES;
      const int k0 = kt * BK;
      if constexpr (VEC) {
        mbar_arrive_tx(full + st, BK * BV * 2 + C::X_BYTES);
#pragma unroll
        for (int b = 0; b < BV / 64; ++b) tma_2d(ws + b * 8192, wmap, n0 + 64 * b, k0, full + st);
        tma_2d(xs, xmap, k0, m0, full + st);
      } else {
        if (pt == 0) {
          mbar_arrive_tx(full + st, C::X_BYTES);
          tma_2d(xs, xmap, k0, m0, full + st);
        }
        bf16* raw = reinterpret_cast<bf16*>(ws);
        constexpr int CH = BV / 8 + 1;  // chunks of a row, from its start rounded down
        const int seg = min(BV, p.V - n0);
        for (int i = pt; i < BK * CH; i += 128) {
          const int r = i / CH, c = i % CH;
          const bf16* row = p.w + (size_t)(k0 + r) * p.V + n0;
          const unsigned char* src =
              reinterpret_cast<const unsigned char*>((uintptr_t)row & ~(uintptr_t)15) + c * 16;
          const bool ok = k0 + r < p.K && src < reinterpret_cast<const unsigned char*>(row + seg);
          tc::cp_async16(raw + r * W_LD + c * 8, ok ? (const void*)src : (const void*)p.w,
                         ok ? 16 : 0);
        }
        mbar_arrive_cp_async(full + st);
      }
      if (++st == C::STAGES) st = 0, phase ^= 1;
    }
  }
}

// Warp (w % 4)'s A fragment of product j at k-step ks: w^T's rows v = vb ..
// vb + 15 (vb = the warp's first column in the tile), k = 16 ks .. + 15.
template <bool VEC>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const unsigned char* ws, int vb, int ks,
                                       int lane, int shift_base, int vstep) {
  if constexpr (VEC) {
    // matrix i of ldmatrix.x4: k + 8 (i >> 1), v + 8 (i & 1); lane l gives
    // row l % 8 of matrix l / 8; .trans hands each thread A's (v, k) pairs
    const int i = lane >> 3, k = 16 * ks + (lane & 7) + ((i >> 1) << 3);
    const int v = vb + ((i & 1) << 3);
    tc::ldmatrix_x4_trans(a, ws + (v >> 6) * 8192 + sw128(k, (v & 63) >> 3));
  } else {
    // the copied rows: element (k, v) at raw[k][shift(k) + v], shift(k) =
    // (shift_base + k * vstep) % 8 (row k's start past its 16-byte boundary)
    const unsigned short* raw = reinterpret_cast<const unsigned short*>(ws);
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // k + 8h
      const int k = 16 * ks + 2 * q + 8 * h;
      const int s0 = (shift_base + k * vstep) & 7, s1 = (shift_base + (k + 1) * vstep) & 7;
#pragma unroll
      for (int u = 0; u < 2; ++u) {  // v + 8u
        const int v = vb + g + 8 * u;
        a[2 * h + u] = (uint32_t)raw[k * W_LD + s0 + v] | (uint32_t)raw[(k + 1) * W_LD + s1 + v] << 16;
      }
    }
  }
}

template <int BM, bool VEC>
__device__ __forceinline__ void consume(const Args& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int* answer, int tid) {
  using C = Cfg<BM>;
  constexpr int NW = C::NW, NACC = C::NACC;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int v0 = (warp >> 2) * (BV / 2) + (warp & 3) * 16;  // + 64j: the warp's A rows
  float acc[NW][NACC];
  Walk w(p.tiles, p.ktiles, p.stream_k);
  int tile, kb, ke, st = 0;
  uint32_t phase = 0;
  while (w.next(tile, kb, ke)) {
    const int m0 = (tile % p.mtiles) * BM, n0 = (tile / p.mtiles) * BV;
    // VEC = false: row k0 + k of the tile starts (shift_base + k * vstep) % 8
    // elements past a 16-byte boundary
    const int vstep = p.V & 7;
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[j][i] = 0.f;
    for (int kt = kb; kt < ke; ++kt) {
      mbar_wait(full + st, phase);
      const unsigned char* ws = smem + st * C::W_BYTES;
      const uint64_t desc = kmajor_sw128(smem + C::X_OFF + st * C::X_BYTES);
      const int shift_base =
          (int)((((uintptr_t)p.w >> 1) + (size_t)kt * BK * p.V + n0) & 7);
      uint32_t a[NW][4][4];
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          a_frag<VEC>(a[j][ks], ws, v0 + 64 * j, ks, lane, shift_base, vstep);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < NW; ++j) Mma<BM>::run(acc[j], a[j][ks], desc + 2 * ks);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NW; ++j) fence_regs(acc[j]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
      if (++st == C::STAGES) st = 0, phase ^= 1;
    }

    const int rows = p.M - m0;  // of this row tile
    const bool emit = finish_piece<1>(
        w, tile, kb, ke, p.ticket, answer, tid, CONSUMERS,
        [&](int slot) {  // the partial sums in the fragments' layout, real rows only
          float4* mine =
              reinterpret_cast<float4*>(p.part + (size_t)(2 * blockIdx.x + slot) * C::PIECE) + tid;
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int i = 0; i < NACC / 4; ++i)
              if (8 * i < rows)
                mine[(j * (NACC / 4) + i) * CONSUMERS] = make_float4(
                    acc[j][4 * i], acc[j][4 * i + 1], acc[j][4 * i + 2], acc[j][4 * i + 3]);
        },
        [&](int blk, int, bool first) {
          const float4* src = reinterpret_cast<const float4*>(
                                  p.part + (size_t)(2 * blk + w.slot_of(blk, tile)) * C::PIECE) +
                              tid;
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int i = 0; i < NACC / 4; ++i)
              if (8 * i < rows) {
                const float4 v = __ldcg(src + (j * (NACC / 4) + i) * CONSUMERS);
                float* a = acc[j] + 4 * i;
                if (first) a[0] = a[1] = a[2] = a[3] = 0.f;
                a[0] += v.x, a[1] += v.y, a[2] += v.z, a[3] += v.w;
              }
        });
    if (!emit) continue;

    // acc[j][4i + e]: x row m0 + 8i + 2q + (e & 1), column v0 + 64j + g (+ 8 for e >= 2)
#pragma unroll
    for (int i = 0; i < NACC / 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * i + 2 * q + e;
        if (m >= rows) continue;
        float* o = p.out + (size_t)(m0 + m) * p.V;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int c = n0 + v0 + 64 * j + g;
          if (c < p.V) o[c] = acc[j][4 * i + e];
          if (c + 8 < p.V) o[c + 8] = acc[j][4 * i + 2 + e];
        }
      }
  }
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    dense_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const Args p) {
  using C = Cfg<BM>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  int* answer = reinterpret_cast<int*>(empty + C::STAGES);
  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid == 0) {
    if (tc::smem_addr(smem) & 1023) __trap();
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, VEC ? 1 : 1 + 128);  // the TMA thread; the cp.async copies
      mbar_init(empty + s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - CONSUMERS;
    if (!VEC || pt == 0) produce<BM, VEC>(&xmap, &wmap, p, smem, full, empty, pt);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<BM, VEC>(p, smem, full, empty, answer, tid);
  }
}

template <int BM, bool VEC>
cudaError_t launch(const CUtensorMap (&maps)[2], const Args& p, int grid, cudaStream_t st) {
  using C = Cfg<BM>;
  static const cudaError_t ok = allow_smem(dense_wg_kernel<BM, VEC>, C::SMEM);
  if (ok != cudaSuccess) return ok;
  dense_wg_kernel<BM, VEC><<<grid, THREADS, C::SMEM, st>>>(maps[0], maps[1], p);
  return cudaGetLastError();
}

}  // namespace dwg
