// K6 and K7 on Hopper, in the exact GEMV mode: the fused decode MLP
// (q4_mlp.cu, entry q4_mlp_launch) and the fused decode layer (layer_tail.cu,
// entry layer_tail_launch) as one persistent, warp-specialised kernel a
// launch whose GEMV phases run K1's Hopper mainloop (q4_gemv_wg.cuh) and
// whose weights stream across the grid barriers.
//
// Replaces, with the kernels that include it, the TPU kernels
// exllama_tpu/ops/mlp.py:_q4_mlp_kernel (K6) and
// exllama_tpu/ops/attn_block.py:_layer_tail_kernel (K7). Their parents on
// this card, the streaming GEMV phases of q4_stream.cuh (fused_layer.cuh),
// stay reachable only through q4_mlp_stream_launch and
// layer_tail_stream_launch (chip_smoke.py's yardsticks).
//
// Bound on the H100: bytes (the 4-bit weights once, the KV cache once; at
// Llama-7B, B = 1, past 2000 ~114 MB for a whole layer, 34 us at 3.35 TB/s).
// The parent streamed each phase on up to four blocks an SM that each
// issued their own cp.async copies, paid a ramp and a grid barrier over up
// to 528 blocks a phase, and put only the first few slabs of the next phase
// in flight before each barrier. Design:
//   - one cooperative block an SM (132 on an H100), 384 threads: two
//     consumer warpgroups (256 threads, setmaxnreg 224) and a producer
//     warpgroup (setmaxnreg 56): warp 8 streams every GEMV
//     phase's weight slabs (the packed words [8, 256] and the halves' scale
//     and zero-scale rows) by TMA into a ring of mbarrier slots, phase after
//     phase from the launch's start: no weight depends on an earlier phase,
//     so the next phase's slabs fill the ring while the consumers wait at a
//     grid barrier or run attention; warp 9 loads each slab's x rows by TMA
//     ([BM rows, 64 k], 128-byte swizzled, zeros past M), but only once the
//     grid barrier that x follows has completed (it reads the grid's counter
//     with acquire, then fence.proxy.async: x was stored by other blocks'
//     threads and is read here through the async proxy), with the slab's
//     norm weights beside them;
//   - each slab is staged in place before its products: bf16(x * rs * w)
//     under the norm (the JAX rounding order: the normed row is rounded
//     before the product; the rows' rs = 1 / sqrt(mean(x^2) + eps) computed
//     by the consumers from the whole rows at the phase's start),
//     silu(gate) * up for the down projection (the gate and up boxes of
//     gate|up's scratch, so no pass and no barrier of its own between
//     gate|up and down), x as it is elsewhere; beside the rows each row's
//     sum over each 32-deep half; then fence.proxy.async. At a row tile of
//     8 the producer warpgroup's warps 10 and 11 stage the slabs in turns
//     (off the consumers' path: staging there cost K6 at one row 0.059 ->
//     0.088 ms); at 16 and 32 rows the consumers stage each slab, a 16-byte
//     chunk a thread, and a named barrier among them precedes the products
//     (two warps staged 32 rows too slowly: K6 at 32 rows 0.170 -> 0.109);
//   - a GEMV phase is K1's loop (k1wg::slab_loop, shared with K1's own
//     kernel; this header gives it the ring, PhaseRing): out^T = W^T x^T
//     with the raw nibbles of 64 weight columns as wgmma's register A (bf16
//     128 + q by the exponent trick) and x's rows as its N (a row tile of 8,
//     16 or 32), the group fold acc += s * p - (zs + 128 s) * sum(x_half),
//     stream-K
//     over the phase's (256-column tile, 64-deep slab) units on the first
//     min(grid, units) blocks, a tile cut between blocks added by its first
//     block in the order of k (finish_head): the same bits in every run,
//     graphed or eager; the epilogue stores bf16, or bf16(res +
//     bf16(v)) where the phase has a residual;
//   - the grid barrier is the consumers' alone: named barrier 1 inside the
//     block, one arrival a block on the counter; the producer warps never
//     arrive, so they never hold it back, and wait only on ring slots and,
//     before x, on the counter;
//   - attention (K7's phase C) is the kernel's Attn, run by the consumer
//     warps between two grid barriers (layer_tail.cu), its K / V chunks
//     brought by the x warp (warp 9) into a ring of their own (TMA and
//     cp.async.bulk; the cache is an input, so they wait for no barrier)
//     beside the GEMV ring, which keeps streaming the next phase's weights.
// Rounding order of each phase: phases with the norm (K7's qkv, K6's and
// K7's gate|up) round the normed row to bf16 before the products; down's x
// is silu(gate) * up with the separate path's casts (common.cuh:silu_mul);
// each GEMV output is rounded to bf16 once, a residual added to it in f32
// and rounded again. ops/mlp.py:fused_wg_gemv_split_plain writes the same
// decomposition in plain code.
#pragma once

#include "q4_gemv_wg.cuh"
#include "tma_map.cuh"

namespace {
namespace fwg {

using namespace hop;

constexpr int BK = 64, BN = 256;
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
constexpr int SMEM_MAX = 232448;
// maps: up to 18 of the GEMV phases, and one of attention's (the K cache)
constexpr int MAX_PHASES = 4, MAX_MAPS = 19, ATT_MAP = MAX_MAPS - 1;
// setmaxnreg: what the producer warpgroup gives up covers what the
// consumers take, within the block's 168 registers a thread at launch (an
// .inc that cannot be covered never returns)
constexpr int REGS_PRODUCER = 56, REGS_CONSUMER = 224;
static_assert(128 * REGS_PRODUCER + CONSUMERS * REGS_CONSUMER <= THREADS * 168,
              "setmaxnreg within the block's registers");
// named barriers: 1 the consumers' (the staged slabs, the grid barrier, the
// stream-K ends, attention); 3 the consumers' hand-over of a norm phase's
// row scales to the staging warps (row tile 8)
constexpr int BAR_RS = 3, STAGERS = 2;

// Who stages x at row tile BM: the consumers (16, 32 rows) or warps 10-11.
template <int BM>
__host__ __device__ constexpr bool consumers_stage() { return BM >= 16; }

template <int BM, int ATT_BYTES, int ATT_MIN>
struct Cfg {
  static constexpr int NW = BN / 128;           // 64-column products a consumer warpgroup
  static constexpr int NACC = BM / 2;           // f32 accumulators a thread a product
  static constexpr int X_BYTES = BM * BK * 2;   // x's slab: BM rows of 128 bytes, swizzled
  static constexpr int W_BYTES = BK / 8 * BN * 4;     // the packed words [8][BN]
  static constexpr int S_BYTES = 4 * BN * SC_BYTES;   // the halves' scale rows, zero-scale rows
  static constexpr int N_BYTES = BK * 2;        // the slab's norm weights
  static constexpr int U_BYTES = 2 * BM * 4;    // a row's sum over each half
  // x, the up rows of down's x, words, scales, norm weights, sums
  static constexpr int STAGE = 2 * X_BYTES + W_BYTES + S_BYTES + N_BYTES + U_BYTES;
  // what a block's shared memory holds besides the GEMV ring and attention:
  // the barriers, the row scales and sums, and the base's alignment
  static constexpr int OTHER = 3 * 12 * 8 + 16 + 32 * 4 + CONSUMERS * 4 + 2 * 1024;
  // the GEMV ring: at most 12 slots (~120-200 KB in flight an SM), and with
  // attention at most 8 (an 8-slot ring read the same,
  // scripts/fused_wg_ablation.py stages8), the rest to attention's ring
  static constexpr int FIT = (SMEM_MAX - OTHER - ATT_BYTES - ATT_MIN) / STAGE;
  static constexpr int CAP = ATT_MIN > 0 ? 8 : 12;
  static constexpr int STAGES = FIT < CAP ? FIT : CAP;
  static constexpr int X2_OFF = STAGES * X_BYTES;  // x slots first: 1024-byte aligned
  static constexpr int W_OFF = X2_OFF + STAGES * X_BYTES;
  static constexpr int S_OFF = W_OFF + STAGES * W_BYTES;
  static constexpr int N_OFF = S_OFF + STAGES * S_BYTES;
  static constexpr int U_OFF = N_OFF + STAGES * N_BYTES;
  static constexpr int ATT_OFF = (U_OFF + STAGES * U_BYTES + 1023) & ~1023;  // TMA's swizzle atoms
  static constexpr int ATT_RING =
      ATT_MIN > 0 ? (SMEM_MAX - OTHER - ATT_OFF - ATT_BYTES) & ~1023 : 0;
  static constexpr int BAR_OFF = ATT_OFF + ATT_BYTES + ATT_RING;
  static constexpr int RS_OFF = BAR_OFF + 3 * STAGES * 8 + 16;  // full, empty, xfull
  static constexpr int RED_OFF = RS_OFF + 32 * 4;
  static constexpr int SMEM = RED_OFF + CONSUMERS * 4;  // red: [8 warps][32] f32
  static constexpr int PIECE = BM * BN;  // f32 of a stream-K piece
  static_assert(STAGES >= 6 && SMEM + 1024 <= SMEM_MAX && ATT_BYTES % 1024 == 0 &&
                    ATT_RING >= ATT_MIN,
                "shared memory of one block");
};

// One GEMV phase: out [M, N] = x [M, K] @ W, W as stored (packed nibbles
// [K/8, N] int32, scale and zero-scale rows [K/gs, N]).
struct Gemv {
  int K, N, tiles, ktiles, grid;  // grid: the blocks that share its units
  int w;                 // maps: the words w, the scales w + 1, the zero-scales w + 2
  int x;                 // map of x's rows [M, ldx], boxes [BM, 64] swizzled
  int nmap;              // map of the norm weights (boxes of 64), or -1
  int glu;               // > 0: x = silu_mul(x[:, k], x[:, glu + k])
  int dep;               // the grid barrier x follows (0: x is an input)
  const bf16* xg;        // x in device memory (the norm's sums)
  int ldx;
  const bf16* norm_w;    // [K] or NULL
  bf16* out;             // [M, ldo]
  const bf16* res;       // [M, ldo] or NULL: out = bf16(res + bf16(x @ W))
  int ldo;
};

struct Plan {
  Gemv g[MAX_PHASES];
  int nphases;
  int attn_at;           // attention runs before GEMV phase attn_at (-1: none)
  int M, gs;
  float eps;
  unsigned int* bar;     // the grid barrier's counter and its exit count: zeros,
                         // which the launch leaves zero
  float* part;           // stream-K pieces: [grid][2][PIECE] f32
  unsigned int* ticket;  // one zero a tile of the widest phase
};

struct __align__(64) Maps {
  CUtensorMap m[MAX_MAPS];
};

// K6: no attention phase. An Attn (K7's: layer_tail.cu, TailAttn) has
// BYTES of shared memory of its own (1024-byte aligned) and a ring of at
// least RING_MIN bytes after them, which takes what the GEMV ring leaves
// (Cfg::ATT_RING); init (its barriers, thread 0), produce (its loads, the x
// warp's lane 0, before the x of GEMV phase attn_at) and run (the
// consumers, before that phase).
struct NoAttn {
  static constexpr int BYTES = 0, RING_MIN = 0;
  struct Params {};
  static __device__ __forceinline__ void init(unsigned char*) {}
  static __device__ __forceinline__ void produce(const Maps&, const Params&, unsigned char*,
                                                 int) {}
  static __device__ __forceinline__ void run(const Params&, unsigned char*, int) {}
};

// Spin until the grid barrier's counter reaches target (acquire). Built with
// -DWG_WATCHDOG=1, a wait that never ends traps, as hop::mbar_wait does.
__device__ __forceinline__ void wait_count(const unsigned int* bar, unsigned int target) {
#if WG_WATCHDOG
  long long spins = 0;
#endif
  for (;;) {
    unsigned int v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(bar) : "memory");
    if (v >= target) return;
    __nanosleep(32);
#if WG_WATCHDOG
    if (++spins > (1ll << 26)) __trap();
#endif
  }
}

// Generic-proxy stores to device memory ordered with the async proxy (TMA)
// on either side of a grid barrier.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The consumers' grid barrier: every consumer thread's stores are fenced,
// named barrier 1, one arrival a block; barrier number e completes when the
// counter reaches e * gridDim.x.
__device__ __forceinline__ void grid_sync(unsigned int* bar, unsigned int& epoch, int tid) {
  fence_proxy_async_global();
  __threadfence();
  bar_sync(1, CONSUMERS);
  epoch += 1;
  if (tid == 0) {
    atomicAdd(bar, 1u);
    wait_count(bar, epoch * gridDim.x);
    __threadfence();
  }
  bar_sync(1, CONSUMERS);
}

// The end of a block's range [kb, ke) of tile `tile` in a GEMV phase. A
// tile cut between blocks is added by its FIRST block (the one whose range
// holds the tile's first slab: it reaches that slab at the end of its range,
// after the tile's other blocks have reached theirs at the starts of
// theirs), so no block waits on a ticket's round trip in the middle of its
// walk: the others `publish` their piece to scratch slot 0 and count it on
// the tile's ticket (a release add, not waited for); the first block
// waits for the count, adds the pieces of blocks first + 1 .. last to its
// own in the order of k (`combine(blk, n)`, n <= BATCH loaded together),
// resets the ticket and returns true: it writes the tile. A whole tile
// returns true at once. The same sums in the same order as
// hop::finish_piece's: the same bits in every run.
template <int BATCH, class Publish, class Combine>
__device__ __forceinline__ bool finish_head(const Walk& w, int tile, int kb, int ke,
                                            unsigned int* ticket, int tid, Publish publish,
                                            Combine combine) {
  if (kb == 0 && ke == w.KT) return true;
  const int first = w.first_of(tile), last = w.last_of(tile);
  if ((int)blockIdx.x != first) {
    publish(0);  // a piece that does not hold the tile's first slab: the block's first range
    bar_sync(1, CONSUMERS);
    if (tid == 0)
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(ticket + tile) : "memory");
    return false;
  }
  if (tid == 0) {
    wait_count(ticket + tile, (unsigned int)(last - first));
    ticket[tile] = 0u;  // ready for the next phase or launch
  }
  bar_sync(1, CONSUMERS);
  for (int blk = first + 1; blk <= last; blk += BATCH)  // in the order of k
    combine(blk, min(BATCH, last + 1 - blk));
  return true;
}

// Warp 8, one thread: every phase's weight slabs of the block's walk, in
// order, by TMA.
template <class C>
__device__ __forceinline__ void produce(const Maps& mp, const Plan& pl, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty) {
  const bool halves = pl.gs % BK != 0;  // two groups a slab: four scale rows
  const uint32_t bytes = C::W_BYTES + (halves ? 4 : 2) * BN * SC_BYTES;
  for (int ph = 0; ph < pl.nphases; ++ph)
    for (int i = 0; i < 3; ++i) prefetch_map(&mp.m[pl.g[ph].w + i]);
  int seq = 0;
  for (int ph = 0; ph < pl.nphases; ++ph) {
    const Gemv& g = pl.g[ph];
    const CUtensorMap *wm = &mp.m[g.w], *sm = &mp.m[g.w + 1], *zm = &mp.m[g.w + 2];
    Walk w(g.tiles, g.ktiles, g.grid, true);
    int tile, kb, ke;
    while (w.next(tile, kb, ke)) {
      const int n0 = tile * BN;
      for (int kt = kb; kt < ke; ++kt, ++seq) {
        const int st = seq % C::STAGES;
        mbar_wait(empty + st, ((seq / C::STAGES) & 1) ^ 1);
        unsigned char* ws = smem + C::W_OFF + st * C::W_BYTES;
        unsigned char* ss = smem + C::S_OFF + st * C::S_BYTES;
        const int k0 = kt * BK, g0 = k0 / pl.gs, g1 = (k0 + BK / 2) / pl.gs;
        mbar_arrive_tx(full + st, bytes);
        tma_2d(ws, wm, n0, kt * (BK / 8), full + st);
        tma_2d(ss, sm, n0, g0, full + st);
        tma_2d(ss + 2 * BN * SC_BYTES, zm, n0, g0, full + st);
        if (halves) {
          tma_2d(ss + BN * SC_BYTES, sm, n0, g1, full + st);
          tma_2d(ss + 3 * BN * SC_BYTES, zm, n0, g1, full + st);
        }
      }
    }
  }
}

// Warp 9, one thread: each slab's x rows by TMA (and, for down, the up rows
// beside them; under the norm, the slab's norm weights), each phase's after
// the grid barrier its x follows; before the x of phase attn_at, the
// attention phase's loads (Attn::produce: they need no barrier).
template <class C, class Attn>
__device__ __forceinline__ void load_x(const Maps& mp, const Plan& pl,
                                       const typename Attn::Params& ap, unsigned char* smem,
                                       uint64_t* xfull, uint64_t* empty) {
  int seq = 0;
  for (int ph = 0; ph < pl.nphases; ++ph) {
    const Gemv& g = pl.g[ph];
    if (ph == pl.attn_at) Attn::produce(mp, ap, smem + C::ATT_OFF, C::ATT_RING);
    const CUtensorMap* xm = &mp.m[g.x];
    const CUtensorMap* nm = g.nmap >= 0 ? &mp.m[g.nmap] : nullptr;
    prefetch_map(xm);
    if (nm != nullptr) prefetch_map(nm);
    bool ready = g.dep == 0;
    Walk w(g.tiles, g.ktiles, g.grid, true);
    int tile, kb, ke;
    while (w.next(tile, kb, ke)) {
      for (int kt = kb; kt < ke; ++kt, ++seq) {
        const int st = seq % C::STAGES;
        mbar_wait(empty + st, ((seq / C::STAGES) & 1) ^ 1);
        if (!ready) {  // x was stored by other blocks before the barrier
          wait_count(pl.bar, (unsigned int)g.dep * gridDim.x);
          fence_proxy_async_global();
          ready = true;
        }
        const int k0 = kt * BK;
        mbar_arrive_tx(xfull + st, C::X_BYTES * (g.glu ? 2 : 1) + (nm ? C::N_BYTES : 0));
        tma_2d(smem + st * C::X_BYTES, xm, k0, 0, xfull + st);
        if (g.glu) tma_2d(smem + C::X2_OFF + st * C::X_BYTES, xm, g.glu + k0, 0, xfull + st);
        if (nm != nullptr) tma_2d(smem + C::N_OFF + st * C::N_BYTES, nm, k0, 0, xfull + st);
      }
    }
  }
}

// Stage the slab of k0 in place for the products (see the header), with
// each row's sum over each half beside it; rows past M stay TMA's zeros
// (their sums are never read into a written output), k past K becomes 0.
// Item t < 8 BM: chunk t % 8 of row t / 8, by a whole warp's items at once
// (the sums' shuffles; the consumers' thread t, or a staging warp's lane
// l's l + 32 j). nws: the slab's norm weights.
template <int BM>
__device__ __forceinline__ void stage_slab(const Gemv& g, int M, unsigned char* xs,
                                           const unsigned char* xs2, const bf16* nws, float* us,
                                           int k0, const float* rs, int t) {
  if (t >= 8 * BM) return;
  const int c = t & 7, m = t >> 3, k = k0 + 8 * c;
  const bool kin = k < g.K, norm = g.norm_w != nullptr;
  float sum = 0.f;
  if (m < M) {
    uint4* at = reinterpret_cast<uint4*>(xs + sw128(m, c));
    uint4 o = *at;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
    if (!kin) {
      o = make_uint4(0u, 0u, 0u, 0u);
    } else if (g.glu) {
      const uint4 u = *reinterpret_cast<const uint4*>(xs2 + sw128(m, c));
      const uint32_t* uw = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
        const float2 uf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&uw[e]));
        ow[e] = tc::pack_bf16(silu_mul(gf.x, uf.x), silu_mul(gf.y, uf.y));
      }
    } else if (norm) {
      const uint4 wv = *reinterpret_cast<const uint4*>(nws + 8 * c);
      const uint32_t* ww = reinterpret_cast<const uint32_t*>(&wv);
      const float r = rs[m];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
        const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ww[e]));
        ow[e] = tc::pack_bf16(f.x * r * w.x, f.y * r * w.y);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
      sum += v.x + v.y;
    }
    if (!kin || g.glu || norm) *at = o;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (m < M && (c & 3) == 0) us[(c >> 2) * BM + m] = sum;
}

// rs[m] = 1 / sqrt(mean(x[m]^2) + eps) of a norm phase's x rows (in device
// memory, written earlier in the launch or an input), by the consumers
// (t = 0..255): sixteen rows at a time, each thread's loads issued before
// their use; red holds the warps' sums. At row tile 8 an arrival on BAR_RS
// hands rs to the staging warps.
template <int BM>
__device__ __forceinline__ void row_scales(const Gemv& g, const Plan& pl, float* rs, float* red,
                                           int t) {
  constexpr int R = 16, NWARP = CONSUMERS / 32;
  const int lane = t & 31, warp = t >> 5;
  for (int m0 = 0; m0 < pl.M; m0 += R) {
    float ss[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ss[r] = 0.f;
    for (int k = t * 8; k < g.K; k += CONSUMERS * 8) {
      uint4 u[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        u[r] = m0 + r < pl.M
                   ? __ldcg(reinterpret_cast<const uint4*>(g.xg + (size_t)(m0 + r) * g.ldx + k))
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[r]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          ss[r] += f.x * f.x + f.y * f.y;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = warp_sum(ss[r]);
      if (lane == 0 && m0 + r < pl.M) red[warp * 32 + m0 + r] = v;
    }
  }
  bar_sync(1, CONSUMERS);
  if (t < pl.M) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) v += red[w * 32 + t];
    rs[t] = 1.0f / sqrtf(v / (float)g.K + pl.eps);
  }
  if constexpr (consumers_stage<BM>()) {
    bar_sync(1, CONSUMERS);
  } else {
    __threadfence_block();
    bar_arrive(BAR_RS, CONSUMERS + 32 * STAGERS);
  }
}

// Warps 10 and 11 (row tile 8): slab s of the block's walk is staged by
// warp 10 + s % 2 before its arrival on the slab's full barrier.
template <int BM, class C>
__device__ __forceinline__ void stage(const Plan& pl, unsigned char* smem, uint64_t* full,
                                      uint64_t* xfull, int s, int lane) {
  const float* rs = reinterpret_cast<const float*>(smem + C::RS_OFF);
  int seq = 0;
  for (int ph = 0; ph < pl.nphases; ++ph) {
    const Gemv& g = pl.g[ph];
    if (g.norm_w != nullptr) bar_sync(BAR_RS, CONSUMERS + 32 * STAGERS);  // the rows' rs
    Walk w(g.tiles, g.ktiles, g.grid, true);
    int tile, kb, ke;
    while (w.next(tile, kb, ke)) {
      for (int kt = kb; kt < ke; ++kt, ++seq) {
        if (seq % STAGERS != s) continue;
        const int st = seq % C::STAGES;
        mbar_wait(xfull + st, (seq / C::STAGES) & 1);
#pragma unroll
        for (int j = 0; j < BM / 4; ++j) {  // rows lane / 8 + 4 j
          if (4 * j >= pl.M) break;         // the same for the whole warp
          stage_slab<BM>(g, pl.M, smem + st * C::X_BYTES, smem + C::X2_OFF + st * C::X_BYTES,
                         reinterpret_cast<const bf16*>(smem + C::N_OFF + st * C::N_BYTES),
                         reinterpret_cast<float*>(smem + C::U_OFF + st * C::U_BYTES), kt * BK,
                         rs, lane + 32 * j);
        }
        fence_proxy_async();  // the rows are read by wgmma (the async proxy)
        __syncwarp();
        if (lane == 0) mbar_arrive(full + st);
      }
    }
  }
}

// A GEMV phase's ring (k1wg::slab_loop's R): the slots of Cfg, in the
// order of the block's walk over every phase (seq); a slab is ready once
// its x rows and weights have landed and x is staged (at 16 and 32 rows by
// the consumers here, a 16-byte chunk a thread, then a named barrier among
// them; at 8 rows by warps 10-11 before the weights' barrier completes).
template <int BM, class C>
struct PhaseRing {
  static constexpr int SROW = BN;
  unsigned char* smem;
  uint64_t *full, *xfull, *empty;
  const Gemv& g;
  const float* rs;  // the phase's row scales (norm phases)
  int M, tid;
  int& seq;
  __device__ __forceinline__ int slot() const { return seq % C::STAGES; }
  __device__ __forceinline__ void advance() { ++seq; }
  __device__ __forceinline__ void wait(int kt) {
    const int st = seq % C::STAGES;
    const uint32_t par = (seq / C::STAGES) & 1;
    mbar_wait(xfull + st, par);
    if constexpr (consumers_stage<BM>()) {
      stage_slab<BM>(g, M, smem + st * C::X_BYTES, smem + C::X2_OFF + st * C::X_BYTES,
                     reinterpret_cast<const bf16*>(smem + C::N_OFF + st * C::N_BYTES),
                     reinterpret_cast<float*>(smem + C::U_OFF + st * C::U_BYTES), kt * BK, rs,
                     tid);
      fence_proxy_async();  // the rows are read by wgmma (the async proxy)
    }
    mbar_wait(full + st, par);
    if constexpr (consumers_stage<BM>()) bar_sync(1, CONSUMERS);
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
  __device__ __forceinline__ void shifts(int, int (&)[4]) const {}
  __device__ __forceinline__ void folded(const float*, int) {}
  __device__ __forceinline__ void release(int s) { mbar_arrive(empty + s); }
};

// One GEMV phase on the consumer warpgroups: each range of the block's walk
// through K1's slab loop (q4_gemv_wg.cuh: k1wg::slab_loop, the products on
// wgmma and the group fold), then the cut tiles' combine (finish_head) and
// the epilogue. rs: the phase's row scales (norm phases).
template <int BM, bool HALVES, class C>
__device__ __forceinline__ void gemv_phase(const Gemv& g, const Plan& pl, unsigned char* smem,
                                           uint64_t* full, uint64_t* xfull, uint64_t* empty,
                                           const float* rs, int tid, int& seq) {
  constexpr int NW = C::NW, NACC = C::NACC;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const int r0 = (warp >> 2) * (BN / 2) + (warp & 3) * 16 + 2 * gq;  // A rows gq, gq + 8
  const int M = pl.M;
  float acc[NW][NACC];
  PhaseRing<BM, C> ring{smem, full, xfull, empty, g, rs, M, tid, seq};
  Walk w(g.tiles, g.ktiles, g.grid, true);
  int tile, kb, ke;
  while (w.next(tile, kb, ke)) {
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[j][i] = 0.f;
    k1wg::slab_loop<BM, true, HALVES>(acc, kb, ke, tid, ring);

    constexpr int BATCH = BM == 32 ? 2 : 4;  // pieces loaded together (registers)
    const bool emit = finish_head<BATCH>(
        w, tile, kb, ke, pl.ticket, tid,
        [&](int slot) {  // the partial sums in the fragments' layout, rows < M only
          float4* mine =
              reinterpret_cast<float4*>(pl.part + (size_t)(2 * blockIdx.x + slot) * C::PIECE) + tid;
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int i = 0; i < NACC / 4; ++i)
              if (8 * i < M)
                mine[(j * (NACC / 4) + i) * CONSUMERS] = make_float4(
                    acc[j][4 * i], acc[j][4 * i + 1], acc[j][4 * i + 2], acc[j][4 * i + 3]);
        },
        [&](int blk0, int n) {  // up to BATCH pieces, loaded together, onto acc
          float4 v[BATCH][NW][NACC / 4];
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            if (b >= n) break;
            const int blk = blk0 + b;
            const float4* src =
                reinterpret_cast<const float4*>(pl.part + (size_t)(2 * blk) * C::PIECE) + tid;
#pragma unroll
            for (int j = 0; j < NW; ++j)
#pragma unroll
              for (int i = 0; i < NACC / 4; ++i)
                if (8 * i < M) v[b][j][i] = __ldcg(src + (j * (NACC / 4) + i) * CONSUMERS);
          }
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            if (b >= n) break;
#pragma unroll
            for (int j = 0; j < NW; ++j)
#pragma unroll
              for (int i = 0; i < NACC / 4; ++i)
                if (8 * i < M) {
                  float* x = acc[j] + 4 * i;
                  const float4 t = v[b][j][i];
                  x[0] += t.x, x[1] += t.y, x[2] += t.z, x[3] += t.w;
                }
          }
        });
    if (!emit) continue;

    // the output: rows 8i + 2q + e of columns c, c + 1; every residual is
    // loaded before the first store (a store could alias them)
    const int n0 = tile * BN;
    uint32_t rv[BM / 8][2][NW];
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int m = 8 * i + 2 * q + e, c = n0 + r0 + 64 * j;
          rv[i][e][j] = g.res != nullptr && m < M && c < g.N
                            ? __ldcg(reinterpret_cast<const unsigned int*>(
                                  g.res + (size_t)m * g.ldo + c))
                            : 0u;
        }
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * i + 2 * q + e;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int c = n0 + r0 + 64 * j;
          if (c >= g.N) continue;
          float v0 = acc[j][4 * i + e], v1 = acc[j][4 * i + 2 + e];
          if (g.res != nullptr) {
            const float2 r =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv[i][e][j]));
            v0 = r.x + bf2f(f2bf(v0));
            v1 = r.y + bf2f(f2bf(v1));
          }
          *reinterpret_cast<uint32_t*>(g.out + (size_t)m * g.ldo + c) = tc::pack_bf16(v0, v1);
        }
      }
  }
}

template <int BM, bool HALVES, class Attn>
__global__ void __launch_bounds__(THREADS, 1)
    fused_wg_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Plan pl,
                    const __grid_constant__ typename Attn::Params ap) {
  using C = Cfg<BM, Attn::BYTES, Attn::RING_MIN>;
  // 1024-byte aligned (the 128-byte swizzle's atoms), used as declared so
  // that the compiler keeps the shared address space (see q4_wgmma.cuh)
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  uint64_t* xfull = empty + C::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    if (tc::smem_addr(smem) & 1023) __trap();
    for (int s = 0; s < C::STAGES; ++s) {
      // the weights' TMA (and at row tile 8 the slab's staging warp)
      mbar_init(full + s, consumers_stage<BM>() ? 1 : 2);
      mbar_init(empty + s, CONSUMERS / 32);
      mbar_init(xfull + s, 1);                   // x's rows by TMA
    }
    Attn::init(smem + C::ATT_OFF);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS_PRODUCER) : "memory");
    const int role = warp - CONSUMERS / 32;
    if (role == 0 && lane == 0) produce<C>(maps, pl, smem, full, empty);
    if (role == 1 && lane == 0) load_x<C, Attn>(maps, pl, ap, smem, xfull, empty);
    if constexpr (!consumers_stage<BM>())
      if (role >= 2) stage<BM, C>(pl, smem, full, xfull, role - 2, lane);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS_CONSUMER) : "memory");
    int seq = 0;
    unsigned int epoch = 0;
    for (int ph = 0; ph < pl.nphases; ++ph) {
      if (ph == pl.attn_at) {
        Attn::run(ap, smem + C::ATT_OFF, C::ATT_RING);
        grid_sync(pl.bar, epoch, tid);
      }
      float* rs = reinterpret_cast<float*>(smem + C::RS_OFF);
      if (pl.g[ph].norm_w != nullptr)
        row_scales<BM>(pl.g[ph], pl, rs, reinterpret_cast<float*>(smem + C::RED_OFF), tid);
      gemv_phase<BM, HALVES, C>(pl.g[ph], pl, smem, full, xfull, empty, rs, tid, seq);
      if (ph + 1 < pl.nphases) grid_sync(pl.bar, epoch, tid);
    }
    // leave the barrier's counter at zero for the next launch: the last
    // block here resets it (every block is past the last barrier, and its
    // x warp past its last wait on the counter)
    if (tid == 0 && atomicAdd(pl.bar + 1, 1u) == gridDim.x - 1) {
      pl.bar[0] = 0u;
      pl.bar[1] = 0u;
    }
  }
}

// ---------------------------------------------------------------- host side

static inline int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The row tile (wgmma's N) of m rows: 8, 16 or 32.
static inline int row_tile(int m) { return m <= 8 ? 8 : m <= 16 ? 16 : 32; }

// Append GEMV phase out = x @ W (see Gemv) to the plan: its tensor maps,
// its tiles and the blocks that share its units. x [M, ldx] bf16 in device
// memory, 16-byte aligned rows; W's words and scale rows 16-byte aligned, N
// a multiple of 8.
struct PhaseArgs {
  const void *qw, *s, *z;
  int K, N;
  const void* x;
  int ldx, glu;
  const void* norm_w;
  void* out;
  const void* res;
  int ldo;
};

static inline cudaError_t add_phase(Maps& maps, int& nmaps, Plan& pl, const PhaseArgs& a, int bm,
                                    int dep, int grid) {
  if (pl.nphases >= MAX_PHASES || nmaps + 4 + (a.norm_w != nullptr) > ATT_MAP)
    return cudaErrorInvalidValue;
  if (a.N % 8 || a.K % 32 || a.ldx % 8 || (uintptr_t)a.qw % 16 || (uintptr_t)a.s % 16 ||
      (uintptr_t)a.z % 16 || (uintptr_t)a.x % 16 || (a.res && (uintptr_t)a.res % 4) ||
      (uintptr_t)a.out % 4 || a.ldo % 2 || (uintptr_t)a.norm_w % 16)
    return cudaErrorMisalignedAddress;
  Gemv& g = pl.g[pl.nphases++];
  g.K = a.K, g.N = a.N;
  g.tiles = (a.N + BN - 1) / BN, g.ktiles = (a.K + BK - 1) / BK;
  const long long units = (long long)g.tiles * g.ktiles;
  g.grid = units < grid ? (int)units : grid;
  g.glu = a.glu, g.dep = dep;
  g.xg = (const bf16*)a.x, g.ldx = a.ldx;
  g.norm_w = (const bf16*)a.norm_w;
  g.out = (bf16*)a.out, g.res = (const bf16*)a.res, g.ldo = a.ldo;
  const CUtensorMapDataType sdt =
      SC_BYTES == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  g.w = nmaps;
  cudaError_t e = tensor_map(&maps.m[nmaps++],
                             {a.qw, (uint64_t)a.N, (uint64_t)(a.K / 8), (uint32_t)BN,
                              (uint32_t)(BK / 8), CU_TENSOR_MAP_DATA_TYPE_INT32, 4,
                              CU_TENSOR_MAP_SWIZZLE_NONE});
  if (e == cudaSuccess)
    e = tensor_map(&maps.m[nmaps++], {a.s, (uint64_t)a.N, (uint64_t)(a.K / pl.gs), (uint32_t)BN, 1u,
                                      sdt, SC_BYTES, CU_TENSOR_MAP_SWIZZLE_NONE});
  if (e == cudaSuccess)
    e = tensor_map(&maps.m[nmaps++], {a.z, (uint64_t)a.N, (uint64_t)(a.K / pl.gs), (uint32_t)BN, 1u,
                                      sdt, SC_BYTES, CU_TENSOR_MAP_SWIZZLE_NONE});
  g.x = nmaps;
  if (e == cudaSuccess)
    e = tensor_map(&maps.m[nmaps++], {a.x, (uint64_t)a.ldx, (uint64_t)pl.M, (uint32_t)BK,
                                      (uint32_t)bm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                      CU_TENSOR_MAP_SWIZZLE_128B});
  g.nmap = -1;
  if (e == cudaSuccess && a.norm_w != nullptr) {
    g.nmap = nmaps;
    e = tensor_map(&maps.m[nmaps++], {a.norm_w, (uint64_t)a.K, 1u, (uint32_t)BK, 1u,
                                      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                      CU_TENSOR_MAP_SWIZZLE_NONE});
  }
  return e;
}

template <int BM, bool HALVES, class Attn>
cudaError_t launch(const Maps& maps, const Plan& pl, const typename Attn::Params& ap, int grid,
                   cudaStream_t st) {
  using C = Cfg<BM, Attn::BYTES, Attn::RING_MIN>;
  const auto kernel = fused_wg_kernel<BM, HALVES, Attn>;
  static const cudaError_t ok = allow_smem(kernel, C::SMEM);
  if (ok != cudaSuccess) return ok;
  void* args[] = {const_cast<Maps*>(&maps), const_cast<Plan*>(&pl),
                  const_cast<typename Attn::Params*>(&ap)};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args, C::SMEM,
                                  st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The instantiations: row tile 8, 16 or 32; a fold a slab or a half slab.
template <class Attn>
cudaError_t launch_by(int bm, bool halves, const Maps& maps, const Plan& pl,
                      const typename Attn::Params& ap, int grid, cudaStream_t st) {
  if (bm == 8)
    return halves ? launch<8, true, Attn>(maps, pl, ap, grid, st)
                  : launch<8, false, Attn>(maps, pl, ap, grid, st);
  if (bm == 16)
    return halves ? launch<16, true, Attn>(maps, pl, ap, grid, st)
                  : launch<16, false, Attn>(maps, pl, ap, grid, st);
  return halves ? launch<32, true, Attn>(maps, pl, ap, grid, st)
                : launch<32, false, Attn>(maps, pl, ap, grid, st);
}

}  // namespace fwg
}  // namespace
