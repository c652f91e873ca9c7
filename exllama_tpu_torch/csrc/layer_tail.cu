// K7 layer_tail: the deferred-commit decode layer (T = 1, B <= 32) after --
// or, with phase B, including -- the qkv projection, in one launch:
//
//   [B: xn = rms_norm(h)*w_in; qkv = xn @ Wqkv; rope on q and k]
//   C: attention of each query head over cache[:, :, :past_b] plus the
//      in-flight K/V row of this step (bf16, int8 or int4 KV; GQA, left-pad
//      bias)
//   D: h' = h + bf16(attn @ Wo)
//   [E/F with the MLP: out = h' + down(silu(gate(xn')) * up(xn')),
//    xn' = rms_norm(h')*w_post; without it out = h']
//
// Replaces the TPU kernel exllama_tpu/ops/attn_block.py:_layer_tail_kernel
// (launched at attn_block.py:792), which serves the three entry points
// attn_block_o, layer_tail and layer_step; here too one __global__ with
// phase flags serves all three. Masking as attn_block.py:288-340: keys at
// s >= past_b are masked, the left-pad bias NEG_INF is added after that,
// the in-flight row is folded in at the end, l == 0 -> 1; the attention row
// is rounded to bf16 before the o-projection and the o output to bf16
// before the residual add; the MLP numerics are K6's.
//
// A quantized cache (kv_mode 1: int8 rows of D bytes; 2: int4 rows of D/2
// bytes, byte d = dims d (low nibble, q + 8) and d + D/2 (high nibble, two's
// complement); f32 scales [B, Hkv, S] for K and for V) takes K3's
// arithmetic, which is the TPU kernel's (attn_block.py:274-317): the raw
// integers in the q.k dot, the f32 score times the key's K scale and then
// 1/sqrt(D), the key's V scale on p before p is rounded to bf16, l over the
// unscaled p; the in-flight row stays bf16. The quantized caches have
// libraries of their own, built from this source with -DKV_QUANT=1 (one per
// GEMV mode), whose kernel branches at run time into the int8 or the int4
// attention phase; the bf16 libraries are the code they were (sharing one
// kernel with the quantized phases cost the bf16 attention 2-4 us on an
// H100, two kernels in one library doubled its build time). For
// PV a lane still owns head dims 4*lane..4*lane+3: with int4 lanes 0-15 take
// the low nibbles and lanes 16-31 the high nibbles of the same 64 bytes.
//
// Bound on the H100: bytes. At Llama-7B, B=1, past=2000 it streams 8.9 MB
// of o-proj, 32.8 MB of K/V (16.9 MB in int8, 8.7 MB in int4, scales
// included) and about 72 MB of MLP weights (~114 MB, ~34 us at 3.35 TB/s;
// ~98 MB in int8, ~90 MB in int4); the flops are ~2 per weight or cache
// element. Design: a
// cooperative launch (every block co-resident, at most 4 to an SM) whose
// phases are separated by grid barriers, where the TPU grid runs them in
// order. The GEMV phases take the shared GEMVs (fused_layer.cuh:
// gemv_phase): the weights stream through a cp.async ring, stream-K over
// (256-column tile, 128-k unit) items shared evenly among the grid, the B
// rows in one row tile of 1, 8, 16, 24 or 32 (q4_stream.cuh: a GEMV that
// split no K left the o and down projections of Llama-7B, 128 tiles of 32
// columns, to 128 of the grid's blocks). At one row the next phase's first
// weight slabs are put in flight before each grid barrier
// (fused::gemv_prefetch). Attention has only
// B*Hkv (batch row, kv head) pairs -- 32 at 7B, B=1, which is why the separate K3 decode
// reached 2% of its bound -- so each pair's keys are split across blocks
// (split-KV): a block owns a
// key range, its 8 warps each keep an online softmax over 32-key chunks
// (one key per lane for the scores, four head dims per lane for PV), the
// block merges its warps and writes (m, l, acc) partials to scratch; the
// last block of a pair to finish (an atomic ticket, which it resets)
// merges the pair's splits in split order into the bf16 attention row, so
// no barrier of its own is needed. Rope is applied as q and the in-flight
// k are loaded, so phase B needs one barrier only. Scratch (qkv, partials,
// attention row, h', gate|up, the barrier counter) is allocated by the
// wrapper; the GEMV splits' partials and the tickets are the per-device
// scratch of ops/quant.py:fused_gemv_scratch.
//
// Built with -DGEMV_MODE=1 or 2 every GEMV phase (qkv, o-proj, gate|up,
// down) runs the W4A8 arithmetic of K9 (attn_block.py's a8 / a8x2 kernels);
// attention itself keeps K3's arithmetic. One library per mode (and cache
// kind: bf16, or quantized).
//
// In the exact GEMV mode (-DGEMV_MODE=0) the kernel is the Hopper design of
// fused_wg.cuh: one persistent block an SM, its GEMV phases on K1's wgmma
// mainloop with a producer warp that streams every phase's weights by TMA
// across the grid barriers, and the attention phase below (wg::consume) run
// by the consumer warpgroups on chunks of 16 keys that the x warp brings
// into a ring of their own (wg::produce: the K tile by TMA, the V rows,
// scales and pad flags by cp.async.bulk), from the launch's start where
// attention comes first.
// The rounding order of each phase is fused_wg.cuh's: the normed rows of
// phases B and E are rounded to bf16 before the products (not K1's route,
// whose 1/rms comes after them), the attention row and o as above. The
// parent, the streaming GEMV phases above, stays reachable in the exact mode
// only through layer_tail_stream_launch, built with -DPARENT=1 into
// libraries of its own (layer_tail_stream, layer_tail_stream_kvq), whose
// launches layer_tail_stream_launches counts; the a8 / a8x2 libraries keep
// it as their kernel.
#include "fused_layer.cuh"

#ifndef KV_QUANT
#define KV_QUANT 0  // 1: the library for int8 / int4 KV caches
#endif
#ifndef PARENT
#define PARENT 0    // 1: the exact mode's parent alone (layer_tail_stream_launch)
#endif
#define HOPPER_KERNEL (GEMV_MODE == 0 && !PARENT)
#if HOPPER_KERNEL
#include <type_traits>

#include "fused_wg.cuh"
#else
#include <atomic>
#endif

namespace {

using q4::QW;
using q4::THREADS;
using q4::WARPS;
using q4::XSrc;

constexpr int D = 128;     // head_dim (the gate in ops/attn_block.py)
constexpr int GMAX = 8;    // query heads per kv head
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;  // attention.py:37
constexpr float NEG_INF = -1e9f;                               // attention.py:36

struct TailParams {
  const bf16* q;          // [B, H, D] post-rope queries (NULL with phase B)
  const bf16* k_new;      // [B, Hkv, D] in-flight rows (NULL with phase B)
  const bf16* v_new;
  const void* k_cache;    // [B, Hkv, S, D] bf16 | int8, or [.., D/2] int4 bytes
  const void* v_cache;
  const float* k_scale;   // [B, Hkv, S] (NULL for a bf16 cache)
  const float* v_scale;
  const int32_t* past;    // [B]
  const uint8_t* mask;    // [B, mask_stride] (1 = real token) or NULL
  const bf16* h;          // [B, hidden] residual input
  QW o;                   // H*D -> hidden
  // phase B (in_norm != NULL)
  const bf16* in_norm;    // [hidden]
  QW qkv;                 // hidden -> (H + 2*Hkv)*D
  const float* sin;       // [1 | B, D] rope rows at position past_b
  const float* cos;
  bf16* k_row;            // [B, Hkv, D] post-rope K rows out
  bf16* v_row;            // [B, Hkv, D] V rows out
  // MLP (post_norm != NULL)
  const bf16* post_norm;  // [hidden]
  QW gu;                  // hidden -> 2*inter
  QW dn;                  // inter -> hidden
  bf16* out;              // [B, hidden]
  // scratch
  bf16* qkv_scr;          // [B, (H + 2*Hkv)*D]
  float* part;            // [B*Hkv*nsplit, G, D + 2]: acc, then m and l
  bf16* attn_scr;         // [B, H*D]
  bf16* h1_scr;           // [B, hidden]
  bf16* gu_scr;           // [B, 2*inter]
  unsigned int* bar;
  fused::SplitScratch gsc;  // the GEMV phases' split partials; their tickets and
                            // the (batch row, kv head) pairs' ([B*Hkv])
  int B, H, Hkv, S, hidden, inter, gs, nsplit, mask_stride, rope_stride, attend_len;
  int kv_mode;            // 0 bf16, 1 int8, 2 int4
  float eps, scale;
};

// Shared memory of the attention phase (floats).
constexpr int ATT_Q = 0;                        // [GMAX][D] queries
constexpr int ATT_KN = ATT_Q + GMAX * D;        // [D] in-flight K row
constexpr int ATT_VN = ATT_KN + D;              // [D] in-flight V row
constexpr int ATT_SN = ATT_VN + D;              // [GMAX] in-flight scores
constexpr int ATT_WM = ATT_SN + GMAX;           // [WARPS][GMAX] warp maxima
constexpr int ATT_WL = ATT_WM + WARPS * GMAX;   // [WARPS][GMAX] warp sums
constexpr int ATT_WA = ATT_WL + WARPS * GMAX;   // [WARPS][GMAX][D] warp accumulators
constexpr int ATT_FLOATS = ATT_WA + WARPS * GMAX * D;

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Raw value e (0..3) of the four cache bytes in w: int8, or for int4 the low
// (hi = false) or high nibble, as unpack_kv4 (attention.py:97).
template <int KV>
__device__ __forceinline__ float kv_raw(uint32_t w, int e, bool hi) {
  const int b = (int)(int8_t)(w >> (8 * e));
  if constexpr (KV == 1) return (float)b;
  return (float)(hi ? b >> 4 : (b & 15) - 8);
}

// A barrier of the block's threads, or (WG) of the Hopper kernel's 256
// consumer threads alone (named barrier 1).
template <bool WG>
__device__ __forceinline__ void block_sync() {
  if constexpr (WG)
    asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
  else
    __syncthreads();
}

// The last split block of pair (b, hk): merge the pair's G heads' splits,
// in split order, into the bf16 attention row. A function of its own, out
// of line, so that its registers do not add to the attention phase's.
// (Its operands are passed by value: a reference to the kernel's parameter
// block would copy it to local memory.) wa: 2 G nsplit + G floats of
// shared memory. WG: the Hopper kernel's consumers.
template <bool WG>
__device__ __noinline__ void merge_splits(const float* part, bf16* attn_scr, float* wa,
                                          int nsplit, int G, int H, int b, int hk, int bh) {
  __threadfence();
  // each split's m and l (one load each, all in flight), then per head the
  // weights exp(m - max m) and the merged l, then the sums of acc over the
  // splits in order, their loads unrolled
  const float* base = part + (size_t)bh * nsplit * G * (D + 2);
  const size_t stride = (size_t)G * (D + 2);
  float* wt = wa;                       // [G][nsplit]: the splits' m, then weights
  float* lw = wt + G * nsplit;          // [G][nsplit]: the splits' l
  float* lsum = lw + G * nsplit;        // [G]: the merged l
  for (int i = threadIdx.x; i < 2 * G * nsplit; i += THREADS) {
    const int r = i % (G * nsplit);
    wt[i] = __ldcg(base + (r % nsplit) * stride + (r / nsplit) * (D + 2) + D +
                   (i >= G * nsplit ? 1 : 0));
  }
  block_sync<WG>();
  if (threadIdx.x < G) {
    const int j = threadIdx.x;
    float mm = MASK_VALUE;
    for (int sp = 0; sp < nsplit; ++sp) mm = fmaxf(mm, wt[j * nsplit + sp]);
    float ll = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float f = expf(wt[j * nsplit + sp] - mm);
      wt[j * nsplit + sp] = f;
      ll += f * lw[j * nsplit + sp];
    }
    lsum[j] = ll == 0.f ? 1.f : ll;
  }
  block_sync<WG>();
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int j = i / D, d = i - j * D;
    const float* pj = base + j * (D + 2) + d;
    float aa = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < nsplit; ++sp) aa += wt[j * nsplit + sp] * __ldcg(pj + sp * stride);
    attn_scr[(size_t)b * H * D + (size_t)(hk * G + j) * D + d] = f2bf(aa / lsum[j]);
  }
}

#if HOPPER_KERNEL
// Phase C of the Hopper kernel (fused_wg.cuh), run by its 256 consumer
// threads: the arithmetic, the work items and the merge of attention_phase
// below, each warp a chunk of 16 keys at a time, lanes l and l + 16 each
// half of key l's row (their partial scores added by one shuffle), every
// lane four head dims of each of the chunk's V rows. The chunks come from
// a ring in shared memory that the x warp of the producer warpgroup
// (fused_wg.cuh: load_x, lane 0) fills, from the launch's start where
// attention comes first, else once it has put the qkv phase's x in flight:
// a slot holds one chunk's K tile by TMA (2-D map of the cache's rows,
// 128-byte swizzled boxes of 64 dims, int4 rows 64-byte swizzled: eight
// lanes that read one 16-byte column of eight rows hit different banks,
// and the queries they multiply stay one broadcast address), its V rows
// and the 16-byte granules that hold its K and V scales and pad flags by
// cp.async.bulk (the scale and mask tensors' bases 16-byte aligned, so no
// granule leaves their allocations). The K/V cache is an input, so the
// ring fills while the consumers run the qkv phase or wait at a grid
// barrier; the GEMV ring beside it keeps streaming the o-projection's
// weights. Integers become f32 through the mantissa (hop::ints_of: a prmt
// and a subtraction each), not the quarter-rate conversion. The queries live in shared memory as f32, the
// second half of each head 16 bytes off the first (one wavefront for the
// two halves' broadcasts).
namespace wg {

using namespace hop;

constexpr int CH = 16;                 // keys of a warp's chunk
constexpr int RING_MIN = 32768;        // bytes of the K / V ring, at least
constexpr int NA_MAX = 32;             // slots of the ring, at most
constexpr int EXTRA = 192;             // a slot's K, V scale granules (80 bytes each), pad flags (32)
constexpr int QS = D + 8;              // floats of a head's queries
constexpr int HALF_PAD = 4;            // floats between a head's two halves

template <int KV>
struct Ring {
  static constexpr int RB = KV == 0 ? D * 2 : KV == 1 ? D : D / 2;  // bytes of a row
  static constexpr int BOX = CH * (KV == 2 ? 64 : 128);              // a K box: 16 rows
  static constexpr int K_BYTES = CH * RB;                            // the chunk's K tile
  static constexpr int SLOT = 2 * K_BYTES;                           // K tile, then V rows
  static_assert(SLOT % 1024 == 0 && RING_MIN >= 4 * SLOT,
                "K tiles 1024-byte aligned (the swizzle's atoms)");
  // The warps that read a ring of `ring` bytes, and its slots: chunk a of
  // the block's sequence lies in slot a % slots, and chunk c of an item is
  // read by warp c % warps, the slots a multiple of the warps, so that
  // within an item a slot's previous chunk (a - slots) was read by the same
  // warp, and before an item the block's barrier saw every earlier chunk
  // read. A warp then never waits on a slot whose previous fill may still
  // be landing (TMA completes out of order, and an mbarrier's parity tells
  // only two phases apart: a wait for the next phase would pass at once).
  // Which warp sums which keys depends on the item alone, so a row's
  // attention does not depend on the other rows' keys.
  static __device__ __forceinline__ int warps(int ring) {
    return min(WARPS, min(NA_MAX, ring / SLOT));
  }
  static __device__ __forceinline__ int slots(int ring) {
    const int n = min(NA_MAX, ring / SLOT);
    return n - n % warps(ring);
  }
};

// The attention region of the kernel's shared memory (1024-byte aligned):
// the slots' scale and mask granules, the ring's barriers, the queries and
// partials (floats), the last-split flag; then, at RING_OFF, the ring (what
// the kernel's shared memory leaves beside the GEMV ring: fused_wg.cuh Cfg).
constexpr int EX_OFF = 0;
constexpr int BAR_OFF = EX_OFF + NA_MAX * EXTRA;
constexpr int F_OFF = BAR_OFF + 2 * NA_MAX * 8;
constexpr int F_Q = 0;                         // [GMAX][QS] queries
constexpr int F_KN = F_Q + GMAX * QS;          // [D] in-flight K row
constexpr int F_VN = F_KN + D;                 // [D] in-flight V row
constexpr int F_SN = F_VN + D;                 // [GMAX] in-flight scores
constexpr int F_WM = F_SN + GMAX;              // [WARPS][GMAX] warp maxima
constexpr int F_WL = F_WM + WARPS * GMAX;      // [WARPS][GMAX] warp sums
constexpr int F_WA = F_WL + WARPS * GMAX;      // [WARPS][GMAX][D] warp accumulators
constexpr int F_FLOATS = F_WA + WARPS * GMAX * D;
constexpr int RING_OFF = (F_OFF + F_FLOATS * 4 + 16 + 1023) & ~1023;

__device__ __forceinline__ int qi(int j, int d) { return j * QS + d + (d >> 6) * HALF_PAD; }

// The item's keys [s_begin, s_end) of [0, past_b): split `split` of nsplit.
struct Item {
  int b, hk, bh, split, s_begin, s_end;
  __device__ __forceinline__ Item(const TailParams& p, int item) {
    split = item % p.nsplit, bh = item / p.nsplit;
    hk = bh % p.Hkv, b = bh / p.Hkv;
    const int pb = min(p.past[b], p.attend_len);  // keys s < past_b are visible
    const int cs = ((pb + p.nsplit - 1) / p.nsplit + 31) & ~31;
    s_begin = split * cs;
    s_end = min(pb, s_begin + cs);
  }
  __device__ __forceinline__ int chunks() const {
    return s_end > s_begin ? (s_end - s_begin + CH - 1) / CH : 0;
  }
};

// The 16-byte granules of [p, p + n bytes): their first address and bytes.
__device__ __forceinline__ uintptr_t granules(const void* p, int n, uint32_t& bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p), lo = a & ~(uintptr_t)15;
  bytes = (uint32_t)(((a + n + 15) & ~(uintptr_t)15) - lo);
  return lo;
}

// The x warp's lane 0: every chunk of the block's items, in the order the
// consumers take them, into the ring.
template <int KV>
__device__ __forceinline__ void produce(const CUtensorMap* kmap, const TailParams& p,
                                        unsigned char* ar, int ring) {
  using R = Ring<KV>;
  const int NA = R::slots(ring);
  uint64_t* full = reinterpret_cast<uint64_t*>(ar + BAR_OFF);
  uint64_t* empty = full + NA_MAX;
  prefetch_map(kmap);
  const int items = p.B * p.Hkv * p.nsplit;
  int a = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it(p, item);
    const size_t strip = (size_t)it.bh * p.S;
    for (int c0 = it.s_begin; c0 < it.s_end; c0 += CH, ++a) {
      const int st = a % NA, nk = min(CH, it.s_end - c0);
      mbar_wait(empty + st, ((a / NA) & 1) ^ 1);
      unsigned char* slot = ar + RING_OFF + st * R::SLOT;
      unsigned char* ex = ar + EX_OFF + st * EXTRA;
      uint32_t tx = R::K_BYTES + nk * R::RB, sb = 0, mb = 0;
      uintptr_t ks = 0, vs = 0, ms = 0;
      if constexpr (KV != 0) {
        ks = granules(p.k_scale + strip + c0, 4 * nk, sb);
        vs = ks - reinterpret_cast<uintptr_t>(p.k_scale) + reinterpret_cast<uintptr_t>(p.v_scale);
        tx += 2 * sb;
      }
      if (p.mask != nullptr) {
        ms = granules(p.mask + (size_t)it.b * p.mask_stride + c0, nk, mb);
        tx += mb;
      }
      mbar_arrive_tx(full + st, tx);
      const int row = (int)(strip + c0);
      tma_2d(slot, kmap, 0, row, full + st);
      if constexpr (KV == 0) tma_2d(slot + R::BOX, kmap, 64, row, full + st);
      bulk_copy(slot + R::K_BYTES,
                static_cast<const unsigned char*>(p.v_cache) + (strip + c0) * R::RB, nk * R::RB,
                full + st);
      if constexpr (KV != 0) {
        bulk_copy(ex, reinterpret_cast<const void*>(ks), sb, full + st);
        bulk_copy(ex + 80, reinterpret_cast<const void*>(vs), sb, full + st);
      }
      if (p.mask != nullptr) bulk_copy(ex + 160, reinterpret_cast<const void*>(ms), mb, full + st);
    }
  }
}

// This lane's partial scores of its key (row kl of the slot's K tile, the
// half `half` of its dims) against the G heads' queries.
template <int KV>
__device__ __forceinline__ void scores(const unsigned char* kt, const float* qs, int kl, int half,
                                       int G, float (&sc)[GMAX]) {
  if constexpr (KV == 0) {  // box `half`: dims 64 half .. ; chunk v of row kl at v ^ (kl & 7)
    const unsigned char* row = kt + half * Ring<0>::BOX + kl * 128;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(row + ((v ^ (kl & 7)) << 4)), f);
#pragma unroll
      for (int j = 0; j < GMAX; ++j) {
        if (j >= G) break;
        const float* qj = qs + qi(j, half * 64 + v * 8);
#pragma unroll
        for (int e = 0; e < 8; ++e) sc[j] = fmaf(qj[e], f[e], sc[j]);
      }
    }
  } else if constexpr (KV == 1) {  // bytes = dims 16 c .. of chunk c = 4 half + v
    const unsigned char* row = kt + kl * 128;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = 4 * half + v;
      const uint4 u = *reinterpret_cast<const uint4*>(row + ((c ^ (kl & 7)) << 4));
      const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float f[4];
        ints_of<0>(w4[i], f);
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          if (j >= G) break;
          const float* qj = qs + qi(j, 16 * c + 4 * i);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j] = fmaf(qj[e], f[e], sc[j]);
        }
      }
    }
  } else {  // 64-byte rows, 64-byte swizzle: chunk c at c ^ ((kl >> 1) & 3); byte
            // column = low dim, high nibble = dim + 64
    const unsigned char* row = kt + kl * 64;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int c = 2 * half + v;
      const uint4 u = *reinterpret_cast<const uint4*>(row + ((c ^ ((kl >> 1) & 3)) << 4));
      const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float lo[4], hi[4];
        ints_of<1>(w4[i], lo);
        ints_of<2>(w4[i], hi);
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          if (j >= G) break;
          const float* ql = qs + qi(j, 16 * c + 4 * i);
          const float* qh = qs + qi(j, D / 2 + 16 * c + 4 * i);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j] = fmaf(qh[e], hi[e], fmaf(ql[e], lo[e], sc[j]));
        }
      }
    }
  }
}

// Head dims 4 lane .. 4 lane + 3 of V row kk of the slot (int8: bytes
// 4 lane ..; int4: lanes 0-15 the low nibbles, 16-31 the high nibbles of
// bytes 4 (lane & 15) ..).
template <int KV>
__device__ __forceinline__ void v_dims(const unsigned char* vt, int kk, int lane, float2& v01,
                                       float2& v23) {
  const unsigned char* vrow = vt + kk * Ring<KV>::RB;
  if constexpr (KV == 0) {
    const uint2 u = *reinterpret_cast<const uint2*>(vrow + 8 * lane);
    v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  } else {
    float f[4];
    if constexpr (KV == 1) {
      ints_of<0>(*reinterpret_cast<const uint32_t*>(vrow + 4 * lane), f);
    } else {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(vrow + 4 * (lane & 15));
      if (lane < 16)
        ints_of<1>(w, f);
      else
        ints_of<2>(w, f);
    }
    v01 = make_float2(f[0], f[1]);
    v23 = make_float2(f[2], f[3]);
  }
}

template <int KV>
__device__ __forceinline__ void consume(const TailParams& p, unsigned char* ar, int ring) {
  using R = Ring<KV>;
  const int NA = R::slots(ring), W = R::warps(ring);
  uint64_t* full = reinterpret_cast<uint64_t*>(ar + BAR_OFF);
  uint64_t* empty = full + NA_MAX;
  float* sm = reinterpret_cast<float*>(ar + F_OFF);
  int* last_split = reinterpret_cast<int*>(sm + F_FLOATS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = p.H / p.Hkv;
  const int nqkv = p.qkv.N;
  const int items = p.B * p.Hkv * p.nsplit;
  float* qs = sm + F_Q;
  float* kn = sm + F_KN;
  float* vn = sm + F_VN;
  float* sn = sm + F_SN;
  const int kl = lane & 15, half = lane >> 4;  // the key and the half of its row a lane reads
  int a0 = 0;                                  // the ring's sequence number of the item's first chunk
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it(p, item);
    const int b = it.b, hk = it.hk;
    block_sync<true>();  // the previous item's shared memory is consumed
    if (p.in_norm) {
      const bf16* row = p.qkv_scr + (size_t)b * nqkv;
      const float* sn_b = p.sin + (size_t)b * p.rope_stride;
      const float* cs_b = p.cos + (size_t)b * p.rope_stride;
      for (int i = threadIdx.x; i < G * D; i += THREADS) {
        const int j = i / D, d = i - j * D;
        qs[qi(j, d)] = fused::rope_elem<D>(row + (size_t)(hk * G + j) * D, d, sn_b, cs_b);
      }
      for (int d = threadIdx.x; d < D; d += THREADS) {
        kn[d] = fused::rope_elem<D>(row + (size_t)(p.H + hk) * D, d, sn_b, cs_b);
        vn[d] = q4::ld_cg(row + (size_t)(p.H + p.Hkv + hk) * D + d);
      }
    } else {
      for (int i = threadIdx.x; i < G * D; i += THREADS) {
        const int j = i / D, d = i - j * D;
        qs[qi(j, d)] = bf2f(p.q[((size_t)b * p.H + hk * G) * D + i]);
      }
      for (int d = threadIdx.x; d < D; d += THREADS) {
        kn[d] = bf2f(p.k_new[((size_t)b * p.Hkv + hk) * D + d]);
        vn[d] = bf2f(p.v_new[((size_t)b * p.Hkv + hk) * D + d]);
      }
    }
    block_sync<true>();
    if (p.in_norm && it.split == 0)
      for (int d = threadIdx.x; d < D; d += THREADS) {
        p.k_row[((size_t)b * p.Hkv + hk) * D + d] = f2bf(kn[d]);
        p.v_row[((size_t)b * p.Hkv + hk) * D + d] = f2bf(vn[d]);
      }
    if (it.split == 0 && warp < G) {  // in-flight scores s_new = q . k_new
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += qs[qi(warp, d)] * kn[d];
      s = warp_sum(s);
      if (lane == 0) sn[warp] = s * p.scale;
    }

    float m[GMAX], l[GMAX], acc[GMAX][4];
#pragma unroll
    for (int j = 0; j < GMAX; ++j) {
      m[j] = MASK_VALUE;
      l[j] = 0.f;
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    const size_t strip = (size_t)it.bh * p.S;
    const int nc = it.chunks();
    // chunk c: keys s_begin + 16 c .., read by warp c % W
    for (int c = warp < W ? warp : nc; c < nc; c += W) {
      const int a = a0 + c, st = a % NA;
      const int c0 = it.s_begin + c * CH, nk = min(CH, it.s_end - c0);
      const bool valid = kl < nk;
      const unsigned char* kt = ar + RING_OFF + st * R::SLOT;
      const unsigned char* ex = ar + EX_OFF + st * EXTRA;
      mbar_wait(full + st, (a / NA) & 1);
      float ksc = 1.f, vsc = 1.f;  // this lane's key's scales (KV != 0)
      if (KV != 0 && valid) {
        const int off = (int)((reinterpret_cast<uintptr_t>(p.k_scale + strip + c0) & 15) >> 2);
        ksc = reinterpret_cast<const float*>(ex)[off + kl];
        vsc = reinterpret_cast<const float*>(ex + 80)[off + kl];
      }
      bool pad = false;
      if (valid && p.mask != nullptr) {
        const unsigned char* mrow = p.mask + (size_t)b * p.mask_stride + c0;
        pad = ex[160 + (reinterpret_cast<uintptr_t>(mrow) & 15) + kl] == 0;
      }
      float sc[GMAX];
#pragma unroll
      for (int j = 0; j < GMAX; ++j) sc[j] = 0.f;
      scores<KV>(kt, qs, kl, half, G, sc);
      float pbf[GMAX];
#pragma unroll
      for (int j = 0; j < GMAX; ++j) {
        if (j >= G) break;
        sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], 16);  // the two halves
        float sv = MASK_VALUE;
        if (valid) {
          sv = sc[j];
          if constexpr (KV != 0) sv *= ksc;  // the K scale, then 1/sqrt(D)
          sv *= p.scale;
          if (pad) sv += NEG_INF;  // pad bias after the causal mask
        }
        const float m_new = fmaxf(m[j], warp_max(sv));
        const float alpha = expf(m[j] - m_new);
        const float pj = valid ? expf(sv - m_new) : 0.f;
        l[j] = alpha * l[j] + warp_sum(half == 0 ? pj : 0.f);
        m[j] = m_new;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha;
        // p is rounded to bf16 for the PV product, the V scale folded in
        // first; l above sums the unscaled p
        pbf[j] = bf2f(f2bf(KV != 0 ? pj * vsc : pj));
      }
      for (int kk = 0; kk < nk; ++kk) {
        float2 v01, v23;  // head dims 4*lane .. 4*lane+3 of key c0 + kk
        v_dims<KV>(kt + R::K_BYTES, kk, lane, v01, v23);
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          if (j >= G) break;
          const float pk = __shfl_sync(0xffffffffu, pbf[j], kk);
          acc[j][0] = fmaf(pk, v01.x, acc[j][0]);
          acc[j][1] = fmaf(pk, v01.y, acc[j][1]);
          acc[j][2] = fmaf(pk, v23.x, acc[j][2]);
          acc[j][3] = fmaf(pk, v23.y, acc[j][3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);  // the slot is read
    }
    a0 += nc;
    // merge the warps, fold in the in-flight row (split 0), write partials
#pragma unroll
    for (int j = 0; j < GMAX; ++j) {
      if (j >= G) break;
      if (lane == 0) {
        sm[F_WM + warp * GMAX + j] = m[j];
        sm[F_WL + warp * GMAX + j] = l[j];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sm[F_WA + (warp * GMAX + j) * D + lane * 4 + e] = acc[j][e];
    }
    block_sync<true>();
    float* out = p.part + (size_t)item * G * (D + 2);
    for (int i = threadIdx.x; i < G * D; i += THREADS) {
      const int j = i / D, d = i - j * D;
      float mm = MASK_VALUE;
      for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, sm[F_WM + w * GMAX + j]);
      float ll = 0.f, aa = 0.f;
      for (int w = 0; w < WARPS; ++w) {
        const float f = expf(sm[F_WM + w * GMAX + j] - mm);
        ll += f * sm[F_WL + w * GMAX + j];
        aa += f * sm[F_WA + (w * GMAX + j) * D + d];
      }
      if (it.split == 0) {
        const float s_new = sn[j];
        const float m_fin = fmaxf(mm, s_new);
        const float alpha = expf(mm - m_fin);
        const float p_new = expf(s_new - m_fin);
        ll = alpha * ll + p_new;
        aa = aa * alpha + p_new * vn[d];
        mm = m_fin;
      }
      out[j * (D + 2) + d] = aa;
      if (d == 0) {
        out[j * (D + 2) + D] = mm;
        out[j * (D + 2) + D + 1] = ll;
      }
    }
    // the last split of (b, hk) to finish merges its G heads, splits in
    // order, into the bf16 attention row
    __threadfence();
    block_sync<true>();
    if (threadIdx.x == 0)
      *last_split = atomicAdd(p.gsc.ticket + it.bh, 1u) == (unsigned)(p.nsplit - 1);
    block_sync<true>();
    if (!*last_split) continue;
    merge_splits<true>(p.part, p.attn_scr, sm + F_WA, p.nsplit, G, p.H, b, hk, it.bh);
    if (threadIdx.x == 0) p.gsc.ticket[it.bh] = 0u;  // ready for the next phase or launch
  }
}

}  // namespace wg

// The Hopper kernel's attention phase (fused_wg.cuh: Attn): the ring's
// barriers (init), its producer (the x warp, produce) and the consumers
// (run). The cache format is uniform across the grid.
struct TailAttn {
  static constexpr int BYTES = wg::RING_OFF, RING_MIN = wg::RING_MIN;
  using Params = TailParams;
  static __device__ __forceinline__ void init(unsigned char* ar) {
    uint64_t* full = reinterpret_cast<uint64_t*>(ar + wg::BAR_OFF);
    for (int s = 0; s < wg::NA_MAX; ++s) {
      hop::mbar_init(full + s, 1);               // the producer's arrival and its bytes
      hop::mbar_init(full + wg::NA_MAX + s, 1);  // the consuming warp's lane 0
    }
  }
  static __device__ __forceinline__ void produce(const fwg::Maps& mp, const TailParams& p,
                                                 unsigned char* ar, int ring) {
    const CUtensorMap* kmap = &mp.m[fwg::ATT_MAP];
#if KV_QUANT
    if (p.kv_mode == 1)
      wg::produce<1>(kmap, p, ar, ring);
    else
      wg::produce<2>(kmap, p, ar, ring);
#else
    wg::produce<0>(kmap, p, ar, ring);
#endif
  }
  static __device__ __forceinline__ void run(const TailParams& p, unsigned char* ar, int ring) {
#if KV_QUANT
    if (p.kv_mode == 1)
      wg::consume<1>(p, ar, ring);
    else
      wg::consume<2>(p, ar, ring);
#else
    wg::consume<0>(p, ar, ring);
#endif
  }
};

cudaError_t launch_hopper(const TailParams& p, int nsplit_cap, const bf16* in_norm_w,
                          const bf16* post_norm_w, cudaStream_t st) {
  TailParams tp = p;
  const int grid = fwg::num_sms();
  int nsplit = grid / (p.B * p.Hkv);  // enough work items to cover the grid
  if (nsplit > nsplit_cap) nsplit = nsplit_cap;
  tp.nsplit = nsplit < 1 ? 1 : nsplit;
  fwg::Plan pl{};
  fwg::Maps maps;
  int nmaps = 0;
  pl.M = p.B, pl.gs = p.gs, pl.eps = p.eps, pl.bar = p.bar;
  pl.part = p.gsc.part, pl.ticket = p.gsc.ticket;
  const int bm = fwg::row_tile(p.B);
  const int hid = p.hidden, nq = p.H * D;
  int syncs = 0;  // the grid barriers before a phase
  cudaError_t e = cudaSuccess;
  if (p.in_norm) {  // phase B: qkv = bf16(rms_norm(h) * w_in) @ Wqkv
    e = fwg::add_phase(maps, nmaps, pl,
                       {p.qkv.qweight, p.qkv.scales, p.qkv.zscale, hid, p.qkv.N, p.h, hid, 0,
                        in_norm_w, p.qkv_scr, nullptr, p.qkv.N},
                       bm, 0, grid);
    syncs = 1;
  }
  pl.attn_at = pl.nphases;
  syncs += 1;
  bf16* hdst = p.post_norm ? p.h1_scr : p.out;
  if (e == cudaSuccess)  // phase D: h' = h + bf16(attn @ Wo)
    e = fwg::add_phase(maps, nmaps, pl,
                       {p.o.qweight, p.o.scales, p.o.zscale, nq, hid, p.attn_scr, nq, 0, nullptr,
                        hdst, p.h, hid},
                       bm, syncs, grid);
  if (p.post_norm) {  // phases E / F: the MLP of h'
    if (e == cudaSuccess)
      e = fwg::add_phase(maps, nmaps, pl,
                         {p.gu.qweight, p.gu.scales, p.gu.zscale, hid, 2 * p.inter, p.h1_scr, hid,
                          0, post_norm_w, p.gu_scr, nullptr, 2 * p.inter},
                         bm, ++syncs, grid);
    if (e == cudaSuccess)
      e = fwg::add_phase(maps, nmaps, pl,
                         {p.dn.qweight, p.dn.scales, p.dn.zscale, p.inter, hid, p.gu_scr,
                          2 * p.inter, p.inter, nullptr, p.out, p.h1_scr, hid},
                         bm, ++syncs, grid);
  }
  // the K cache's rows for attention's ring: [B * Hkv * S, row] in boxes of
  // 16 rows by 128 bytes (bf16: two boxes of 64 dims), 128-byte swizzled
  // (int4's 64-byte rows 64-byte swizzled)
  if (e == cudaSuccess) {
    const uint64_t rows = (uint64_t)p.B * p.Hkv * p.S;
    const bool bf = p.kv_mode == 0, i4 = p.kv_mode == 2;
    if (rows > 0x7FFFFFFFull) return cudaErrorInvalidValue;  // TMA's int32 coordinates
    e = tensor_map(&maps.m[fwg::ATT_MAP],
                   {p.k_cache, (uint64_t)(bf ? D : i4 ? D / 2 : D), rows,
                    (uint32_t)(bf ? 64 : i4 ? 64 : 128), (uint32_t)wg::CH,
                    bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                    bf ? 2 : 1, i4 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B});
  }
  // the scale and mask granules of a chunk are copied whole
  if (e == cudaSuccess && ((uintptr_t)p.k_scale % 16 || (uintptr_t)p.v_scale % 16 ||
                           (uintptr_t)p.mask % 16 || (uintptr_t)p.v_cache % 16))
    e = cudaErrorMisalignedAddress;
  if (e != cudaSuccess) return e;
  return fwg::launch_by<TailAttn>(bm, p.gs % fwg::BK != 0, maps, pl, tp, grid, st);
}
#else
// Phase C: one work item = (batch row b, kv head hk, key split); the last
// split of a pair merges them. KV: the cache format (TailParams::kv_mode).
template <int KV>
__device__ void attention_phase(const TailParams& p, float* sm) {
  __shared__ int last_split;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = p.H / p.Hkv;
  const int nqkv = p.qkv.N;
  const int items = p.B * p.Hkv * p.nsplit;
  float* qs = sm + ATT_Q;
  float* kn = sm + ATT_KN;
  float* vn = sm + ATT_VN;
  float* sn = sm + ATT_SN;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int split = item % p.nsplit, bh = item / p.nsplit;
    const int hk = bh % p.Hkv, b = bh / p.Hkv;
    const int pb = min(p.past[b], p.attend_len);  // keys s < past_b are visible
    __syncthreads();  // the previous item's shared memory is consumed
    if (p.in_norm) {
      const bf16* row = p.qkv_scr + (size_t)b * nqkv;
      const float* sn_b = p.sin + (size_t)b * p.rope_stride;
      const float* cs_b = p.cos + (size_t)b * p.rope_stride;
      for (int i = threadIdx.x; i < G * D; i += THREADS) {
        const int j = i / D, d = i - j * D;
        qs[i] = fused::rope_elem<D>(row + (size_t)(hk * G + j) * D, d, sn_b, cs_b);
      }
      for (int d = threadIdx.x; d < D; d += THREADS) {
        kn[d] = fused::rope_elem<D>(row + (size_t)(p.H + hk) * D, d, sn_b, cs_b);
        vn[d] = q4::ld_cg(row + (size_t)(p.H + p.Hkv + hk) * D + d);
      }
    } else {
      for (int i = threadIdx.x; i < G * D; i += THREADS)
        qs[i] = bf2f(p.q[((size_t)b * p.H + hk * G) * D + i]);
      for (int d = threadIdx.x; d < D; d += THREADS) {
        kn[d] = bf2f(p.k_new[((size_t)b * p.Hkv + hk) * D + d]);
        vn[d] = bf2f(p.v_new[((size_t)b * p.Hkv + hk) * D + d]);
      }
    }
    __syncthreads();
    if (p.in_norm && split == 0)
      for (int d = threadIdx.x; d < D; d += THREADS) {
        p.k_row[((size_t)b * p.Hkv + hk) * D + d] = f2bf(kn[d]);
        p.v_row[((size_t)b * p.Hkv + hk) * D + d] = f2bf(vn[d]);
      }
    if (split == 0 && warp < G) {  // in-flight scores s_new = q . k_new
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += qs[warp * D + d] * kn[d];
      s = warp_sum(s);
      if (lane == 0) sn[warp] = s * p.scale;
    }

    // this split's keys: [s_begin, s_end) of [0, past_b)
    const int cs = ((pb + p.nsplit - 1) / p.nsplit + 31) & ~31;
    const int s_begin = split * cs;
    const int s_end = min(pb, s_begin + cs);
    float m[GMAX], l[GMAX], acc[GMAX][4];
#pragma unroll
    for (int j = 0; j < GMAX; ++j) {
      m[j] = MASK_VALUE;
      l[j] = 0.f;
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    constexpr int RB = KV == 0 ? D * 2 : KV == 1 ? D : D / 2;  // bytes of a row
    const size_t strip = ((size_t)b * p.Hkv + hk) * p.S;
    const unsigned char* kb = static_cast<const unsigned char*>(p.k_cache) + strip * RB;
    const unsigned char* vb = static_cast<const unsigned char*>(p.v_cache) + strip * RB;
    for (int c0 = s_begin + warp * 32; c0 < s_end; c0 += WARPS * 32) {
      const int s = c0 + lane;
      const bool valid = s < s_end;
      float sc[GMAX];
#pragma unroll
      for (int j = 0; j < GMAX; ++j) sc[j] = 0.f;
      float ksc = 1.f, vsc = 1.f;  // this lane's key's scales (KV != 0)
      if (valid) {
        const uint4* kr = reinterpret_cast<const uint4*>(kb + (size_t)s * RB);
        if constexpr (KV == 0) {
#pragma unroll 4
          for (int v8 = 0; v8 < D / 8; ++v8) {
            float f[8];
            unpack8(__ldg(kr + v8), f);
#pragma unroll
            for (int j = 0; j < GMAX; ++j) {
              if (j >= G) break;
              const float* qj = qs + j * D + v8 * 8;
#pragma unroll
              for (int e = 0; e < 8; ++e) sc[j] = fmaf(qj[e], f[e], sc[j]);
            }
          }
        } else {
          ksc = __ldg(p.k_scale + strip + s);
          vsc = __ldg(p.v_scale + strip + s);
#pragma unroll 2
          for (int v16 = 0; v16 < RB / 16; ++v16) {
            const uint4 u = __ldg(kr + v16);
            const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int d0 = v16 * 16 + i * 4 + e;  // byte column = low dim
                const float lo = kv_raw<KV>(w4[i], e, false);
                const float hi = KV == 2 ? kv_raw<KV>(w4[i], e, true) : 0.f;
#pragma unroll
                for (int j = 0; j < GMAX; ++j) {
                  if (j >= G) break;
                  sc[j] = fmaf(qs[j * D + d0], lo, sc[j]);
                  if constexpr (KV == 2) sc[j] = fmaf(qs[j * D + D / 2 + d0], hi, sc[j]);
                }
              }
            }
          }
        }
      }
      const bool pad = valid && p.mask != nullptr && p.mask[(size_t)b * p.mask_stride + s] == 0;
      float pbf[GMAX];
#pragma unroll
      for (int j = 0; j < GMAX; ++j) {
        if (j >= G) break;
        float sv = MASK_VALUE;
        if (valid) {
          sv = sc[j];
          if constexpr (KV != 0) sv *= ksc;  // the K scale, then 1/sqrt(D)
          sv *= p.scale;
          if (pad) sv += NEG_INF;  // pad bias after the causal mask
        }
        const float m_new = fmaxf(m[j], warp_max(sv));
        const float alpha = expf(m[j] - m_new);
        const float pj = valid ? expf(sv - m_new) : 0.f;
        l[j] = alpha * l[j] + warp_sum(pj);
        m[j] = m_new;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha;
        // p is rounded to bf16 for the PV product, the V scale folded in
        // first; l above sums the unscaled p
        pbf[j] = bf2f(f2bf(KV != 0 ? pj * vsc : pj));
      }
      const int nk = min(32, s_end - c0);
      for (int kk = 0; kk < nk; ++kk) {
        float2 v01, v23;  // head dims 4*lane .. 4*lane+3 of key c0 + kk
        const unsigned char* vrow = vb + (size_t)(c0 + kk) * RB;
        if constexpr (KV == 0) {
          const uint2 u = __ldg(reinterpret_cast<const uint2*>(vrow) + lane);
          v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
          v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        } else {
          // int8: bytes 4*lane..; int4: lanes 0-15 the low nibbles, lanes
          // 16-31 the high nibbles of bytes 4*(lane & 15)..
          const int word = KV == 1 ? lane : (lane & 15);
          const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(vrow) + word);
          const bool hi = lane >= 16;
          v01 = make_float2(kv_raw<KV>(w, 0, hi), kv_raw<KV>(w, 1, hi));
          v23 = make_float2(kv_raw<KV>(w, 2, hi), kv_raw<KV>(w, 3, hi));
        }
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          if (j >= G) break;
          const float pk = __shfl_sync(0xffffffffu, pbf[j], kk);
          acc[j][0] = fmaf(pk, v01.x, acc[j][0]);
          acc[j][1] = fmaf(pk, v01.y, acc[j][1]);
          acc[j][2] = fmaf(pk, v23.x, acc[j][2]);
          acc[j][3] = fmaf(pk, v23.y, acc[j][3]);
        }
      }
    }
    // merge the warps, fold in the in-flight row (split 0), write partials
#pragma unroll
    for (int j = 0; j < GMAX; ++j) {
      if (j >= G) break;
      if (lane == 0) {
        sm[ATT_WM + warp * GMAX + j] = m[j];
        sm[ATT_WL + warp * GMAX + j] = l[j];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sm[ATT_WA + (warp * GMAX + j) * D + lane * 4 + e] = acc[j][e];
    }
    __syncthreads();
    float* out = p.part + (size_t)item * G * (D + 2);
    for (int i = threadIdx.x; i < G * D; i += THREADS) {
      const int j = i / D, d = i - j * D;
      float mm = MASK_VALUE;
      for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, sm[ATT_WM + w * GMAX + j]);
      float ll = 0.f, aa = 0.f;
      for (int w = 0; w < WARPS; ++w) {
        const float f = expf(sm[ATT_WM + w * GMAX + j] - mm);
        ll += f * sm[ATT_WL + w * GMAX + j];
        aa += f * sm[ATT_WA + (w * GMAX + j) * D + d];
      }
      if (split == 0) {
        const float s_new = sn[j];
        const float m_fin = fmaxf(mm, s_new);
        const float alpha = expf(mm - m_fin);
        const float p_new = expf(s_new - m_fin);
        ll = alpha * ll + p_new;
        aa = aa * alpha + p_new * vn[d];
        mm = m_fin;
      }
      out[j * (D + 2) + d] = aa;
      if (d == 0) {
        out[j * (D + 2) + D] = mm;
        out[j * (D + 2) + D + 1] = ll;
      }
    }
    // the last split of (b, hk) to finish merges its G heads, splits in
    // order, into the bf16 attention row (a fault that drops a split or
    // counts one twice is held against the plain merge:
    // ops/attn_block.py:attention_split_plain)
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last_split = atomicAdd(p.gsc.ticket + bh, 1u) == (unsigned)(p.nsplit - 1);
    __syncthreads();
    if (!last_split) continue;
    merge_splits<false>(p.part, p.attn_scr, sm + ATT_WA, p.nsplit, G, p.H, b, hk, bh);
    if (threadIdx.x == 0) p.gsc.ticket[bh] = 0u;  // ready for the next phase or launch
  }
}

template <int MB>
__global__ void __launch_bounds__(THREADS, q4s::min_blocks(MB))
    layer_tail_kernel(const TailParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned int epoch = 0;
  const int M = p.B;
  if (p.in_norm) {  // phase B: input norm + fused qkv GEMV
    const int nqkv = p.qkv.N;
    const XSrc x{p.h, p.hidden, p.in_norm, p.eps, nullptr, 0};
    fused::gemv_phase<MB, GEMV_MODE>(x, p.qkv, M, p.hidden, p.gs, p.gsc, smem,
                                     q4s::Out{p.qkv_scr, nullptr, nqkv});
    fused::grid_sync(p.bar, epoch);
  }
  __syncthreads();
#if KV_QUANT
  if (p.kv_mode == 1)  // uniform across the grid
    attention_phase<1>(p, reinterpret_cast<float*>(smem));
  else
    attention_phase<2>(p, reinterpret_cast<float*>(smem));
#else
  attention_phase<0>(p, reinterpret_cast<float*>(smem));
#endif
  fused::gemv_prefetch<MB, GEMV_MODE>(p.o, M, p.H * D, p.gs, smem);
  fused::grid_sync(p.bar, epoch);
  // phase D: o-projection + residual, into h' (MLP) or the output
  const int hid = p.hidden;
  bf16* hdst = p.post_norm ? p.h1_scr : p.out;
  const XSrc xo{p.attn_scr, p.H * D, nullptr, 0.f, nullptr, 0};
  fused::gemv_phase<MB, GEMV_MODE>(xo, p.o, M, p.H * D, p.gs, p.gsc, smem,
                                   q4s::Out{hdst, p.h, hid}, true);
  if (!p.post_norm) return;
  fused::gemv_prefetch<MB, GEMV_MODE>(p.gu, M, hid, p.gs, smem);
  fused::grid_sync(p.bar, epoch);
  fused::mlp_phases<MB, GEMV_MODE>(p.h1_scr, p.post_norm, p.eps, p.gu, p.dn, M, hid, p.inter,
                                   p.gs, p.gu_scr, p.out, p.gsc, p.bar, epoch, smem, true);
}

template <int MB>
cudaError_t launch(TailParams p, int nsplit_cap, cudaStream_t st) {
  size_t smem = (size_t)ATT_FLOATS * 4;
  if (fused::gemv_smem(MB, GEMV_MODE, p.B) > smem) smem = fused::gemv_smem(MB, GEMV_MODE, p.B);
  const int grid = fused::coop_grid(layer_tail_kernel<MB>, smem);
  // splits per (b, kv head): enough work items to cover the grid
  int nsplit = grid / (p.B * p.Hkv);
  if (nsplit > nsplit_cap) nsplit = nsplit_cap;
  p.nsplit = nsplit < 1 ? 1 : nsplit;
  return fused::coop_launch(layer_tail_kernel<MB>, grid, p, smem, p.bar, st);
}
#endif  // HOPPER_KERNEL

int tail_entry(
    const void* q, const void* k_new, const void* v_new, const void* k_cache,
    const void* v_cache, const void* k_scale, const void* v_scale, const void* past,
    const void* mask, const void* h, const void* o_q,
    const void* o_s, const void* o_z, const void* in_norm, const void* qkv_q,
    const void* qkv_s, const void* qkv_z, const void* sin, const void* cos, void* k_row,
    void* v_row, const void* post_norm, const void* gu_q, const void* gu_s,
    const void* gu_z, const void* dn_q, const void* dn_s, const void* dn_z, void* qkv_scr,
    void* part, void* attn_scr, void* h1_scr, void* gu_scr, void* bar, void* gpart, void* gticket, void* out, int B,
    int H, int Hkv, int S, int hidden, int inter, int gs, int mask_stride, int rope_stride,
    int nsplit_cap, int attend_len, int kv_mode, float eps, float scale, void* stream) {
  if (H % Hkv || H / Hkv > GMAX || nsplit_cap < 1) return cudaErrorInvalidValue;
  if (kv_mode < 0 || kv_mode > 2 || (kv_mode != 0) != (KV_QUANT != 0) ||
      (kv_mode != 0) != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr))
    return cudaErrorInvalidValue;
  TailParams p;
  p.q = (const bf16*)q;
  p.k_new = (const bf16*)k_new;
  p.v_new = (const bf16*)v_new;
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_scale = (const float*)k_scale;
  p.v_scale = (const float*)v_scale;
  p.kv_mode = kv_mode;
  p.past = (const int32_t*)past;
  p.mask = (const uint8_t*)mask;
  p.h = (const bf16*)h;
  p.o = QW{(const int32_t*)o_q, (const scale_t*)o_s, (const scale_t*)o_z, hidden};
  p.in_norm = (const bf16*)in_norm;
  p.qkv = QW{(const int32_t*)qkv_q, (const scale_t*)qkv_s, (const scale_t*)qkv_z,
             (H + 2 * Hkv) * D};
  p.sin = (const float*)sin;
  p.cos = (const float*)cos;
  p.k_row = (bf16*)k_row;
  p.v_row = (bf16*)v_row;
  p.post_norm = (const bf16*)post_norm;
  p.gu = QW{(const int32_t*)gu_q, (const scale_t*)gu_s, (const scale_t*)gu_z, 2 * inter};
  p.dn = QW{(const int32_t*)dn_q, (const scale_t*)dn_s, (const scale_t*)dn_z, hidden};
  p.out = (bf16*)out;
  p.qkv_scr = (bf16*)qkv_scr;
  p.part = (float*)part;
  p.attn_scr = (bf16*)attn_scr;
  p.h1_scr = (bf16*)h1_scr;
  p.gu_scr = (bf16*)gu_scr;
  p.bar = PARENT ? fused::own_barrier_word() : (unsigned int*)bar;
  if (p.bar == nullptr) return cudaErrorInvalidValue;
  p.gsc = fused::SplitScratch{(float*)gpart, (unsigned int*)gticket};
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.hidden = hidden;
  p.inter = post_norm ? inter : 0;
  p.gs = gs;
  p.nsplit = 1;
  p.mask_stride = mask_stride;
  p.rope_stride = rope_stride;
  p.attend_len = attend_len;
  p.eps = eps;
  p.scale = scale;
  auto st = (cudaStream_t)stream;
  if (B < 1 || B > 32 || gpart == nullptr || gticket == nullptr) return cudaErrorInvalidValue;
#if HOPPER_KERNEL
  return launch_hopper(p, nsplit_cap, p.in_norm, p.post_norm, st);
#else
  switch (fused::fused_mb(B)) {
    case 1: return launch<1>(p, nsplit_cap, st);
    case 8: return launch<8>(p, nsplit_cap, st);
    case 16: return launch<16>(p, nsplit_cap, st);
    case 24: return launch<24>(p, nsplit_cap, st);
    default: return launch<32>(p, nsplit_cap, st);
  }
#endif
}

#if PARENT
std::atomic<int> stream_launches{0};  // layer_tail_stream_launch's
#endif

}  // namespace

// Operands (bf16 unless noted; NULL where a phase is off):
//   q [B, H, D], k_new / v_new [B, Hkv, D]   (NULL with phase B)
//   k_cache / v_cache [B, Hkv, S, D] bf16 (kv_mode 0) or int8 (1), or
//   [B, Hkv, S, D/2] int4 bytes (2); k_scale / v_scale [B, Hkv, S] f32 (NULL
//   for kv_mode 0); past [B] int32; mask [B, mask_stride]
//   uint8 or NULL; h [B, hidden]; o: qweight [H*D/8, hidden] int32,
//   scales / zscale [H*D/gs, hidden]
//   phase B: in_norm [hidden]; qkv qweight [hidden/8, (H+2*Hkv)*D], scales /
//   zscale; sin / cos [1 | B, D] f32 (rope_stride 0 or D); k_row / v_row
//   [B, Hkv, D] outputs
//   MLP: post_norm [hidden]; gate|up and down as in K6; inter
//   scratch: qkv_scr [B, (H+2*Hkv)*D] bf16, part [B*Hkv*nsplit_cap*G*(D+2)]
//   f32, attn_scr [B, H*D], h1_scr [B, hidden], gu_scr [B, 2*inter] bf16,
//   bar one uint32 (in the exact mode two zeros that the launch leaves
//   zero, not cleared here); gpart, gticket the split scratch of fused::SplitScratch
//   (ticket >= B*Hkv entries too); out [B, hidden]. D = 128, H / Hkv <= 8; keys at
//   s >= min(past_b, attend_len) are not read.
#if PARENT
// The parent of the exact mode (chip_smoke.py's yardstick only): the
// streaming GEMV phases on up to four blocks an SM, with layer_tail_launch's
// operands and scratch; `bar` is not used (the library's own counter,
// fused::own_barrier, stands in for it).
extern "C" int layer_tail_stream_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_cache,
    const void* v_cache, const void* k_scale, const void* v_scale, const void* past,
    const void* mask, const void* h, const void* o_q,
    const void* o_s, const void* o_z, const void* in_norm, const void* qkv_q,
    const void* qkv_s, const void* qkv_z, const void* sin, const void* cos, void* k_row,
    void* v_row, const void* post_norm, const void* gu_q, const void* gu_s,
    const void* gu_z, const void* dn_q, const void* dn_s, const void* dn_z, void* qkv_scr,
    void* part, void* attn_scr, void* h1_scr, void* gu_scr, void* bar, void* gpart, void* gticket, void* out, int B,
    int H, int Hkv, int S, int hidden, int inter, int gs, int mask_stride, int rope_stride,
    int nsplit_cap, int attend_len, int kv_mode, float eps, float scale, void* stream) {
  const int e = tail_entry(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, past, mask, h, o_q, o_s, o_z, in_norm, qkv_q, qkv_s, qkv_z, sin, cos, k_row, v_row, post_norm, gu_q, gu_s, gu_z, dn_q, dn_s, dn_z, qkv_scr, part, attn_scr, h1_scr, gu_scr, bar, gpart, gticket, out, B, H, Hkv, S, hidden, inter, gs, mask_stride, rope_stride, nsplit_cap, attend_len, kv_mode, eps, scale, stream);
  if (e == 0) ++stream_launches;
  return e;
}

extern "C" int layer_tail_stream_launches() { return stream_launches.load(); }
#else
extern "C" int layer_tail_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_cache,
    const void* v_cache, const void* k_scale, const void* v_scale, const void* past,
    const void* mask, const void* h, const void* o_q,
    const void* o_s, const void* o_z, const void* in_norm, const void* qkv_q,
    const void* qkv_s, const void* qkv_z, const void* sin, const void* cos, void* k_row,
    void* v_row, const void* post_norm, const void* gu_q, const void* gu_s,
    const void* gu_z, const void* dn_q, const void* dn_s, const void* dn_z, void* qkv_scr,
    void* part, void* attn_scr, void* h1_scr, void* gu_scr, void* bar, void* gpart, void* gticket, void* out, int B,
    int H, int Hkv, int S, int hidden, int inter, int gs, int mask_stride, int rope_stride,
    int nsplit_cap, int attend_len, int kv_mode, float eps, float scale, void* stream) {
  return tail_entry(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, past, mask, h, o_q, o_s, o_z, in_norm, qkv_q, qkv_s, qkv_z, sin, cos, k_row, v_row, post_norm, gu_q, gu_s, gu_z, dn_q, dn_s, dn_z, qkv_scr, part, attn_scr, h1_scr, gu_scr, bar, gpart, gticket, out, B, H, Hkv, S, hidden, inter, gs, mask_stride, rope_stride, nsplit_cap, attend_len, kv_mode, eps, scale, stream);
}
#endif
