// K3's prefill path on Hopper (flash_attn.cu, entry flash_attn_launch with
// no decode scratch): causal GQA attention of more than 16 query rows a kv
// head over the KV cache, bf16, int8 or packed int4, head_dim 64 / 128 (the
// flash_attn library) or 256 (flash_attn_d256). The function and its
// arithmetic are flash_attn.cu's header's: the TPU kernel
// exllama_tpu/ops/attention.py:_flash_prefill_kernel (launched through
// _attend_flash_prefill at attention.py:967). Its parent on this card is
// flash_attn.cu's prefill_kernel (FlashAttention-2 tiles on mma.sync, a
// 2-stage cp.async ring), reachable only through
// flash_attn_prefill_fa2_launch.
//
// Bound on the H100: operations (T*S*D*4 flops on bf16 tensor cores in every
// format; at Llama-7B, T = 1919, 30 GFLOP against 33 MB of K and V). The
// design puts both products on wgmma, the only route to that rate:
//   - roles: CW consumer warpgroups of 64 query rows each (BR = 64 CW rows
//     a block; ops/attention.py:prefill_plan picks CW = 1 where a kv head
//     has at most 64 query rows, so a 64-row admission chunk does not carry
//     64 empty rows, else 2) and a producer of one warp over a bf16 cache
//     or four over int8 / int4 (the TMA warp and three converting warps).
//     The registers go to the consumers by the block's size, not by
//     setmaxnreg: with a whole producer warpgroup (384 threads, 168
//     registers a thread) ptxas serialized the products for want of
//     registers (C7512) in every two-warpgroup build, setmaxnreg 40 / 232
//     notwithstanding; 288 threads give the bf16 consumers 224. Over an
//     integer cache the conversion sets the pace: three converting warps
//     (384 threads) beat two (352; scripts/prefill_ablation.py convert2);
//   - loads: thread 0 of the producer keeps TMA loads of the K and V tiles
//     (BN keys x D, boxes of 64 columns, 128-byte swizzled) in flight into
//     an mbarrier ring of up to five stages; the tiles come through a 3-D
//     map of the cache
//     ([B * Hkv, attend_len, D]: TMA zero-fills the keys past attend_len and
//     reads nothing past them); key tiles wholly above the block's causal
//     diagonal are never loaded;
//   - S = Q K^T on wgmma m64nBNk16, K the K-major shared-memory operand; Q
//     the register operand (its fragments loaded once by ldmatrix from a
//     swizzled staging), at head_dim 256 a K-major shared-memory operand
//     (Mma64SS), where its 64 fragment registers would spill beside O's
//     128 (at 128 the two placements time alike: scripts/prefill_ablation.py
//     q_shared);
//   - the key tile: 128 keys at head_dim 64, 64 above, never as wide as
//     the head (Cfg asserts BN != D): with S and PV on one wgmma shape
//     (m64nDk16) the second key tile's S came out as the first tile's P,
//     not Q, times its K^T (S read the registers of PV's A fragment), and
//     splitting either product into m64n64 halves made the output right
//     (scripts/prefill_tile_probe.py; not confirmed in SASS);
//   - the online softmax on the accumulator fragment, as the parent: the K
//     scale and 1/sqrt(D), the causal mask only on tiles that cross the
//     diagonal of the warpgroup's rows, the pad bias, quad reductions; the
//     loop compiled apart for those tiles and for a padded batch, so the
//     other tiles pay no per-key test (the softmax was half the kernel's
//     time before: scripts/prefill_ablation.py no_softmax);
//   - O += P V: P's accumulator, rounded to bf16 (the V scale folded in
//     first), is the register A operand (the C layout of S is the A layout
//     of PV), V the B operand read MN-major (hopper.cuh: mnmajor_sw128,
//     imm-trans-b 1) from the same tile layout as K;
//   - int8 / int4: TMA brings the raw bytes into a second ring and the
//     producer's three other warps convert each tile into the bf16 swizzled
//     tiles wgmma reads (hop::sw128; each integer as 2^23 + u in an f32's
//     mantissa, minus the bias: no quarter-rate int-to-float conversion),
//     with the two scale strips beside them (loaded before the waits), then
//     fence.proxy.async before their arrival; the consumers do not convert;
//   - order: one block a query tile of one (batch row, kv head), the
//     heaviest tiles launched first, so the card's block scheduler hands
//     the longest work out first.
#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "tma_map.cuh"

namespace fwg {

using namespace hop;

constexpr int SMEM_MAX = 232448;

template <int D, int KV, int CW>
struct Cfg {
  static constexpr int BN = D > 64 ? 64 : 128;  // keys a tile (never D: see above)
  static constexpr int BR = 64 * CW;             // query rows a block
  static constexpr int PW = KV ? 4 : 1;          // producer warps
  static constexpr int THREADS = 128 * CW + 32 * PW;
  static constexpr int NB = D / 64;              // 64-column boxes of a row
  static constexpr int BOX = BN * 128;           // one box of a K or V tile
  static constexpr int TILE = NB * BOX;          // a bf16 K or V tile
  static constexpr int Q_BYTES = BR * D * 2;     // NB boxes of [BR][128 B]
  static constexpr int RAW_ROW = KV == 1 ? D : D / 2;  // bytes of a raw key row
  static constexpr int RAW = KV ? 2 * BN * RAW_ROW : 0;  // raw K, V of a tile
  static constexpr int SC = KV ? 2 * BN * 4 : 0;         // K, V scales of a tile
  static constexpr int FIXED = Q_BYTES + 1024;
  // up to five bf16 stages beside two raw stages; two beside one raw stage
  // where two do not fit
  static constexpr int FIT2 = (SMEM_MAX - FIXED - 2 * RAW) / (2 * TILE + SC);
  static constexpr int FIT = (SMEM_MAX - FIXED - RAW) / (2 * TILE + SC);
  static constexpr int STAGES = FIT2 >= 2 ? (FIT2 < 5 ? FIT2 : 5) : 2;
  static constexpr int RSTAGES = !KV ? 0 : FIT2 >= 2 ? 2 : 1;
  static constexpr int RING_OFF = Q_BYTES;
  static constexpr int RAW_OFF = RING_OFF + STAGES * 2 * TILE;
  static constexpr int SC_OFF = RAW_OFF + RSTAGES * RAW;
  static constexpr int BAR_OFF = SC_OFF + STAGES * SC;
  static constexpr int SMEM = BAR_OFF + 4 * 8 * 8;  // four arrays of 8 mbarriers
  static_assert(FIT >= 2 && SMEM <= SMEM_MAX && STAGES <= 8, "shared memory of one block");
  static_assert(BN != D, "S and PV on one wgmma shape: the second tile's S goes wrong");
  static_assert(Q_BYTES % 1024 == 0 && TILE % 1024 == 0 && RAW % 1024 == 0,
                "the swizzled boxes start on 1024-byte boundaries");
};

struct Args {
  const bf16* q;         // [B, T, H, D]
  const float* k_scale;  // [B, Hkv, S] (KV != 0)
  const float* v_scale;
  const int32_t* past;   // [B]
  const uint8_t* mask;   // [B, mask_stride] or NULL
  bf16* out;             // [B, T, H, D]
  int B, T, H, Hkv, S, attend_len, mask_stride;
  float scale;
};

constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;  // attention.py:37
constexpr float NEG_INF = -1e9f;                               // attention.py:36

// The block's query tile and key range, the same in every role.
struct Item {
  int b, hk, r0, rows, g, pb, kv_end, ntiles;
  template <int BR, int BN>
  __device__ __forceinline__ static Item of(const Args& a) {
    Item it;
    it.g = a.H / a.Hkv;
    it.rows = a.T * it.g;
    const int nqt = (it.rows + BR - 1) / BR, nbh = a.B * a.Hkv;
    const int qt = nqt - 1 - (int)blockIdx.x / nbh;  // heaviest query tiles first
    const int bh = blockIdx.x % nbh;
    it.b = bh / a.Hkv, it.hk = bh % a.Hkv;
    it.r0 = qt * BR;
    it.pb = a.past[it.b];
    it.kv_end = min(a.attend_len, it.pb + (min(it.rows, it.r0 + BR) - 1) / it.g + 1);
    it.ntiles = (it.kv_end + BN - 1) / BN;
    return it;
  }
};

// 16 integer bytes -> 16 bf16 (exact) at chunks (c, c + 1) of row r of a
// swizzled tile: int8 dims 16c' .. 16c' + 15, or for int4 one nibble of
// each byte (lo: (b & 15) - 8; hi: b >> 4).
template <int MODE>  // 0: int8, 1: int4 low nibbles, 2: int4 high nibbles
__device__ __forceinline__ void put_ints(unsigned char* tile, int box_bytes, int r, int dim0,
                                         const uint4& raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  __align__(16) __nv_bfloat162 h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    h[e] = __floats2bfloat162_rn(int_of<MODE>(w[e >> 1], 2 * (e & 1)),
                                 int_of<MODE>(w[e >> 1], 2 * (e & 1) + 1));
  const int c = dim0 >> 3;  // 16-byte chunk of the bf16 row
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int cc = c + u;
    *reinterpret_cast<uint4*>(tile + (cc >> 3) * box_bytes + sw128(r, cc & 7)) =
        *reinterpret_cast<const uint4*>(&h[4 * u]);
  }
}

template <int D, int KV, int CW>
__device__ __forceinline__ void produce(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        const Args& a, const Item& it, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty, uint64_t* rfull,
                                        uint64_t* rempty) {
  using C = Cfg<D, KV, CW>;
  const int bh = it.b * a.Hkv + it.hk;
  prefetch_map(kmap);
  prefetch_map(vmap);
  int st = 0;
  uint32_t ph = 0;
  for (int j = 0; j < it.ntiles; ++j) {
    const int s0 = j * C::BN;
    if constexpr (KV == 0) {
      mbar_wait(empty + st, ph ^ 1);
      mbar_arrive_tx(full + st, 2 * C::TILE);
      unsigned char* kt = smem + C::RING_OFF + st * 2 * C::TILE;
#pragma unroll
      for (int bx = 0; bx < C::NB; ++bx) {
        tma_3d(kt + bx * C::BOX, kmap, 64 * bx, s0, bh, full + st);
        tma_3d(kt + C::TILE + bx * C::BOX, vmap, 64 * bx, s0, bh, full + st);
      }
      if (++st == C::STAGES) st = 0, ph ^= 1;
    } else {
      mbar_wait(rempty + st, ph ^ 1);
      mbar_arrive_tx(rfull + st, C::RAW);
      unsigned char* raw = smem + C::RAW_OFF + st * C::RAW;
      tma_3d(raw, kmap, 0, s0, bh, rfull + st);
      tma_3d(raw + C::BN * C::RAW_ROW, vmap, 0, s0, bh, rfull + st);
      if (++st == C::RSTAGES) st = 0, ph ^= 1;
    }
  }
}

// The producer's warps 1-3 (KV != 0): each raw tile into the bf16 ring.
template <int D, int KV, int CW>
__device__ __forceinline__ void convert(const Args& a, const Item& it, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty, uint64_t* rfull,
                                        uint64_t* rempty, int ct) {
  using C = Cfg<D, KV, CW>;
  constexpr int CPR = C::RAW_ROW / 16;  // 16-byte chunks of a raw row
  constexpr int NT = 32 * (C::PW - 1);
  const size_t strip = ((size_t)it.b * a.Hkv + it.hk) * a.S;
  constexpr int NSC = (2 * C::BN + NT - 1) / NT;  // scales a thread stages a tile
  int st = 0, rs = 0;
  uint32_t ph = 0, rph = 0;
  for (int j = 0; j < it.ntiles; ++j) {
    const int s0 = j * C::BN;
    float scv[NSC];  // the tile's K and V scales, loaded before the waits
#pragma unroll
    for (int n = 0; n < NSC; ++n) {
      const int i = ct + n * NT, s = s0 + (i % C::BN);
      scv[n] = i < 2 * C::BN && s < a.attend_len
                   ? __ldg((i < C::BN ? a.k_scale : a.v_scale) + strip + s)
                   : 0.f;
    }
    mbar_wait(rfull + rs, rph);
    mbar_wait(empty + st, ph ^ 1);
    const unsigned char* raw = smem + C::RAW_OFF + rs * C::RAW;
    unsigned char* kt = smem + C::RING_OFF + st * 2 * C::TILE;
#pragma unroll 4
    for (int i = ct; i < 2 * C::BN * CPR; i += NT) {
      const int which = i / (C::BN * CPR), rem = i - which * C::BN * CPR;
      const int r = rem / CPR, c = rem - r * CPR;
      const uint4 u = *reinterpret_cast<const uint4*>(raw + which * C::BN * C::RAW_ROW +
                                                      r * C::RAW_ROW + c * 16);
      unsigned char* tile = kt + which * C::TILE;
      if constexpr (KV == 1) {
        put_ints<0>(tile, C::BOX, r, 16 * c, u);
      } else {  // byte d pairs dims d (low nibble) and d + D/2 (high)
        put_ints<1>(tile, C::BOX, r, 16 * c, u);
        put_ints<2>(tile, C::BOX, r, D / 2 + 16 * c, u);
      }
    }
    float* sc = reinterpret_cast<float*>(smem + C::SC_OFF + st * C::SC);
#pragma unroll
    for (int n = 0; n < NSC; ++n)
      if (ct + n * NT < 2 * C::BN) sc[ct + n * NT] = scv[n];
    fence_proxy_async();  // the tiles are read by wgmma (the async proxy)
    __syncwarp();
    if ((ct & 31) == 0) {
      mbar_arrive(full + st);
      mbar_arrive(rempty + rs);
    }
    if (++st == C::STAGES) st = 0, ph ^= 1;
    if (++rs == C::RSTAGES) rs = 0, rph ^= 1;
  }
}

template <int D, int KV, int CW>
__device__ __forceinline__ void consume(const Args& a, const Item& it, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty, int wg, int ct) {
  using C = Cfg<D, KV, CW>;
  constexpr int BN = C::BN, BR = C::BR;
  const int warp = ct >> 5, lane = ct & 31, gq = lane >> 2, q4 = lane & 3;
  const int rw0 = it.r0 + 64 * wg;  // the warpgroup's first query row

  // Q's 64 rows of this warpgroup into the swizzled staging (zeros past the
  // last row), then its fragments (D <= 128) once
  unsigned char* qs = smem;
  for (int i = ct; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), c = i - r * (D / 8);
    const int row = rw0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < it.rows) {
      const int t = row / it.g, head = it.hk * it.g + row - t * it.g;
      v = *reinterpret_cast<const uint4*>(a.q + (((size_t)it.b * a.T + t) * a.H + head) * D +
                                          c * 8);
    }
    *reinterpret_cast<uint4*>(qs + (c >> 3) * BR * 128 + sw128(64 * wg + r, c & 7)) = v;
  }
  fence_proxy_async();
  bar_sync(2 + wg, 128);
  constexpr bool QREG = D <= 128;
  uint32_t qf[QREG ? D / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const int r = 64 * wg + 16 * warp + (lane & 15), c = 2 * kd + (lane >> 4);
      tc::ldmatrix_x4(qf[kd], qs + (c >> 3) * BR * 128 + sw128(r, c & 7));
    }
  }

  int lim[2];  // key s is visible to this thread's row h iff s < lim[h]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rw0 + 16 * warp + gq + 8 * h;
    lim[h] = row < it.rows ? min(a.attend_len, it.pb + row / it.g + 1) : 0;
  }
  const int full_end = min(a.attend_len, it.pb + rw0 / it.g + 1);  // visible to all rows
  const uint8_t* mrow0 = a.mask ? a.mask + (size_t)it.b * a.mask_stride : nullptr;

  float o[D / 2], sc[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};
  for (int j = 0; j < it.ntiles; ++j) {
    const int s0 = j * BN;
    const unsigned char* kt = smem + C::RING_OFF + (j % C::STAGES) * 2 * C::TILE;
    mbar_wait(full + j % C::STAGES, (j / C::STAGES) & 1);

    // S = Q K^T (every register the products use written before the fence)
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const uint64_t kdesc = kmajor_sw128(kt + (kd >> 2) * C::BOX) + 2 * (kd & 3);
      if constexpr (QREG)
        Mma<BN>::run(sc, qf[kd], kdesc, kd > 0);
      else
        Mma64SS::run(sc, kmajor_sw128(qs + (kd >> 2) * BR * 128 + 64 * wg * 128) + 2 * (kd & 3),
                     kdesc, kd > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scale, mask and the online softmax; sc[4i + 2h + e] is key 8i + 2q4 +
    // e of row h (gq, gq + 8). Tiles that cross the diagonal (DIAG) and a
    // padded batch (PAD) take their own copies of the loop.
    const float* kst = reinterpret_cast<const float*>(smem + C::SC_OFF + (j % C::STAGES) * C::SC);
    const float* vst = kst + BN;
    float alpha[2];
    auto softmax = [&](auto diag_tag, auto pad_tag) {
      constexpr bool DIAG = decltype(diag_tag)::value, PAD = decltype(pad_tag)::value;
      const uint8_t* mrow = PAD ? mrow0 + s0 : nullptr;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = MASK_VALUE;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * i + 2 * q4 + e;
            float v = sc[4 * i + 2 * h + e];
            if constexpr (KV != 0) v *= kst[c];  // the K scale, then 1/sqrt(D)
            v *= a.scale;
            if (DIAG && s0 + c >= lim[h])
              v = MASK_VALUE;
            else if (PAD && mrow[c] == 0)
              v += NEG_INF;  // pad bias after the causal mask
            sc[4 * i + 2 * h + e] = v;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = __expf(m[h] - m_new);
        m[h] = m_new;
        float ps = 0.f;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * i + 2 * q4 + e;
            float p = __expf(sc[4 * i + 2 * h + e] - m_new);
            if (DIAG && s0 + c >= lim[h]) p = 0.f;
            ps += p;  // l sums the unscaled p
            if constexpr (KV != 0) p *= vst[c];
            sc[4 * i + 2 * h + e] = p;
          }
        l[h] = alpha[h] * l[h] + ps;  // per thread; the quad is summed at the end
      }
    };
    using T = std::true_type;
    using F = std::false_type;
    if (s0 + BN > full_end)
      mrow0 ? softmax(T{}, T{}) : softmax(T{}, F{});
    else
      mrow0 ? softmax(F{}, T{}) : softmax(F{}, F{});
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {  // O's rows rescaled to the new maxima
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }

    // O += P V: P rounded to bf16 in A's register layout, V MN-major
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = tc::pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = tc::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = tc::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = tc::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    const unsigned char* vt = kt + C::TILE;
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      Mma<D>::template run<1>(o, pa[kk], mnmajor_sw128(vt + kk * 2048, C::BOX));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + j % C::STAGES);  // the stage is free
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float ll = l[h];
    ll += __shfl_xor_sync(0xffffffffu, ll, 1);
    ll += __shfl_xor_sync(0xffffffffu, ll, 2);
    if (ll == 0.f) ll = 1.f;
    const int row = rw0 + 16 * warp + gq + 8 * h;
    if (row >= it.rows) continue;
    const int t = row / it.g, head = it.hk * it.g + row - t * it.g;
    bf16* dst = a.out + (((size_t)it.b * a.T + t) * a.H + head) * D + 2 * q4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2 * h] / ll, o[4 * n + 2 * h + 1] / ll);
  }
}

template <int D, int KV, int CW>
__global__ void __launch_bounds__(Cfg<D, KV, CW>::THREADS, 1)
    prefill_wg_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const Args a) {
  using C = Cfg<D, KV, CW>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + 8;
  uint64_t* rfull = empty + 8;
  uint64_t* rempty = rfull + 8;
  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid == 0) {
    if (tc::smem_addr(smem) & 1023) __trap();
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, KV ? C::PW - 1 : 1);  // the converting warps; the TMA thread
      mbar_init(empty + s, 4 * CW);     // the consumer warps
    }
    for (int s = 0; s < C::RSTAGES; ++s) {
      mbar_init(rfull + s, 1);
      mbar_init(rempty + s, C::PW - 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CW) {  // the producer warps
    const int pt = tid - 128 * CW;
    const Item it = Item::of<C::BR, C::BN>(a);
    if (pt == 0) {
      produce<D, KV, CW>(&kmap, &vmap, a, it, smem, full, empty, rfull, rempty);
    } else if constexpr (KV != 0) {
      if (pt >= 32) convert<D, KV, CW>(a, it, smem, full, empty, rfull, rempty, pt - 32);
    }
  } else {
    const Item it = Item::of<C::BR, C::BN>(a);
    consume<D, KV, CW>(a, it, smem, full, empty, warp >> 2, tid & 127);
  }
}

// The 3-D maps of the K and V caches' first attend_len rows of each (batch
// row, kv head) strip: bf16 in 64-column boxes of BN rows, 128-byte
// swizzled; raw int8 / int4 bytes as one box a tile's rows, unswizzled.
template <int D, int KV, int CW>
cudaError_t maps(CUtensorMap (&m)[2], const void* k_cache, const void* v_cache, int BH, int S,
                 int attend_len) {
  using C = Cfg<D, KV, CW>;
  const void* ptrs[2] = {k_cache, v_cache};
  for (int i = 0; i < 2; ++i) {
    MapKey key = KV == 0 ? MapKey{ptrs[i], (uint64_t)D, (uint64_t)attend_len, 64u,
                                  (uint32_t)C::BN, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                  CU_TENSOR_MAP_SWIZZLE_128B}
                         : MapKey{ptrs[i], (uint64_t)C::RAW_ROW, (uint64_t)attend_len,
                                  (uint32_t)C::RAW_ROW, (uint32_t)C::BN,
                                  CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, CU_TENSOR_MAP_SWIZZLE_NONE};
    key.outer2 = (uint64_t)BH;
    key.stride2 = (uint64_t)S * (KV == 0 ? D * 2 : C::RAW_ROW);
    const cudaError_t e = tensor_map(&m[i], key);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int D, int KV, int CW>
cudaError_t launch(const Args& a, const void* k_cache, const void* v_cache, cudaStream_t st) {
  using C = Cfg<D, KV, CW>;
  static const cudaError_t ok = allow_smem(prefill_wg_kernel<D, KV, CW>, C::SMEM);
  if (ok != cudaSuccess) return ok;
  CUtensorMap m[2];
  const cudaError_t e = maps<D, KV, CW>(m, k_cache, v_cache, a.B * a.Hkv, a.S, a.attend_len);
  if (e != cudaSuccess) return e;
  const int rows = a.T * (a.H / a.Hkv);
  prefill_wg_kernel<D, KV, CW>
      <<<(rows + C::BR - 1) / C::BR * a.B * a.Hkv, C::THREADS, C::SMEM, st>>>(m[0], m[1], a);
  return cudaGetLastError();
}

}  // namespace fwg
