// K3 flash_attn: causal GQA attention over the KV cache (bf16, int8 or packed
// int4), any T.
//
// Replaces the TPU kernels exllama_tpu/ops/attention.py:_flash_kernel (via
// _attend_flash_padded, launched at attention.py:747) and
// _flash_prefill_kernel (via _attend_flash_prefill, attention.py:967):
// online-softmax attention in which query rows are grouped per kv head
// (row = t*g + slot, attention.py:1006-1008; no repeat_kv), causal on the
// absolute position (key s visible iff s <= past+t, or s < past+t in
// deferred mode, with past a per-row cursor), reading only
// cache[:, :, :attend_len], honouring the left-pad input mask, and in
// deferred (decode) mode folding in the in-flight K/V row after the cache
// (attention.py:594-613). Softmax scale 1/sqrt(D); p is cast to bf16 before
// the PV product. Causally masked scores use the finite _MASK_VALUE and get
// p = 0; left-pad keys get the finite bias NEG_INF added after that, as the
// TPU kernel adds its bias (attention.py:563-565), so a query row whose
// visible keys are all padding averages V over them; the l == 0 -> 1 guard
// stays for a row with no causal key.
//
// A quantized cache (KV = 1: int8 [B, Hkv, S, D]; KV = 2: int4, bytes
// [B, Hkv, S, D/2], byte d holding dims d (low nibble, q + 8) and d + D/2
// (high nibble, two's complement); one f32 scale per (b, kv head, key) for K
// and for V) follows the TPU kernels' arithmetic (attention.py:544-586,
// :829-866): the raw integers, exact in bf16, enter the QK^T product; the f32
// score is multiplied by the key's K scale and then by 1/sqrt(D); the key's V
// scale multiplies p before p is rounded to bf16 for PV, while l sums the
// unscaled p. The in-flight row of a deferred step stays bf16.
//
// Bound on the H100: bytes at decode (T=1: every cache byte is read for ~2
// flops per element: 32.8 MB at Llama-7B, past 2000 in bf16, 16.9 MB in
// int8 and 8.7 MB in int4 with their scales), operations at long prefill
// (T*S*D*4 flops over the same cache bytes, on bf16 tensor cores in every
// format). The wrapper (ops/attention.py:attend) picks one of two paths by
// shape; both stage 64-key tiles of K and V (and the scales) through a ring
// of cp.async copies, so the loads of later tiles are in flight while the
// current one is computed.
//
// (a) Decode, split-KV (T = 1, or at most 16 query rows per kv head): one
// block per work item (batch row, kv head, group of R query rows, key
// split); the splits are sized by the wrapper (attention.split_plan) so
// that the items cover the card about twice -- at 7B, B=1 the 32 (batch
// row, kv head) pairs alone would fill 32 of 132 SMs. Inside a split each of
// the 4 warps keeps an online softmax over its 16 keys of every tile: two
// lanes per key for the scores (each a half of the head dims, the R rows
// sharing each staged key), D/32 head dims per lane for PV. The block merges
// its warps and writes (m, l, acc) partials [.., R, D + 2] f32 to scratch;
// the last block of each (batch row, kv head, row group) -- found by an
// atomic ticket, which it resets -- combines the splits, folds in the
// in-flight row and writes bf16. A split with no visible key carries
// m = MASK_VALUE, l = 0 and weighs nothing.
//
// (b) Prefill, on Hopper's own instructions (flash_prefill_wg.cuh): a
// producer warp keeps TMA loads of K and V tiles in flight into an mbarrier
// ring (over an int8 / int4 cache three more warps convert each raw tile
// into bf16 there); one or two consumer warpgroups of 64 query rows run S = QK^T
// and O += PV on wgmma, P as the register operand of PV and V read
// MN-major. Key tiles wholly above the causal diagonal are not read; only
// tiles that cross it are masked element by element; the heaviest query
// tiles are launched first. Its parent, FlashAttention-2 tiles on
// mma.sync with a 2-stage cp.async ring (prefill_kernel below: Q fragments
// by ldmatrix, S = QK^T on mma.sync.m16n8k16, the online softmax on the S
// fragment, the S fragment rounded to bf16 as PV's A fragment; int8 / int4
// tiles converted to bf16 in shared memory by all threads), stays
// reachable only through flash_attn_prefill_fa2_launch, which chip_smoke.py
// times beside the new kernel; flash_attn_prefill_fa2_launches counts it.
#include <atomic>
#include <type_traits>

#include "async_mma.cuh"
#include "flash_prefill_wg.cuh"

#ifndef FLASH_D256
#define FLASH_D256 0  // 1: the library of head_dim 256 (one library per set of head dims)
#endif

namespace {

constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;  // attention.py:37
constexpr float NEG_INF = -1e9f;                               // attention.py:36
constexpr int BC = 64;                                         // keys per staged tile
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const bf16* q;          // [B, T, H, D]
  const void* k_cache;    // [B, Hkv, S, D] bf16 | int8, or [.., D/2] int4 bytes
  const void* v_cache;
  const float* k_scale;   // [B, Hkv, S] (NULL for a bf16 cache)
  const float* v_scale;
  const int32_t* past;    // [B]
  const uint8_t* mask;    // [B, mask_stride] (1 = real token) or NULL
  const bf16* k_new;      // [B, 1, Hkv, D] in-flight rows, or NULL
  const bf16* v_new;
  bf16* out;              // [B, T, H, D]
  float* part;            // decode: [B, Hkv, ngroups, nsplit, R, D + 2] partials
  int* ticket;            // decode: [B, Hkv, ngroups], zero between launches
  int B, T, H, Hkv, S, attend_len, mask_stride, nsplit, chunk, ngroups;
  float scale;
};

// Bytes of one cached row, and its stride in shared memory: 16 bytes of
// padding keep ldmatrix and the per-lane 16-byte reads free of bank
// conflicts.
template <int D, int KV>
struct Row {
  static constexpr int bytes = KV == 0 ? D * 2 : KV == 1 ? D : D / 2;
  static constexpr int ld = bytes + 16;
  static constexpr int tile = 2 * BC * ld + (KV ? 2 * BC * 4 : 0);  // K, V (+ scales)
};

// Issue the copies of the tile of BC keys from s0 into dst: K rows, V rows
// ([BC][ld] each; keys >= kv_end zero-filled) and, for a quantized cache, K
// and V scales ([BC] f32 each; 4-byte copies, since a strip of S scales
// need not be 16-byte aligned). Every thread of the block calls it.
template <int D, int KV, int NT>
__device__ __forceinline__ void issue_tile(unsigned char* dst, const unsigned char* kb,
                                           const unsigned char* vb, const float* ksb,
                                           const float* vsb, int s0, int kv_end) {
  using RW = Row<D, KV>;
  constexpr int CPR = RW::bytes / 16;
  unsigned char* vdst = dst + BC * RW::ld;
  for (int i = threadIdx.x; i < BC * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * 16;
    const int s = s0 + r;
    const int n = s < kv_end ? 16 : 0;
    const size_t off = (size_t)(n ? s : 0) * RW::bytes + c;
    tc::cp_async16(dst + r * RW::ld + c, kb + off, n);
    tc::cp_async16(vdst + r * RW::ld + c, vb + off, n);
  }
  if constexpr (KV != 0) {
    float* sc = reinterpret_cast<float*>(vdst + BC * RW::ld);
    for (int i = threadIdx.x; i < 2 * BC; i += NT) {
      const int s = s0 + (i & (BC - 1));
      const int n = s < kv_end ? 4 : 0;
      tc::cp_async4(sc + i, (i < BC ? ksb : vsb) + (n ? s : 0), n);
    }
  }
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 16 integer-valued floats -> 16 bf16 (exact) at a 16-byte aligned address.
__device__ __forceinline__ void put16(bf16* dst, const float (&f)[16]) {
  __align__(16) __nv_bfloat162 h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
  reinterpret_cast<uint4*>(dst)[0] = *reinterpret_cast<const uint4*>(&h[0]);
  reinterpret_cast<uint4*>(dst)[1] = *reinterpret_cast<const uint4*>(&h[4]);
}

// 16 cache bytes at byte column c of a row into the bf16 row dst[D]:
// int8 -> dims c..c+15; int4 -> dims c..c+15 (low nibbles) and D/2 + c..
// (high nibbles), as unpack_kv4 (attention.py:97).
template <int D, int KV>
__device__ __forceinline__ void stage16(bf16* dst, int c, const uint4& raw) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  float f[16];
  if constexpr (KV == 1) {
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = (float)b[e];
    put16(dst + c, f);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = (float)((b[e] & 15) - 8);
    put16(dst + c, f);
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = (float)(b[e] >> 4);
    put16(dst + D / 2 + c, f);
  }
}

// ------------------------------------------------------- (a) decode, split-KV

constexpr int DW = 4, DT = DW * 32;  // warps, threads of a decode block
constexpr int D_STAGES = 3;
constexpr int KPW = BC / DW;         // keys per warp and tile

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int D, int KV, int R>
struct DecSmem {
  static constexpr int ring = D_STAGES * Row<D, KV>::tile;
  static constexpr int merge = DW * R * (D + 2) * 4;  // after the loop, over the ring
  static constexpr int q_off = ((ring > merge ? ring : merge) + 15) & ~15;
  static constexpr int sn_off = q_off + R * D * 4;    // [R] in-flight scores
  static constexpr int flag_off = sn_off + R * 4;
  static constexpr int bytes = flag_off + 16;
};

// The partial score of this lane's half of the head dims of the staged key
// row krow against each of the R query rows qs [R][D] (f32).
template <int D, int KV, int R>
__device__ __forceinline__ void half_scores(const unsigned char* krow, const float* qs, int half,
                                            float (&sc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) sc[r] = 0.f;
  if constexpr (KV == 0) {
#pragma unroll
    for (int v8 = 0; v8 < D / 16; ++v8) {
      const int d0 = half * (D / 2) + v8 * 8;
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(krow + d0 * 2), f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(qs + r * D + d0);
        const float4 c = *reinterpret_cast<const float4*>(qs + r * D + d0 + 4);
        sc[r] = fmaf(a.x, f[0], sc[r]);
        sc[r] = fmaf(a.y, f[1], sc[r]);
        sc[r] = fmaf(a.z, f[2], sc[r]);
        sc[r] = fmaf(a.w, f[3], sc[r]);
        sc[r] = fmaf(c.x, f[4], sc[r]);
        sc[r] = fmaf(c.y, f[5], sc[r]);
        sc[r] = fmaf(c.z, f[6], sc[r]);
        sc[r] = fmaf(c.w, f[7], sc[r]);
      }
    }
  } else if constexpr (KV == 1) {
#pragma unroll
    for (int v16 = 0; v16 < D / 32; ++v16) {
      const int d0 = half * (D / 2) + v16 * 16;
      const uint4 u = *reinterpret_cast<const uint4*>(krow + d0);
      const int8_t* bq = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(qs + r * D + d0 + 4 * e4);
          sc[r] = fmaf(a.x, (float)bq[4 * e4], sc[r]);
          sc[r] = fmaf(a.y, (float)bq[4 * e4 + 1], sc[r]);
          sc[r] = fmaf(a.z, (float)bq[4 * e4 + 2], sc[r]);
          sc[r] = fmaf(a.w, (float)bq[4 * e4 + 3], sc[r]);
        }
    }
  } else {  // int4: byte c holds dims c (low nibble) and c + D/2 (high)
#pragma unroll
    for (int v16 = 0; v16 < D / 64; ++v16) {
      const int c0 = half * (D / 4) + v16 * 16;
      const uint4 u = *reinterpret_cast<const uint4*>(krow + c0);
      const int8_t* bq = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 lo = *reinterpret_cast<const float4*>(qs + r * D + c0 + 4 * e4);
          const float4 hi = *reinterpret_cast<const float4*>(qs + r * D + D / 2 + c0 + 4 * e4);
          const float ql[4] = {lo.x, lo.y, lo.z, lo.w}, qh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int byte = bq[4 * e4 + e];
            sc[r] = fmaf(ql[e], (float)((byte & 15) - 8), sc[r]);
            sc[r] = fmaf(qh[e], (float)(byte >> 4), sc[r]);
          }
        }
    }
  }
}

// Head dims lane*DPL .. +DPL-1 of the staged V row vrow, raw (int8: the
// integers; int4: lanes 0-15 the low nibbles, lanes 16-31 the high nibbles of
// the same bytes).
template <int D, int KV>
__device__ __forceinline__ void v_dims(const unsigned char* vrow, int lane,
                                       float (&v)[D / 32]) {
  constexpr int DPL = D / 32;
  if constexpr (KV == 0) {
    if constexpr (DPL == 8) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(vrow + lane * 16), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = f[e];
    } else if constexpr (DPL == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(vrow + lane * 8);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v[0] = a.x, v[1] = a.y, v[2] = c.x, v[3] = c.y;
    } else {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(vrow + lane * 4);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
      v[0] = a.x, v[1] = a.y;
    }
  } else {
    const int off = KV == 1 ? lane * DPL : (lane & 15) * DPL;
    uint64_t w;
    if constexpr (DPL == 8)
      w = *reinterpret_cast<const uint64_t*>(vrow + off);
    else if constexpr (DPL == 4)
      w = *reinterpret_cast<const uint32_t*>(vrow + off);
    else
      w = *reinterpret_cast<const uint16_t*>(vrow + off);
    const bool hi = lane >= 16;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int b = (int)(int8_t)(w >> (8 * e));
      v[e] = KV == 1 ? (float)b : (float)(hi ? b >> 4 : (b & 15) - 8);
    }
  }
}

template <int D, int KV, int R>
__global__ void __launch_bounds__(DT) decode_kernel(const Args a) {
  using RW = Row<D, KV>;
  using SM = DecSmem<D, KV, R>;
  constexpr int DPL = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + SM::q_off);  // [R][D]
  float* sn = reinterpret_cast<float*>(smem + SM::sn_off);
  int* flag = reinterpret_cast<int*>(smem + SM::flag_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = a.H / a.Hkv, rows = a.T * g;
  int item = blockIdx.x;
  const int split = item % a.nsplit;
  const int bhg = item / a.nsplit;  // (batch row, kv head, row group)
  const int rg = bhg % a.ngroups, bh = bhg / a.ngroups;
  const int hk = bh % a.Hkv, b = bh / a.Hkv;
  const int row0 = rg * R, nrows = min(R, rows - row0);
  const int pb = a.past[b];
  const bool deferred = a.k_new != nullptr;
  const int add = deferred ? 0 : 1;

  // key s is visible to row r iff s < lim[r]
  int lim[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    lim[r] = r < nrows ? min(a.attend_len, pb + (row0 + r) / g + add) : 0;
  const int kv_end = min(a.attend_len, pb + (row0 + nrows - 1) / g + add);
  const int s_begin = split * a.chunk;
  const int s_end = min(kv_end, s_begin + a.chunk);
  const int ntiles = s_end > s_begin ? (s_end - s_begin + BC - 1) / BC : 0;

  const size_t strip = ((size_t)b * a.Hkv + hk) * a.S;
  const unsigned char* kb = static_cast<const unsigned char*>(a.k_cache) + strip * RW::bytes;
  const unsigned char* vb = static_cast<const unsigned char*>(a.v_cache) + strip * RW::bytes;
  const float* ksb = KV ? a.k_scale + strip : nullptr;
  const float* vsb = KV ? a.v_scale + strip : nullptr;

#pragma unroll
  for (int st = 0; st < D_STAGES - 1; ++st) {
    if (st < ntiles)
      issue_tile<D, KV, DT>(smem + st * RW::tile, kb, vb, ksb, vsb, s_begin + st * BC, s_end);
    tc::cp_async_commit();
  }
  for (int i = tid; i < R * D; i += DT) {
    const int r = i / D, d = i - r * D;
    float v = 0.f;
    if (r < nrows) {
      const int row = row0 + r, t = row / g, head = hk * g + row - t * g;
      v = bf2f(a.q[(((size_t)b * a.T + t) * a.H + head) * D + d]);
    }
    qs[i] = v;
  }

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = MASK_VALUE;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }
  const int kk = lane & 15, half = lane >> 4;  // lanes l, l + 16: one key, two halves
  for (int j = 0; j < ntiles; ++j) {
    tc::cp_async_wait<D_STAGES - 2>();
    __syncthreads();  // tile j landed for all; tile j - 1 consumed by all
    {
      const int nt = j + D_STAGES - 1;
      if (nt < ntiles)
        issue_tile<D, KV, DT>(smem + (nt % D_STAGES) * RW::tile, kb, vb, ksb, vsb,
                              s_begin + nt * BC, s_end);
      tc::cp_async_commit();
    }
    const unsigned char* kt = smem + (j % D_STAGES) * RW::tile;
    const unsigned char* vt = kt + BC * RW::ld;
    const int key = warp * KPW + kk;
    const int s = s_begin + j * BC + key;
    float sc[R];
    half_scores<D, KV, R>(kt + key * RW::ld, qs, half, sc);
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] += __shfl_xor_sync(FULL, sc[r], 16);
    float ksc = 1.f, vsc = 1.f;
    if constexpr (KV != 0) {
      const float* kst = reinterpret_cast<const float*>(vt + BC * RW::ld);
      ksc = kst[key];
      vsc = kst[BC + key];
    }
    const bool pad = s < s_end && a.mask != nullptr &&
                     a.mask[(size_t)b * a.mask_stride + s] == 0;
    float pbf[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool ok = s < s_end && s < lim[r];
      float v = MASK_VALUE;
      if (ok) {
        v = sc[r];
        if constexpr (KV != 0) v *= ksc;  // the K scale, then 1/sqrt(D)
        v *= a.scale;
        if (pad) v += NEG_INF;  // pad bias after the causal mask
      }
      const float m_new = fmaxf(m[r], max16(v));
      const float alpha = expf(m[r] - m_new);
      const float p = ok ? expf(v - m_new) : 0.f;
      l[r] = alpha * l[r] + sum16(p);  // l sums the unscaled p
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
      pbf[r] = bf2f(f2bf(KV != 0 ? p * vsc : p));  // V scale on p, then bf16
    }
#pragma unroll 4
    for (int k2 = 0; k2 < KPW; ++k2) {
      float v[DPL];
      v_dims<D, KV>(vt + (warp * KPW + k2) * RW::ld, lane, v);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pk = __shfl_sync(FULL, pbf[r], k2);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pk, v[e], acc[r][e]);
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' states go over it

  float* wm = reinterpret_cast<float*>(smem);  // [DW][R]
  float* wl = wm + DW * R;                     // [DW][R]
  float* wa = wl + DW * R;                     // [DW][R][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      wm[warp * R + r] = m[r];
      wl[warp * R + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) wa[(warp * R + r) * D + lane * DPL + e] = acc[r][e];
  }
  __syncthreads();
  float* part = a.part + (size_t)item * R * (D + 2);
  for (int i = tid; i < R * D; i += DT) {
    const int r = i / D, d = i - r * D;
    float mm = MASK_VALUE;
#pragma unroll
    for (int w = 0; w < DW; ++w) mm = fmaxf(mm, wm[w * R + r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < DW; ++w) {
      const float f = expf(wm[w * R + r] - mm);
      ll += f * wl[w * R + r];
      aa += f * wa[(w * R + r) * D + d];
    }
    part[r * (D + 2) + d] = aa;
    if (d == 0) {
      part[r * (D + 2) + D] = mm;
      part[r * (D + 2) + D + 1] = ll;
    }
  }

  // the last split of this (batch row, kv head, row group) to finish
  // combines them all
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(a.ticket + bhg, 1) == a.nsplit - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (deferred)  // in-flight scores s_new = q . k_new (no pad bias, no scale)
    for (int r = warp; r < nrows; r += DW) {
      const bf16* krow = a.k_new + ((size_t)b * a.Hkv + hk) * D;
      float d = 0.f;
      for (int c = lane; c < D; c += 32) d += qs[r * D + c] * bf2f(krow[c]);
      d = warp_sum(d);
      if (lane == 0) sn[r] = d * a.scale;
    }
  __syncthreads();
  const float* base = a.part + (size_t)bhg * a.nsplit * R * (D + 2);
  const size_t stride = (size_t)R * (D + 2);
  for (int i = tid; i < nrows * D; i += DT) {
    const int r = i / D, d = i - r * D;
    const float* pr = base + r * (D + 2);
    float mm = MASK_VALUE;
    for (int sp = 0; sp < a.nsplit; ++sp) mm = fmaxf(mm, __ldcg(pr + sp * stride + D));
    float ll = 0.f, aa = 0.f;
    for (int sp = 0; sp < a.nsplit; ++sp) {
      const float f = expf(__ldcg(pr + sp * stride + D) - mm);
      ll += f * __ldcg(pr + sp * stride + D + 1);
      aa += f * __ldcg(pr + sp * stride + d);
    }
    if (deferred) {
      const float m_fin = fmaxf(mm, sn[r]);
      const float alpha = expf(mm - m_fin), pn = expf(sn[r] - m_fin);
      ll = alpha * ll + pn;
      aa = alpha * aa + pn * bf2f(a.v_new[((size_t)b * a.Hkv + hk) * D + d]);
    }
    if (ll == 0.f) ll = 1.f;
    const int row = row0 + r, t = row / g, head = hk * g + row - t * g;
    a.out[(((size_t)b * a.T + t) * a.H + head) * D + d] = f2bf(aa / ll);
  }
  if (tid == 0) a.ticket[bhg] = 0;  // ready for the next launch
}

// ------------------------------- (b) prefill, FA2 style: the parent only

constexpr int PW = 4, BR = PW * 16;  // warps of 16 query rows, query rows of a block
constexpr int P_STAGES = 2;

// At D = 256 a warp's O fragment alone would be 128 f32 registers a
// thread, so the head dims of O are split across two warps: warps w and
// w + PW own the same 16 query rows, both compute its S and softmax (the
// same values, in the same order), and each multiplies P by its half of V.
template <int D>
struct PreShape {
  static constexpr int DS = D > 128 ? 2 : 1;  // warps sharing a row strip
  static constexpr int NT = PW * DS * 32;     // threads of a block
  static constexpr int DO = D / DS;           // head dims of O a warp owns
};

template <int D, int KV>
struct PreSmem {
  static constexpr int LD = D + 8;             // bf16 elements of a staged row
  static constexpr int kv_tile = BC * LD * 2;  // one bf16 K or V tile
  static constexpr int ring_off = BR * LD * 2;
  static constexpr int conv_off = ring_off + P_STAGES * Row<D, KV>::tile;
  static constexpr int bytes = conv_off + (KV ? 2 * kv_tile : 0);
};

template <int D, int KV>
__global__ void __launch_bounds__(PreShape<D>::NT) prefill_kernel(const Args a) {
  using RW = Row<D, KV>;
  using P = PreSmem<D, KV>;
  constexpr int LD = P::LD;
  constexpr int PT = PreShape<D>::NT, DO = PreShape<D>::DO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + P::ring_off;

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) % PW, dh = (tid >> 5) / PW;  // row strip, O half
  const int gq = lane >> 2, q4 = lane & 3;
  const int g = a.H / a.Hkv, rows = a.T * g;
  const int nqt = (rows + BR - 1) / BR, nbh = a.B * a.Hkv;
  const int qt = nqt - 1 - (int)blockIdx.x / nbh;  // heaviest query tiles first
  const int bh = blockIdx.x % nbh, b = bh / a.Hkv, hk = bh % a.Hkv;
  const int r0 = qt * BR;
  const int pb = a.past[b];
  const int kv_end = min(a.attend_len, pb + (min(rows, r0 + BR) - 1) / g + 1);
  const int full_end = min(a.attend_len, pb + r0 / g + 1);  // visible to every row
  const int ntiles = (kv_end + BC - 1) / BC;

  const size_t strip = ((size_t)b * a.Hkv + hk) * a.S;
  const unsigned char* kb = static_cast<const unsigned char*>(a.k_cache) + strip * RW::bytes;
  const unsigned char* vb = static_cast<const unsigned char*>(a.v_cache) + strip * RW::bytes;
  const float* ksb = KV ? a.k_scale + strip : nullptr;
  const float* vsb = KV ? a.v_scale + strip : nullptr;

  for (int i = tid; i < BR * (D / 8); i += PT) {
    const int r = i / (D / 8), c = (i - r * (D / 8)) * 8;
    const int row = r0 + r;
    const bf16* src = a.q;
    if (row < rows) {
      const int t = row / g, head = hk * g + row - t * g;
      src = a.q + (((size_t)b * a.T + t) * a.H + head) * D + c;
    }
    tc::cp_async16(Qs + r * LD + c, src, row < rows ? 16 : 0);
  }
  tc::cp_async_commit();
#pragma unroll
  for (int st = 0; st < P_STAGES - 1; ++st) {
    if (st < ntiles) issue_tile<D, KV, PT>(ring + st * RW::tile, kb, vb, ksb, vsb, st * BC, kv_end);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<P_STAGES - 1>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    tc::ldmatrix_x4(qf[kd], Qs + (warp * 16 + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8);

  // this thread's rows: warp*16 + gq (h = 0) and + 8 (h = 1)
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + gq + 8 * h;
    lim[h] = row < rows ? min(a.attend_len, pb + row / g + 1) : 0;
  }
  float o[DO / 8][4];
#pragma unroll
  for (int n = 0; n < DO / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    tc::cp_async_wait<P_STAGES - 2>();
    __syncthreads();  // tile j landed for all; tile j - 1 consumed by all
    {
      const int nt = j + P_STAGES - 1;
      if (nt < ntiles)
        issue_tile<D, KV, PT>(ring + (nt % P_STAGES) * RW::tile, kb, vb, ksb, vsb, nt * BC, kv_end);
      tc::cp_async_commit();
    }
    const unsigned char* st = ring + (j % P_STAGES) * RW::tile;
    const bf16* Kt;
    const bf16* Vt;
    const float* kst = nullptr;
    const float* vst = nullptr;
    if constexpr (KV == 0) {
      Kt = reinterpret_cast<const bf16*>(st);
      Vt = Kt + BC * LD;
    } else {  // the integers, exact in bf16, converted in shared memory
      bf16* Kc = reinterpret_cast<bf16*>(smem + P::conv_off);
      bf16* Vc = Kc + BC * LD;
      constexpr int CPR = RW::bytes / 16;
      for (int i = tid; i < BC * CPR; i += PT) {
        const int r = i / CPR, c = (i - r * CPR) * 16;
        stage16<D, KV>(Kc + r * LD, c, *reinterpret_cast<const uint4*>(st + r * RW::ld + c));
        stage16<D, KV>(Vc + r * LD, c,
                       *reinterpret_cast<const uint4*>(st + (BC + r) * RW::ld + c));
      }
      kst = reinterpret_cast<const float*>(st + 2 * BC * RW::ld);
      vst = kst + BC;
      __syncthreads();
      Kt = Kc;
      Vt = Vc;
    }
    const int s0 = j * BC;

    // S = Q K^T: this warp's 16 rows x 64 keys, 8 fragments of 16x8
    float sacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        tc::ldmatrix_x4(kf, Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kd * 16 +
                                ((lane >> 3) & 1) * 8);
        tc::mma_bf16(sacc[2 * np], qf[kd], kf[0], kf[1]);
        tc::mma_bf16(sacc[2 * np + 1], qf[kd], kf[2], kf[3]);
      }

    // scale, mask and the online softmax on the fragment; a thread holds
    // keys 8n + 2*q4 + {0, 1} of rows h = 0, 1
    const bool diag = s0 + BC > full_end;
    const uint8_t* mrow = a.mask ? a.mask + (size_t)b * a.mask_stride + s0 : nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = MASK_VALUE;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * q4 + e;
          float v = sacc[n][2 * h + e];
          if constexpr (KV != 0) v *= kst[c];  // the K scale, then 1/sqrt(D)
          v *= a.scale;
          if (diag && s0 + c >= lim[h])
            v = MASK_VALUE;
          else if (mrow != nullptr && mrow[c] == 0)
            v += NEG_INF;  // pad bias after the causal mask
          sacc[n][2 * h + e] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = __expf(m[h] - m_new);
      m[h] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * q4 + e;
          const bool ok = !diag || s0 + c < lim[h];
          float p = ok ? __expf(sacc[n][2 * h + e] - m_new) : 0.f;
          ps += p;  // l sums the unscaled p
          if constexpr (KV != 0) p *= vst[c];
          sacc[n][2 * h + e] = p;
        }
      l[h] = alpha * l[h] + ps;  // per thread; the quad is summed at the end
#pragma unroll
      for (int n = 0; n < DO / 8; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }

    // O += P V: P's fragments, rounded to bf16, are the A operand
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint32_t pa[4] = {tc::pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                              tc::pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                              tc::pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                              tc::pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DO / 16; ++dp) {
        uint32_t vf[4];
        tc::ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 15)) * LD + dh * DO + dp * 16 +
                                      (lane >> 4) * 8);
        tc::mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        tc::mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float ll = l[h];
    ll += __shfl_xor_sync(FULL, ll, 1);
    ll += __shfl_xor_sync(FULL, ll, 2);
    if (ll == 0.f) ll = 1.f;
    const int row = r0 + warp * 16 + gq + 8 * h;
    if (row >= rows) continue;
    const int t = row / g, head = hk * g + row - t * g;
    bf16* dst = a.out + (((size_t)b * a.T + t) * a.H + head) * D + dh * DO + 2 * q4;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[n][2 * h] / ll, o[n][2 * h + 1] / ll);
  }
}

template <int D, int KV, int R>
cudaError_t launch_decode(const Args& a, cudaStream_t st) {
  constexpr int bytes = DecSmem<D, KV, R>::bytes;
  static const cudaError_t smem_ok = allow_smem(decode_kernel<D, KV, R>, bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  decode_kernel<D, KV, R><<<a.B * a.Hkv * a.ngroups * a.nsplit, DT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D, int KV>
cudaError_t launch(const Args& a, const void* k_cache, const void* v_cache, int rows_per_item,
                   cudaStream_t st) {
  if (a.part != nullptr) {
    switch (rows_per_item) {
      case 1: return launch_decode<D, KV, 1>(a, st);
      case 2: return launch_decode<D, KV, 2>(a, st);
      case 4: return launch_decode<D, KV, 4>(a, st);
      case 8: return launch_decode<D, KV, 8>(a, st);
      case 16: return launch_decode<D, KV, 16>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  const fwg::Args p{a.q, a.k_scale, a.v_scale, a.past, a.mask, a.out,
                    a.B, a.T, a.H, a.Hkv, a.S, a.attend_len, a.mask_stride, a.scale};
  if (rows_per_item == 64) return fwg::launch<D, KV, 1>(p, k_cache, v_cache, st);
  if (rows_per_item == 128) return fwg::launch<D, KV, 2>(p, k_cache, v_cache, st);
  return cudaErrorInvalidValue;
}

template <int D, int KV>
cudaError_t launch_fa2(const Args& a, cudaStream_t st) {
  constexpr int bytes = PreSmem<D, KV>::bytes;
  static const cudaError_t smem_ok = allow_smem(prefill_kernel<D, KV>, bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  const int rows = a.T * (a.H / a.Hkv);
  prefill_kernel<D, KV><<<(rows + BR - 1) / BR * a.B * a.Hkv, PreShape<D>::NT, bytes, st>>>(a);
  return cudaGetLastError();
}

// The transposed-B wgmma building block alone: out[64 x N] f32 = a[64 x K]
// (bf16, row-major; per warp the m16n8k16 A fragment, from device memory)
// times b[K x N] (bf16, row-major: N contiguous), b staged into boxes of 64
// columns x K rows, 128-byte swizzled, and read MN-major (imm-trans-b 1)
// through hop::mnmajor_sw128's descriptor. One warpgroup.
template <int N>
__global__ void __launch_bounds__(128) tnsp_check_kernel(const bf16* a, const bf16* b, float* out,
                                                        int K) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int box = K * 128;
  for (int i = tid; i < K * (N / 8); i += 128) {
    const int r = i / (N / 8), c = i % (N / 8);
    *reinterpret_cast<uint4*>(smem + (c >> 3) * box + hop::sw128(r, c & 7)) =
        *reinterpret_cast<const uint4*>(b + (size_t)r * N + 8 * c);
  }
  hop::fence_proxy_async();
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const bf16* ar = a + (size_t)(16 * warp + g) * K + k0 + 2 * q;
    uint32_t af[4];
    af[0] = *reinterpret_cast<const uint32_t*>(ar);
    af[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * K);
    af[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
    af[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * K + 8);
    const uint64_t desc = hop::mnmajor_sw128(smem + k0 * 128, box);
    hop::wgmma_fence();
    hop::Mma<N>::template run<1>(d, af, desc);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(d);
  }
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(size_t)(16 * warp + g + 8 * (e >> 1)) * N + 8 * i + 2 * q + (e & 1)] = d[4 * i + e];
}

std::atomic<int> fa2_launches{0};  // the parent's, flash_attn_prefill_fa2_launch

}  // namespace

// q [B, T, H, D] bf16; k_cache, v_cache [B, Hkv, S, D] bf16 (kv_mode 0), int8
// (1) or [B, Hkv, S, D/2] int4 bytes (2); k_scale, v_scale [B, Hkv, S] f32
// (NULL for kv_mode 0); past [B] int32; mask [B, mask_stride] uint8 or NULL;
// k_new, v_new [B, 1, Hkv, D] bf16 or NULL (deferred mode, T = 1); out
// [B, T, H, D] bf16. D must be 64 or 128, or 256 in the library built with
// -DFLASH_D256=1 (which takes 256 only).
// Decode path (part != NULL): query rows are taken rows_per_item (1, 2, 4,
// 8 or 16) at a time; keys in nsplit splits of chunk (a multiple of 64,
// nsplit * chunk >= attend_len); part holds B*Hkv*ngroups*nsplit*
// rows_per_item*(D + 2) f32, ticket B*Hkv*ngroups int32 zeros, with ngroups
// = ceil(T*H/Hkv / rows_per_item). Prefill path: part, ticket NULL,
// rows_per_item the query rows of a block, 64 or 128
// (ops/attention.py:prefill_plan); the caches' rows 16-byte aligned.
extern "C" int flash_attn_launch(const void* q, const void* k_cache, const void* v_cache,
                                 const void* k_scale, const void* v_scale, const void* past,
                                 const void* mask, const void* k_new, const void* v_new,
                                 void* out, void* part, void* ticket, int B, int T, int H,
                                 int Hkv, int D, int S, int attend_len, int mask_stride,
                                 int kv_mode, int rows_per_item, int nsplit, int chunk,
                                 float scale, void* stream) {
  if ((kv_mode != 0) != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr))
    return cudaErrorInvalidValue;
  if ((part == nullptr) != (ticket == nullptr) || (k_new != nullptr && (part == nullptr || T != 1)))
    return cudaErrorInvalidValue;
  int ngroups = 0;
  if (part != nullptr) {
    if (rows_per_item < 1 || nsplit < 1 || chunk < BC || chunk % BC ||
        (long long)nsplit * chunk < attend_len)
      return cudaErrorInvalidValue;
    ngroups = (T * (H / Hkv) + rows_per_item - 1) / rows_per_item;
  }
  const Args a{(const bf16*)q, k_cache, v_cache, (const float*)k_scale, (const float*)v_scale,
               (const int32_t*)past, (const uint8_t*)mask, (const bf16*)k_new,
               (const bf16*)v_new, (bf16*)out, (float*)part, (int*)ticket,
               B, T, H, Hkv, S, attend_len, mask_stride, nsplit, chunk, ngroups, scale};
  auto by_kv = [&](auto d_tag) {
    constexpr int d = decltype(d_tag)::value;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (kv_mode) {
      case 0: return launch<d, 0>(a, k_cache, v_cache, rows_per_item, st);
      case 1: return launch<d, 1>(a, k_cache, v_cache, rows_per_item, st);
      case 2: return launch<d, 2>(a, k_cache, v_cache, rows_per_item, st);
      default: return cudaErrorInvalidValue;
    }
  };
#if FLASH_D256
  if (D == 256) return by_kv(std::integral_constant<int, 256>{});
#else
  if (D == 64) return by_kv(std::integral_constant<int, 64>{});
  if (D == 128) return by_kv(std::integral_constant<int, 128>{});
#endif
  return cudaErrorInvalidValue;
}

// The parent of K3's prefill path (chip_smoke.py's yardstick only): the
// FlashAttention-2 tiles on mma.sync. Arguments as flash_attn_launch's
// prefill path; the head dims of this library.
extern "C" int flash_attn_prefill_fa2_launch(const void* q, const void* k_cache,
                                             const void* v_cache, const void* k_scale,
                                             const void* v_scale, const void* past,
                                             const void* mask, void* out, int B, int T, int H,
                                             int Hkv, int D, int S, int attend_len,
                                             int mask_stride, int kv_mode, float scale,
                                             void* stream) {
  if ((kv_mode != 0) != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr))
    return cudaErrorInvalidValue;
  const Args a{(const bf16*)q, k_cache, v_cache, (const float*)k_scale, (const float*)v_scale,
               (const int32_t*)past, (const uint8_t*)mask, nullptr, nullptr, (bf16*)out,
               nullptr, nullptr, B, T, H, Hkv, S, attend_len, mask_stride, 0, 0, 0, scale};
  auto by_kv = [&](auto d_tag) {
    constexpr int d = decltype(d_tag)::value;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (kv_mode) {
      case 0: return launch_fa2<d, 0>(a, st);
      case 1: return launch_fa2<d, 1>(a, st);
      case 2: return launch_fa2<d, 2>(a, st);
      default: return cudaErrorInvalidValue;
    }
  };
  cudaError_t err = cudaErrorInvalidValue;
#if FLASH_D256
  if (D == 256) err = by_kv(std::integral_constant<int, 256>{});
#else
  if (D == 64) err = by_kv(std::integral_constant<int, 64>{});
  if (D == 128) err = by_kv(std::integral_constant<int, 128>{});
#endif
  if (err == cudaSuccess) ++fa2_launches;
  return err;
}

extern "C" int flash_attn_prefill_fa2_launches() { return fa2_launches.load(); }

// hop::Mma's transposed-B product checked alone (the tests): out [64 x n]
// f32 = a [64 x k] bf16 @ b [k x n] bf16; n 64, 128 or 256, k a multiple of
// 16 up to 128.
extern "C" int flash_attn_tnsp_check(const void* a, const void* b, void* out, int k, int n,
                                     void* stream) {
  if (k < 16 || k % 16 || k > 128) return cudaErrorInvalidValue;
  const int smem = (n / 64) * k * 128;
  auto go = [&](auto kernel) {
    const cudaError_t ok = allow_smem(kernel, smem);
    if (ok != cudaSuccess) return ok;
    kernel<<<1, 128, smem, (cudaStream_t)stream>>>((const bf16*)a, (const bf16*)b, (float*)out, k);
    return cudaGetLastError();
  };
  if (n == 64) return go(tnsp_check_kernel<64>);
  if (n == 128) return go(tnsp_check_kernel<128>);
  if (n == 256) return go(tnsp_check_kernel<256>);
  return cudaErrorInvalidValue;
}
