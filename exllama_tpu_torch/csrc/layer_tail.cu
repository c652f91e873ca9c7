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
// gemv_phase): at B = 1 the weights stream through a cp.async ring,
// stream-K over (256-column tile, 128-k unit) items shared evenly among
// the grid (q4_stream.cuh: a GEMV that split no K left the o and down
// projections of Llama-7B, 128 tiles of 32 columns, to 128 of the grid's
// blocks); at B >= 2 the tensor-core GEMV, its (128-column tile, K split)
// items planned to fill one wave of the grid (q4tc::plan_splits). The
// next phase's first weight slabs are put in flight before each grid
// barrier (fused::gemv_prefetch). Attention has only B*Hkv (batch row, kv
// head) pairs -- 32 at 7B, B=1, which is why the separate K3 decode
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
#include "fused_layer.cuh"

#ifndef KV_QUANT
#define KV_QUANT 0  // 1: the library for int8 / int4 KV caches
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

// The last split block of pair (b, hk): merge the pair's G heads' splits,
// in split order, into the bf16 attention row. A function of its own, out
// of line, so that its registers do not add to the attention phase's.
// (Its operands are passed by value: a reference to the kernel's parameter
// block would copy it to local memory.)
__device__ __noinline__ void merge_splits(const float* part, bf16* attn_scr, float* sm,
                                          int nsplit, int G, int H, int b, int hk, int bh) {
  __threadfence();
  // each split's m and l (one load each, all in flight), then per head the
  // weights exp(m - max m) and the merged l, then the sums of acc over the
  // splits in order, their loads unrolled
  const float* base = part + (size_t)bh * nsplit * G * (D + 2);
  const size_t stride = (size_t)G * (D + 2);
  float* wt = sm + ATT_WA;              // [G][nsplit]: the splits' m, then weights
  float* lw = wt + G * nsplit;          // [G][nsplit]: the splits' l
  float* lsum = lw + G * nsplit;        // [G]: the merged l
  for (int i = threadIdx.x; i < 2 * G * nsplit; i += THREADS) {
    const int r = i % (G * nsplit);
    wt[i] = __ldcg(base + (r % nsplit) * stride + (r / nsplit) * (D + 2) + D +
                   (i >= G * nsplit ? 1 : 0));
  }
  __syncthreads();
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
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int j = i / D, d = i - j * D;
    const float* pj = base + j * (D + 2) + d;
    float aa = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < nsplit; ++sp) aa += wt[j * nsplit + sp] * __ldcg(pj + sp * stride);
    attn_scr[(size_t)b * H * D + (size_t)(hk * G + j) * D + d] = f2bf(aa / lsum[j]);
  }
}

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
    merge_splits(p.part, p.attn_scr, sm, p.nsplit, G, p.H, b, hk, bh);
    if (threadIdx.x == 0) p.gsc.ticket[bh] = 0u;  // ready for the next phase or launch
  }
}

template <int MB>
__global__ void __launch_bounds__(THREADS, 2) layer_tail_kernel(const TailParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned int epoch = 0;
  const int M = p.B;
  if (p.in_norm) {  // phase B: input norm + fused qkv GEMV
    const int nqkv = p.qkv.N;
    const XSrc x{p.h, p.hidden, p.in_norm, p.eps, nullptr, 0};
    fused::gemv_phase<MB, GEMV_MODE>(x, p.qkv, M, p.hidden, p.gs, p.gsc, smem,
                          [&](int m, int n, float v) {
                            p.qkv_scr[(size_t)m * nqkv + n] = f2bf(v);
                          });
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
  fused::gemv_prefetch<MB>(p.o, p.H * D, p.gs, smem);
  fused::grid_sync(p.bar, epoch);
  // phase D: o-projection + residual, into h' (MLP) or the output
  const int hid = p.hidden;
  bf16* hdst = p.post_norm ? p.h1_scr : p.out;
  const XSrc xo{p.attn_scr, p.H * D, nullptr, 0.f, nullptr, 0};
  fused::gemv_phase<MB, GEMV_MODE>(
      xo, p.o, M, p.H * D, p.gs, p.gsc, smem,
      [&](int m, int n, float v) {
        const size_t i = (size_t)m * hid + n;
        hdst[i] = f2bf(bf2f(p.h[i]) + bf2f(f2bf(v)));
      },
      true);
  if (!p.post_norm) return;
  fused::gemv_prefetch<MB>(p.gu, hid, p.gs, smem);
  fused::grid_sync(p.bar, epoch);
  fused::mlp_phases<MB, GEMV_MODE>(p.h1_scr, p.post_norm, p.eps, p.gu, p.dn, M, hid, p.inter,
                                   p.gs, p.gu_scr, p.out, p.gsc, p.bar, epoch, smem, true);
}

template <int MB>
cudaError_t launch(TailParams p, int nsplit_cap, cudaStream_t st) {
  size_t smem = (size_t)ATT_FLOATS * 4;
  if (fused::gemv_smem(MB, GEMV_MODE) > smem) smem = fused::gemv_smem(MB, GEMV_MODE);
  const int grid = fused::coop_grid(layer_tail_kernel<MB>, smem);
  // splits per (b, kv head): enough work items to cover the grid
  int nsplit = grid / (p.B * p.Hkv);
  if (nsplit > nsplit_cap) nsplit = nsplit_cap;
  p.nsplit = nsplit < 1 ? 1 : nsplit;
  return fused::coop_launch(layer_tail_kernel<MB>, grid, p, smem, p.bar, st);
}

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
//   bar one uint32; gpart, gticket the split scratch of fused::SplitScratch
//   (ticket >= B*Hkv entries too); out [B, hidden]. D = 128, H / Hkv <= 8; keys at
//   s >= min(past_b, attend_len) are not read.
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
  p.o = QW{(const int32_t*)o_q, (const bf16*)o_s, (const bf16*)o_z, hidden};
  p.in_norm = (const bf16*)in_norm;
  p.qkv = QW{(const int32_t*)qkv_q, (const bf16*)qkv_s, (const bf16*)qkv_z,
             (H + 2 * Hkv) * D};
  p.sin = (const float*)sin;
  p.cos = (const float*)cos;
  p.k_row = (bf16*)k_row;
  p.v_row = (bf16*)v_row;
  p.post_norm = (const bf16*)post_norm;
  p.gu = QW{(const int32_t*)gu_q, (const bf16*)gu_s, (const bf16*)gu_z, 2 * inter};
  p.dn = QW{(const int32_t*)dn_q, (const bf16*)dn_s, (const bf16*)dn_z, hidden};
  p.out = (bf16*)out;
  p.qkv_scr = (bf16*)qkv_scr;
  p.part = (float*)part;
  p.attn_scr = (bf16*)attn_scr;
  p.h1_scr = (bf16*)h1_scr;
  p.gu_scr = (bf16*)gu_scr;
  p.bar = (unsigned int*)bar;
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
  switch (fused::fused_mb(B)) {
    case 1: return launch<1>(p, nsplit_cap, st);
    case 16: return launch<16>(p, nsplit_cap, st);
    default: return launch<32>(p, nsplit_cap, st);
  }
}
