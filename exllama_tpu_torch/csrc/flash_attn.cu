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
// unscaled p. The integers are converted while a block of keys is staged
// into shared memory, so the tensor-core loops are the bf16 ones; the 64 K
// and V scales of the block are staged beside them. The in-flight row of a
// deferred step stays bf16.
//
// Bound on the H100: bytes at decode (T=1: every cache byte is read for ~2
// flops per element: 32.8 MB at Llama-7B, past 2000 in bf16, 16.9 MB in
// int8 and 8.7 MB in int4 with their scales), operations at long prefill
// (T*S*D*4 flops over the same cache bytes, on bf16 tensor cores in every
// format). Design: one block per (64-row query tile, kv head,
// batch row); the KV loop runs inside the block, 64 keys at a time staged in
// shared memory; QK^T and PV run on the tensor cores with WMMA (mma.sync)
// fragments, the online-softmax bookkeeping in f32 per row, the output
// accumulator in shared memory. KV blocks wholly above the causal diagonal
// of the tile are never read. Not yet tuned: decode uses one block per kv
// head (no split-KV), and there is no cp.async/TMA pipelining or wgmma.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;  // attention.py:37
constexpr float NEG_INF = -1e9f;                               // attention.py:36
constexpr int BR = 64, BC = 64;
constexpr int WARPS = 4, THREADS = WARPS * 32;

template <int D, int KV>
struct Layout {
  static constexpr int QLD = D + 8, KLD = D + 8, SLD = BC + 4, PLD = BC + 8, OLD = D + 4;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + BR * QLD * 2;
  static constexpr int v_off = k_off + BC * KLD * 2;
  static constexpr int s_off = v_off + BC * KLD * 2;
  static constexpr int p_off = s_off + BR * SLD * 4;
  static constexpr int o_off = p_off + BR * PLD * 2;
  static constexpr int m_off = o_off + BR * OLD * 4;
  static constexpr int ks_off = m_off + 3 * BR * 4;  // [2][BC] K, V scales
  static constexpr int bytes = ks_off + (KV ? 2 * BC * 4 : 0);
};

// 16 integer-valued floats -> 16 bf16 (exact) at a 16-byte aligned address.
__device__ __forceinline__ void put16(bf16* dst, const float (&f)[16]) {
  __align__(16) __nv_bfloat162 h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
  reinterpret_cast<uint4*>(dst)[0] = *reinterpret_cast<const uint4*>(&h[0]);
  reinterpret_cast<uint4*>(dst)[1] = *reinterpret_cast<const uint4*>(&h[4]);
}

// Stage 16 cache bytes at byte column c of a row into the bf16 row dst[D]:
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

template <int D, int KV>
__global__ void __launch_bounds__(THREADS) flash_attn_kernel(
    const bf16* __restrict__ q, const void* __restrict__ k_cache,
    const void* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ past,
    const uint8_t* __restrict__ mask, const bf16* __restrict__ k_new,
    const bf16* __restrict__ v_new, bf16* __restrict__ out, int T, int H, int Hkv, int S,
    int attend_len, int mask_stride, float scale) {
  using L = Layout<D, KV>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);   // [BR][QLD]
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);   // [BC][KLD]
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);   // [BC][KLD]
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);  // [BR][SLD]
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);   // [BR][PLD]
  float* Os = reinterpret_cast<float*>(smem + L::o_off);  // [BR][OLD]
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = m_s + BR;
  float* a_s = l_s + BR;
  float* ks_s = reinterpret_cast<float*>(smem + L::ks_off);  // [BC] (KV != 0)
  float* vs_s = ks_s + BC;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const int rows = T * g;
  const int r0 = blockIdx.x * BR;
  const int pb = past[b];
  const bool deferred = k_new != nullptr;
  constexpr int VPR = D / 8;  // 16-byte vectors per row

  for (int i = tid; i < BR * VPR; i += THREADS) {
    const int r = i / VPR, c8 = (i - r * VPR) * 8;
    const int R = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (R < rows) {
      const int t = R / g, slot = R - t * g;
      v = *reinterpret_cast<const uint4*>(q + (((size_t)b * T + t) * H + hk * g + slot) * D + c8);
    }
    *reinterpret_cast<uint4*>(Qs + r * L::QLD + c8) = v;
  }
  for (int i = tid; i < BR * D; i += THREADS) Os[(i / D) * L::OLD + (i % D)] = 0.f;
  for (int i = tid; i < BR; i += THREADS) {
    m_s[i] = MASK_VALUE;
    l_s[i] = 0.f;
  }

  const int t_max = (min(rows, r0 + BR) - 1) / g;
  const int kv_end = min(attend_len, pb + t_max + (deferred ? 0 : 1));
  const bool warp_active = r0 + warp * 16 < rows;
  // bytes of one cached row, and the strip of this (batch row, kv head)
  constexpr int RB = KV == 0 ? D * 2 : KV == 1 ? D : D / 2;
  const size_t strip = ((size_t)b * Hkv + hk) * S;
  const unsigned char* kbase = static_cast<const unsigned char*>(k_cache) + strip * RB;
  const unsigned char* vbase = static_cast<const unsigned char*>(v_cache) + strip * RB;
  __syncthreads();

  for (int s0 = 0; s0 < kv_end; s0 += BC) {
    constexpr int RV = RB / 16;  // 16-byte vectors per cached row
    for (int i = tid; i < BC * RV; i += THREADS) {
      const int r = i / RV, c = (i - r * RV) * 16;  // c: byte column
      const int s = s0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (s < kv_end) {
        kv = *reinterpret_cast<const uint4*>(kbase + (size_t)s * RB + c);
        vv = *reinterpret_cast<const uint4*>(vbase + (size_t)s * RB + c);
      }
      if constexpr (KV == 0) {
        *reinterpret_cast<uint4*>(Ks + r * L::KLD + c / 2) = kv;
        *reinterpret_cast<uint4*>(Vs + r * L::KLD + c / 2) = vv;
      } else {
        stage16<D, KV>(Ks + r * L::KLD, c, kv);
        stage16<D, KV>(Vs + r * L::KLD, c, vv);
      }
    }
    if constexpr (KV != 0) {
      // scale 0 beyond the visible keys: their p is 0 and stays 0
      for (int i = tid; i < BC; i += THREADS) {
        const int s = s0 + i;
        ks_s[i] = s < kv_end ? k_scale[strip + s] : 0.f;
        vs_s[i] = s < kv_end ? v_scale[strip + s] : 0.f;
      }
    }
    __syncthreads();
    if (warp_active) {
      // scores of this warp's 16 query rows against the 64 staged keys
#pragma unroll
      for (int j = 0; j < BC / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
        wmma::fill_fragment(sc, 0.f);
#pragma unroll
        for (int d = 0; d < D; d += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(a, Qs + warp * 16 * L::QLD + d, L::QLD);
          wmma::load_matrix_sync(kb, Ks + j * 16 * L::KLD + d, L::KLD);
          wmma::mma_sync(sc, a, kb, sc);
        }
        wmma::store_matrix_sync(Ss + warp * 16 * L::SLD + j * 16, sc, L::SLD,
                                wmma::mem_row_major);
      }
      __syncwarp();
      // online softmax, one row at a time, two keys per lane
      for (int rr = 0; rr < 16; ++rr) {
        const int r = warp * 16 + rr, R = r0 + r;
        const int t = R / g;
        const int lim = pb + t + (deferred ? 0 : 1);  // keys s < lim are causal
        float v[2], p[2];
        bool ok[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int c = lane + 32 * h2, s = s0 + c;
          ok[h2] = R < rows && s < kv_end && s < lim;
          float sc = Ss[r * L::SLD + c];
          if constexpr (KV != 0) sc *= ks_s[c];  // the K scale, then 1/sqrt(D)
          v[h2] = ok[h2] ? sc * scale : MASK_VALUE;
          if (ok[h2] && mask != nullptr && mask[(size_t)b * mask_stride + s] == 0)
            v[h2] += NEG_INF;  // pad bias after the causal mask
        }
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(v[0], v[1])));
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) p[h2] = ok[h2] ? expf(v[h2] - m_new) : 0.f;
        const float ps = warp_sum(p[0] + p[1]);  // l sums the unscaled p
        if constexpr (KV != 0) {  // the V scale rides on p into the PV product
          p[0] *= vs_s[lane];
          p[1] *= vs_s[lane + 32];
        }
        Ps[r * L::PLD + lane] = f2bf(p[0]);
        Ps[r * L::PLD + lane + 32] = f2bf(p[1]);
        __syncwarp();
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          m_s[r] = m_new;
          l_s[r] = alpha * l_s[r] + ps;
          a_s[r] = alpha;
        }
        __syncwarp();
      }
      for (int e = lane; e < 16 * D; e += 32) {
        const int r = warp * 16 + e / D;
        Os[r * L::OLD + (e % D)] *= a_s[r];
      }
      __syncwarp();
      // O += P V on this warp's rows
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::load_matrix_sync(o, Os + warp * 16 * L::OLD + j * 16, L::OLD, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
          wmma::load_matrix_sync(a, Ps + warp * 16 * L::PLD + kk, L::PLD);
          wmma::load_matrix_sync(vb, Vs + kk * L::KLD + j * 16, L::KLD);
          wmma::mma_sync(o, a, vb, o);
        }
        wmma::store_matrix_sync(Os + warp * 16 * L::OLD + j * 16, o, L::OLD, wmma::mem_row_major);
      }
    }
    __syncthreads();
  }

  // fold in the in-flight row (deferred mode), normalize, write
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr, R = r0 + r;
    if (R >= rows) break;
    const int t = R / g, head = hk * g + (R - t * g);
    float l = l_s[r], alpha = 1.f, pn = 0.f;
    const bf16* vrow = nullptr;
    if (deferred) {
      const bf16* krow = k_new + ((size_t)b * Hkv + hk) * D;  // k_new [B, 1, Hkv, D]
      float d = 0.f;
      for (int c = lane; c < D; c += 32) d += bf2f(Qs[r * L::QLD + c]) * bf2f(krow[c]);
      d = warp_sum(d) * scale;
      const float m = m_s[r];
      const float m_fin = fmaxf(m, d);
      alpha = expf(m - m_fin);
      pn = expf(d - m_fin);
      l = alpha * l + pn;
      vrow = v_new + ((size_t)b * Hkv + hk) * D;
    }
    if (l == 0.f) l = 1.f;
    for (int c = lane; c < D; c += 32) {
      float o = Os[r * L::OLD + c];
      if (deferred) o = o * alpha + pn * bf2f(vrow[c]);
      out[(((size_t)b * T + t) * H + head) * D + c] = f2bf(o / l);
    }
  }
}

template <int D, int KV>
cudaError_t launch(const bf16* q, const void* kc, const void* vc, const float* ks,
                   const float* vs, const int32_t* past, const uint8_t* mask, const bf16* kn,
                   const bf16* vn, bf16* out, int B, int T, int H, int Hkv, int S,
                   int attend_len, int mask_stride, float scale, cudaStream_t st) {
  using L = Layout<D, KV>;
  static const cudaError_t smem_ok = allow_smem(flash_attn_kernel<D, KV>, L::bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  const int rows = T * (H / Hkv);
  dim3 grid((rows + BR - 1) / BR, Hkv, B);
  flash_attn_kernel<D, KV><<<grid, THREADS, L::bytes, st>>>(
      q, kc, vc, ks, vs, past, mask, kn, vn, out, T, H, Hkv, S, attend_len, mask_stride, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, T, H, D] bf16; k_cache, v_cache [B, Hkv, S, D] bf16 (kv_mode 0), int8
// (1) or [B, Hkv, S, D/2] int4 bytes (2); k_scale, v_scale [B, Hkv, S] f32
// (NULL for kv_mode 0); past [B] int32; mask [B, mask_stride] uint8 or NULL;
// k_new, v_new [B, 1, Hkv, D] bf16 or NULL (deferred mode); out [B, T, H, D]
// bf16. D must be 64 or 128.
extern "C" int flash_attn_launch(const void* q, const void* k_cache, const void* v_cache,
                                 const void* k_scale, const void* v_scale, const void* past,
                                 const void* mask, const void* k_new, const void* v_new,
                                 void* out, int B, int T, int H, int Hkv, int D, int S,
                                 int attend_len, int mask_stride, int kv_mode, float scale,
                                 void* stream) {
  if ((kv_mode != 0) != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr))
    return cudaErrorInvalidValue;
  auto args = [&](auto d_tag, auto kv_tag) {
    constexpr int d = decltype(d_tag)::value, kv = decltype(kv_tag)::value;
    return launch<d, kv>((const bf16*)q, k_cache, v_cache, (const float*)k_scale,
                         (const float*)v_scale, (const int32_t*)past, (const uint8_t*)mask,
                         (const bf16*)k_new, (const bf16*)v_new, (bf16*)out, B, T, H, Hkv, S,
                         attend_len, mask_stride, scale, (cudaStream_t)stream);
  };
  auto by_kv = [&](auto d_tag) {
    switch (kv_mode) {
      case 0: return args(d_tag, std::integral_constant<int, 0>{});
      case 1: return args(d_tag, std::integral_constant<int, 1>{});
      case 2: return args(d_tag, std::integral_constant<int, 2>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (D == 64) return by_kv(std::integral_constant<int, 64>{});
  if (D == 128) return by_kv(std::integral_constant<int, 128>{});
  return cudaErrorInvalidValue;
}
