// K3 flash_attn: causal GQA attention over the bf16 KV cache, any T.
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
// stays for a row with no causal key. bf16 KV only (int8/int4 dequant is a
// later change).
//
// Bound on the H100: bytes at decode (T=1: every cache byte is read for ~2
// flops per bf16 element), operations at long prefill (T*S*D*4 flops over
// the same cache bytes). Design: one block per (64-row query tile, kv head,
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

template <int D>
struct Layout {
  static constexpr int QLD = D + 8, KLD = D + 8, SLD = BC + 4, PLD = BC + 8, OLD = D + 4;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + BR * QLD * 2;
  static constexpr int v_off = k_off + BC * KLD * 2;
  static constexpr int s_off = v_off + BC * KLD * 2;
  static constexpr int p_off = s_off + BR * SLD * 4;
  static constexpr int o_off = p_off + BR * PLD * 2;
  static constexpr int m_off = o_off + BR * OLD * 4;
  static constexpr int bytes = m_off + 3 * BR * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_cache,
    const bf16* __restrict__ v_cache, const int32_t* __restrict__ past,
    const uint8_t* __restrict__ mask, const bf16* __restrict__ k_new,
    const bf16* __restrict__ v_new, bf16* __restrict__ out, int T, int H, int Hkv, int S,
    int attend_len, int mask_stride, float scale) {
  using L = Layout<D>;
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
  const bf16* kbase = k_cache + ((size_t)b * Hkv + hk) * S * D;
  const bf16* vbase = v_cache + ((size_t)b * Hkv + hk) * S * D;
  __syncthreads();

  for (int s0 = 0; s0 < kv_end; s0 += BC) {
    for (int i = tid; i < BC * VPR; i += THREADS) {
      const int r = i / VPR, c8 = (i - r * VPR) * 8;
      const int s = s0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (s < kv_end) {
        kv = *reinterpret_cast<const uint4*>(kbase + (size_t)s * D + c8);
        vv = *reinterpret_cast<const uint4*>(vbase + (size_t)s * D + c8);
      }
      *reinterpret_cast<uint4*>(Ks + r * L::KLD + c8) = kv;
      *reinterpret_cast<uint4*>(Vs + r * L::KLD + c8) = vv;
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
          v[h2] = ok[h2] ? Ss[r * L::SLD + c] * scale : MASK_VALUE;
          if (ok[h2] && mask != nullptr && mask[(size_t)b * mask_stride + s] == 0)
            v[h2] += NEG_INF;  // pad bias after the causal mask
        }
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(v[0], v[1])));
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) p[h2] = ok[h2] ? expf(v[h2] - m_new) : 0.f;
        const float ps = warp_sum(p[0] + p[1]);
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

template <int D>
cudaError_t launch(const bf16* q, const bf16* kc, const bf16* vc, const int32_t* past,
                   const uint8_t* mask, const bf16* kn, const bf16* vn, bf16* out, int B,
                   int T, int H, int Hkv, int S, int attend_len, int mask_stride, float scale,
                   cudaStream_t st) {
  static const cudaError_t smem_ok = allow_smem(flash_attn_kernel<D>, Layout<D>::bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  const int rows = T * (H / Hkv);
  dim3 grid((rows + BR - 1) / BR, Hkv, B);
  flash_attn_kernel<D><<<grid, THREADS, Layout<D>::bytes, st>>>(
      q, kc, vc, past, mask, kn, vn, out, T, H, Hkv, S, attend_len, mask_stride, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, T, H, D] bf16; k_cache, v_cache [B, Hkv, S, D] bf16; past [B] int32;
// mask [B, mask_stride] uint8 or NULL; k_new, v_new [B, 1, Hkv, D] bf16 or
// NULL (deferred mode); out [B, T, H, D] bf16. D must be 64 or 128.
extern "C" int flash_attn_launch(const void* q, const void* k_cache, const void* v_cache,
                                 const void* past, const void* mask, const void* k_new,
                                 const void* v_new, void* out, int B, int T, int H, int Hkv,
                                 int D, int S, int attend_len, int mask_stride, float scale,
                                 void* stream) {
  auto args = [&](auto tag) {
    constexpr int d = decltype(tag)::value;
    return launch<d>((const bf16*)q, (const bf16*)k_cache, (const bf16*)v_cache,
                     (const int32_t*)past, (const uint8_t*)mask, (const bf16*)k_new,
                     (const bf16*)v_new, (bf16*)out, B, T, H, Hkv, S, attend_len, mask_stride,
                     scale, (cudaStream_t)stream);
  };
  if (D == 64) return args(std::integral_constant<int, 64>{});
  if (D == 128) return args(std::integral_constant<int, 128>{});
  return cudaErrorInvalidValue;
}
