// K8 kv_commit: every layer's deferred K/V rows of a decode step written into
// its cache at the step's cursor, in one launch; quantized on the way into an
// int8 or int4 cache.
//
// Replaces the TPU kernel exllama_tpu/ops/attention.py:_commit_kernel
// (launched at attention.py:389 via commit_kv_cache, :284), for a cursor
// shared by the batch:
//   cache_l[b, hk, past, :] = rows_l[b, 0, hk, :]   for K and V, every layer l,
// and for a quantized cache also scale_l[b, hk, past] = the row's scale. The
// TPU kernel receives rows that XLA quantized before it
// (attention.py:352-366); here the kernel quantizes, so the commit stays one
// launch: per row scale = max(amax, 1e-8) / 127 (int4: / 7), q =
// clip(round_half_even(x / scale)), both in true f32 division, which gives
// the bytes and scales of quantize_kv_rows / quantize_kv_rows4
// (attention.py:58-94) bit for bit; an int4 byte d packs dims d (low nibble,
// q + 8) and d + D/2 (high nibble, (q + 8) ^ 8).
//
// Bound on the H100: launch overhead. It reads 2*L*B*Hkv*D bf16 values
// (0.5 MB at Llama-7B, B=1: 0.16 us of bytes) and writes as many, half or a
// quarter, far less than one launch costs. Design: the port's caches are L
// separate tensors updated in place, so the launcher takes a device array of
// the cache base pointers (built once per cache by the wrapper: 2L caches,
// then for a quantized cache 2L scale tensors); one block per (layer, K|V,
// batch row, kv head) row: a bf16 row is copied with 16-byte vectors, a
// quantized one by a single warp (amax by shuffle, then scale, round, pack).
// The TPU kernel's strip read-modify-write exists only for Mosaic's (8, 128)
// tiling and is not carried over.
#include "common.cuh"

namespace {

struct Row {
  int l, kv, b, hk;
};

__device__ __forceinline__ Row row_of(int r, int B, int Hkv) {
  Row w;                                 // r = ((l * 2 + kv) * B + b) * Hkv + hk
  w.hk = r % Hkv;
  r /= Hkv;
  w.b = r % B;
  r /= B;
  w.kv = r & 1;
  w.l = r >> 1;
  return w;
}

__global__ void kv_commit_kernel(const unsigned long long* __restrict__ caches,
                                 const bf16* __restrict__ new_k, const bf16* __restrict__ new_v,
                                 int L, int B, int Hkv, int S, int D, int past) {
  const Row w = row_of(blockIdx.x, B, Hkv);
  const bf16* src = (w.kv ? new_v : new_k) + (((size_t)w.l * B + w.b) * Hkv + w.hk) * D;
  bf16* dst = reinterpret_cast<bf16*>(caches[w.kv * L + w.l]) +
              (((size_t)w.b * Hkv + w.hk) * S + past) * D;
  for (int i = threadIdx.x; i < D / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

// One warp per row. INT4 = false: D int8 bytes; true: D/2 packed bytes.
template <bool INT4>
__global__ void kv_commit_quant_kernel(const unsigned long long* __restrict__ caches,
                                       const bf16* __restrict__ new_k,
                                       const bf16* __restrict__ new_v, int L, int B, int Hkv,
                                       int S, int D, int past) {
  const Row w = row_of(blockIdx.x, B, Hkv);
  const int lane = threadIdx.x;
  const bf16* src = (w.kv ? new_v : new_k) + (((size_t)w.l * B + w.b) * Hkv + w.hk) * D;
  const size_t pos = ((size_t)w.b * Hkv + w.hk) * S + past;
  float amax = 0.f;
  for (int i = lane; i < D; i += 32) amax = fmaxf(amax, fabsf(bf2f(src[i])));
  amax = warp_max(amax);
  constexpr float QMAX = INT4 ? 7.f : 127.f;
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), QMAX);
  auto quant = [&](int i) {
    const int q = __float2int_rn(__fdiv_rn(bf2f(src[i]), scale));
    return max(-(int)QMAX, min((int)QMAX, q));
  };
  if constexpr (INT4) {
    int8_t* dst = reinterpret_cast<int8_t*>(caches[w.kv * L + w.l]) + pos * (D / 2);
    for (int i = lane; i < D / 2; i += 32) {
      const int lo = quant(i) + 8, hi = (quant(i + D / 2) + 8) ^ 8;
      dst[i] = (int8_t)(lo | (hi << 4));
    }
  } else {
    int8_t* dst = reinterpret_cast<int8_t*>(caches[w.kv * L + w.l]) + pos * D;
    for (int i = lane; i < D; i += 32) dst[i] = (int8_t)quant(i);
  }
  if (lane == 0) reinterpret_cast<float*>(caches[(2 + w.kv) * L + w.l])[pos] = scale;
}

}  // namespace

// caches uint64: the K caches of layers 0..L-1, then the V caches, each
// [B, Hkv, S, D] bf16 (kv_mode 0), [B, Hkv, S, D] int8 (1) or [B, Hkv, S, D/2]
// int4 bytes (2); for kv_mode 1 and 2 then the L K-scale and the L V-scale
// tensors [B, Hkv, S] f32. new_k / new_v [L, B, 1, Hkv, D] bf16; D % 8 == 0,
// 16-byte aligned rows; 0 <= past < S.
extern "C" int kv_commit_launch(const void* caches, const void* new_k, const void* new_v,
                                int L, int B, int Hkv, int S, int D, int past, int kv_mode,
                                void* stream) {
  if (D % 8 || past < 0 || past >= S || kv_mode < 0 || kv_mode > 2)
    return cudaErrorInvalidValue;
  const auto* c = (const unsigned long long*)caches;
  const auto* nk = (const bf16*)new_k;
  const auto* nv = (const bf16*)new_v;
  const int rows = 2 * L * B * Hkv;
  auto st = (cudaStream_t)stream;
  if (kv_mode == 0) {
    const int threads = D / 8 < 32 ? 32 : D / 8;
    kv_commit_kernel<<<rows, threads, 0, st>>>(c, nk, nv, L, B, Hkv, S, D, past);
  } else if (kv_mode == 1) {
    kv_commit_quant_kernel<false><<<rows, 32, 0, st>>>(c, nk, nv, L, B, Hkv, S, D, past);
  } else {
    kv_commit_quant_kernel<true><<<rows, 32, 0, st>>>(c, nk, nv, L, B, Hkv, S, D, past);
  }
  return cudaGetLastError();
}
