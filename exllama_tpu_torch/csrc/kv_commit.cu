// K8 kv_commit: every layer's deferred K/V rows of a decode step written into
// its cache at the step's cursor, in one launch; quantized on the way into an
// int8 or int4 cache.
//
// Replaces the TPU kernel exllama_tpu/ops/attention.py:_commit_kernel
// (launched at attention.py:389 via commit_kv_cache, :284):
//   cache_l[b, hk, past_b, :] = rows_l[b, 0, hk, :]   for K and V, every layer l,
// and for a quantized cache also scale_l[b, hk, past] = the row's scale. The
// TPU kernel receives rows that XLA quantized before it
// (attention.py:352-366); here the kernel quantizes, so the commit stays one
// launch: per row scale = max(amax, 1e-8) / 127 (int4: / 7), q =
// clip(round_half_even(x / scale)), both in true f32 division, which gives
// the bytes and scales of quantize_kv_rows / quantize_kv_rows4
// (attention.py:58-94) bit for bit; an int4 byte d packs dims d (low nibble,
// q + 8) and d + D/2 (high nibble, (q + 8) ^ 8).
//
// The cursor lives in device memory: an int32 [1] (shared by the batch) or
// [B] (one per row, as the JAX commit_kv_cache takes, attention.py:284-300),
// read by the kernel, which writes no row whose cursor is outside [0, S),
// as the plain writes at a tensor cursor leave it (ops/attention.py:
// _write_at; the callers that hold an int cursor check it on the host). A
// stated deviation: the JAX package's vmapped dynamic_update_slice lands
// such a row on a valid one (S or beyond at S - 1; -1 counted from the end).
// So a decode step that commits through K8 passes no cursor by value and
// makes no host sync for a per-row cursor.
//
// Bound on the H100: launch overhead. It reads 2*L*B*Hkv*D bf16 values
// (0.5 MB at Llama-7B, B=1: 0.16 us of bytes) and writes as many, half or a
// quarter, less than one launch costs (phase 3 of chip_smoke.py times an
// empty launch, kv_launch_floor, beside it). Design: the port's caches are
// L separate tensors updated in place, so the launcher takes a device
// array of the cache base pointers (built once per cache by the wrapper: 2L
// caches, then for a quantized cache 2L scale tensors). A bf16 row is
// copied as D/8 16-byte vectors, the rows' vectors dealt out over a grid
// near the SM count (128 blocks of 256 threads at Llama-7B, B = 1), VEC of
// them a thread (two or four a thread in fewer threads measured 14-37%
// slower: the per-vector index arithmetic then runs on too few warps); a
// quantized row is one warp's (amax by shuffle,
// then scale, round, pack), a row a warp (256 blocks of 8 warps); a grid
// of one block a row, 32 threads each, read 7-8 us on an H100 against a
// ~5 us launch floor (chip_smoke.py phase 3). The TPU kernel's strip
// read-modify-write exists only for Mosaic's (8, 128) tiling and is not
// carried over.
#include "common.cuh"

namespace {

constexpr int COPY_THREADS = 256;   // a bf16 block
constexpr int VEC = 1;               // 16-byte vectors a thread has in flight (bf16)
constexpr int QUANT_THREADS = 256;   // a quantized block: 8 warps, a row each

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

// The cursor of batch row b: past[0] when shared (npast == 1), else past[b].
__device__ __forceinline__ int cursor_of(const int32_t* past, int npast, int b) {
  return __ldg(past + (npast == 1 ? 0 : b));
}

__global__ void __launch_bounds__(COPY_THREADS) kv_commit_kernel(
    const unsigned long long* __restrict__ caches, const bf16* __restrict__ new_k,
    const bf16* __restrict__ new_v, const int32_t* __restrict__ past, int npast, int L, int B,
    int Hkv, int S, int D) {
  const int per_row = D / 8, total = 2 * L * B * Hkv * per_row;
  const int stride = gridDim.x * COPY_THREADS;
  for (int i0 = blockIdx.x * COPY_THREADS + threadIdx.x; i0 < total; i0 += VEC * stride) {
    uint4 v[VEC];
    bf16* dst[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {  // every load issued before the first store
      const int i = i0 + j * stride;
      dst[j] = nullptr;
      if (i >= total) continue;
      const Row w = row_of(i / per_row, B, Hkv);
      const int p = cursor_of(past, npast, w.b);
      const size_t src = (((size_t)w.l * B + w.b) * Hkv + w.hk) * D;
      v[j] = reinterpret_cast<const uint4*>((w.kv ? new_v : new_k) + src)[i % per_row];
      if (p >= 0 && p < S)
        dst[j] = reinterpret_cast<bf16*>(caches[w.kv * L + w.l]) +
                 (((size_t)w.b * Hkv + w.hk) * S + p) * D;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (dst[j]) reinterpret_cast<uint4*>(dst[j])[(i0 + j * stride) % per_row] = v[j];
  }
}

// One warp per row, the rows dealt out over the grid's warps. INT4 = false:
// D int8 bytes; true: D/2 packed bytes.
template <bool INT4>
__global__ void __launch_bounds__(QUANT_THREADS) kv_commit_quant_kernel(
    const unsigned long long* __restrict__ caches, const bf16* __restrict__ new_k,
    const bf16* __restrict__ new_v, const int32_t* __restrict__ past, int npast, int L, int B,
    int Hkv, int S, int D) {
  const int lane = threadIdx.x & 31, rows = 2 * L * B * Hkv;
  const int warps = gridDim.x * (QUANT_THREADS / 32);
  for (int r = blockIdx.x * (QUANT_THREADS / 32) + (threadIdx.x >> 5); r < rows; r += warps) {
    const Row w = row_of(r, B, Hkv);
    const int p = cursor_of(past, npast, w.b);
    if (p < 0 || p >= S) continue;  // warp-uniform
    const bf16* src = (w.kv ? new_v : new_k) + (((size_t)w.l * B + w.b) * Hkv + w.hk) * D;
    const size_t pos = ((size_t)w.b * Hkv + w.hk) * S + p;
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
}

__global__ void empty_kernel() {}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace

// caches uint64: the K caches of layers 0..L-1, then the V caches, each
// [B, Hkv, S, D] bf16 (kv_mode 0), [B, Hkv, S, D] int8 (1) or [B, Hkv, S, D/2]
// int4 bytes (2); for kv_mode 1 and 2 then the L K-scale and the L V-scale
// tensors [B, Hkv, S] f32. new_k / new_v [L, B, 1, Hkv, D] bf16; D % 8 == 0,
// 16-byte aligned rows. past: int32 on the card, npast = 1 (one cursor for
// the batch) or B (one a row); a row whose cursor is outside [0, S) is not
// written.
extern "C" int kv_commit_launch(const void* caches, const void* new_k, const void* new_v,
                                const void* past, int npast, int L, int B, int Hkv, int S,
                                int D, int kv_mode, void* stream) {
  if (D % 8 || kv_mode < 0 || kv_mode > 2 || past == nullptr || (npast != 1 && npast != B))
    return cudaErrorInvalidValue;
  const auto* c = (const unsigned long long*)caches;
  const auto* nk = (const bf16*)new_k;
  const auto* nv = (const bf16*)new_v;
  const auto* ps = (const int32_t*)past;
  const int rows = 2 * L * B * Hkv;
  auto st = (cudaStream_t)stream;
  // enough threads for VEC vectors (bf16) or one row (quantized) each, at
  // most two (bf16) or four blocks an SM
  if (kv_mode == 0) {
    const int want = (rows * (D / 8) + VEC * COPY_THREADS - 1) / (VEC * COPY_THREADS);
    const int grid = want < 2 * sm_count() ? want : 2 * sm_count();
    kv_commit_kernel<<<grid, COPY_THREADS, 0, st>>>(c, nk, nv, ps, npast, L, B, Hkv, S, D);
  } else {
    const int want = (rows + QUANT_THREADS / 32 - 1) / (QUANT_THREADS / 32);
    const int grid = want < 4 * sm_count() ? want : 4 * sm_count();
    if (kv_mode == 1)
      kv_commit_quant_kernel<false><<<grid, QUANT_THREADS, 0, st>>>(c, nk, nv, ps, npast, L, B,
                                                                    Hkv, S, D);
    else
      kv_commit_quant_kernel<true><<<grid, QUANT_THREADS, 0, st>>>(c, nk, nv, ps, npast, L, B,
                                                                   Hkv, S, D);
  }
  return cudaGetLastError();
}

// One launch of an empty kernel (one block of one thread): the launch floor
// that phase 3 times beside K8 with the same timer.
extern "C" int kv_launch_floor(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return cudaGetLastError();
}
