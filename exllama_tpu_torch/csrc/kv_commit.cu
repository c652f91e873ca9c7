// K8 kv_commit: every layer's deferred K/V rows of a decode step written into
// its cache at the step's cursor, in one launch.
//
// Replaces the TPU kernel exllama_tpu/ops/attention.py:_commit_kernel
// (launched at attention.py:389 via commit_kv_cache, :284), for a bf16
// cache and a cursor shared by the batch:
//   cache_l[b, hk, past, :] = rows_l[b, 0, hk, :]   for K and V, every layer l.
//
// Bound on the H100: launch overhead. It copies 2*L*B*Hkv*D bf16 values
// (0.5 MB at Llama-7B, B=1: 0.16 us of bytes), far less than one launch
// costs. Design: the port's caches are L separate tensors updated in place,
// so the launcher takes a device array of the 2L cache base pointers (built
// once per cache by the wrapper); one block per (layer, K|V, batch row, kv
// head) row copies it with 16-byte vectors. The TPU kernel's strip
// read-modify-write exists only for Mosaic's (8, 128) tiling and is not
// carried over.
#include "common.cuh"

namespace {

__global__ void kv_commit_kernel(const unsigned long long* __restrict__ caches,
                                 const bf16* __restrict__ new_k, const bf16* __restrict__ new_v,
                                 int L, int B, int Hkv, int S, int D, int past) {
  int r = blockIdx.x;                    // ((l * 2 + kv) * B + b) * Hkv + hk
  const int hk = r % Hkv;
  r /= Hkv;
  const int b = r % B;
  r /= B;
  const int kv = r & 1, l = r >> 1;
  const bf16* src = (kv ? new_v : new_k) + (((size_t)l * B + b) * Hkv + hk) * D;
  bf16* dst = reinterpret_cast<bf16*>(caches[kv * L + l]) +
              (((size_t)b * Hkv + hk) * S + past) * D;
  for (int i = threadIdx.x; i < D / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

}  // namespace

// caches [2L] uint64: the K caches of layers 0..L-1, then the V caches, each
// [B, Hkv, S, D] bf16; new_k / new_v [L, B, 1, Hkv, D] bf16; D % 8 == 0,
// 16-byte aligned rows; 0 <= past < S.
extern "C" int kv_commit_launch(const void* caches, const void* new_k, const void* new_v,
                                int L, int B, int Hkv, int S, int D, int past,
                                void* stream) {
  if (D % 8 || past < 0 || past >= S) return cudaErrorInvalidValue;
  const int threads = D / 8 < 32 ? 32 : D / 8;
  kv_commit_kernel<<<2 * L * B * Hkv, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)caches, (const bf16*)new_k, (const bf16*)new_v, L, B, Hkv,
      S, D, past);
  return cudaGetLastError();
}
