// Shared helpers of the port's Hopper kernels (built for sm_90a by
// exllama_tpu_torch/kernels/__init__.py, one shared library per .cu file).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

// silu(g) * up with the separate path's casts: g and u are the bf16-rounded
// gate / up outputs; silu in f32, rounded to bf16, times u, rounded to bf16
// (ops/mlp.py:_silu_boundary, ops/quant.py:680-682).
__device__ __forceinline__ float silu_mul(float g, float u) {
  const float sg = bf2f(f2bf(g / (1.f + expf(-g))));
  return bf2f(f2bf(sg * u));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows of the activation are handled in register tiles of MB (a power of two
// >= M, at most 32); kernels are instantiated once per tile size.
static inline int pick_mb(int m) {
  return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : m <= 8 ? 8 : m <= 16 ? 16 : 32;
}

// Opt a kernel into more than 48 KB of dynamic shared memory (once per
// kernel instantiation and process).
template <typename K>
static inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}
