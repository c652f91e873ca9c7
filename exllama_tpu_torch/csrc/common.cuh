// Shared helpers of the port's Hopper kernels (built for sm_90a by
// exllama_tpu_torch/kernels/__init__.py, one shared library per .cu file).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

// Storage type of the 4-bit weights' per-group scale and zero-scale rows
// (TuningParams.scale_dtype): bf16, or f32 in the libraries built with
// -DSCALE_F32=1. Fixed at compile time: each scale type is a library of its
// own, so the bf16 builds are the code they were.
#if SCALE_F32
typedef float scale_t;
__device__ __forceinline__ float sc2f(scale_t v) { return v; }
#else
typedef bf16 scale_t;
__device__ __forceinline__ float sc2f(scale_t v) { return bf2f(v); }
#endif
constexpr int SC_BYTES = (int)sizeof(scale_t);
constexpr int SC_VEC = 16 / SC_BYTES;  // scales in a 16-byte copy
// Host-visible symbols of headers outside an anonymous namespace (the ring
// kernel's template kernels and launcher) get a namespace of their own in
// the f32-scale builds: libraries of both scale types share a process, and
// two copies of one symbol would resolve to the first library loaded.
#if SCALE_F32
#define SCALE_NS_BEGIN inline namespace scale_f32 {
#define SCALE_NS_END }
#else
#define SCALE_NS_BEGIN
#define SCALE_NS_END
#endif

// E consecutive scales (E * SC_BYTES a multiple of 8, 8-byte aligned) held
// in registers as they were loaded, converted to f32 where they are used.
template <int E>
struct ScaleRow {
  static constexpr int WORDS = E * SC_BYTES / 4;
  static_assert(WORDS % 2 == 0, "loads of 8 or 16 bytes");
  uint32_t w[WORDS];
  __device__ __forceinline__ explicit ScaleRow(const scale_t* p) {
    if constexpr (WORDS == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < WORDS; i += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(reinterpret_cast<const uint32_t*>(p) + i);
        w[i] = v.x, w[i + 1] = v.y, w[i + 2] = v.z, w[i + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ float operator[](int i) const {
    return sc2f(reinterpret_cast<const scale_t*>(w)[i]);
  }
};

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
