// What the 4-bit GPTQ GEMVs share: the tensor-core GEMV at 2..32 rows
// (q4_gemv_tc.cuh) and the streaming GEMV at one row (q4_stream.cuh), which
// serve K1 / K9 (q4_gemv.cu), K6 (q4_mlp.cu) and K7 (layer_tail.cu): how
// the activation is formed (XSrc), the packed weight (QW), the arithmetic
// modes and the a8 rows' quantization.
//
// out[m, n] = sum_g ( s[g,n] * sum_{k in g} x[m,k]*q[k,n]
//                     - zs[g,n] * sum_{k in g} x[m,k] )
// in f32: scales and zero-points act on group partial sums of exact
// nibbles, never per weight (the TPU kernel's math, quant.py:_q4_gemv_kernel
// and ops/mlp.py:_npair_gemv_partials).
//
// K9, the W4A8 modes (MODE; replaces
// exllama_tpu/ops/quant.py:_q4_gemv_kernel_npair_a8 and the a8 / a8x2
// branches of ops/mlp.py:_npair_gemv_partials): per (row, group) the staged
// activation is quantized to int8, sx = max(amax, 1e-20)/127,
// xq = clip(rint(x/sx), +-127), and the group product runs on integers:
//   out += s * sx * sum(xq*q) - zs * sum(x)      (sum(x) stays the exact f32)
// A8X2 adds a second int8 pass over the residual r = x - sx*xq at sx/254.
// A K-packed word holds eight consecutive k of one column; w & 0x0F0F0F0F
// and (w >> 4) & 0x0F0F0F0F are its even and odd nibbles as four bytes
// each, against int8 activations staged in the same order (each block of
// eight k as its four even members, then its four odd ones). The bound is
// the exact mode's: the packed weights are streamed once either way.
#pragma once

#include "common.cuh"

namespace q4 {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

// Arithmetic of the group products (the port's matmul_impl values "pallas",
// "pallas_a8", "pallas_a8x2" at M <= 32).
constexpr int EXACT = 0, A8 = 1, A8X2 = 2;

// K1, K6 and K7 are each built once per mode (-DGEMV_MODE=0|1|2, one
// shared library each), so a mode costs no build time of the others.
#ifndef GEMV_MODE
#define GEMV_MODE 0
#endif

// Loads of data another block wrote earlier in the same launch (the fused
// kernels' scratch) bypass L1, which is not coherent across SMs.
__device__ __forceinline__ float ld_cg(const bf16* p) {
  return bf2f(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// How the staged activation x[m, k] (m < M, k < K) is formed.
struct XSrc {
  const bf16* x;          // row m at x + m * ld
  int ld;                 // row stride of x, in elements
  const bf16* norm_w;     // [K] or NULL: x = bf16(x * rs[m] * w) (RMSNorm)
  float eps;
  const int32_t* x_map;   // [K] or NULL: x[m, k] = x[m, x_map[k]]
  int glu_off;            // > 0: x[m, k] = silu_mul(x[m, k], x[m, glu_off + k])
};

// One packed weight matrix: qweight [K/8, N] int32, scales / zscale [K/gs, N]
// (scale_t: bf16, or f32 under -DSCALE_F32=1).
struct QW {
  const int32_t* qweight;
  const scale_t* scales;
  const scale_t* zscale;
  int N;
};

// clip(rint(v / scale), +-127): round half to even on a true division, as
// jnp.round(x / sx).
__device__ __forceinline__ int quant8(float v, float scale) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, scale))));
}

}  // namespace q4
